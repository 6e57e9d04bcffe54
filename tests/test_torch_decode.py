"""The port's decode attention (`flash_attn_tpu_torch.kernels.flash_decode`,
plain version on the CPU) and `combine_attn_partials` against the JAX
package's `decode_attn_bhsd` (Pallas interpret mode) and combine, on the same
seeded numpy inputs in float32.

Tolerance: o atol 2e-5, lse atol 1e-5 (float32 on both sides, summation
order only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.combine import (
    combine_attn_partials as jax_combine, merge_attn_state as jax_merge)
from flash_attn_tpu.kernels.flash_decode import decode_attn_bhsd as jax_decode
from flash_attn_tpu.utils import testing as jax_testing
from flash_attn_tpu_torch.kernels import combine as port_combine
from flash_attn_tpu_torch.kernels import flash_decode as port_decode

O_ATOL, LSE_ATOL = 2e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references here are tiny programs whose time is compiling,
    not running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def jitted(fn, *args, **kw):
    """fn(*args, **kw) under `jax.jit`, the keyword arrays traced and the
    other keywords static."""
    arrays = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    return jax.jit(functools.partial(fn, **static))(*args, **arrays)
@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny torch ops run faster on one thread than with torch's threads
    contending with JAX's (and other test processes') in one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMAX = 40

CASES = {
    "sq1_g1": dict(h=4, hk=4, sq=1, lens=[0, 17, SMAX]),
    "sq1_g2": dict(h=4, hk=2, sq=1, lens=[5, SMAX, 23]),
    "sq4_g1": dict(h=4, hk=4, sq=4, lens=[4, 29, SMAX]),
    "sq4_g2": dict(h=4, hk=2, sq=4, lens=[SMAX, 9, 31]),
    "splits3_g2": dict(h=4, hk=2, sq=1, lens=[0, 38, 21], num_splits=3,
                       block_k=16),
    "splits3_sq4": dict(h=4, hk=4, sq=4, lens=[12, SMAX, 4], num_splits=3,
                        block_k=16),
    "window": dict(h=4, hk=2, sq=4, lens=[SMAX, 26, 11], window=(6, 0)),
    "softcap": dict(h=4, hk=4, sq=1, lens=[33, 8, SMAX], softcap=30.0),
    "alibi": dict(h=4, hk=4, sq=4, lens=[SMAX, 19, 7], alibi=True),
    "cache_batch_idx": dict(h=4, hk=2, sq=1, lens=[30, 12, SMAX],
                            cache_batch_idx=[3, 0, 2]),
}


def make_inputs(c, d=32, seed=0):
    rng = np.random.default_rng(seed)
    b = len(c["lens"])
    bc = 4 if "cache_batch_idx" in c else b
    q = rng.standard_normal((b, c["h"], c["sq"], d)).astype(np.float32)
    kc = rng.standard_normal((bc, c["hk"], SMAX, d)).astype(np.float32)
    vc = rng.standard_normal((bc, c["hk"], SMAX, d)).astype(np.float32)
    slopes = (rng.uniform(0.05, 0.5, (b, c["h"])).astype(np.float32)
              if c.get("alibi") else None)
    return q, kc, vc, slopes


def kwargs(c, slopes, lib, d=32):
    kw = dict(softmax_scale=d ** -0.5, causal=True,
              window_size=c.get("window", (-1, -1)),
              softcap=c.get("softcap", 0.0),
              alibi_slopes=None if slopes is None else lib(slopes),
              num_splits=c.get("num_splits", 1), block_k=c.get("block_k"))
    if "cache_batch_idx" in c:
        kw["cache_batch_idx"] = lib(np.asarray(c["cache_batch_idx"], np.int32))
    return kw


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_jax_kernel(name):
    c = CASES[name]
    q, kc, vc, slopes = make_inputs(c)
    lens = np.asarray(c["lens"], np.int32)
    o_j, lse_j = jitted(jax_decode, q, kc, vc, lens,
                        **kwargs(c, slopes, jnp.asarray))
    o_t, lse_t = port_decode.decode_attn_bhsd(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lens), **kwargs(c, slopes, torch.from_numpy))
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    o_t, lse_t = o_t.numpy(), lse_t.numpy()
    np.testing.assert_allclose(o_t, o_j, atol=O_ATOL, rtol=0)
    assert np.array_equal(np.isinf(lse_t), np.isinf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], atol=LSE_ATOL, rtol=0)
    if 0 in c["lens"]:
        i = c["lens"].index(0)
        assert np.all(o_t[i] == 0.0) and np.all(np.isposinf(lse_t[i]))


def test_decode_alibi_gqa_matches_jax_oracle():
    """ALiBi with g > 1 against JAX `attention_ref` (the JAX decode kernel
    itself fails on this input in interpret mode: see ROADMAP Queue 3)."""
    c = dict(h=4, hk=2, sq=4, lens=[SMAX, 19, 7], alibi=True)
    q, kc, vc, slopes = make_inputs(c, seed=3)
    o_t, _ = port_decode.decode_attn_bhsd(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.tensor(c["lens"], dtype=torch.int32),
        **kwargs(c, slopes, torch.from_numpy))
    kpm = np.arange(SMAX)[None] < np.asarray(c["lens"])[:, None]

    @jax.jit
    def oracle(q, kc, vc, slopes, kpm):
        bias = jax_testing.attn_bias_from_alibi_slopes(
            slopes, c["sq"], SMAX, None, kpm, causal=False)
        return jax_testing.attention_ref(
            q.transpose(0, 2, 1, 3), kc.transpose(0, 2, 1, 3),
            vc.transpose(0, 2, 1, 3), key_padding_mask=kpm, attn_bias=bias,
            causal=True, softmax_scale=32 ** -0.5)[0]

    ref = oracle(q, kc, vc, slopes, kpm)
    np.testing.assert_allclose(o_t.numpy(),
                               np.asarray(ref).transpose(0, 2, 1, 3),
                               atol=O_ATOL, rtol=0)


@pytest.mark.parametrize("smax,num_splits,block_k,expect", [
    (40, 1, None, (1, 40)),
    (40, 3, 16, (3, 16)),
    (1024, 4, None, (1, 1024)),
    (1024, 4, 128, (4, 256)),
    (100, 8, 16, (7, 16)),
])
def test_split_layout_matches_jax_wrapper(smax, num_splits, block_k, expect):
    """(splits, keys per split) as `decode_attn_bhsd:269-287` computes them."""
    assert port_decode.split_layout(smax, num_splits, block_k) == expect


# (b, hk, row tiles, keys, split unit): the decode kernel's grid before the
# key split, on a card of 132 SMs (an H100 SXM)
NUM_SPLITS_CASES = {
    # b * hk * row tiles >= 132 blocks already fill the card
    "fills_batch": ((32, 8, 1, 16384, 1024), 1),
    "fills_prefill_tiles": ((4, 8, 24, 4096, 1024), 1),
    # the bench shape: Llama-3-8B's 8 kv heads, batch 8, one row tile, 64
    # pages of 256 rows (bf16 units of 4 pages, int8 units of 8), and the
    # shortest bench length, 8192 keys
    "bench_bf16": ((8, 8, 1, 16384, 1024), 6),
    "bench_int8": ((8, 8, 1, 16384, 2048), 8),
    "bench_bf16_8192": ((8, 8, 1, 8192, 1024), 8),
    # the serving decode: GPT-2's 12 heads, batch 8, a 1024-row cache in
    # 256-key units
    "serving": ((8, 12, 1, 1024, 256), 4),
    # fewer units than the fill wants: one split a unit, no more
    "few_units": ((2, 2, 1, 3000, 1024), 3),
}


@pytest.mark.parametrize("name", list(NUM_SPLITS_CASES))
def test_decode_num_splits(name):
    """`decode_num_splits` (num_splits = 0 on CUDA): 1 where the grid fills
    the card, else the smallest count whose splits give at least two blocks
    an SM or one split a unit; the count cuts the keys into non-empty
    splits of whole units under `split_layout`."""
    (b, hk, tiles, keys, unit), want = NUM_SPLITS_CASES[name]
    n = port_decode.decode_num_splits(b, hk, tiles, keys, unit, 132)
    assert n == want
    units = -(-keys // unit)
    assert 1 <= n <= units
    base = b * hk * tiles
    if base < 132:
        assert base * n >= 2 * 132 or n == units
    ns, split_keys = port_decode.split_layout(keys, n, unit)
    assert ns == n and split_keys % unit == 0
    assert (n - 1) * split_keys < keys <= n * split_keys


def test_decode_num_splits_on_ref_layout_units():
    """At the bench shape the automatic count cuts the paged cache on the
    units of `ref_layout_tiles` (bundles of pages) into non-empty splits,
    for bf16 and int8 caches."""
    for dtype, unit in ((torch.bfloat16, 1024), (torch.int8, 2048)):
        kc = torch.empty((512, 256, 8, 128), dtype=dtype, device="meta")
        table = torch.zeros((8, 64), dtype=torch.int32)
        bk, nk_max, bundle, _, _ = port_decode.ref_layout_tiles(
            kc, kc, table, 1, None)
        assert (bk * bundle, nk_max * bk) == (unit, 16384)
        n = port_decode.decode_num_splits(8, 8, 1, nk_max * bk,
                                          bundle * bk, 132)
        *_, ns, bps = port_decode.ref_layout_tiles(kc, kc, table, n, None)
        assert ns == n and 8 * 8 * n >= 2 * 132
        assert (n - 1) * bps * bundle < nk_max <= n * bps * bundle


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine_matches_jax(seed):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((3, 2, 4, 5, 8)).astype(np.float32)
    lse = rng.standard_normal((3, 2, 4, 5)).astype(np.float32) * 3
    lse[rng.random(lse.shape) < 0.3] = np.inf  # empty splits
    lse[:, 0, 0, 0] = np.inf  # a row with every split empty
    o[np.isinf(lse)] = 0.0
    o_j, lse_j = jax_combine(jnp.asarray(o), jnp.asarray(lse), axis=0)
    o_t, lse_t = port_combine.combine_attn_partials(
        torch.from_numpy(o), torch.from_numpy(lse), axis=0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=O_ATOL,
                               rtol=0)
    lse_j = np.asarray(lse_j)
    assert np.array_equal(np.isposinf(lse_t.numpy()), np.isposinf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t.numpy()[fin], lse_j[fin], atol=LSE_ATOL,
                               rtol=0)
    # pairwise merge (ring-attention hop form)
    o_j2, lse_j2 = jax_merge(jnp.asarray(o[0]), jnp.asarray(lse[0]),
                             jnp.asarray(o[1]), jnp.asarray(lse[1]))
    o_t2, lse_t2 = port_combine.merge_attn_state(
        torch.from_numpy(o[0]), torch.from_numpy(lse[0]),
        torch.from_numpy(o[1]), torch.from_numpy(lse[1]))
    np.testing.assert_allclose(o_t2.numpy(), np.asarray(o_j2), atol=O_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kw", [dict(block_table=np.zeros((3, 2), np.int32)),
                                dict(cache_leftpad=np.zeros(3, np.int32)),
                                dict(attention_chunk=8)])
def test_decode_unsupported_options_raise(kw):
    c = CASES["sq1_g1"]
    q, kc, vc, _ = make_inputs(c)
    with pytest.raises(NotImplementedError):
        port_decode.decode_attn_bhsd(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.tensor(c["lens"], dtype=torch.int32), softmax_scale=0.1,
            **kw)
