"""The port's KV-cache API against the JAX package on the same seeded numpy
inputs: `flash_attn_with_kvcache` (rotary, append, paged and fused caches,
cache_batch_idx, cache_leftpad, int8/fp8 caches with quantise-on-append,
splits, sinks, qv), `flash_attn_varlen_func(block_table=)` (paged chunked
prefill), `flash_attn_combine`, `get_scheduler_metadata`, `fuse_kv_cache` /
`split_kv_cache`, and `layers/rotary`.  JAX runs its Pallas kernels in
interpret mode; the port runs the plain versions (CPU tensors).

Tolerance: float32 on both sides, o atol 2e-5, lse atol 1e-5 (summation
order only), +inf lse on the same rows; appended cache rows equal (atol
1e-6 after rotary, bit for bit when quantised).  The int8 cases are held to
the same bound: the plain version walks the JAX kernel's tiles, its integer
products are exact, and no probability of these inputs falls on a rounding
tie of round(127 p).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flash_attn_tpu import interface as jfa
from flash_attn_tpu.layers import rotary as jax_rotary
from flash_attn_tpu_torch import interface as port
from flash_attn_tpu_torch.kernels import flash_decode as port_decode
from flash_attn_tpu_torch.layers import rotary as port_rotary

O_ATOL, LSE_ATOL = 2e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references here are tiny programs whose time is compiling,
    not running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def one_page_a_step(monkeypatch):
    """The JAX paged kernel bundles pages into grid steps of 1024 cache rows
    (`flash_decode.py:816`): 64 pages of 16 rows, each traced apart, which
    costs tens of seconds of interpret-mode tracing.  One page a step gives
    the same result (the bundle moves only split boundaries, and every
    paged case here runs one split)."""
    monkeypatch.setenv("FLASH_ATTN_TPU_BUNDLE_ROWS", "16")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny shapes run faster on one thread than with torch's threads
    contending with JAX's in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(a):
    """numpy (float8 from ml_dtypes included) -> torch, same bits."""
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def to_numpy(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def assert_attention_close(o_t, lse_t, o_j, lse_j):
    o_j, lse_j = np.asarray(o_j, np.float32), np.asarray(lse_j)
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=O_ATOL, rtol=0)
    lse_t = lse_t.numpy()
    assert np.array_equal(np.isposinf(lse_t), np.isposinf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], atol=LSE_ATOL, rtol=0)


BASE = dict(b=3, h=4, hk=2, d=32, sq=1, smax=40, page=16, pps=4, snew=0,
            causal=True, lens=None)

CASES = {
    "sq1_causal": dict(),
    "sq1_noncausal": dict(causal=False),
    "sq4_causal": dict(sq=4, lens=[40, 2, 23]),
    "sq4_noncausal": dict(sq=4, causal=False),
    "append": dict(sq=3, snew=3),
    "window_chunk_softcap_alibi_gqa": dict(sq=4, window=(9, 0), chunk=16,
                                           softcap=20.0, alibi=True),
    "paged_shuffled": dict(paged=True, snew=1),
    "rotary": dict(rotary="plain", snew=1),
    "fused": dict(paged=True, fused=True, sq=2, snew=2),
    "rotary_interleaved_paged": dict(rotary="interleaved", sq=2, snew=2,
                                     paged=True),
    "batch_idx_leftpad_empty": dict(sq=2, snew=1, cbi=[3, 0, 1],
                                    leftpad=[5, 0, 3], lens=[30, 0, 25]),
    # num_splits = 0 ("auto") is one split on CPU tensors, as in JAX; an
    # int8 result depends on the splits (each restarts the quantisation)
    "int8_paged_append": dict(cache="int8", paged=True, snew=1, sq=2,
                              num_splits=0),
    "int8_contiguous": dict(cache="int8", sq=4, window=(20, 0)),
    "fp8_append": dict(cache="fp8", snew=1),
    "splits3": dict(smax=2304, num_splits=3, lens=[2304, 1500, 700]),
    "sinks_splits": dict(sinks=True, smax=2304, num_splits=3,
                         lens=[2304, 0, 900]),
    "qv": dict(qv=True, sq=2),
    "qv_int8_fused": dict(qv=True, cache="int8", paged=True, fused=True,
                          snew=1),
}


def make_case(c, seed=0):
    """numpy inputs and keyword arguments of one flash_attn_with_kvcache
    call (caches already quantised for int8 / fp8)."""
    rng = np.random.default_rng(seed)
    b, h, hk, d, sq, snew = c["b"], c["h"], c["hk"], c["d"], c["sq"], c["snew"]
    paged = c.get("paged", False)
    cap = c["page"] * c["pps"] if paged else c["smax"]
    lens = c["lens"]
    if lens is None:
        lens = rng.integers(sq, cap - snew + 1, b).tolist()
    arrays = dict(q=rng.standard_normal((b, sq, h, d)).astype(np.float32))
    kw = dict(causal=c["causal"], cache_seqlens=np.asarray(lens, np.int32),
              window_size=c.get("window", (-1, -1)),
              attention_chunk=c.get("chunk", 0),
              softcap=c.get("softcap", 0.0),
              num_splits=c.get("num_splits", 0))
    if paged:
        npages = b * c["pps"] + 2
        shape = (npages, c["page"], hk, d)
        kw["block_table"] = rng.permutation(npages)[:b * c["pps"]].reshape(
            b, c["pps"]).astype(np.int32)
    else:
        shape = (4 if "cbi" in c else b, cap, hk, d)
    quant = c.get("cache")
    if quant == "int8":
        kc = rng.integers(-127, 128, shape).astype(np.int8)
        vc = rng.integers(-127, 128, shape).astype(np.int8)
    elif quant == "fp8":
        kc = np.clip(rng.standard_normal(shape) * 60, -440, 440).astype(
            ml_dtypes.float8_e4m3fn)
        vc = np.clip(rng.standard_normal(shape) * 60, -440, 440).astype(
            ml_dtypes.float8_e4m3fn)
    else:
        kc = rng.standard_normal(shape).astype(np.float32)
        vc = rng.standard_normal(shape).astype(np.float32)
    if quant:
        kw["k_descale"] = rng.uniform(0.01, 0.02, (b, hk)).astype(np.float32)
        kw["v_descale"] = rng.uniform(0.01, 0.02, (b, hk)).astype(np.float32)
    if c.get("fused"):
        arrays["k_cache"] = np.stack([kc, vc], axis=1)
        arrays["v_cache"] = None
    else:
        arrays["k_cache"], arrays["v_cache"] = kc, vc
    if snew:
        # within e4m3's range (448) once divided by the descales: JAX and
        # torch both give NaN past it
        amp = 0.5 if quant else 1.0
        for name in ("k", "v"):
            arrays[name] = (amp * rng.standard_normal((b, snew, hk, d))
                            ).astype(np.float32)
    if c.get("rotary"):
        rd = d if c["rotary"] == "plain" else d // 2
        inv = 1.0 / (10000 ** (np.arange(0, rd, 2) / rd))
        ang = np.outer(np.arange(cap), inv)
        arrays["rotary_cos"] = np.cos(ang).astype(np.float32)
        arrays["rotary_sin"] = np.sin(ang).astype(np.float32)
        kw["rotary_interleaved"] = c["rotary"] == "interleaved"
    if "cbi" in c:
        kw["cache_batch_idx"] = np.asarray(c["cbi"], np.int32)
    if "leftpad" in c:
        kw["cache_leftpad"] = np.asarray(c["leftpad"], np.int32)
    if c.get("alibi"):
        kw["alibi_slopes"] = rng.uniform(0.05, 0.5, (b, h)).astype(np.float32)
    if c.get("sinks"):
        kw["sinks"] = rng.standard_normal(h).astype(np.float32)
    if c.get("qv"):
        arrays["qv"] = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return arrays, kw


def call_both(arrays, kw):
    """(JAX results, port results) of flash_attn_with_kvcache with lse and
    the updated caches; the port's caches are its in-place updates.  The
    JAX call runs under `jax.jit` (a third of its eager time here)."""
    common = dict(return_softmax_lse=True, return_updated_cache=True)
    tensors = {k: v for k, v in {**arrays, **kw}.items()
               if isinstance(v, np.ndarray)}
    static = {k: v for k, v in {**arrays, **kw}.items() if k not in tensors}
    res_j = jax.jit(lambda t: jfa.flash_attn_with_kvcache(
        **t, **static, **common))(
            {k: jnp.asarray(v) for k, v in tensors.items()})
    targs = {k: to_torch(v) for k, v in tensors.items()}
    res_t = port.flash_attn_with_kvcache(**targs, **static, **common)
    if arrays["v_cache"] is not None:
        assert res_t[2][0] is targs["k_cache"]  # updated in place
    return res_j, res_t


@pytest.mark.parametrize("name", list(CASES))
def test_kvcache_matches_jax(name):
    c = {**BASE, **CASES[name]}
    arrays, kw = make_case(c)
    (o_j, lse_j, caches_j), (o_t, lse_t, caches_t) = call_both(arrays, kw)
    if arrays["v_cache"] is None:
        caches_j, caches_t = (caches_j,), (caches_t,)
    for cj, ct in zip(caches_j, caches_t):
        cj, ct = np.asarray(cj), to_numpy(ct)
        if c.get("cache"):
            assert np.array_equal(cj.view(np.uint8), ct.view(np.uint8))
        else:
            np.testing.assert_allclose(ct, cj, atol=1e-6, rtol=0)
    assert o_t.shape == o_j.shape and o_t.dtype == torch.float32
    assert_attention_close(o_t, lse_t, o_j, lse_j)
    if kw["num_splits"] == 0:  # the plain version's tiles: one split
        cache = to_torch(arrays["k_cache"])
        table = kw.get("block_table")
        assert port_decode.ref_layout_tiles(
            cache, None if arrays["v_cache"] is None else cache,
            None if table is None else torch.from_numpy(table), 0,
            None)[3] == 1
    if c["lens"] is not None and 0 in c["lens"] and not c["snew"]:
        i = c["lens"].index(0)
        assert torch.all(o_t[i] == 0)
        # an empty row has lse +inf, or the sink's logit with sinks
        want = (torch.from_numpy(kw["sinks"])[:, None] if c.get("sinks")
                else torch.inf)
        assert torch.all(lse_t[i] == want)


@pytest.mark.parametrize("causal,window,alibi,seqused", [
    (True, (-1, -1), False, False),
    (True, (12, 0), True, True),
])
def test_paged_varlen_prefill_matches_jax(causal, window, alibi, seqused):
    rng = np.random.default_rng(5)
    h, hk, d, page, pps = 4, 2, 32, 16, 4
    lens_k = np.asarray([40, 17, 64], np.int32)
    lens_q = np.asarray([5, 1, 8], np.int32)
    b = len(lens_k)
    npages = b * pps + 3
    table = rng.permutation(npages)[:b * pps].reshape(b, pps).astype(np.int32)
    kp = rng.standard_normal((npages, page, hk, d)).astype(np.float32)
    vp = rng.standard_normal((npages, page, hk, d)).astype(np.float32)
    q = rng.standard_normal((int(lens_q.sum()), h, d)).astype(np.float32)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    slopes = (rng.uniform(0.05, 0.5, (b, h)).astype(np.float32)
              if alibi else None)
    max_sq, max_sk = int(lens_q.max()), int(lens_k.max())

    def call(f, lib):
        return f(lib(q), lib(kp), lib(vp), lib(cu_q),
                 lib(cu_k if not seqused else cu_q), max_sq, max_sk,
                 causal=causal, window_size=window,
                 alibi_slopes=None if slopes is None else lib(slopes),
                 return_attn_probs=True, block_table=lib(table),
                 seqused_k=lib(lens_k) if seqused else None)

    # the JAX call under `jax.jit`, its arrays traced (eager, each op of
    # the interpret-mode kernel dispatches apart)
    o_j, lse_j, _ = jax.jit(lambda: call(jfa.flash_attn_varlen_func,
                                         jnp.asarray))()
    o_t, lse_t, none = call(port.flash_attn_varlen_func, torch.from_numpy)
    assert none is None and lse_t.shape == (b, h, max_sq)
    assert_attention_close(o_t, lse_t, o_j, lse_j)
    assert torch.all(torch.isposinf(lse_t[1, :, 1:]))  # padding rows


def test_varlen_unported_branches_raise():
    """Varlen dropout is the one branch left unported, on the packed and
    the padded route alike."""
    q = torch.zeros(6, 2, 32)
    cu = torch.tensor([0, 2, 6], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue 2b"):
        port.flash_attn_varlen_func(q, q, q, cu, cu, 4, 4, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="Queue 2b"):
        port.flash_attn_varlen_func(q, q, q, cu, cu, 4, 4, dropout_p=0.1,
                                    return_attn_probs=True)


@pytest.mark.parametrize("form", ["plain", "out_dtype", "out_buffer"])
def test_flash_attn_combine_matches_jax(form):
    rng = np.random.default_rng(7)
    o = rng.standard_normal((3, 2, 5, 4, 8)).astype(np.float32)
    lse = (rng.standard_normal((3, 2, 4, 5)) * 3).astype(np.float32)
    lse[rng.random(lse.shape) < 0.3] = np.inf
    lse[:, 0, 0, 0] = np.inf  # every split empty
    o[np.isinf(lse).transpose(0, 1, 3, 2)] = 0.0
    o_j, lse_j = jax.jit(jfa.flash_attn_combine)(o, lse)
    args = torch.from_numpy(o), torch.from_numpy(lse)
    o_t, lse_t = port.flash_attn_combine(*args)
    assert_attention_close(o_t, lse_t, o_j, lse_j)
    if form == "out_dtype":
        o_b, _ = port.flash_attn_combine(*args, out_dtype=torch.bfloat16)
        assert torch.equal(o_b, o_t.to(torch.bfloat16))
    elif form == "out_buffer":
        buf = torch.empty(2, 5, 4, 8)
        o_b, _ = port.flash_attn_combine(*args, out=buf)
        assert o_b is buf and torch.equal(buf, o_t)


@pytest.mark.parametrize("kw", [
    dict(batch_size=8, max_seqlen_q=1, max_seqlen_k=16384, num_heads_q=32,
         num_heads_kv=8, headdim=128),
    dict(batch_size=1, max_seqlen_q=1, max_seqlen_k=32768, num_heads_q=8,
         num_heads_kv=2, headdim=64, causal=True),
    dict(batch_size=1, max_seqlen_q=4, max_seqlen_k=32768, num_heads_q=8,
         num_heads_kv=2, headdim=128, cache_seqlens=[9000]),
    dict(batch_size=2, max_seqlen_q=300, max_seqlen_k=2000, num_heads_q=16,
         num_heads_kv=2, headdim=256, page_size=256, num_splits=3),
])
def test_get_scheduler_metadata_matches_jax(kw):
    assert port.get_scheduler_metadata(**kw) == jfa.get_scheduler_metadata(
        **kw)


def test_fuse_split_round_trip():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((5, 16, 2, 32)).astype(np.float32)
    v = rng.standard_normal((5, 16, 2, 32)).astype(np.float32)
    fused = port.fuse_kv_cache(torch.from_numpy(k), torch.from_numpy(v))
    assert np.array_equal(fused.numpy(), np.asarray(
        jfa.fuse_kv_cache(jnp.asarray(k), jnp.asarray(v))))
    k2, v2 = port.split_kv_cache(fused)
    assert np.array_equal(k2.numpy(), k) and np.array_equal(v2.numpy(), v)
    with pytest.raises(ValueError):
        port.fuse_kv_cache(torch.from_numpy(k), torch.from_numpy(v[:4]))


ROTARY_CASES = ["offset_int", "offset_tensor", "varlen", "interleaved_half",
                "xpos_qkv", "ntk_kv", "gqa_packed"]


@pytest.mark.parametrize("name", ROTARY_CASES)
def test_rotary_matches_jax(name):
    rng = np.random.default_rng(11)
    b, s, h, d = 2, 6, 3, 16
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    if name in ("xpos_qkv", "ntk_kv", "gqa_packed"):
        kwargs = dict(xpos_qkv=dict(scale_base=512),
                      ntk_kv=dict(interpolation_factor=2.0, base=500000.0),
                      gqa_packed=dict(interleaved=True))[name]
        rj = jax_rotary.RotaryEmbedding(d, **kwargs)
        rt = port_rotary.RotaryEmbedding(d, device="cpu", **kwargs)
        if name == "xpos_qkv":
            qkv = rng.standard_normal((b, s, 3, h, d)).astype(np.float32)
            args = dict(seqlen_offset=3)
            outs = (rj(jnp.asarray(qkv), **args),
                    rt(torch.from_numpy(qkv), **args))
        elif name == "ntk_kv":
            kv = rng.standard_normal((b, s, 2, 1, d)).astype(np.float32)
            outs = (rj(jnp.asarray(x), jnp.asarray(kv)),
                    rt(torch.from_numpy(x), torch.from_numpy(kv)))
        else:
            qkv = rng.standard_normal((b, s, 8, d)).astype(np.float32)
            outs = (rj(jnp.asarray(qkv), num_heads_q=4, max_seqlen=20),
                    rt(torch.from_numpy(qkv), num_heads_q=4, max_seqlen=20))
        js, ts = outs
        if isinstance(js, tuple):
            pairs = list(zip(js, ts))
        else:
            pairs = [(js, ts)]
        np.testing.assert_allclose(rt._cos.numpy(), np.asarray(rj._cos),
                                   rtol=0, atol=0)
        for j, t in pairs:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                       rtol=0)
        return
    rd = d // 2 if name == "interleaved_half" else d
    ang = np.outer(np.arange(32), 1.0 / (10000 ** (np.arange(0, rd, 2) / rd)))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    interleaved = name == "interleaved_half"
    kw = {}
    xs = x
    if name == "offset_int":
        kw["seqlen_offsets"] = 5
    elif name == "offset_tensor":
        kw["seqlen_offsets"] = np.asarray([3, 20], np.int32)
    elif name == "varlen":
        xs = x.reshape(b * s, h, d)
        kw["cu_seqlens"] = np.asarray([0, 4, 12], np.int32)
        kw["seqlen_offsets"] = np.asarray([2, 7], np.int32)

    def call(f, lib):
        return f(lib(xs), lib(cos), lib(sin), interleaved,
                 **{k: (v if isinstance(v, int) else lib(v))
                    for k, v in kw.items()})

    out_j = jax.jit(lambda: call(jax_rotary.apply_rotary_emb, jnp.asarray))()
    out_t = call(port_rotary.apply_rotary_emb, torch.from_numpy)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6,
                               rtol=0)
