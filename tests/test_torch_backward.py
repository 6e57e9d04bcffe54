"""The port's attention backward (`flash_attn_tpu_torch.kernels.flash_bwd`,
plain version on the CPU) and its autograd `Function`
(`flash_attn_tpu_torch.interface`) against the JAX package, on the same
seeded numpy inputs in float32.

* `flash_attn_bwd_bhsd` against the JAX `flash_attn_bwd_bhsd` (Pallas
  interpret mode), over the forward's cases (`test_torch_attention.CASES`),
  fed the same o and lse.  One case passes `dlse`; one runs the JAX side
  with `full_lengths=True` (its scheduled fused kernel).
* `flash_attn_func` gradients through `FlashAttnFunc` against `jax.grad` of
  the JAX `flash_attn_func`, in the (b, s, h, d) layout.
* `FlashAttnFunc` against autograd through the plain forward.

Tolerance: atol 5e-5 on dq (rows < seqused_q), dk and dv, whose entries are
of order 1.  Both sides compute in float32; the JAX kernel folds the scale
into q (one extra float32 rounding of q) and sums in other orders, which
moves gradients by a few 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.interface import flash_attn_func as jax_flash_attn_func
from flash_attn_tpu.kernels.flash_bwd import flash_attn_bwd_bhsd as jax_bwd
from flash_attn_tpu_torch.interface import (flash_attn_func,
                                            flash_attn_kvpacked_func,
                                            flash_attn_qkvpacked_func)
from flash_attn_tpu_torch.kernels import flash_bwd as port_bwd
from flash_attn_tpu_torch.kernels import flash_fwd as port_fwd
from test_torch_attention import CASES, kwargs, make_inputs, rows_valid

GRAD_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references here are tiny programs whose time is compiling,
    not running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny shapes run faster on one thread than with torch's threads
    contending with JAX's in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bwd_inputs(c, seed, with_dlse):
    """q, k, v, slopes; the plain forward's o and lse; dO (zero on rows past
    seqused_q, as the callers pass it) and optionally dlse."""
    q, k, v, slopes = make_inputs(c, seed)
    rng = np.random.default_rng(seed + 100)
    valid = rows_valid(c)
    o, lse = port_fwd.flash_attn_fwd_bhsd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        c["seqused_q"], c["seqused_k"], **kwargs(c, slopes, torch.from_numpy))
    do = (rng.standard_normal(o.shape) * valid[..., None]).astype(np.float32)
    dlse = None
    if with_dlse:
        dlse = (rng.standard_normal(lse.shape) * valid).astype(np.float32)
        dlse = np.where(np.isinf(lse.numpy()), 0.0, dlse).astype(np.float32)
    return q, k, v, slopes, o.numpy(), lse.numpy(), do, dlse


# causal_ragged also carries dlse; gqa (causal, full lengths) runs the JAX
# side with full_lengths=True, its scheduled fused kernel (table row 6).
BWD_CASES = [(name, name == "causal_ragged", name == "gqa") for name in CASES]


@pytest.mark.parametrize("name,with_dlse,full_lengths", BWD_CASES)
def test_bwd_matches_jax_kernel(name, with_dlse, full_lengths):
    c = CASES[name]
    q, k, v, slopes, o, lse, do, dlse = _bwd_inputs(c, 3, with_dlse)
    squ = np.asarray(c["seqused_q"], np.int32)
    sku = np.asarray(c["seqused_k"], np.int32)
    j = jnp.asarray
    ref = jax.jit(functools.partial(
        jax_bwd, full_lengths=full_lengths, **kwargs(c, slopes, j)))(
            j(do), j(q), j(k), j(v), j(o), j(lse), j(squ), j(sku),
            dlse=None if dlse is None else j(dlse))
    t = torch.from_numpy
    out = port_bwd.flash_attn_bwd_bhsd(
        t(do), t(q), t(k), t(v), t(o), t(lse), t(squ), t(sku),
        dlse=None if dlse is None else t(dlse), **kwargs(c, slopes, t))
    valid = np.broadcast_to(rows_valid(c)[..., None], q.shape)
    dq_j, dk_j, dv_j = (np.asarray(x) for x in ref)
    dq_t, dk_t, dv_t = (x.numpy() for x in out)
    np.testing.assert_allclose(dq_t[valid], dq_j[valid], atol=GRAD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(dk_t, dk_j, atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(dv_t, dv_j, atol=GRAD_ATOL, rtol=0)
    if name == "seqused_k_zero":
        assert not dq_t[1].any() and not dk_t[1].any() and not dv_t[1].any()
    for b, n in enumerate(c["seqused_k"]):  # keys past seqused_k
        assert not dk_t[b, :, n:].any() and not dv_t[b, :, n:].any()


FUNC_CASES = {
    "causal_gqa": dict(b=2, s=24, sk=24, h=4, hk=2, d=32, causal=True,
                       window=(-1, -1), softcap=0.0, probs=False),
    # GQA, sq < sk, bottom-right aligned window, softcap, and the lse's
    # gradient
    "window_softcap_lse": dict(b=2, s=16, sk=40, h=4, hk=2, d=32, causal=False,
                               window=(8, 4), softcap=20.0, probs=True),
}


def _func_inputs(c, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((c["b"], c["s"], c["h"], c["d"]), np.float32)
    k = rng.standard_normal((c["b"], c["sk"], c["hk"], c["d"]), np.float32)
    v = rng.standard_normal((c["b"], c["sk"], c["hk"], c["d"]), np.float32)
    do = rng.standard_normal(q.shape, np.float32)
    dlse = rng.standard_normal((c["b"], c["h"], c["s"]), np.float32)
    return q, k, v, do, dlse


@pytest.mark.parametrize("name", list(FUNC_CASES))
def test_flash_attn_func_grads_match_jax(name):
    c = FUNC_CASES[name]
    q, k, v, do, dlse = _func_inputs(c)
    kw = dict(causal=c["causal"], window_size=c["window"],
              softcap=c["softcap"], return_attn_probs=c["probs"])

    def jloss(q_, k_, v_):
        out = jax_flash_attn_func(q_, k_, v_, **kw)
        if not c["probs"]:
            return jnp.sum(out * do)
        o, lse, _ = out
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    grads_j = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attn_func(qt, kt, vt, **kw)
    if c["probs"]:
        o, lse, s_dmask = out
        assert s_dmask is None
        loss = (o * torch.from_numpy(do)).sum() + (
            lse * torch.from_numpy(dlse)).sum()
    else:
        loss = (out * torch.from_numpy(do)).sum()
    loss.backward()
    for t, g in zip((qt, kt, vt), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("probs", [False, True])
def test_function_matches_autograd_of_plain_forward(probs):
    """FlashAttnFunc's backward against autograd through
    `flash_attn_fwd_bhsd_ref`, in the (b, s, h, d) layout; GQA, causal,
    ALiBi.  Both sides float32: atol 1e-5."""
    c = dict(FUNC_CASES["causal_gqa"], probs=probs)
    q, k, v, do, dlse = _func_inputs(c, seed=6)
    slopes = torch.from_numpy(
        np.random.default_rng(7).uniform(0.05, 0.5, (c["b"], c["h"])).astype(
            np.float32))
    kw = dict(softmax_scale=c["d"] ** -0.5, causal=True, alibi_slopes=slopes)

    def loss_of(o, lse):
        loss = (o * torch.from_numpy(do)).sum()
        return loss + (lse * torch.from_numpy(dlse)).sum() if probs else loss

    grads = []
    for use_function in (True, False):
        qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        if use_function:
            out = flash_attn_func(qt, kt, vt, return_attn_probs=True, **kw)
            o, lse = out[0], out[1]
        else:
            full = [c["s"]] * c["b"]
            o, lse = port_fwd.flash_attn_fwd_bhsd_ref(
                qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
                full, full, **kw)
            o = o.transpose(1, 2)
        loss_of(o, lse).backward()
        grads.append([t.grad for t in (qt, kt, vt)])
    for g_func, g_ref in zip(*grads):
        torch.testing.assert_close(g_func, g_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(dropout_p=1.0),
                                dict(sinks=torch.zeros(4)),
                                dict(attention_chunk=8)])
def test_bwd_unsupported_options_raise(kw):
    """As `test_fwd_unsupported_options_raise`: dropout is ported, and a p
    outside [0, 1) raises ValueError."""
    q = torch.zeros(1, 4, 8, 32)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError if "dropout_p" in kw
                       else NotImplementedError):
        port_bwd.flash_attn_bwd_bhsd(q, q, q, q, q, lse, [8], [8],
                                     softmax_scale=0.1, **kw)


@pytest.mark.parametrize("kw", [
    dict(dropout_p=1.0), dict(qv=torch.zeros(1, 8, 4, 32)),
    dict(sinks=torch.zeros(4)), dict(q_descale=torch.ones(1, 4)),
    dict(attention_chunk=4)])
def test_flash_attn_func_unsupported_options_raise(kw):
    """Dropout is ported; a p outside [0, 1) raises ValueError."""
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError if "dropout_p" in kw
                       else NotImplementedError):
        flash_attn_func(q, q, q, **kw)


def test_packed_variants_match_flash_attn_func():
    rng = np.random.default_rng(8)
    qkv = torch.from_numpy(rng.standard_normal((2, 12, 3, 4, 32), np.float32))
    out = flash_attn_func(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                          causal=True)
    torch.testing.assert_close(flash_attn_qkvpacked_func(qkv, causal=True),
                               out, atol=0, rtol=0)
    torch.testing.assert_close(
        flash_attn_kvpacked_func(qkv[:, :, 0], qkv[:, :, 1:], causal=True),
        out, atol=0, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bwd_stats_layout(seed):
    """The rows the CUDA dQ kernel writes for the dK/dV kernel (lse in log2
    units, then delta, `kernels.flash_bwd.stats_rows` / `varlen_stats_rows`,
    `stats_row0`): each sequence's 128-row tiles stay inside the head's
    allocation and clear of the next sequence's rows, and every 64-row
    stage starts 16-byte aligned, for seeded packed lengths of 0-600 tokens
    (and the dense rule at the same lengths)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 601, size=int(rng.integers(1, 40))).tolist()
    cu = np.concatenate([[0], np.cumsum(lens)]).tolist()
    total = cu[-1] + int(rng.integers(0, 5))  # rows past the last sequence
    rows = port_bwd.varlen_stats_rows(len(lens), total)
    assert rows % 4 == 0
    end = 0
    for i, n in enumerate(lens):
        start = port_bwd.stats_row0(cu[i], i)
        assert start % 4 == 0 and start >= end
        tiles = -(-n // port_bwd.STATS_TILE) * port_bwd.STATS_TILE
        end = start + tiles
        assert end <= rows
    for n in lens + [1, 127, 128, 129]:
        dense = port_bwd.stats_rows(n)
        assert dense % port_bwd.STATS_TILE == 0 and n <= dense < n + 128


@pytest.mark.parametrize("d,q_tiles,heads,b,want", [
    (64, 8, 12, 8, 2),    # GPT-2 small's training shape: 768 blocks
    (64, 8, 12, 3, 1),    # 288 blocks: half would not fill 132 SMs twice
    (64, 4, 12, 11, 2),   # 528 blocks: exactly 4 an SM
    (64, 4, 12, 10, 1),   # 480 blocks: fewer
    (128, 16, 32, 2, 1),  # d = 128: one set of Q, dO, O fits
])
def test_dq_items_rule(d, q_tiles, heads, b, want):
    """`kernels.flash_bwd.dq_items`, the q tiles each CUDA dQ block owns,
    on the H100's 132 SMs: two at d = 64 where the one-tile grid holds at
    least 4 blocks an SM."""
    assert port_bwd.dq_items(d, q_tiles, heads, b, 132) == want
