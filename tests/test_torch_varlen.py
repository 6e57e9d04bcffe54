"""The port's varlen attention (`flash_attn_tpu_torch.interface.
flash_attn_varlen_func` and its packed forms, `kernels.varlen`, plain
versions on the CPU) against the JAX package, on the same seeded numpy
inputs in float32.

* Packed route (b > 1): against the JAX `flash_attn_varlen_qkvpacked_func`
  and `..._kvpacked_func`, whose Pallas packed kernels (`varlen_sched.py`)
  run in interpret mode under `jax.jit`: non-causal MHA; causal GQA with an
  empty sequence and tokens past the last sequence; and one gradient case
  (the packed backward kernel).
* Features (window, softcap, ALiBi, cross lengths with an empty q and an
  empty k sequence, a one-sided window normalised to max_seqlen_k) and
  the padded route (one sequence; seqused_k), forward and gradients,
  against JAX's `attention_ref` one sequence at a time, as
  `tests/kernels/test_varlen_sched.py` checks the JAX kernel.
* The padded route's lse (`return_attn_probs`) and fp8 against the JAX
  function; the router; the argument checks.

Tolerances: 1e-5 on outputs and lse, 5e-5 on gradients (entries of order
1); both sides compute in float32 and differ only in summation order and
in where the scale is applied.  fp8 compares bf16 outputs: see its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import interface as jax_iface
from flash_attn_tpu.utils import testing as jax_testing
from flash_attn_tpu_torch import interface
from flash_attn_tpu_torch.kernels import varlen

O_ATOL = 1e-5
GRAD_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references are tiny programs whose time is compiling, not
    running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def packed(rng, lens, heads, d, extra=0):
    """(sum(lens) + extra, heads, d) float32 and cu_seqlens int32."""
    x = rng.standard_normal((sum(lens) + extra, heads, d)).astype(np.float32)
    return x, np.cumsum([0] + list(lens)).astype(np.int32)


def inputs(lens_q, lens_k, h, hk, d, seed, extra=0):
    rng = np.random.default_rng(seed)
    q, cu_q = packed(rng, lens_q, h, d, extra)
    k, cu_k = packed(rng, lens_k, hk, d, extra)
    v, _ = packed(rng, lens_k, hk, d, extra)
    return q, k, v, cu_q, cu_k


def t(x):
    return torch.from_numpy(np.asarray(x))


# name: (lens_q, lens_k, h, hk, causal, window, extra tokens, JAX function)
KERNEL_CASES = {
    "mha_qkvpacked": ([40, 17, 65, 23], None, 4, 4, False, (-1, -1), 0,
                      "qkvpacked"),
    "gqa_causal_empty_kvpacked": ([40, 0, 65, 23], None, 4, 2, True,
                                  (-1, -1), 3, "kvpacked"),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_packed_matches_jax_kernel(name):
    lens_q, lens_k, h, hk, causal, window, extra, form = KERNEL_CASES[name]
    lens_k = lens_k or lens_q
    q, k, v, cu_q, cu_k = inputs(lens_q, lens_k, h, hk, 64, 1, extra)
    mq, mk = max(lens_q), max(lens_k)
    kw = dict(causal=causal, window_size=window)
    if form == "qkvpacked":
        qkv = np.stack([q, k, v], axis=1)
        ref = jax.jit(lambda x: jax_iface.flash_attn_varlen_qkvpacked_func(
            x, jnp.asarray(cu_q), mq, **kw))(jnp.asarray(qkv))
        out = interface.flash_attn_varlen_qkvpacked_func(
            t(qkv), t(cu_q), mq, **kw)
    else:
        kv = np.stack([k, v], axis=1)
        ref = jax.jit(lambda a, b: jax_iface.flash_attn_varlen_kvpacked_func(
            a, b, jnp.asarray(cu_q), jnp.asarray(cu_k), mq, mk, **kw))(
                jnp.asarray(q), jnp.asarray(kv))
        out = interface.flash_attn_varlen_kvpacked_func(
            t(q), t(kv), t(cu_q), t(cu_k), mq, mk, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=O_ATOL,
                               rtol=0)
    if extra:  # tokens past the last sequence attend nothing
        assert not out[sum(lens_q):].any()


def test_packed_grad_matches_jax_kernel():
    """jax.grad through the JAX packed backward kernel against the port's
    FlashAttnVarlenFunc, causal GQA with an empty sequence."""
    lens = [40, 0, 65, 23]
    q, k, v, cu, _ = inputs(lens, lens, 4, 2, 64, 2)
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    m = max(lens)

    def loss(a, b, c):
        o = jax_iface.flash_attn_varlen_func(a, b, c, jnp.asarray(cu),
                                             jnp.asarray(cu), m, m,
                                             causal=True)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.jit(jax.grad(loss, (0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    o = interface.flash_attn_varlen_func(qt, kt, vt, t(cu), t(cu), m, m,
                                         causal=True)
    o.backward(t(do))
    for name, a, r in zip("qkv", (qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{name}")


def ref_per_seq(q, k, v, cu_q, cu_k, slopes=None, used_k=None, **kw):
    """JAX attention_ref (float32) over each sequence, on its first
    used_k[i] keys; empty sequences give no row or zero rows.  The ALiBi
    bias is the full |i + sk - sq - j| form, and causality comes from the
    mask, so the result is exact."""
    outs = []
    for i in range(len(cu_q) - 1):
        end_k = cu_k[i + 1] if used_k is None else cu_k[i] + used_k[i]
        qi = q[cu_q[i]:cu_q[i + 1]][None]
        ki = k[cu_k[i]:end_k][None]
        vi = v[cu_k[i]:end_k][None]
        if qi.shape[1] == 0:
            continue
        if ki.shape[1] == 0:
            outs.append(jnp.zeros_like(qi[0]))
            continue
        bias = None
        if slopes is not None:
            bias = jax_testing.attn_bias_from_alibi_slopes(
                slopes[None], qi.shape[1], ki.shape[1], causal=False)
        outs.append(jax_testing.attention_ref(qi, ki, vi, attn_bias=bias,
                                              **kw)[0][0])
    return jnp.concatenate(outs, axis=0)


# name: (lens_q, lens_k, causal, window, softcap, alibi, seqused_k); the
# "padded_" cases take the padded route (one sequence; seqused_k)
FEATURE_CASES = {
    "window": ([50, 31, 64], None, False, (12, 5), 0.0, False, None),
    "softcap_causal": ([50, 31, 64], None, True, (-1, -1), 20.0, False,
                       None),
    "alibi_causal": ([50, 31, 64], None, True, (-1, -1), 0.0, True, None),
    "cross_empty_causal": ([30, 0, 17, 9], [50, 12, 0, 40], True, (-1, -1),
                           0.0, False, None),
    # the open side of a one-sided window is max_seqlen_k (40), not each
    # sequence's length: sequence 0 (30 rows, 10 keys) sees keys it would
    # not with 10
    "cross_onesided_window": ([30, 5, 17], [10, 12, 40], False, (8, -1),
                              0.0, False, None),
    "padded_one_sequence": ([37], None, True, (-1, -1), 0.0, False, None),
    "padded_seqused_k_window": ([20, 33, 7], None, True, (16, 3), 0.0,
                                False, [15, 33, 0]),
}


@pytest.mark.parametrize("name", list(FEATURE_CASES))
def test_varlen_matches_reference(name):
    """Forward and gradients of both routes against attention_ref per
    sequence."""
    lens_q, lens_k, causal, window, softcap, alibi, used_k = \
        FEATURE_CASES[name]
    lens_k = lens_k or lens_q
    h, hk, d = 4, 2, 32
    q, k, v, cu_q, cu_k = inputs(lens_q, lens_k, h, hk, d, 4)
    rng = np.random.default_rng(5)
    slopes = rng.uniform(0.05, 0.5, h).astype(np.float32) if alibi else None
    do = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window_size=window, softcap=softcap)
    mq, mk = max(lens_q), max(lens_k)
    ref_kw = dict(kw)
    if window[0] >= 0 > window[1]:
        ref_kw["window_size"] = (window[0], mk)

    def loss(a, b, c):
        o = ref_per_seq(a, b, c, cu_q, cu_k,
                        None if slopes is None else jnp.asarray(slopes),
                        used_k, **ref_kw)
        return jnp.sum(o * jnp.asarray(do[:o.shape[0]])), o

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, (0, 1, 2),
                                                 has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    calls = varlen.launches_fwd
    o = interface.flash_attn_varlen_func(
        qt, kt, vt, t(cu_q), t(cu_k), mq, mk,
        alibi_slopes=None if slopes is None else t(slopes),
        seqused_k=None if used_k is None else torch.tensor(used_k), **kw)
    assert varlen.launches_fwd == calls  # the CPU runs the plain version
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref),
                               atol=O_ATOL, rtol=0)
    o.backward(t(do))
    for n, a, r in zip("qkv", (qt.grad, kt.grad, vt.grad), grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{n}")
    if name == "cross_empty_causal":
        assert not o[30:47].any()  # sequence 2 has no key
        # no query sees sequence 1's keys
        assert not kt.grad[50:62].any() and not vt.grad[50:62].any()


def test_packed_plain_lse_and_empty_rows():
    """The plain forward's lse is (h, total_q): +inf on rows with no key
    and on tokens past the last sequence, natural-log elsewhere."""
    lens_q, lens_k = [6, 4, 5], [8, 0, 3]
    q, k, v, cu_q, cu_k = inputs(lens_q, lens_k, 2, 2, 32, 6, extra=2)
    o, lse = varlen.varlen_attn_fwd(t(q), t(k), t(v), t(cu_q), t(cu_k),
                                    6, 8, softmax_scale=32 ** -0.5,
                                    causal=True)
    assert lse.shape == (2, q.shape[0])
    assert torch.isposinf(lse[:, 6:10]).all() and not o[6:10].any()
    assert torch.isposinf(lse[:, 15:]).all() and not o[15:].any()
    # causal with len_q > len_k (sequence 2): its first 2 rows see no key
    assert torch.isposinf(lse[:, 10:12]).all()
    assert torch.isfinite(lse[:, :6]).all() and torch.isfinite(lse[:, 12:15]).all()
    s = torch.einsum("thd,shd->hts", t(q[:6]), t(k[:8])) * 32 ** -0.5
    mask = torch.arange(8)[None, :] > torch.arange(6)[:, None] + 2
    ref = torch.logsumexp(s.masked_fill(mask, -torch.inf), -1)
    torch.testing.assert_close(lse[:, :6], ref, atol=O_ATOL, rtol=0)


def test_padded_route_lse_matches_jax():
    """`return_attn_probs` takes the padded route and returns the lse
    (b, h, max_seqlen_q), +inf past each sequence, as the JAX function
    (dense Pallas kernel) does."""
    lens = [20, 33, 7]
    q, k, v, cu, _ = inputs(lens, lens, 4, 2, 64, 7)
    m = max(lens)
    kw = dict(causal=True, return_attn_probs=True)
    out_j, lse_j, _ = jax.jit(lambda a, b, c: jax_iface.flash_attn_varlen_func(
        a, b, c, jnp.asarray(cu), jnp.asarray(cu), m, m, **kw))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse, none = interface.flash_attn_varlen_func(
        t(q), t(k), t(v), t(cu), t(cu), m, m, **kw)
    lse, lse_j = lse.numpy(), np.asarray(lse_j)
    assert none is None and lse.shape == (len(lens), 4, m)
    assert np.array_equal(np.isinf(lse), np.isinf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse[fin], lse_j[fin], atol=O_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=O_ATOL,
                               rtol=0)


# fp8: both sides dequantise q the same way and round it to bf16, then the
# JAX kernel accumulates in float32 while the port's plain version runs its
# products in bf16 and rounds p to bf16; outputs are bf16 of magnitude < 3,
# so they may differ by a few bf16 steps (2^-7 each near 1): atol 3e-2.
FP8_ATOL = 3e-2


def test_fp8_matches_jax():
    lens = [24, 40, 9]
    h, hk, d = 4, 2, 64
    q, k, v, cu, _ = inputs(lens, lens, h, hk, d, 10)
    rng = np.random.default_rng(11)
    ds = [rng.uniform(0.5, 1.5, (len(lens), hk)).astype(np.float32)
          for _ in range(3)]
    m = max(lens)
    q8, k8, v8 = (jnp.asarray(x, jnp.float8_e4m3fn) for x in (q, k, v))
    ref = jax.jit(lambda a, b, c: jax_iface.flash_attn_varlen_func(
        a, b, c, jnp.asarray(cu), jnp.asarray(cu), m, m, causal=True,
        q_descale=jnp.asarray(ds[0]), k_descale=jnp.asarray(ds[1]),
        v_descale=jnp.asarray(ds[2])))(q8, k8, v8)
    qt, kt, vt = (t(x).to(torch.float8_e4m3fn) for x in (q, k, v))
    out = interface.flash_attn_varlen_func(
        qt, kt, vt, t(cu), t(cu), m, m, causal=True, q_descale=t(ds[0]),
        k_descale=t(ds[1]), v_descale=t(ds[2]))
    assert out.dtype == torch.bfloat16 and not out.requires_grad
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=FP8_ATOL, rtol=0)


def test_router(monkeypatch):
    """The JAX router: b > 1 without seqused / return_attn_probs and with
    max lengths <= 65535 takes the packed route; everything else the
    padded one."""
    taken = []
    monkeypatch.setattr(interface, "flash_attn_varlen_sched_func",
                        lambda *a, **k: taken.append("packed"))
    monkeypatch.setattr(interface, "_varlen_padded",
                        lambda *a, **k: taken.append("padded"))
    q = torch.zeros(10, 2, 64)
    cu2, cu1 = torch.tensor([0, 4, 10]).int(), torch.tensor([0, 10]).int()
    f = interface.flash_attn_varlen_func
    f(q, q, q, cu2, cu2, 6, 6)
    f(q, q, q, cu1, cu1, 10, 10)
    f(q, q, q, cu2, cu2, 6, 6, return_attn_probs=True)
    f(q, q, q, cu2, cu2, 6, 6, seqused_q=torch.tensor([4, 6]))
    f(q, q, q, cu2, cu2, 6, 70000)
    assert taken == ["packed", "padded", "padded", "padded", "padded"]


def test_argument_checks():
    q = torch.zeros(10, 2, 64)
    cu = torch.tensor([0, 4, 10]).int()
    with pytest.raises(NotImplementedError):
        interface.flash_attn_varlen_func(q, q, q, cu, cu, 6, 6, dropout_p=0.1)
    with pytest.raises(ValueError):
        interface.flash_attn_varlen_func(q, q, q, cu, cu, 6, 6, dropout_p=1.0)
    with pytest.raises(ValueError, match="65535"):
        varlen.flash_attn_varlen_sched_func(q, q, q, cu, cu, 6, 70000)
    with pytest.raises(ValueError, match="required"):
        varlen.flash_attn_varlen_sched_func(q, q, q, cu, cu)


def test_same_stream_and_block_sizes_change_nothing():
    """Whether cu_seqlens_q is cu_seqlens_k (`same_stream`, the TPU's
    pruning) and the TPU block sizes do not change results; a one-sided
    window is normalised to max_seqlen_k, not to total_k."""
    q, k, v, cu, _ = inputs([9, 4, 13], [9, 4, 13], 2, 2, 64, 12)
    q, k, v, cu = t(q), t(k), t(v), t(cu)
    f = varlen.flash_attn_varlen_sched_func
    base = f(q, k, v, cu, cu, 13, 13, causal=True)
    assert torch.equal(base, f(q, k, v, cu, cu.clone(), 13, 13, causal=True,
                               block_q=128, block_k=256, block_h=2))
    assert torch.equal(f(q, k, v, cu, cu, 13, 13, window_size=(2, -1)),
                       f(q, k, v, cu, cu, 13, 13, window_size=(2, 13)))
