"""The port's prefill attention (`flash_attn_tpu_torch.kernels.flash_fwd`,
plain version on the CPU) against the JAX package's `flash_attn_fwd_bhsd`
(Pallas interpret mode) and JAX `attention_ref`, on the same seeded numpy
inputs in float32.

Tolerance: o atol 2e-5 and lse atol 1e-5, on rows < seqused_q (the JAX
kernel leaves rows past seqused_q unmasked).  Both sides compute in float32
and differ only in summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.flash_fwd import flash_attn_fwd_bhsd as jax_fwd
from flash_attn_tpu.utils import testing as jax_testing
from flash_attn_tpu_torch.kernels import flash_fwd as port_fwd
from flash_attn_tpu_torch.utils import testing as port_testing

O_ATOL, LSE_ATOL = 2e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references here are tiny programs whose time is compiling,
    not running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny torch ops run faster on one thread than with torch's threads
    contending with JAX's (and other test processes') in one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "causal_ragged": dict(h=4, hk=4, d=32, sq=24, sk=64, seqused_q=[24, 17],
                          seqused_k=[64, 40], causal=True),
    "gqa": dict(h=4, hk=2, d=32, sq=24, sk=64, seqused_q=[24, 24],
                seqused_k=[64, 64], causal=True),
    "window_8_0": dict(h=4, hk=2, d=32, sq=24, sk=64, seqused_q=[24, 20],
                       seqused_k=[64, 50], window=(8, 0)),
    "window_one_sided": dict(h=4, hk=4, d=32, sq=24, sk=64,
                             seqused_q=[24, 24], seqused_k=[64, 64],
                             window=(8, -1)),
    "softcap": dict(h=4, hk=4, d=32, sq=24, sk=64, seqused_q=[24, 19],
                    seqused_k=[64, 33], causal=True, softcap=30.0),
    "alibi": dict(h=4, hk=2, d=32, sq=24, sk=64, seqused_q=[24, 24],
                  seqused_k=[64, 57], causal=True, alibi=True),
    "seqused_k_zero": dict(h=4, hk=4, d=32, sq=24, sk=64, seqused_q=[24, 24],
                           seqused_k=[64, 0], causal=True),
    # offset = seqused_k - seqused_q < 0: the first causal rows see no key
    "seqused_k_lt_q": dict(h=4, hk=4, d=32, sq=24, sk=64, seqused_q=[24, 22],
                           seqused_k=[64, 10], causal=True),
    "d64": dict(h=4, hk=2, d=64, sq=24, sk=64, seqused_q=[21, 24],
                seqused_k=[64, 48], causal=True),
    # the masks and mods whose plain version the CUDA kernel is held
    # against on the card: checked against the JAX kernel only
    "causal_window_8_m1": dict(h=4, hk=4, d=32, sq=24, sk=64,
                               seqused_q=[24, 20], seqused_k=[64, 50],
                               causal=True, window=(8, -1), kernel_only=True),
    "causal_window_8_4": dict(h=4, hk=2, d=32, sq=24, sk=64,
                              seqused_q=[24, 24], seqused_k=[64, 37],
                              causal=True, window=(8, 4), kernel_only=True),
    "window_right_4": dict(h=4, hk=4, d=32, sq=24, sk=64, seqused_q=[24, 18],
                           seqused_k=[64, 64], window=(-1, 4),
                           kernel_only=True),
    # sq > sk: the first rows of a causal call see no key
    "sq_gt_sk_causal": dict(h=4, hk=4, d=32, sq=40, sk=24,
                            seqused_q=[40, 33], seqused_k=[24, 24],
                            causal=True, kernel_only=True),
    "softcap_alibi": dict(h=4, hk=2, d=32, sq=24, sk=64, seqused_q=[24, 24],
                          seqused_k=[64, 45], causal=True, softcap=30.0,
                          alibi=True, kernel_only=True),
    "window_0_0": dict(h=4, hk=4, d=32, sq=24, sk=64, seqused_q=[24, 24],
                       seqused_k=[64, 30], window=(0, 0), kernel_only=True),
}
# the cases also held to JAX's attention_ref
ORACLE_CASES = [name for name, c in CASES.items() if not c.get("kernel_only")]


def make_inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    b = len(c["seqused_q"])
    q = rng.standard_normal((b, c["h"], c["sq"], c["d"])).astype(np.float32)
    k = rng.standard_normal((b, c["hk"], c["sk"], c["d"])).astype(np.float32)
    v = rng.standard_normal((b, c["hk"], c["sk"], c["d"])).astype(np.float32)
    slopes = (rng.uniform(0.05, 0.5, (b, c["h"])).astype(np.float32)
              if c.get("alibi") else None)
    return q, k, v, slopes


def kwargs(c, slopes, lib):
    return dict(softmax_scale=c["d"] ** -0.5, causal=c.get("causal", False),
                window_size=c.get("window", (-1, -1)),
                softcap=c.get("softcap", 0.0),
                alibi_slopes=None if slopes is None else lib(slopes))


def rows_valid(c):
    sq = c["sq"]
    return np.arange(sq)[None, None, :] < np.asarray(c["seqused_q"])[:, None,
                                                                      None]


@pytest.mark.parametrize("name", list(CASES))
def test_fwd_matches_jax_kernel(name):
    c = CASES[name]
    q, k, v, slopes = make_inputs(c)
    squ = np.asarray(c["seqused_q"], np.int32)
    sku = np.asarray(c["seqused_k"], np.int32)
    kw = kwargs(c, slopes, jnp.asarray)
    slopes_j = kw.pop("alibi_slopes")
    o_j, lse_j = jax.jit(functools.partial(jax_fwd, **kw))(
        q, k, v, squ, sku, alibi_slopes=slopes_j)
    o_t, lse_t = port_fwd.flash_attn_fwd_bhsd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(squ), torch.from_numpy(sku),
        **kwargs(c, slopes, torch.from_numpy))
    valid = np.broadcast_to(rows_valid(c), lse_t.shape)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    o_t, lse_t = o_t.numpy(), lse_t.numpy()
    np.testing.assert_allclose(o_t[valid], o_j[valid], atol=O_ATOL, rtol=0)
    assert np.array_equal(np.isinf(lse_t[valid]), np.isinf(lse_j[valid]))
    fin = valid & np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], atol=LSE_ATOL, rtol=0)
    if name == "seqused_k_zero":
        assert np.all(o_t[1] == 0.0) and np.all(np.isposinf(lse_t[1]))
    if name in ("seqused_k_lt_q", "sq_gt_sk_causal"):
        empty = c["seqused_q"][1] - c["seqused_k"][1]
        assert np.all(o_t[1, :, :empty] == 0.0)
        assert np.all(np.isposinf(lse_t[1, :, :empty]))
        assert np.all(np.isfinite(lse_t[1, :, empty:c["seqused_q"][1]]))


def _jax_oracle(c, q, k, v, slopes):
    """JAX attention_ref in its (b, s, h, d) layout, with padding masks for
    the ragged lengths."""
    qpm = jnp.asarray(np.arange(c["sq"])[None] < np.asarray(
        c["seqused_q"])[:, None])
    kpm = jnp.asarray(np.arange(c["sk"])[None] < np.asarray(
        c["seqused_k"])[:, None])
    bias = None
    if slopes is not None:
        bias = jax_testing.attn_bias_from_alibi_slopes(
            jnp.asarray(slopes), c["sq"], c["sk"], qpm, kpm, causal=False)
    out, _ = jax_testing.attention_ref(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), query_padding_mask=qpm,
        key_padding_mask=kpm, attn_bias=bias, causal=c.get("causal", False),
        window_size=c.get("window", (-1, -1)), softcap=c.get("softcap", 0.0),
        softmax_scale=c["d"] ** -0.5)
    return np.asarray(out).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_fwd_matches_jax_oracle(name):
    c = CASES[name]
    q, k, v, slopes = make_inputs(c, seed=1)
    o_t, _ = port_fwd.flash_attn_fwd_bhsd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(c["seqused_q"], dtype=torch.int32),
        torch.tensor(c["seqused_k"], dtype=torch.int32),
        **kwargs(c, slopes, torch.from_numpy))
    ref = _jax_oracle(c, q, k, v, slopes)
    valid = np.broadcast_to(rows_valid(c)[..., None], ref.shape)
    np.testing.assert_allclose(o_t.numpy()[valid], ref[valid], atol=O_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["causal_ragged", "window_8_0", "alibi",
                                  "seqused_k_zero"])
def test_port_oracle_matches_jax_oracle(name):
    """The port's own `attention_ref` (used by the plain versions' checks)
    against its JAX twin."""
    c = CASES[name]
    q, k, v, slopes = make_inputs(c, seed=2)
    qpm = torch.arange(c["sq"])[None] < torch.tensor(c["seqused_q"])[:, None]
    kpm = torch.arange(c["sk"])[None] < torch.tensor(c["seqused_k"])[:, None]
    bias = None
    if slopes is not None:
        bias = port_testing.attn_bias_from_alibi_slopes(
            torch.from_numpy(slopes), c["sq"], c["sk"], qpm, kpm)
    out, _ = port_testing.attention_ref(
        torch.from_numpy(q.transpose(0, 2, 1, 3)),
        torch.from_numpy(k.transpose(0, 2, 1, 3)),
        torch.from_numpy(v.transpose(0, 2, 1, 3)), query_padding_mask=qpm,
        key_padding_mask=kpm, attn_bias=bias, causal=c.get("causal", False),
        window_size=c.get("window", (-1, -1)), softmax_scale=c["d"] ** -0.5)
    ref = _jax_oracle(c, q, k, v, slopes)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1, 3), ref,
                               atol=O_ATOL, rtol=0)


def test_check_close_rule():
    ref = torch.zeros(4)
    pt = torch.full((4,), 1e-3)
    assert port_testing.check_close(torch.full((4,), 2e-3), ref, pt)[0] == \
        pytest.approx(2e-3)
    with pytest.raises(AssertionError):
        port_testing.check_close(torch.full((4,), 3e-3), ref, pt)


@pytest.mark.parametrize("kw", [dict(dropout_p=1.0), dict(sinks=torch.zeros(4)),
                                dict(attention_chunk=8)])
def test_fwd_unsupported_options_raise(kw):
    """Options not ported raise NotImplementedError; dropout is ported
    (`tests/test_torch_dropout.py`), and a p outside [0, 1) raises
    ValueError, as in JAX."""
    c = CASES["gqa"]
    q, k, v, _ = make_inputs(c)
    with pytest.raises(ValueError if "dropout_p" in kw
                       else NotImplementedError):
        port_fwd.flash_attn_fwd_bhsd(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            [24, 24], [64, 64], softmax_scale=0.1, **kw)

