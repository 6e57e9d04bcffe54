"""The port's programmable attention (`flash_attn_tpu_torch.kernels.flex`,
`kernels.varlen_packed`, `blocksparse`; plain versions on the CPU) against
the JAX package, on the same seeded numpy inputs.

* Exact: the eight tables of `create_block_mask` (causal, sliding window,
  document mask through aux, head-invariant), of `varlen_block_mask` and of
  `convert_blockmask`; `_segment_aux`; the partial-block bits against the
  JAX mask evaluated on those blocks.
* Against the JAX `flex_attention`, `flash_blocksparse_attn_func` and
  `flash_attn_varlen_packed_func` (Pallas kernels in interpret mode under
  `jax.jit`), within `check_close`: |port - oracle| <= 2 |JAX - oracle| +
  1e-5, where the oracle is a dense float64 attention with the mask
  materialised; outputs, lse and gradients (dbias included), in float32.
* Without JAX: an arbitrary score-mod callable against the oracle, the
  descriptors against their compiled-in formulas, the 16-bit position
  check.
"""

import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import blocksparse as jax_bs
from flash_attn_tpu.kernels import flex as jax_flex
from flash_attn_tpu.kernels import varlen_packed as jax_vp
from flash_attn_tpu_torch import blocksparse
from flash_attn_tpu_torch.diag import flex_ab
from flash_attn_tpu_torch.kernels import flex, varlen_packed
from flash_attn_tpu_torch.utils.testing import check_close


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


def t(x):
    return torch.from_numpy(np.array(x))


def jax_block_mask(mask_mod, b, h, sq, sk, q_aux=None, kv_aux=None, **kw):
    """The JAX `create_block_mask` under `jax.jit` (eager, each of its ops
    compiles on its own)."""
    aux = {} if q_aux is None else dict(q_aux=q_aux, kv_aux=kv_aux)
    return jax.jit(lambda a: jax_flex.create_block_mask(
        mask_mod, b, h, sq, sk, **kw, **a))(aux)


def port_mask(jbm):
    """The JAX `BlockMask` carried over through `BlockMask.from_numpy`."""
    return flex.BlockMask.from_numpy(
        jbm.block_q, jbm.block_k, jbm.q_len, jbm.kv_len, device="cpu",
        **{n: np.asarray(getattr(jbm, n)) for n in flex.TABLES})


def assert_same_tables(bm, jbm):
    assert (bm.block_q, bm.block_k, bm.q_len, bm.kv_len) == (
        jbm.block_q, jbm.block_k, jbm.q_len, jbm.kv_len)
    for n in flex.TABLES:
        np.testing.assert_array_equal(getattr(bm, n).numpy(),
                                      np.asarray(getattr(jbm, n)), err_msg=n)


def causal(b, h, q_idx, kv_idx):
    return q_idx >= kv_idx


def sliding(b, h, q_idx, kv_idx):
    return (q_idx >= kv_idx) & (q_idx - kv_idx <= 100)


def same_doc(b, h, q_idx, kv_idx, qa, ka):
    return qa == ka


def doc_ids(b, s, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.random((b, s)) < 0.02, axis=1).astype(np.int32)


# name: (mask_mod, b, h, q_len, kv_len, block_q, block_k, aux, invariant)
MASK_CASES = {
    "causal": (causal, 2, 3, 200, 264, 64, 128, False, False),
    "sliding": (sliding, 1, 2, 256, 256, 64, 64, False, False),
    "document_aux": (same_doc, 2, 2, 256, 256, 128, 64, True, False),
    "head_invariant": (sliding, 2, 4, 192, 320, 64, 64, False, True),
}


@pytest.mark.parametrize("name", list(MASK_CASES))
def test_create_block_mask_matches_jax(name):
    mod, b, h, sq, sk, bq, bk, aux, inv = MASK_CASES[name]
    kw = dict(block_q=bq, block_k=bk, head_invariant=inv)
    ids = doc_ids(b, max(sq, sk), 0) if aux else None
    jbm = jax_block_mask(
        mod, b, h, sq, sk, **kw,
        **(dict(q_aux=jnp.asarray(ids), kv_aux=jnp.asarray(ids)) if aux
           else {}))
    bm = flex.create_block_mask(
        mod, b, h, sq, sk, device="cpu", **kw,
        **(dict(q_aux=t(ids), kv_aux=t(ids)) if aux else {}))
    assert_same_tables(bm, jbm)
    assert bm.sparsity == pytest.approx(jbm.sparsity)


@pytest.mark.parametrize("name", ["causal", "document_aux", "head_invariant"])
def test_partial_bits_match_jax_mask(name):
    """The packed bits of every partial block against the JAX mask_mod on
    that block, with the JAX kernels' conventions: aux 0 past its end, keys
    at or past kv_len masked."""
    mod, b, h, sq, sk, bq, bk, aux, inv = MASK_CASES[name]
    ids = doc_ids(b, max(sq, sk), 0) if aux else None
    jaux = (jnp.asarray(ids), jnp.asarray(ids)) if aux else None
    jbm = jax_block_mask(
        mod, b, h, sq, sk, block_q=bq, block_k=bk, head_invariant=inv,
        **(dict(q_aux=jaux[0], kv_aux=jaux[1]) if aux else {}))
    bm = port_mask(jbm)
    bits = flex.partial_block_bits(bm, mod, *((t(ids), t(ids)) if aux
                                              else (None, None)), sk)
    hn = bm.kv_num.shape[1]
    sq_p, sk_p = bm.kv_num.shape[2] * bq, bm.q_num.shape[2] * bk
    qi = jnp.arange(sq_p, dtype=jnp.int32)[:, None]
    ki = jnp.arange(sk_p, dtype=jnp.int32)[None, :]
    dense = np.zeros((b, hn, sq_p, sk_p), bool)
    for bb in range(b):
        for hh in range(hn):
            args = (jnp.int32(bb), jnp.int32(hh), qi, ki)
            if aux:
                pad = [jnp.pad(a[bb], (0, n - a.shape[1]))
                       for a, n in zip(jaux, (sq_p, sk_p))]
                args += (pad[0][qi], pad[1][ki])
            dense[bb, hh] = np.asarray(jnp.broadcast_to(
                mod(*args) & (ki < sk), (sq_p, sk_p)))
    where = bits.slot.ge(0).nonzero().numpy()
    assert len(where) == bits.words.shape[0] > 0
    got = flex._unpack_bits(bits.words, bk).numpy()
    for p, (bb, hh, i, j) in enumerate(where):
        want = dense[bb, hh, i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
        np.testing.assert_array_equal(got[p], want, err_msg=f"slot {p}")


VARLEN_CASES = {
    "causal": ([40, 70, 0, 90], None, True, (-1, -1)),
    "window": ([100, 37, 123], None, False, (32, 8)),
    "cross_causal_window": ([30, 0, 90, 64], [50, 10, 70, 128], True,
                            (40, -1)),
}


@pytest.mark.parametrize("name", list(VARLEN_CASES))
def test_varlen_block_mask_and_aux_match_jax(name):
    lens_q, lens_k, is_causal, window = VARLEN_CASES[name]
    lens_k = lens_k or lens_q
    cu_q = np.cumsum([0] + lens_q).astype(np.int32)
    cu_k = np.cumsum([0] + lens_k).astype(np.int32)
    tq_p, tk_p = 320, 384
    kw = dict(causal=is_causal, window_size=window, block_q=64, block_k=128,
              nheads=3)

    def jax_side(cq, ck):
        return (jax_vp._segment_aux(cq, sum(lens_q), tq_p),
                jax_vp._segment_aux(ck, sum(lens_k), tk_p),
                jax_vp.varlen_block_mask(cq, ck, tq_p, tk_p, **kw))

    jaq, jak, jbm = jax.jit(jax_side)(jnp.asarray(cu_q), jnp.asarray(cu_k))
    for cu, total, total_p, want in ((cu_q, sum(lens_q), tq_p, jaq),
                                     (cu_k, sum(lens_k), tk_p, jak)):
        np.testing.assert_array_equal(
            varlen_packed._segment_aux(t(cu), total, total_p).numpy(),
            np.asarray(want))
    bm = varlen_packed.varlen_block_mask(t(cu_q), t(cu_k), tq_p, tk_p, **kw)
    assert_same_tables(bm, jbm)


@pytest.mark.parametrize("is_causal", [False, True])
@pytest.mark.parametrize("layout_dims", [2, 3])
def test_convert_blockmask_matches_jax(is_causal, layout_dims):
    rng = np.random.default_rng(3)
    h, q_len, kv_len = 2, 250, 300  # kv_len % block_k: a padded tail
    shape = (4, 5) if layout_dims == 2 else (h, 4, 5)
    layout = rng.random(shape) < 0.6
    kw = dict(block_q=64, block_k=64, causal=is_causal)
    jbm = jax_bs.convert_blockmask(jnp.asarray(layout), 2, h, q_len, kv_len,
                                   **kw)
    bm = blocksparse.convert_blockmask(t(layout), 2, h, q_len, kv_len, **kw)
    assert_same_tables(bm, jbm)


# ---------------------------------------------------------------------------
# Attention against JAX and the float64 oracle
# ---------------------------------------------------------------------------


def dense_oracle(q, k, v, keep, bias=None, score_fn=None, scale=None):
    """float64 attention: q (b, sq, h, d), k, v (b, sk, hk, d), keep (b|1,
    h|1, sq, sk) bool; bias added after scaling, then score_fn(s, h_idx,
    q_idx, kv_idx), then the mask.  Rows with no kept key give o = 0 and
    lse = +inf.  Differentiable (gradients stay finite on empty rows)."""
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    kd, vd = kd.repeat_interleave(g, 1), vd.repeat_interleave(g, 1)
    s = torch.matmul(qd, kd.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.double()
    if score_fn is not None:
        hi = torch.arange(h).view(1, h, 1, 1)
        qi = torch.arange(sq).view(1, 1, sq, 1)
        ki = torch.arange(k.shape[1]).view(1, 1, 1, -1)
        s = score_fn(s, hi, qi, ki)
    s = torch.where(keep, s, -math.inf)
    m = s.amax(-1, keepdim=True).detach()
    m = torch.where(torch.isinf(m), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, vd) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l == 0, math.inf, m + torch.log(l))[..., 0]
    return o.transpose(1, 2), lse


def inputs(b, sq, sk, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d),
                  (b, sq, h, d)))


def jax_flex_call(q, k, v, do, bias=None, grads=True, **kw):
    """o, lse and (with `grads`) the gradients of sum(o * do) of the JAX
    flex_attention, under jax.jit; the bias's gradient last when there is
    one."""
    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))

    def f(*a):
        extra = dict(attn_bias=a[3]) if bias is not None else {}
        return jax_flex.flex_attention(*a[:3], return_lse=True, **kw, **extra)

    def run(*a):
        if not grads:
            return f(*a)
        (o, lse), vjp = jax.vjp(f, *a)
        return (o, lse, *vjp((jnp.asarray(do), jnp.zeros_like(lse))))

    return [np.asarray(x) for x in jax.jit(run)(*args)]


def port_call(fn, tensors, do):
    """fn(*tensors) -> o (or (o, lse)); returns [o, lse or None, grads of
    sum(o * do) in the order of tensors]."""
    ins = [t(x).requires_grad_() for x in tensors]
    out = fn(*ins)
    o, lse = out if isinstance(out, tuple) else (out, None)
    grads = torch.autograd.grad(o, ins, t(do))
    return [o.detach(), None if lse is None else lse.detach(), *grads]


def oracle_call(tensors, do, fn):
    ins = [t(x).double().requires_grad_() for x in tensors]
    o, lse = fn(*ins)
    grads = torch.autograd.grad(o, ins, t(do).double())
    return [o.detach(), lse.detach(), *grads]


def check_all(port, ref, jx, names):
    """check_close(port, oracle, JAX) on each named result; lse on its
    finite rows, with +inf rows equal.  Results past the JAX ones (the
    gradients of a forward-only JAX call) are held to the oracle alone,
    within 2e-5 (entries of order 1; float32 against float64)."""
    for name, a, r in list(zip(names, port, ref))[len(jx):]:
        if a is not None:
            torch.testing.assert_close(a, r.float(), atol=2e-5, rtol=0,
                                       msg=name)
    for name, a, r, j in zip(names, port, ref, jx):
        if a is None:
            continue
        j = torch.from_numpy(np.asarray(j))
        if name == "lse":
            inf = torch.isinf(r)
            assert torch.equal(torch.isinf(a), inf), name
            assert torch.equal(torch.isinf(j), inf), f"JAX {name}"
            a, r, j = a[~inf], r[~inf], j[~inf]
        check_close(a, r.float(), j, label=name)


@pytest.fixture(scope="module")
def jax_results():
    """One JAX result per case, computed on first use."""
    return {}


def cached(cache, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


NAMES = ("o", "lse", "dq", "dk", "dv", "dbias")


def test_flex_causal_block_sparse_gqa(jax_results):
    b, s, h, hk, d = 2, 192, 4, 2, 64
    q, k, v, do = inputs(b, s, s, h, hk, d, 0)
    jbm = jax_block_mask(causal, b, h, s, s, block_q=64, block_k=64)
    assert jbm.sparsity < 0.7
    jx = cached(jax_results, "causal", lambda: jax_flex_call(
        q, k, v, do, mask_mod=causal, block_mask=jbm))
    bm = port_mask(jbm)
    port = port_call(lambda *a: flex.flex_attention(
        *a, mask_mod=causal, block_mask=bm, return_lse=True), (q, k, v), do)
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    ref = oracle_call((q, k, v), do, lambda *a: dense_oracle(*a, keep))
    check_all(port, ref, jx, NAMES)


def test_flex_document_mask_through_aux(jax_results):
    b, s, h, d = 2, 256, 2, 64
    q, k, v, do = inputs(b, s, s, h, h, d, 1)
    ids = doc_ids(b, s, 0)
    jids = jnp.asarray(ids)
    jbm = jax_block_mask(same_doc, b, h, s, s, block_q=128, block_k=128,
                         q_aux=jids, kv_aux=jids)
    jx = cached(jax_results, "doc", lambda: jax_flex_call(
        q, k, v, do, grads=False, mask_mod=same_doc, block_mask=jbm,
        q_aux=jids, kv_aux=jids))
    bm = flex.create_block_mask(same_doc, b, h, s, s, block_q=128,
                                block_k=128, q_aux=t(ids), kv_aux=t(ids),
                                device="cpu")
    assert_same_tables(bm, jbm)
    port = port_call(lambda *a: flex.flex_attention(
        *a, mask_mod=same_doc, block_mask=bm, q_aux=t(ids), kv_aux=t(ids),
        return_lse=True), (q, k, v), do)
    keep = (t(ids)[:, :, None] == t(ids)[:, None, :])[:, None]
    ref = oracle_call((q, k, v), do, lambda *a: dense_oracle(*a, keep))
    check_all(port, ref, jx, NAMES)


def test_flex_softcap_descriptor(jax_results):
    b, s, h, d, cap = 1, 192, 2, 64, 5.0
    q, k, v, do = inputs(b, s, s, h, h, d, 2)
    jx = cached(jax_results, "softcap", lambda: jax_flex_call(
        q, k, v, do, score_mod=lambda sc, *_: jnp.tanh(sc / cap) * cap,
        block_q=64, block_k=64))
    port = port_call(lambda *a: flex.flex_attention(
        *a, score_mod=flex.softcap(cap), block_q=64, block_k=64,
        return_lse=True), (q, k, v), do)
    keep = torch.ones(s, s, dtype=torch.bool)
    ref = oracle_call((q, k, v), do, lambda *a: dense_oracle(
        *a, keep, score_fn=lambda sc, *_: torch.tanh(sc / cap) * cap))
    check_all(port, ref, jx, NAMES)


def test_flex_relative_position_head_invariant_gqa(jax_results):
    b, s, h, hk, d = 1, 192, 4, 2, 64
    q, k, v, do = inputs(b, s, s, h, hk, d, 3)
    slopes = 0.01 * (np.arange(h) + 1)

    def jax_mod(sc, b_, h_, q_idx, kv_idx):
        return sc - 0.01 * (h_.astype(jnp.float32) + 1.0) * jnp.abs(
            q_idx - kv_idx)

    jx = cached(jax_results, "relpos", lambda: jax_flex_call(
        q, k, v, do, grads=False, mask_mod=causal, score_mod=jax_mod,
        block_q=64, block_k=64, head_invariant=True))
    port = port_call(lambda *a: flex.flex_attention(
        *a, mask_mod=causal, score_mod=flex.relative_position(slopes),
        block_q=64, block_k=64, head_invariant=True, return_lse=True),
        (q, k, v), do)
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    sl = torch.tensor(slopes).view(1, h, 1, 1)
    ref = oracle_call((q, k, v), do, lambda *a: dense_oracle(
        *a, keep, score_fn=lambda sc, hi, qi, ki: sc - sl * (qi - ki).abs()))
    check_all(port, ref, jx, NAMES)


@pytest.mark.parametrize("bias_shape", ["full", "broadcast"])
def test_flex_attn_bias_and_dbias(jax_results, bias_shape):
    """attn_bias with a bottom-right causal mask and block sparsity, sq != sk;
    dbias against the oracle's and JAX's, broadcast dims summed back."""
    b, sq, sk, h, d = 2, 128, 192, 2, 64
    q, k, v, do = inputs(b, sq, sk, h, h, d, 4)
    rng = np.random.default_rng(5)
    bias = (rng.standard_normal((b, h, sq, sk) if bias_shape == "full"
                                else (1, 1, sq, sk)) * 0.5).astype(np.float32)

    def cm(b_, h_, qi, ki):
        return qi >= ki - (sk - sq)

    jbm = jax_block_mask(cm, b, h, sq, sk, block_q=64, block_k=64)
    jx = cached(jax_results, f"bias_{bias_shape}", lambda: jax_flex_call(
        q, k, v, do, bias=bias, mask_mod=cm, block_mask=jbm))
    bm = port_mask(jbm)
    port = port_call(lambda qq, kk, vv, bb: flex.flex_attention(
        qq, kk, vv, mask_mod=cm, block_mask=bm, attn_bias=bb,
        return_lse=True), (q, k, v, bias), do)
    assert port[-1].shape == bias.shape
    keep = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :] - (sk - sq)
    ref = oracle_call((q, k, v, bias), do,
                      lambda qq, kk, vv, bb: dense_oracle(qq, kk, vv, keep,
                                                          bias=bb))
    check_all(port, ref, jx, NAMES)


def test_flex_ragged_lengths_empty_rows(jax_results):
    """sq != sk, neither a block multiple; rows before 40 keep no key: o = 0
    and lse = +inf there, and their gradients are 0."""
    b, sq, sk, h, d = 1, 100, 150, 2, 64
    q, k, v, do = inputs(b, sq, sk, h, h, d, 6)

    def late(b_, h_, qi, ki):
        return (qi >= 40) & (ki <= qi + 20)

    jbm = jax_block_mask(late, b, h, sq, sk, block_q=64, block_k=64)
    jx = cached(jax_results, "ragged", lambda: jax_flex_call(
        q, k, v, do, grads=False, mask_mod=late, block_mask=jbm))
    bm = port_mask(jbm)
    port = port_call(lambda *a: flex.flex_attention(
        *a, mask_mod=late, block_mask=bm, return_lse=True), (q, k, v), do)
    assert not port[0][:, :40].any()
    assert torch.isposinf(port[1][..., :40]).all()
    assert not port[2][:, :40].any()
    qi, ki = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    keep = (qi >= 40) & (ki <= qi + 20)
    ref = oracle_call((q, k, v), do, lambda *a: dense_oracle(*a, keep))
    check_all(port, ref, jx, NAMES)


@pytest.mark.parametrize("is_causal", [False, True])
def test_blocksparse_matches_jax(jax_results, is_causal):
    b, s, h, d, blk = 1, 256, 2, 64, 64
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((b, s, 3, h, d)).astype(np.float32)
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    nb = s // blk
    layout = np.zeros((nb, nb), bool)
    for i in range(nb):
        layout[i, max(0, i - 1):i + 1] = True
        layout[i, 0] = True
    layout[0, 2] = True  # above the diagonal: masked out when causal

    jo = cached(jax_results, f"bs_{is_causal}", lambda: jax.jit(
        lambda x: jax_bs.flash_blocksparse_attn_func(
            x, jnp.asarray(layout), causal=is_causal, block_q=blk,
            block_k=blk))(jnp.asarray(qkv)))
    port = port_call(lambda x: blocksparse.flash_blocksparse_attn_func(
        x, t(layout), causal=is_causal, block_q=blk, block_k=blk), (qkv,),
        do)
    keep = torch.from_numpy(np.kron(layout, np.ones((blk, blk), bool)))
    if is_causal:
        keep &= torch.ones(s, s, dtype=torch.bool).tril()

    def ora(x):
        o, lse = dense_oracle(x[:, :, 0], x[:, :, 1], x[:, :, 2], keep)
        return o, lse

    ref = oracle_call((qkv,), do, ora)
    check_all([port[0]], [ref[0]], [jo], ("o",))
    # the gradient against the oracle's only: the JAX test of this function
    # checks its forward
    check_all(port[2:], ref[2:], [], ("dqkv",))
    mod = blocksparse.FlashBlocksparseAttention(blockmask=t(layout),
                                                block_q=blk, block_k=blk)
    assert torch.equal(mod(t(qkv), causal=is_causal), port[0])


def test_varlen_packed_causal_window_matches_jax(jax_results):
    lens, h, hk, d, window = [40, 70, 0, 90], 4, 2, 64, (32, 0)
    total = sum(lens)
    rng = np.random.default_rng(8)
    q, k, v, do = (rng.standard_normal((total, n, d)).astype(np.float32)
                   for n in (h, hk, hk, h))
    cu = np.cumsum([0] + lens).astype(np.int32)
    kw = dict(causal=True, window_size=window, block_q=64, block_k=64)

    def jrun(*a):
        o, vjp = jax.vjp(lambda *x: jax_vp.flash_attn_varlen_packed_func(
            *x, jnp.asarray(cu), jnp.asarray(cu), max(lens), max(lens), **kw),
            *a)
        return (o, *vjp(jnp.asarray(do)))

    jx = cached(jax_results, "varlen_packed", lambda: jax.jit(jrun)(
        *(jnp.asarray(x) for x in (q, k, v))))
    port = port_call(lambda *a: varlen_packed.flash_attn_varlen_packed_func(
        *a, t(cu), t(cu), max(lens), max(lens), **kw), (q, k, v), do)
    seg = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(total) - cu[seg]
    qi, ki = pos[:, None], pos[None, :]
    keep = t((seg[:, None] == seg[None, :]) & (ki <= qi) & (ki >= qi - 32))

    def ora(qq, kk, vv):
        o, lse = dense_oracle(qq[None], kk[None], vv[None], keep)
        return o[0], lse

    ref = oracle_call((q, k, v), do, ora)
    check_all([port[0], *port[2:]], [ref[0], *ref[2:]], jx,
              ("o", "dq", "dk", "dv"))


# ---------------------------------------------------------------------------
# Without JAX
# ---------------------------------------------------------------------------


def test_arbitrary_score_mod_matches_oracle():
    """Any callable score mod runs on the CPU, its gradient from autograd."""
    b, s, h, d = 1, 160, 2, 64
    q, k, v, do = inputs(b, s, s, h, h, d, 9)

    def smod(sc, b_, h_, q_idx, kv_idx):
        return sc + 0.5 * torch.sin(sc) * (h_ + 1) - 0.01 * (q_idx % 3)

    port = port_call(lambda *a: flex.flex_attention(
        *a, score_mod=smod, mask_mod=causal, block_q=64, block_k=64,
        return_lse=True), (q, k, v), do)
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    ref = oracle_call((q, k, v), do, lambda *a: dense_oracle(
        *a, keep, score_fn=lambda sc, hi, qi, ki: sc + 0.5 * torch.sin(sc)
        * (hi + 1) - 0.01 * (qi % 3)))
    check_all(port[:1] + port[2:], ref[:1] + ref[2:], [],
              ("o", "dq", "dk", "dv"))


@pytest.mark.parametrize("desc", ["softcap", "relative_position"])
def test_descriptor_callable_equals_compiled_form(desc):
    """A descriptor called as a torch mod gives the value and, by autograd,
    the derivative that the CUDA kernels compute in place
    (csrc/flex.cu::flex_score): tanh(s / cap) * cap with 1 - tanh^2, and
    s - slope[h] |q - k| with 1."""
    rng = np.random.default_rng(10)
    s = t(rng.standard_normal((2, 3, 8, 16)).astype(np.float32) * 40)
    hi = torch.arange(3, dtype=torch.int32).view(1, 3, 1, 1)
    qi = torch.arange(8, dtype=torch.int32).view(1, 1, 8, 1)
    ki = torch.arange(16, dtype=torch.int32).view(1, 1, 1, 16)
    bi = torch.zeros((), dtype=torch.int32)
    x = s.clone().requires_grad_()
    if desc == "softcap":
        mod = flex.softcap(30.0)
        th = torch.tanh(s / 30.0)
        want, dwant = th * 30.0, 1 - th * th
    else:
        slopes = [0.5, 0.25, 0.125]
        mod = flex.relative_position(slopes)
        want = s - torch.tensor(slopes).view(1, 3, 1, 1) * (
            qi - ki).abs().float()
        dwant = torch.ones_like(s)
    y = mod(x, bi, hi, qi, ki)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    torch.testing.assert_close(y.detach(), want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dx, dwant, atol=1e-6, rtol=1e-6)


def test_varlen_packed_position_limit_raises():
    x = torch.zeros(8, 2, 64)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="up to 65535"):
        varlen_packed.flash_attn_varlen_packed_func(x, x, x, cu, cu, 70000, 8)
    long_cu = torch.tensor([0, 70000], dtype=torch.int32)
    with pytest.raises(ValueError, match="length-70000"):
        varlen_packed.flash_attn_varlen_packed_func(x, x, x, long_cu, cu)
    many = torch.arange(0x7FFF + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="32767"):
        varlen_packed.flash_attn_varlen_packed_func(x, x, x, many, many, 1, 1)


@pytest.mark.parametrize("block_q,block_k,tile", [
    (128, 64, (128, 64)), (64, 64, (64, 64)), (512, 512, (128, 128)),
    (192, 192, (64, 64)), (128, 128, (128, 128)), (64, 128, (64, 128)),
    (1024, 1024, (128, 128)), (320, 384, (64, 128)),
])
def test_fwd_tile_rule(block_q, block_k, tile):
    """The CUDA forward's instantiation for (block_q, block_k), the rule of
    `csrc/flex.cu::launch_fwd`: 128 q rows and 128 keys where the blocks
    are multiples of 128, else 64."""
    assert flex.fwd_tile(block_q, block_k) == tile


@pytest.mark.parametrize("block_q,block_k,tile", [
    (128, 64, (128, 64)), (64, 64, (64, 64)), (512, 512, (128, 128)),
    (192, 192, (64, 64)), (128, 128, (128, 128)), (64, 128, (64, 128)),
    (1024, 1024, (128, 128)), (320, 384, (64, 128)), (384, 320, (128, 64)),
])
def test_bwd_tile_rule(block_q, block_k, tile):
    """The CUDA backward's blocks for (block_q, block_k), the rule of
    `csrc/flex.cu::launch_dq` / `launch_dkv`: dQ 128 q rows and dK/dV 128
    keys where the blocks are multiples of 128, else 64."""
    assert flex.bwd_tile(block_q, block_k) == tile


@pytest.mark.parametrize("b,h,hk,s,block_q,block_k,inv", [
    (2, 4, 2, 300, 128, 64, False), (1, 8, 2, 640, 128, 128, True),
    (2, 4, 2, 500, 192, 192, True), (1, 4, 4, 1100, 512, 512, False),
])
def test_bwd_orders_heaviest_first(b, h, hk, s, block_q, block_k, inv):
    """`_bwd_orders` permutes each backward grid's linear block indices (x
    fastest) so that a block's work, the length of the lists it walks (the
    q lists of its kv block over its GQA group; its q block's kv list),
    never rises, ties in the grid's order."""
    bm = flex.create_block_mask(lambda b_, h_, qi, ki: qi >= ki, b, h, s, s,
                                block_q=block_q, block_k=block_k,
                                head_invariant=inv, device="cpu")
    order_dkv, order_dq = flex._bwd_orders(bm, b, h, hk)
    rows, keys = flex.bwd_tile(block_q, block_k)
    g = h // hk
    nq_, nk_ = bm.kv_num.shape[-1], bm.q_num.shape[-1]
    n_q = (bm.full_q_num + bm.q_num).expand(b, h, nk_)
    n_kv = (bm.full_kv_num + bm.kv_num).expand(b, h, nq_)
    grids = ((order_dkv, nk_ * (block_k // keys), hk, block_k // keys,
              lambda z, y, blk: int(n_q[z, y * g:(y + 1) * g, blk].sum())),
             (order_dq, nq_ * (block_q // rows), h, block_q // rows,
              lambda z, y, blk: int(n_kv[z, y, blk])))
    for order, gx, gy, sub, work in grids:
        assert order.dtype == torch.int32
        lin = order.tolist()
        assert sorted(lin) == list(range(gx * gy * b))
        w = [work(i // (gx * gy), i // gx % gy, i % gx // sub) for i in lin]
        assert all(a > c or (a == c and i < j) for a, c, i, j in
                   zip(w, w[1:], lin, lin[1:]))


@pytest.mark.parametrize("variant", list(flex_ab.VARIANTS))
def test_flex_ab_variant_edits_only_its_kernel(variant):
    """Each `diag/flex_ab.py` variant finds its anchor inside the kernel it
    names in `csrc/flex.cu` and changes nothing outside that kernel's
    text, so that no forward variant edits a backward kernel or back."""
    src = (Path(flex_ab.__file__).parents[2] / flex_ab.KERNEL_SOURCE
           ).read_text()
    out = flex_ab.edit_source(src, variant)
    assert out is not None and out != src
    kernel = flex_ab.VARIANTS[variant][0]
    start, end = flex_ab.kernel_span(src, kernel)
    start2, end2 = flex_ab.kernel_span(out, kernel)
    assert out[:start2] == src[:start] and out[end2:] == src[end:]


def test_kernel_ready_reads_strided_views_in_place():
    """q, k, v views of a packed qkv and head-transposed tensors are read in
    place; a broadcast (stride 0) or misaligned view is copied."""
    qkv = torch.zeros(2, 16, 3, 4, 64, dtype=torch.bfloat16)
    for x in (*qkv.unbind(2), torch.zeros(2, 4, 16, 64).transpose(1, 2)):
        assert flex._kernel_ready(x) is x
    wide = torch.zeros(2, 16, 1, 64).expand(2, 16, 4, 64)
    odd = torch.zeros(2, 16, 4, 68)[..., :64]
    for x in (wide, odd):
        y = flex._kernel_ready(x)
        assert y is not x and y.is_contiguous() and torch.equal(y, x)
