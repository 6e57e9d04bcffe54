"""The port's attention dropout against the JAX package's, on the CPU (the
plain versions of the kernels; the JAX Pallas kernels in interpret mode
under `jax.jit`), at tiny sizes, on the same seeded numpy inputs.

* `kernels.flash_fwd.dropout_keep` equals JAX's `dropout_keep` bit for bit
  over seeds {0, 1, -1, 2^31 - 1, -2^31}, batch indices up to 63, heads up
  to 127, rows and keys past 65535, and p in {0.1, 0.17, 0.5, 0.9} plus p
  values whose float32 rounding falls on a 2^-24 step (the threshold's
  integer compare).
* `flash_attn_func` forward and (dq, dk, dv) for causal GQA and for window +
  softcap + ALiBi, with `dropout_seed` None and a given seed; the packed
  and the padded route of `flash_attn_varlen_func`, forward and
  gradients; the debug `S_dmask` of `return_attn_probs`.
* The models with `deterministic=False`: GPT (2 layers, `attn_pdrop`),
  BERT (`unpad_varlen=True`, `attention_probs_dropout_prob`) and ViT
  (`attn_drop_rate`): logits and every parameter's gradient against the
  JAX models (no dropout RNG is needed in JAX when only the attention
  dropout is on); remat with dropout equal to no remat, bitwise; the
  `key_padding_mask` branch without dropout (quirk 10).
* The options that still refuse dropout.

Tolerances: 1e-4 absolute on outputs, lse and gradients of entries of
order 1 (float32 on both sides, which differ in summation order and where
the scale 1 / (1 - p) is applied), 1e-4 of each parameter gradient's
largest entry for the models.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import interface as jax_iface
from flash_attn_tpu.kernels.flash_fwd import dropout_keep as jax_keep
from flash_attn_tpu_torch import interface
from flash_attn_tpu_torch.kernels import flash_fwd

ATOL = 1e-4
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references are tiny programs whose time is compiling, not
    running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


# p whose float32 rounding lies on a 2^-24 step: 0.1's nearest step, and a
# p just above it that float32 rounds down onto it
STEP = 1677722 * 2.0 ** -24
P_VALUES = (0.1, 0.17, 0.5, 0.9, STEP, STEP + 1e-12)


@pytest.mark.parametrize("seed", [0, 1, -1, 2 ** 31 - 1, -2 ** 31])
def test_dropout_keep_matches_jax(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    rows = np.concatenate([np.arange(8), rng.integers(0, 70000, 24),
                           [65534, 65535, 65536, 69999]]).astype(np.int32)
    cols = np.concatenate([np.arange(8), rng.integers(0, 70000, 20),
                           [65535, 65536, 131071]]).astype(np.int32)
    bh = np.array([(0, 0), (1, 5), (63, 127), (17, 64)], np.int32)

    @jax.jit
    def ref(b, h, p_idx):
        return jnp.stack([
            jax_keep(jnp.int32(seed), b[:, None, None], h[:, None, None],
                     jnp.asarray(rows)[None, :, None],
                     jnp.asarray(cols)[None, None, :], p)
            for p in P_VALUES])[p_idx]

    for i, p in enumerate(P_VALUES):
        want = np.asarray(ref(jnp.asarray(bh[:, 0]), jnp.asarray(bh[:, 1]),
                              i))
        got = flash_fwd.dropout_keep(
            seed, t(bh[:, 0]).view(-1, 1, 1), t(bh[:, 1]).view(-1, 1, 1),
            t(rows).view(1, -1, 1), t(cols).view(1, 1, -1), p)
        assert torch.equal(got, t(want)), (seed, p)
    # the integer threshold is the float32 compare's: on a step, keep
    # exactly the hashes at or above it
    assert flash_fwd.dropout_threshold(STEP) == 1677722
    assert flash_fwd.dropout_threshold(STEP + 1e-12) == 1677722
    assert flash_fwd.dropout_threshold(0.0) == 0


def qkv(rng, b, s, h, hk, d):
    return [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, hk, hk)]


DENSE = {
    "causal_gqa": dict(b=2, s=40, h=2, hk=1, d=32, kw=dict(causal=True),
                       p=0.17),
    "window_softcap_alibi": dict(b=2, s=40, h=2, hk=2, d=32,
                                 kw=dict(window_size=(12, 3), softcap=5.0),
                                 alibi=True, p=0.3),
}


def dense_case(name):
    c = DENSE[name]
    rng = np.random.default_rng(len(name))
    q, k, v = qkv(rng, c["b"], c["s"], c["h"], c["hk"], c["d"])
    do = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(c["kw"])
    if c.get("alibi"):
        kw["alibi_slopes"] = rng.uniform(0.05, 0.5, (c["b"], c["h"])).astype(
            np.float32)
    return c, q, k, v, do, kw


_DENSE_REFS = {}


def dense_ref(name, p, kw):
    """JAX's o and (dq, dk, dv) of case `name`, jitted once for both seeds
    (the seed is traced)."""
    if name not in _DENSE_REFS:
        @jax.jit
        def ref(q, k, v, do, s):
            f = lambda q, k, v: jax_iface.flash_attn_func(  # noqa: E731
                q, k, v, dropout_p=p, dropout_seed=s, **kw)
            o, vjp = jax.vjp(f, q, k, v)
            return (o,) + vjp(do)

        _DENSE_REFS[name] = ref
    return _DENSE_REFS[name]


@pytest.mark.parametrize("seed", [None, 123457])
@pytest.mark.parametrize("name", list(DENSE))
def test_flash_attn_func_dropout_matches_jax(name, seed):
    """o and (dq, dk, dv) through `flash_attn_func`; the seed is traced
    into the JAX function (None is seed 0 on both sides)."""
    c, q, k, v, do, kw = dense_case(name)
    p = c["p"]
    want = dense_ref(name, p, kw)(q, k, v, do,
                                  jnp.int32(0 if seed is None else seed))
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    kw_t = {k_: (t(x) if isinstance(x, np.ndarray) else x)
            for k_, x in kw.items()}
    o = interface.flash_attn_func(*ins, dropout_p=p, dropout_seed=seed,
                                  **kw_t)
    o.backward(t(do))
    close(o.detach(), want[0])
    for x, w in zip(ins, want[1:]):
        close(x.grad, w)
    # the dropout did something: the output is not the undropped one
    o0 = interface.flash_attn_func(*[x.detach() for x in ins], **kw_t)
    assert (o0 - o.detach()).abs().max() > 1e-2


def test_s_dmask_matches_jax():
    """`return_attn_probs` with dropout: the debug S_dmask (kept P / (1 -
    p), dropped -P) equals JAX's `_attn_probs_dmask` on the same lse (the
    kernels' lse is held to JAX's above); `S_dmask >= 0` is the keep
    mask."""
    c, q, k, v, _, kw = dense_case("window_softcap_alibi")
    p, seed = c["p"], 99
    kw_t = {k_: (t(x) if isinstance(x, np.ndarray) else x)
            for k_, x in kw.items()}
    o, lse, dm = interface.flash_attn_func(t(q), t(k), t(v), dropout_p=p,
                                           dropout_seed=seed,
                                           return_attn_probs=True, **kw_t)
    dm_j = jax.jit(lambda q, k, lse: jax_iface._attn_probs_dmask(
        q, k, lse, softmax_scale=q.shape[-1] ** -0.5, causal=False,
        attention_chunk=0, dropout_p=p, dropout_seed=seed, **kw))(
            q, k, lse.detach().numpy())
    assert dm.shape == dm_j.shape
    close(dm, dm_j, atol=1e-5)
    b, s, h, _ = q.shape
    keep = flash_fwd.dropout_mask(seed, p, b, h, s, s, "cpu")
    # where P > 0, kept entries are positive and dropped ones negative
    live = dm != 0
    assert torch.equal((dm > 0)[live], keep[live])
    # without dropout there is no S_dmask, dense or varlen
    assert interface.flash_attn_func(t(q), t(k), t(v),
                                     return_attn_probs=True)[2] is None


def packed(rng, lens, h, hk, d):
    total = sum(lens)
    q, k, v = (rng.standard_normal((total, n, d)).astype(np.float32)
               for n in (h, hk, hk))
    return q, k, v, np.cumsum([0] + list(lens)).astype(np.int32)


@pytest.mark.parametrize("route", ["packed", "padded"])
def test_varlen_dropout_matches_jax(route):
    """The packed route hashes packed-stream coordinates (batch 0, token
    index), the padded one (taken here through seqused) each sequence's
    batch index and position: forward and gradients against JAX's router
    on each."""
    rng = np.random.default_rng(5)
    lens, h, hk, d, p, seed = [9, 21, 14], 2, 1, 32, 0.2, 31
    q, k, v, cu = packed(rng, lens, h, hk, d)
    do = rng.standard_normal(q.shape).astype(np.float32)
    extra = {}
    if route == "padded":
        extra = dict(seqused_q=np.asarray(lens, np.int32),
                     seqused_k=np.asarray(lens, np.int32))

    @jax.jit
    def ref(q, k, v, do):
        cu_j = jnp.asarray(cu)
        f = lambda q, k, v: jax_iface.flash_attn_varlen_func(  # noqa: E731
            q, k, v, cu_j, cu_j, max(lens), max(lens), dropout_p=p,
            causal=True, dropout_seed=seed, **extra)
        o, vjp = jax.vjp(f, q, k, v)
        return (o,) + vjp(do)

    want = ref(q, k, v, do)
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    o = interface.flash_attn_varlen_func(
        *ins, t(cu), t(cu), max(lens), max(lens), dropout_p=p, causal=True,
        dropout_seed=seed, **{k_: t(x) for k_, x in extra.items()})
    o.backward(t(do))
    close(o.detach(), want[0])
    for x, w in zip(ins, want[1:]):
        close(x.grad, w)


def test_varlen_routes_hash_their_own_coordinates():
    """The two routes drop different entries of the same call (packed
    coordinates against per-sequence ones) but the first sequence, which
    starts at token 0 in batch 0 on both; `return_attn_probs` gives no
    S_dmask on varlen, as in JAX."""
    rng = np.random.default_rng(6)
    lens = [12, 20]
    q, k, v, cu = (t(x) for x in packed(rng, lens, 2, 2, 32))
    kw = dict(dropout_p=0.3, dropout_seed=4)
    packed_o = interface.flash_attn_varlen_func(q, k, v, cu, cu, 20, 20, **kw)
    padded_o, _, dm = interface.flash_attn_varlen_func(
        q, k, v, cu, cu, 20, 20, return_attn_probs=True, **kw)
    assert dm is None
    assert torch.allclose(packed_o[:12], padded_o[:12], atol=1e-6)
    assert not torch.allclose(packed_o[12:], padded_o[12:], atol=1e-2)


# -- models ---------------------------------------------------------------


def random_tree(init, seed, *args):
    """A flax parameter tree on `jax.eval_shape(init)`'s shapes, from
    numpy: norm weights 1 + N(0, 0.1), other vectors N(0, 0.02), matrices
    and embeddings N(0, 0.05)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape)
        if leaf.ndim >= 2:
            x = 0.05 * x
        elif "weight" in name or "scale" in name:
            x = 1.0 + 0.1 * x
        else:
            x = 0.02 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_grads(model, ref_state):
    for name, prm in model.named_parameters():
        r = ref_state[name].numpy()
        g = torch.zeros_like(prm) if prm.grad is None else prm.grad
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_RTOL * max(np.abs(r).max(),
                                                        1e-6),
                                   err_msg=name)


GPT_TINY = dict(n_embd=128, n_head=2, n_layer=2, vocab_size=311,
                n_positions=64, attn_pdrop=0.15)


def gpt_pair():
    from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPT
    from flash_attn_tpu_torch.models.gpt import (GPTConfig, GPTLMHeadModel,
                                                 state_dict_from_jax_params)

    ids = np.random.default_rng(0).integers(0, 311, (2, 32)).astype(np.int32)
    cfg = GPTConfig(**GPT_TINY)
    jcfg = dataclasses.replace(cfg)
    jcfg.head_dim = cfg.n_embd // cfg.n_head
    jmodel = JaxGPT(jcfg, dtype=jnp.float32)
    init_cfg = dataclasses.replace(jcfg)
    init_cfg.head_dim, init_cfg.use_flash_attn = jcfg.head_dim, False
    params = random_tree(JaxGPT(init_cfg, dtype=jnp.float32).init, 0,
                         jnp.asarray(ids[:, :4]))
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params, cfg))
    return jmodel, params, port, ids, state_dict_from_jax_params


def test_gpt_attention_dropout_matches_jax():
    """Logits and every parameter's gradient of sum(logits * R) with
    `deterministic=False` (attn_pdrop 0.15: JAX's MHA passes no seed, so
    each layer draws seed 0's mask)."""
    jmodel, params, port, ids, to_state = gpt_pair()
    proj = np.random.default_rng(1).standard_normal(
        (2, 32, 311)).astype(np.float32)

    def loss(p):
        logits = jmodel.apply(p, ids, deterministic=False).logits
        return jnp.sum(logits * proj), logits

    (_, logits_j), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    logits = port(t(ids), deterministic=False).logits
    (logits * t(proj)).sum().backward()
    close(logits.detach(), logits_j)
    assert_grads(port, to_state(grads, port.config))
    with torch.no_grad():
        assert (port(t(ids)).logits - logits).abs().max() > 1e-3


def test_gpt_remat_with_dropout_is_bitwise_no_remat():
    """Remat's recompute redraws the same keep mask (a hash of position,
    no RNG state): gradients equal to no remat's, bit for bit."""
    from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel

    ids = t(np.random.default_rng(2).integers(0, 311, (2, 32)))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = GPTLMHeadModel(GPTConfig(**GPT_TINY, remat_blocks=remat),
                               device="cpu")
        model.init_weights(torch.Generator().manual_seed(3))
        model(ids, deterministic=False).logits.square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_gpt_unported_dropouts_raise():
    """The residual and embedding dropouts (jax.random draws) are not
    ported: deterministic=False raises rather than run without them;
    deterministic=True runs."""
    from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel

    ids = torch.zeros(1, 8, dtype=torch.long)
    for field in ("resid_pdrop", "embd_pdrop"):
        cfg = GPTConfig(**{**GPT_TINY, field: 0.1})
        model = GPTLMHeadModel(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match=field):
            model(ids, deterministic=False)
        with torch.no_grad():
            assert torch.isfinite(model(ids).logits).all()


def test_mha_padding_mask_branch_takes_no_dropout():
    """JAX's `key_padding_mask` branch passes no dropout_p (quirk 10); the
    dense branch of the same MHA does drop."""
    from flash_attn_tpu_torch.modules.mha import MHA

    torch.manual_seed(0)
    mha = MHA(64, 2, causal=False, dropout=0.5, device="cpu")
    x = torch.randn(2, 10, 64)
    mask = torch.ones(2, 10, dtype=torch.bool)
    with torch.no_grad():
        ref = mha(x)
        assert torch.equal(mha(x, key_padding_mask=mask,
                               deterministic=False),
                           mha(x, key_padding_mask=mask))
        assert (mha(x, deterministic=False) - ref).abs().max() > 1e-2


BERT = dict(vocab_size=523, hidden_size=128, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=512,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.2)


def test_bert_unpadded_attention_dropout_matches_jax():
    """The unpadded encoder (packed varlen kernels) with
    `deterministic=False`: hidden states and every parameter's gradient of
    sum(hidden * R)."""
    from flash_attn_tpu.models import bert as jax_bert
    from flash_attn_tpu_torch.models import bert

    cfg = bert.BertConfig(**BERT)
    lengths, s = [40, 17, 33], 40
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (3, s)).astype(np.int32)
    types = rng.integers(0, 2, (3, s)).astype(np.int32)
    mask = np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    proj = rng.standard_normal((3, s, cfg.hidden_size)).astype(np.float32)
    jmodel = jax_bert.BertModel(cfg)
    params = random_tree(jmodel.init, 5, ids, mask, types)

    def loss(p):
        h, _ = jmodel.apply(p, ids, mask, types, deterministic=False,
                            unpad_varlen=True)
        return jnp.sum(h * proj), h

    (_, h_j), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = bert.BertModel(cfg, device="cpu")
    model.load_state_dict(bert.bert_state_dict_from_jax_params(params, cfg))
    h, _ = model(t(ids), t(mask), t(types), deterministic=False,
                 unpad_varlen=True)
    (h * t(proj)).sum().backward()
    close(h.detach(), h_j)
    assert_grads(model, bert.bert_state_dict_from_jax_params(grads, cfg))


VIT = dict(img_size=16, patch_size=4, embed_dim=64, depth=2, num_heads=2,
           num_classes=10, attn_drop_rate=0.25)


def test_vit_attention_dropout_matches_jax():
    """ViT with `attn_drop_rate` and `deterministic=False` (the dense
    non-causal kernels): logits and every parameter's gradient of
    sum(logits * R)."""
    from flash_attn_tpu.models.vit import VisionTransformer as JaxViT
    from flash_attn_tpu_torch.models import vit

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    proj = rng.standard_normal((2, 10)).astype(np.float32)
    jm = JaxViT(**VIT, dtype=jnp.float32)
    params = random_tree(JaxViT(**VIT, use_flash_attn=False).init, 8, x)

    def loss(p):
        logits = jm.apply(p, x, deterministic=False)
        return jnp.sum(logits * proj), logits

    (_, logits_j), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    model = vit.VisionTransformer(**VIT, device="cpu")
    model.load_state_dict(vit.state_dict_from_jax_params(params, 2))
    logits = model(t(x), deterministic=False)
    (logits * t(proj)).sum().backward()
    close(logits.detach(), logits_j)
    assert_grads(model, vit.state_dict_from_jax_params(grads, 2))
    with torch.no_grad():
        assert (model(t(x)) - logits).abs().max() > 1e-4


def test_options_that_refuse_dropout_raise():
    """dropout_p outside [0, 1) raises ValueError on every entry point;
    fp8 with dropout and paged varlen with dropout raise
    NotImplementedError, as in JAX."""
    q = torch.zeros(1, 8, 2, 32)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    for p in (1.0, -0.1):
        with pytest.raises(ValueError):
            interface.flash_attn_func(q, q, q, dropout_p=p)
        with pytest.raises(ValueError):
            interface.flash_attn_varlen_func(q[0], q[0], q[0], cu, cu, 8, 8,
                                             dropout_p=p)
    q8 = q[0].to(torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError, match="fp8"):
        interface.flash_attn_varlen_func(q8, q8, q8, cu, cu, 8, 8,
                                         dropout_p=0.1)
    pages = torch.zeros(1, 16, 2, 32)
    with pytest.raises(NotImplementedError, match="dropout_p=0"):
        interface.flash_attn_varlen_func(
            q[0], pages, pages, cu, None, 8, 16, dropout_p=0.1,
            block_table=torch.zeros(1, 1, dtype=torch.int32),
            seqused_k=torch.tensor([8]))
