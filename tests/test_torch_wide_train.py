"""Training at head dims 192 and 256, and BTLM with muP: the port's plain
backward (dense at d 192 and, with dropout, at d 256; packed varlen at d
256), a tiny GPT-J (two heads of d 256), BTLM's and GPT-J's config
conversions and BTLM's remap, muP models and a tiny BTLM (`models.btlm`:
SwiGLU, ALiBi, muP) against the JAX package, on the CPU in float32, from
the same seeded numpy inputs.

The JAX attention kernels run as the JAX package's own tests run them on
the CPU (Pallas interpret mode), under `jax.jit` with XLA's optimisations
off, and JAX's plain `utils.testing.attention_ref` under `jax.vjp`; the
JAX models take the port's `GPTConfig` as their config (no `transformers`
import), and XLA's reference attention but under ALiBi (BTLM), which that
path drops.  JAX's `btlm_config_to_gpt2_config` and
`gptj_config_to_gpt2_config` build a `transformers.GPT2Config`; here a
plain attribute holder stands in for that class, so that the conversions'
own arithmetic is compared without the import (it costs ~7 s).

Tolerances: gradients of the attention kernels 2e-5
(`tests/test_torch_headdim.py`), model logits 1e-4
(`tests/test_torch_families.py`), losses rtol 1e-6 and model gradients
1e-5 (`tests/test_torch_training.py`).
"""

import dataclasses
import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import interface as jax_iface
from flash_attn_tpu.kernels.flash_bwd import \
    flash_attn_bwd_bhsd as jax_bwd
from flash_attn_tpu.kernels.flash_fwd import dropout_keep as jax_keep
from flash_attn_tpu.losses.cross_entropy import \
    cross_entropy_loss as jax_cross_entropy
from flash_attn_tpu.models import btlm as jbtlm
from flash_attn_tpu.models import gptj as jgptj
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPT
from flash_attn_tpu.training.loss import chunked_lm_loss as jax_lm_loss
from flash_attn_tpu.utils import testing as jtesting
from flash_attn_tpu_torch import serve_profile
from flash_attn_tpu_torch.kernels import flash_bwd, flash_fwd, varlen
from flash_attn_tpu_torch.losses.cross_entropy import cross_entropy_loss
from flash_attn_tpu_torch.models import btlm, gptj
from flash_attn_tpu_torch.models.gpt import (GPTConfig, GPTLMHeadModel,
                                             state_dict_from_jax_params)
from flash_attn_tpu_torch.training.loss import chunked_lm_loss

GRAD_ATOL = 2e-5
LOGIT_ATOL = 1e-4
LOSS_RTOL, MODEL_GRAD_ATOL = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references here are tiny programs whose time is compiling,
    not running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny torch ops run faster on one thread than with torch's threads
    contending with JAX's; module scope covers the module's fixtures."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x))


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def seeded(rng, shape, name):
    """Norm weights 1 + N(0, 0.1), other vectors N(0, 0.02), matrices
    N(0, 0.05)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if len(shape) == 1:
        norm = "norm" in name or "ln" in name
        return 1 + 0.1 * x if norm and "weight" in name else 0.02 * x
    return 0.05 * x


def jax_config(cfg):
    """The port's config as the JAX model's, the head dim spelled out.
    Under ALiBi the JAX model runs its attention kernel (interpret mode):
    its XLA reference attention (`use_flash_attn=False`,
    `modules/mha.py:306-311`) drops the ALiBi bias."""
    jcfg = dataclasses.replace(cfg, head_dim=cfg.n_embd // cfg.n_head)
    jcfg.use_flash_attn = cfg.use_alibi
    return jcfg


# ----------------------------------------------------------- backward


def test_plain_dense_bwd_d192_matches_jax_kernel():
    """The plain dense backward at d 192 (the kernels' D 192) against the
    JAX kernel (interpret mode): causal GQA with a 20-key window over
    ragged lengths; dq on rows past seqused_q is not compared (the JAX
    kernel leaves them unmasked), and callers pass dO = 0 there."""
    d = 192
    rng = np.random.default_rng(192)
    b, h, hk, sq, sk = 2, 2, 1, 24, 48
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    squ = np.asarray([24, 21], np.int32)
    sku = np.asarray([48, 30], np.int32)
    valid = np.arange(sq)[None, None, :] < squ[:, None, None]
    do = (rng.standard_normal((b, h, sq, d)).astype(np.float32)
          * valid[..., None])
    kw = dict(softmax_scale=d ** -0.5, causal=True, window_size=(20, 0))
    o, lse = flash_fwd.flash_attn_fwd_bhsd(t(q), t(k), t(v), t(squ), t(sku),
                                           **kw)
    o, lse = o.numpy(), lse.numpy()
    ref = jax.jit(functools.partial(jax_bwd, **kw))(do, q, k, v, o, lse, squ,
                                                    sku)
    out = flash_bwd.flash_attn_bwd_bhsd(t(do), t(q), t(k), t(v), t(o),
                                        t(lse), t(squ), t(sku), **kw)
    rows = np.broadcast_to(valid[..., None], q.shape)
    np.testing.assert_allclose(out[0].numpy()[rows], np.asarray(ref[0])[rows],
                               atol=GRAD_ATOL, rtol=0)
    for name, x, r in zip(("dk", "dv"), out[1:], ref[1:]):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def test_plain_varlen_bwd_d256_matches_jax_kernel():
    """The plain packed varlen backward at d 256 against jax.grad through
    the JAX packed backward kernel (interpret mode): causal GQA over three
    sequences, one of them empty."""
    d, h, hk = 256, 2, 1
    lens = [40, 0, 23]
    rng = np.random.default_rng(256)
    total = sum(lens)
    q = rng.standard_normal((total, h, d)).astype(np.float32)
    k = rng.standard_normal((total, hk, d)).astype(np.float32)
    v = rng.standard_normal((total, hk, d)).astype(np.float32)
    do = rng.standard_normal((total, h, d)).astype(np.float32)
    cu = np.cumsum([0] + lens).astype(np.int32)
    m = max(lens)

    def loss(a, b_, c):
        o = jax_iface.flash_attn_varlen_func(a, b_, c, jnp.asarray(cu),
                                             jnp.asarray(cu), m, m,
                                             causal=True)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.jit(jax.grad(loss, (0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    o, lse = varlen.varlen_attn_fwd(t(q), t(k), t(v), t(cu), t(cu), m, m,
                                    **kw)
    out = varlen.varlen_attn_bwd(t(do), t(q), t(k), t(v), o, lse, t(cu),
                                 t(cu), m, m, **kw)
    for name, x, r in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def reference_grads(q, k, v, do, softmax_scale, causal=False, dropout_p=0.0,
                    dropout_seed=0):
    """o and (dq, dk, dv) of JAX's plain `utils.testing.attention_ref`
    (jax.vjp, float32) on (b, s, h, d) inputs, dropout with the JAX
    kernels' keep mask (`kernels.flash_fwd.dropout_keep`) of a dense
    call."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]

    def ref(q_, k_, v_):
        keep = jax_keep(jnp.int32(dropout_seed),
                        jnp.arange(b)[:, None, None, None],
                        jnp.arange(h)[None, :, None, None],
                        jnp.arange(sq)[None, None, :, None],
                        jnp.arange(sk)[None, None, None, :], dropout_p)
        return jtesting.attention_ref(q_, k_, v_, dropout_p=dropout_p,
                                      dropout_mask=keep, causal=causal,
                                      softmax_scale=softmax_scale)[0]

    def run(q_, k_, v_, do_):
        o, vjp = jax.vjp(ref, q_, k_, v_)
        return o, vjp(do_)

    o, grads = jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, do)))
    return np.asarray(o), [np.asarray(g) for g in grads]


def test_plain_dense_bwd_d256_dropout_matches_jax_reference():
    """The plain dense forward and backward at d 256 with dropout (causal
    GQA, two q heads on one kv head) against jax.vjp of JAX's plain
    `attention_ref` under the JAX kernels' keep mask: the mask the kernels
    at D 256 draw bit for bit, through o and every gradient."""
    d, b, h, hk, sq, sk = 256, 2, 2, 1, 32, 48
    rng = np.random.default_rng(d)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    squ, sku = np.full(b, sq, np.int32), np.full(b, sk, np.int32)
    kw = dict(softmax_scale=d ** -0.5, causal=True, dropout_p=0.1,
              dropout_seed=-3)
    o_ref, grads = reference_grads(
        *(x.transpose(0, 2, 1, 3) for x in (q, k, v, do)), **kw)
    o, lse = flash_fwd.flash_attn_fwd_bhsd(t(q), t(k), t(v), t(squ), t(sku),
                                           **kw)
    out = flash_bwd.flash_attn_bwd_bhsd(t(do), t(q), t(k), t(v), o, lse,
                                        t(squ), t(sku), **kw)
    for name, x, r in zip(("o", "dq", "dk", "dv"), (o, *out),
                          (o_ref, *grads)):
        np.testing.assert_allclose(x.numpy(), r.transpose(0, 2, 1, 3),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------- GPT-J


def test_gptj_d256_loss_and_gradients_match_jax():
    """A tiny GPT-J (n_embd 512: two heads of d 256, 64 features of each
    rotated, interleaved; parallel blocks, untied head with a bias), 2
    layers: the loss of its own logits (head bias included) through the
    cross-entropy, as the card's GPT-J training step takes it, and every
    gradient, against the JAX model on the same weights."""
    cfg = GPTConfig(vocab_size=301, n_positions=0, n_embd=512, n_layer=2,
                    n_head=2, rotary_emb_fraction=0.25,
                    rotary_emb_interleaved=True, tie_word_embeddings=False,
                    qkv_proj_bias=False, out_proj_bias=False,
                    parallel_block=True, parallel_block_tied_norm=True,
                    lm_head_bias=True)
    jm = JaxGPT(jax_config(cfg), dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: seeded(rng, x.shape, jax.tree_util.keystr(path)),
        shapes)
    batch = np.random.default_rng(7).integers(0, 301, (2, 25)).astype(
        np.int32)
    ids, targets = batch[:, :-1], batch[:, 1:].reshape(-1)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(ids)).logits
        losses, _ = jax_cross_entropy(logits.reshape(-1, 301),
                                      jnp.asarray(targets))
        return jnp.mean(losses)

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(params)
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(to_numpy_tree(params),
                                                    cfg))
    logits = port(t(ids).long()).logits
    loss_t = cross_entropy_loss(logits.reshape(-1, 301),
                                t(targets).long())[0].mean()
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    expected = state_dict_from_jax_params(to_numpy_tree(grads_j), cfg)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(),
                                   atol=MODEL_GRAD_ATOL, rtol=0,
                                   err_msg=name)


# ----------------------------------------------------------------- BTLM

# JAX's test_btlm_remap_structure's config (tests/models/
# test_model_families.py): head dim 16, n_inner 172 (kept exact, not
# rounded to GatedMlp's multiple_of)
BTLM_TINY = types.SimpleNamespace(
    vocab_size=277, n_positions=64, n_embd=64, n_layer=2, n_head=4,
    n_inner=172, activation_function="swiglu", resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, layer_norm_epsilon=1e-5,
    initializer_range=0.02, bos_token_id=0, eos_token_id=0,
    position_embedding_type="alibi", mup_embeddings_scale=14.6,
    mup_output_alpha=2.22, mup_width_scale=0.1, mup_scale_qk_dot_by_d=True)


def btlm_hf_state_dict(c, seed):
    """A BTLM checkpoint in HF's layout (`Conv1D` weights (in, out); learned
    positions where the config has no ALiBi), drawn with numpy."""
    rng = np.random.default_rng(seed)
    d, inner = c.n_embd, c.n_inner
    shapes = {"transformer.wte.weight": (c.vocab_size, d),
              "transformer.ln_f.weight": (d,), "transformer.ln_f.bias": (d,)}
    if c.position_embedding_type != "alibi":
        shapes["transformer.wpe.weight"] = (c.n_positions, d)
    for i in range(c.n_layer):
        p = f"transformer.h.{i}."
        for n in ("ln_1", "ln_2"):
            shapes[p + n + ".weight"] = shapes[p + n + ".bias"] = (d,)
        for n, (fan_in, fan_out) in (("attn.c_attn", (d, 3 * d)),
                                     ("attn.c_proj", (d, d)),
                                     ("mlp.c_fc", (d, inner)),
                                     ("mlp.c_fc2", (d, inner)),
                                     ("mlp.c_proj", (inner, d))):
            shapes[p + n + ".weight"] = (fan_in, fan_out)
            shapes[p + n + ".bias"] = (fan_out,)
    return {k: torch.from_numpy(seeded(rng, s, k)) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def btlm_models(monkeypatch_module):
    """The tiny BTLM at one layer through both packages' config
    conversion and remap (the port's model from the port's remap, the JAX
    tree from JAX's), a (2, 25) token batch, and, in one jit, the JAX
    logits of its inputs and JAX's `chunked_lm_loss` of the batch with its
    gradients (whole logits: its chunked form is the same function,
    `tests/test_torch_training.py`); the JAX model's logits program (jaxpr)
    under the config and under one with another
    `mup_embeddings_multiplier`."""
    monkeypatch_module.setitem(
        sys.modules, "transformers",
        types.SimpleNamespace(GPT2Config=types.SimpleNamespace))
    # one layer: JAX's interpret-mode kernels trace each layer's attention
    # anew (~2 s a layer); the remap test covers three
    c = types.SimpleNamespace(**dict(vars(BTLM_TINY), n_layer=1))
    jconv = jbtlm.btlm_config_to_gpt2_config(c)
    cfg = btlm.btlm_config_to_gpt2_config(c)
    sd = btlm_hf_state_dict(c, 11)
    jtree = to_numpy_tree(jbtlm.remap_state_dict_hf_btlm(dict(sd), cfg))
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(btlm.remap_state_dict_hf_btlm(dict(sd), cfg))
    batch = np.random.default_rng(12).integers(0, 277, (2, 25)).astype(
        np.int32)
    other = dataclasses.replace(cfg, mup_embeddings_multiplier=3.0)
    jm = JaxGPT(jax_config(cfg), dtype=jnp.float32)
    params, ids = {"params": jtree}, jnp.asarray(batch[:, :-1])

    def program(c):
        """The logits' jaxpr on XLA's attention: the multiplier's use does
        not hang on the attention path, and interpret-mode kernels trace
        slowly."""
        jc = jax_config(c)
        jc.use_flash_attn = False
        jm = JaxGPT(jc, dtype=jnp.float32)
        return str(jax.make_jaxpr(lambda p, x: jm.apply(p, x).logits)(
            params, ids))

    programs = [program(c) for c in (cfg, other)]

    def run(p, x):
        return jm.apply(p, x[:, :-1]).logits, jax.value_and_grad(
            lambda p_: jax_lm_loss(jm, p_, x, chunk_tokens=0))(p)

    jlogits, (loss, grads) = jax.jit(run)(params, jnp.asarray(batch))
    return dict(jconv=jconv, cfg=cfg, other=other, sd=sd, jtree=jtree,
                port=port.eval(), batch=batch, jlogits=np.asarray(jlogits),
                programs=programs, jloss=float(loss),
                jgrads=to_numpy_tree(grads))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_btlm_config_remap_and_logits_match_jax(btlm_models):
    """The port's config carries JAX's conversion (ALiBi, SwiGLU, tied
    head, muP: softmax scale 1 / 16, logits times 0.222), its remap gives
    JAX's weights exactly, and its logits with muP on match JAX's."""
    m = btlm_models
    cfg, jconv = m["cfg"], m["jconv"]
    for name in ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head",
                 "n_inner", "activation_function", "layer_norm_epsilon",
                 "use_alibi", "tie_word_embeddings", "use_mup",
                 "mup_embeddings_multiplier", "mup_output_multiplier",
                 "mup_attn_multiplier"):
        assert getattr(cfg, name) == getattr(jconv, name), name
    assert cfg.use_mup and cfg.use_alibi
    mixer = m["port"].transformer.layers[0].mixer
    assert mixer.softmax_scale == pytest.approx(1 / 16, rel=1e-12)
    assert m["port"].transformer.layers[0].mlp.fc2.in_features == 172
    sd = btlm.remap_state_dict_hf_btlm(dict(m["sd"]), cfg)
    expected = state_dict_from_jax_params(m["jtree"], cfg)
    assert set(sd) == set(expected) == set(m["port"].state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), expected[k].numpy(),
                                      err_msg=k)
    with pytest.raises(ValueError, match="unmapped"):
        btlm.remap_state_dict_hf_btlm(
            dict(m["sd"], **{"extra.weight": torch.zeros(2)}), cfg)
    ids = m["batch"][:, :-1]
    with torch.no_grad():
        out = m["port"](t(ids).long()).logits.numpy()
    np.testing.assert_allclose(out, m["jlogits"], atol=LOGIT_ATOL, rtol=0)


def test_btlm_mup_embeddings_multiplier_is_unused(btlm_models):
    """JAX carries `mup_embeddings_multiplier` and applies it nowhere; so
    does the port: another value leaves the port's logits as they were,
    bit for bit, and the JAX model's logits program (its jaxpr) as it was,
    so its logits too."""
    m = btlm_models
    ids = m["batch"][:, :-1]
    port = GPTLMHeadModel(m["other"], device="cpu")
    port.load_state_dict(m["port"].state_dict())
    with torch.no_grad():
        a = m["port"](t(ids).long()).logits
        b = port.eval()(t(ids).long()).logits
    assert torch.equal(a, b)
    assert m["programs"][0] == m["programs"][1]


def test_btlm_chunked_lm_loss_matches_jax(btlm_models):
    """`training.loss.chunked_lm_loss` (20-token chunks of the 48 tokens,
    the head times the muP output multiplier) and every gradient against
    JAX's `chunked_lm_loss` on the same weights."""
    m = btlm_models
    cfg, batch = m["cfg"], m["batch"]
    loss_j, grads_j = m["jloss"], m["jgrads"]
    port = m["port"]
    port.zero_grad(set_to_none=True)
    loss_t = chunked_lm_loss(port, t(batch).long(), chunk_tokens=20)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    expected = state_dict_from_jax_params(grads_j, cfg)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(),
                                   atol=MODEL_GRAD_ATOL, rtol=0,
                                   err_msg=name)
    port.zero_grad(set_to_none=True)


BTLM_CONFIG_FIELDS = (
    "vocab_size", "n_positions", "n_embd", "n_layer", "n_head", "n_inner",
    "activation_function", "resid_pdrop", "embd_pdrop", "attn_pdrop",
    "layer_norm_epsilon", "use_alibi", "tie_word_embeddings", "use_mup",
    "mup_embeddings_multiplier", "mup_output_multiplier",
    "mup_attn_multiplier")
MUP_FIELDS = ("mup_embeddings_scale", "mup_output_alpha", "mup_width_scale",
              "mup_scale_qk_dot_by_d")
# BTLM configs by (base, changed fields, dropped fields): the published one,
# learned positions, no muP fields (HF's defaults), the qk scale by
# sqrt(head dim) only, and an embeddings scale of 1 (muP off)
BTLM_VARIANTS = {
    "tiny": (BTLM_TINY, {}, ()),
    "published": (serve_profile.BTLM_3B_8K, {}, ()),
    "learned-positions": (BTLM_TINY,
                          dict(position_embedding_type="learned_absolute"),
                          ()),
    "no-mup-fields": (BTLM_TINY, {}, MUP_FIELDS),
    "qk-not-by-d": (BTLM_TINY, dict(mup_scale_qk_dot_by_d=False), ()),
    "unit-embeddings-scale": (BTLM_TINY, dict(mup_embeddings_scale=1.0), ()),
}


def btlm_variant(name):
    base, changed, dropped = BTLM_VARIANTS[name]
    fields = {**vars(base), **changed}
    return types.SimpleNamespace(**{k: v for k, v in fields.items()
                                    if k not in dropped})


@pytest.fixture
def hf_config_stand_in(monkeypatch):
    """JAX's conversions build a `transformers.GPT2Config`: an attribute
    holder stands in for it (no `transformers` import)."""
    stand_in = types.SimpleNamespace(GPT2Config=types.SimpleNamespace)
    monkeypatch.setitem(sys.modules, "transformers", stand_in)


@pytest.mark.parametrize("variant", list(BTLM_VARIANTS))
def test_btlm_config_conversion_matches_jax(variant, hf_config_stand_in):
    """`btlm_config_to_gpt2_config` gives every field JAX's conversion
    sets, for BTLM configs with and without ALiBi and muP; the model built
    from it has JAX's softmax scale (head_dim ** -0.5 times the muP
    multiplier under muP, else head_dim ** -0.5)."""
    c = btlm_variant(variant)
    jconv = jbtlm.btlm_config_to_gpt2_config(c)
    cfg = btlm.btlm_config_to_gpt2_config(c)
    for name in BTLM_CONFIG_FIELDS:
        assert getattr(cfg, name) == getattr(jconv, name), name
    if variant == "published":  # 2.7 B parameters: not built here
        assert (cfg.n_embd // cfg.n_head, cfg.mup_attn_multiplier) == (
            80, 80 ** -0.5)
        return
    head_dim = c.n_embd // c.n_head
    scale = head_dim ** -0.5 * (jconv.mup_attn_multiplier if jconv.use_mup
                                else 1.0)
    mixer = GPTLMHeadModel(cfg, device="cpu").transformer.layers[0].mixer
    assert mixer.softmax_scale == pytest.approx(scale, rel=1e-12)


@pytest.mark.parametrize("variant", ["alibi-two-layers",
                                     "learned-positions-three-layers",
                                     "with-head-and-mask-buffers"])
def test_btlm_remap_matches_jax(variant, hf_config_stand_in):
    """`remap_state_dict_hf_btlm` gives JAX's remapped weights exactly and
    the model's state_dict keys: learned positions carried, the tied head
    and the attention-mask buffers dropped."""
    c = btlm_variant("learned-positions" if "learned" in variant
                     else "tiny")
    c.n_layer = {"alibi-two-layers": 2}.get(variant, 3)
    cfg = btlm.btlm_config_to_gpt2_config(c)
    sd = btlm_hf_state_dict(c, 21)
    if variant == "with-head-and-mask-buffers":
        sd["lm_head.weight"] = sd["transformer.wte.weight"].clone()
        for i in range(c.n_layer):
            sd[f"transformer.h.{i}.attn.bias"] = torch.ones(1, 1, 8, 8)
    expected = state_dict_from_jax_params(
        to_numpy_tree(jbtlm.remap_state_dict_hf_btlm(dict(sd), cfg)), cfg)
    got = btlm.remap_state_dict_hf_btlm(dict(sd), cfg)
    model_keys = set(GPTLMHeadModel(cfg, device="cpu").state_dict())
    assert set(got) == set(expected) == model_keys
    assert ("transformer.embeddings.wpe.weight" in got) == (
        "learned" in variant)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), expected[k].numpy(),
                                      err_msg=k)


def test_gptj_published_config_converts_like_jax(hf_config_stand_in):
    """GPT-J-6B's published config (`serve_profile.GPTJ_6B`) through the
    port's `gptj_config_to_gpt2_config` and JAX's: the same fields, 16
    heads of d 256 with 64 of them rotated."""
    c = serve_profile.GPTJ_6B
    jconv = jgptj.gptj_config_to_gpt2_config(c)
    cfg = gptj.gptj_config_to_gpt2_config(c)
    for name in ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head",
                 "n_inner", "activation_function", "resid_pdrop",
                 "embd_pdrop", "attn_pdrop", "layer_norm_epsilon",
                 "rotary_emb_fraction", "rotary_emb_interleaved",
                 "tie_word_embeddings", "qkv_proj_bias", "out_proj_bias",
                 "parallel_block", "parallel_block_tied_norm",
                 "lm_head_bias"):
        assert getattr(cfg, name) == getattr(jconv, name), name
    assert (cfg.n_embd // cfg.n_head, cfg.rotary_dim()) == (256, 64)


# muP on models JAX runs with its XLA reference attention (no ALiBi): the
# multipliers on their own and with the options BTLM and GPT-J bring
MUP_MODELS = {
    "tied-swiglu-d16": dict(n_head=4, activation_function="swiglu",
                            n_inner=172, mup_attn_multiplier=0.25,
                            mup_output_multiplier=0.222),
    "untied-rotary-parallel-d32": dict(n_head=2, tie_word_embeddings=False,
                                       n_positions=0, rotary_emb_fraction=0.5,
                                       parallel_block=True,
                                       mup_attn_multiplier=0.5,
                                       mup_output_multiplier=0.3),
    "mup-off": dict(n_head=4, use_mup=False, mup_attn_multiplier=0.25,
                    mup_output_multiplier=0.222),
}


@pytest.mark.parametrize("case", list(MUP_MODELS))
def test_mup_model_logits_match_jax(case):
    """A 2-layer model with muP (embeddings multiplier 14.6, unused on both
    sides) against the JAX model on the same weights: logits 1e-4.  With
    `use_mup` off both ignore the multipliers."""
    cfg = GPTConfig(**{**dict(vocab_size=257, n_positions=64, n_embd=64,
                              n_layer=2, use_mup=True,
                              mup_embeddings_multiplier=14.6),
                       **MUP_MODELS[case]})
    jm = JaxGPT(jax_config(cfg), dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(31)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: seeded(rng, x.shape, jax.tree_util.keystr(path)),
        shapes)
    ids = np.random.default_rng(32).integers(0, 257, (2, 24)).astype(np.int32)
    jlogits = jax.jit(lambda p, x: jm.apply(p, x).logits)(params,
                                                          jnp.asarray(ids))
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(to_numpy_tree(params),
                                                    cfg))
    with torch.no_grad():
        logits = port.eval()(t(ids).long()).logits.numpy()
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=LOGIT_ATOL,
                               rtol=0)
