"""The port's GPT-2 model (`flash_attn_tpu_torch.models.gpt`) against the JAX
model on the same weights, carried across by `state_dict_from_jax_params`,
plus the norm and activation ops.  Tiny model in float32, on the CPU.

Tolerances: logits atol 1e-4 (two layers of float32 matmuls summed in
different orders); live KV-cache rows atol 1e-5 (one projection from
identical inputs); norms atol 1e-5 in float32 and one bf16 rounding
(rtol 2^-7) in bfloat16; GELU atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPT
from flash_attn_tpu.modules.mha import InferenceParams as JaxInferenceParams
from flash_attn_tpu.ops.activations import gelu_approx as jax_gelu
from flash_attn_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from flash_attn_tpu.ops.layer_norm import rms_norm as jax_rms_norm
from flash_attn_tpu_torch.models.gpt import (GPTConfig, GPTLMHeadModel,
                                             state_dict_from_jax_params)
from flash_attn_tpu_torch.modules.mha import InferenceParams
from flash_attn_tpu_torch.ops.activations import gelu_approx
from flash_attn_tpu_torch.ops.layer_norm import layer_norm, rms_norm

LOGIT_ATOL, KV_ATOL = 1e-4, 1e-5
TINY = dict(n_embd=128, n_head=4, n_layer=2, vocab_size=311, n_positions=256)


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


def jax_config(**extra):
    """The JAX model's config: the port's `GPTConfig` carries the
    `GPT2Config` attribute names the JAX model reads, with the same
    defaults, and no `transformers` import (seconds) is needed.  The JAX
    model reads `head_dim` without a default of its own."""
    cfg = GPTConfig(**TINY)
    cfg.head_dim = cfg.n_embd // cfg.n_head
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def seeded_params(init, ids, seed):
    """JAX's parameter tree for `init`, filled from numpy on
    `jax.eval_shape`'s shapes (no compile): norm weights 1 + N(0, 0.1),
    other vectors N(0, 0.02), matrices and embeddings N(0, 0.05)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0),
                            jnp.asarray(ids[:, :4]))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        v = rng.standard_normal(x.shape).astype(np.float32)
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if x.ndim == 1 and ("norm" in name or "ln_f" in name) \
                and name.endswith("weight"):
            return 1 + 0.1 * v
        return v * (0.02 if x.ndim == 1 else 0.05)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def models():
    ids = np.random.default_rng(0).integers(0, 311, (2, 24)).astype(np.int32)
    jmodel = JaxGPT(jax_config(), dtype=jnp.float32)
    init = JaxGPT(jax_config(use_flash_attn=False), dtype=jnp.float32).init
    params = seeded_params(init, ids, 0)
    cfg = GPTConfig(**TINY)
    port = GPTLMHeadModel(cfg, device="cpu", dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax_params(to_numpy_tree(params), cfg))
    port.eval()
    return jmodel, params, port, ids


def test_converter_uses_every_array_once(models):
    _, params, port, _ = models
    tree = to_numpy_tree(params)
    sd = state_dict_from_jax_params(tree, port.config)
    n_arrays = len(jax.tree_util.tree_leaves(tree))
    assert len(sd) == n_arrays
    expected = port.state_dict()
    assert set(sd) == set(expected)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(expected[k].shape), k
    # Dense kernels are (in, out) in flax and (out, in) in nn.Linear.
    w = tree["params"]["transformer"]["layers_0"]["mixer"]["Wqkv"]["kernel"]
    np.testing.assert_array_equal(
        sd["transformer.layers.0.mixer.Wqkv.weight"].numpy(), w.T)
    tree["params"]["transformer"]["extra"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="unused"):
        state_dict_from_jax_params(tree, port.config)


def build_pair(extra, seed, ids):
    """JAX and port models of the tiny config with `extra` options, on the
    same seeded weights (in the tree of JAX's XLA reference path, which has
    the same parameters)."""
    init = JaxGPT(jax_config(use_flash_attn=False, **extra),
                  dtype=jnp.float32).init
    params = seeded_params(init, ids, seed)
    cfg = GPTConfig(**TINY, **extra)
    port = GPTLMHeadModel(cfg, device="cpu", dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax_params(to_numpy_tree(params),
                                                    cfg))
    return params, port.eval()


def check_cached_steps(jmodel, params, port, ids, n_decode):
    """Prefill of 17 tokens (the prefill kernel: s > 16) then `n_decode`
    one-token decode steps, logits and live cache rows compared at every
    step; JAX under `jax.jit`."""
    b, smax = 2, 32
    steps = [ids[:, :17]] + [ids[:, 17 + i:18 + i] for i in range(n_decode)]
    jip = JaxInferenceParams(max_seqlen=smax, max_batch_size=b,
                             lengths_per_sample=jnp.zeros((b,), jnp.int32))
    tip = InferenceParams(max_seqlen=smax, max_batch_size=b,
                          lengths_per_sample=torch.zeros(b, dtype=torch.int32))

    @jax.jit
    def jstep(p, x, ip):
        out = jmodel.apply(p, x, inference_params=ip)
        return out.logits, out.inference_params

    for x in steps:
        jlogits, jip = jstep(params, jnp.asarray(x), jip)
        with torch.no_grad():
            tout = port(torch.from_numpy(x).long(), inference_params=tip)
        np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_ATOL, rtol=0)
        n = int(jip.lengths_per_sample[0])
        assert tip.lengths_per_sample.tolist() == [n, n]
        for li in range(TINY["n_layer"]):
            for jc, tc in zip(jip.key_value_memory_dict[li],
                              tip.key_value_memory_dict[li]):
                np.testing.assert_allclose(tc[:, :, :n].numpy(),
                                           np.asarray(jc)[:, :, :n],
                                           atol=KV_ATOL, rtol=0)


# Model options held to JAX: (config fields, JAX's use_flash_attn, decode
# steps after the no-cache logits).  ALiBi goes through JAX's Pallas path
# (its XLA reference drops ALiBi, ROADMAP Queue 3); the three attention
# options together also through a prefill and two decode steps.
MODEL_OPTIONS = {
    "False": (None, False, 0),  # the default model, XLA reference path
    "True": (None, True, 0),    # the default model, interpret-mode Pallas
    "window": (dict(window_size=(8, 0)), False, 0),
    "softcap": (dict(attn_softcap=5.0), False, 0),
    "alibi": (dict(use_alibi=True), True, 0),
    "window_softcap_alibi": (dict(window_size=(8, 0), attn_softcap=5.0,
                                  use_alibi=True), True, 2),
    "residual_in_fp32": (dict(residual_in_fp32=True), False, 0),
    "lm_head_bias": (dict(tie_word_embeddings=False, lm_head_bias=True),
                     False, 0),
}


@pytest.mark.parametrize("option", list(MODEL_OPTIONS))
def test_no_cache_logits_match_jax(models, option):
    """The default model on JAX's Pallas path (interpret mode) and its XLA
    reference path, and the tiny model with each option of
    MODEL_OPTIONS."""
    extra, use_flash_attn, n_decode = MODEL_OPTIONS[option]
    jmodel, params, port, ids = models
    if extra is not None:
        params, port = build_pair(extra, 2, ids)
    jm = JaxGPT(jax_config(use_flash_attn=use_flash_attn, **(extra or {})),
                dtype=jnp.float32)
    ref = np.asarray(jax.jit(lambda p, x: jm.apply(p, x).logits)(
        params, jnp.asarray(ids)))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long()).logits.numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL, rtol=0)
    if n_decode:
        check_cached_steps(jm, params, port, ids, n_decode)


MLP_OPTIONS = {
    "swiglu": dict(activation_function="swiglu"),
    "sqrelu": dict(activation_function="sqrelu"),
    "glu": dict(activation_function="glu"),
    "geglu": dict(activation_function="geglu"),
    "relu": dict(activation_function="relu"),
    "silu": dict(activation_function="silu"),
    "no_bias": dict(qkv_proj_bias=False, out_proj_bias=False,
                    mlp_fc1_bias=False, mlp_fc2_bias=False),
    "n_inner_200": dict(n_inner=200),
}


@pytest.mark.parametrize("act", list(MLP_OPTIONS))
def test_mlp_variants_match_jax(act):
    """`GatedMlp` with SwiGLU, GLU (sigmoid) and GeGLU, `Mlp` with squared
    ReLU, ReLU and SiLU, no biases, and an inner width of 200, through the
    tiny model (XLA reference attention on the JAX side)."""
    extra = MLP_OPTIONS[act]
    ids = np.random.default_rng(1).integers(0, 311, (2, 12)).astype(np.int32)
    jm = JaxGPT(jax_config(use_flash_attn=False, **extra), dtype=jnp.float32)
    params, port = build_pair(extra, 1, ids)
    ref = np.asarray(jax.jit(lambda p, x: jm.apply(p, x).logits)(
        params, jnp.asarray(ids)))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long()).logits.numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL, rtol=0)


def test_cached_prefill_and_decode_match_jax(models):
    """Prefill of 17 tokens (the prefill kernel: s > 16) then 3 one-token
    decode steps, logits and live cache rows compared at every step."""
    jmodel, params, port, ids = models
    check_cached_steps(jmodel, params, port, ids, 3)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x).astype(jdt)
    out = layer_norm(xt, torch.from_numpy(w), torch.from_numpy(bias))
    ref = jax_layer_norm(xj, jnp.asarray(w), jnp.asarray(bias))
    # float32: summation order only; bf16: one rounding of the output
    tol = (dict(atol=1e-5, rtol=0) if dtype is np.float32
           else dict(atol=1e-6, rtol=2 ** -7))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    out = rms_norm(xt, torch.from_numpy(w))
    ref = jax_rms_norm(xj, jnp.asarray(w))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


def test_gelu_approx_matches_jax():
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    np.testing.assert_allclose(gelu_approx(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("field,value", [
    ("use_mup", True), ("tensor_parallel", True), ("prenorm", False)])
def test_unported_features_raise(field, value):
    """Tensor parallelism and the post-norm path raise NotImplementedError.
    muP raised until it was ported; now it builds (its arithmetic:
    `test_mup_scales_attention_and_logits`)."""
    cfg = GPTConfig(**TINY, **{field: value})
    if field == "use_mup":
        assert GPTLMHeadModel(cfg, device="cpu").config.use_mup
        return
    with pytest.raises(NotImplementedError):
        GPTLMHeadModel(cfg, device="cpu")


def test_mup_scales_attention_and_logits():
    """muP (`use_mup`) as JAX applies it: the softmax scale is head_dim **
    -0.5 * mup_attn_multiplier and the logits are multiplied by
    mup_output_multiplier; without `use_mup` the multipliers are ignored.
    (`tests/test_torch_wide_train.py` holds BTLM with muP to JAX.)"""
    mult = dict(mup_attn_multiplier=0.5, mup_output_multiplier=0.25,
                mup_embeddings_multiplier=7.0)
    plain = GPTLMHeadModel(GPTConfig(**TINY, **mult), device="cpu")
    mup = GPTLMHeadModel(GPTConfig(**TINY, use_mup=True, **mult),
                         device="cpu")
    mup.load_state_dict(plain.state_dict())
    hd = TINY["n_embd"] // TINY["n_head"]
    base = plain.transformer.layers[0].mixer.softmax_scale
    assert base == pytest.approx(hd ** -0.5, rel=1e-12)
    assert mup.transformer.layers[0].mixer.softmax_scale == pytest.approx(
        base * 0.5, rel=1e-12)
    for layer in mup.transformer.layers:  # the scale alone differs
        layer.mixer.softmax_scale = base
    ids = torch.arange(12).view(2, 6) % TINY["vocab_size"]
    with torch.no_grad():
        torch.testing.assert_close(mup(ids).logits,
                                   plain(ids).logits * 0.25, rtol=0,
                                   atol=1e-6)
