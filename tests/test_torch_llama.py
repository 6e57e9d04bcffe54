"""The LLaMA-family pieces of the port against the JAX package on the CPU,
in float32: `ops.rms_norm.RMSNorm`, `MHA` with rotary in each branch, the
GPT model with a Llama's options and with parallel blocks, the Llama's
cached prefill and decode, and `ServingEngine` on a tiny Llama.

Weights come from JAX's parameter shapes filled from a seed with numpy
(`jax.eval_shape`: tracing only) and are carried across with
`state_dict_from_jax_params`; JAX runs under `jax.jit`, with XLA's
optimisations off for these tiny programs.

Tolerances as in `tests/test_torch_gpt.py`: logits atol 1e-4 (two layers
of float32 matmuls summed in different orders); MHA outputs atol 1e-5 (one
layer); live KV-cache rows atol 1e-5 (one projection and rotation of
identical inputs); RMSNorm atol 1e-5 in float32 and one bf16 rounding
(rtol 2^-7) in bfloat16.  A served greedy token passes when it is JAX's
argmax or, where JAX's top-2 gap is below 1e-4, its runner-up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPT
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu.modules.mha import InferenceParams as JaxInferenceParams
from flash_attn_tpu.ops.rms_norm import RMSNorm as JaxRMSNorm
from flash_attn_tpu_torch.models.gpt import (GPTConfig, GPTLMHeadModel,
                                             state_dict_from_jax_params)
from flash_attn_tpu_torch.modules.block import ParallelBlock
from flash_attn_tpu_torch.modules.mha import MHA, InferenceParams
from flash_attn_tpu_torch.ops.rms_norm import RMSNorm, rms_norm_fn
from flash_attn_tpu_torch.serving import ServingEngine

LOGIT_ATOL, KV_ATOL, MHA_ATOL = 1e-4, 1e-5, 1e-5
TINY = dict(n_embd=128, n_head=4, n_layer=2, vocab_size=311, n_positions=256)
# A Llama (`llama_config_to_gpt2_config`'s options) at the tiny widths.
LLAMA = dict(n_head_kv=2, rms_norm=True, rotary_emb_fraction=1.0,
             rotary_emb_interleaved=True, rotary_emb_base=500000.0,
             activation_function="swiglu", n_inner=344,
             tie_word_embeddings=False, qkv_proj_bias=False,
             out_proj_bias=False, mlp_fc1_bias=False, mlp_fc2_bias=False)


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
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


def seeded_params(init, *args, seed=0):
    """JAX's parameter tree for `init(*args)`, filled from numpy: norm
    weights 1 + N(0, 0.1), other vectors N(0, 0.02), matrices N(0, 0.05)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, x):
        v = rng.standard_normal(x.shape).astype(np.float32)
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if x.ndim == 1 and ("norm" in name or "ln_f" in name) \
                and name.endswith("weight"):
            return 1 + 0.1 * v
        return v * (0.02 if x.ndim == 1 else 0.05)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


def build_pair(extra, seed):
    """The JAX model (XLA reference attention) and the port's model of the
    tiny config with `extra` options, on the same seeded weights."""
    jm = JaxGPT(jax_config(use_flash_attn=False, **extra), dtype=jnp.float32)
    params = seeded_params(jm.init, jnp.zeros((1, 4), jnp.int32), seed=seed)
    cfg = GPTConfig(**TINY, **extra)
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params, cfg))
    return jm, params, port.eval()


# ------------------------------------------------------------ RMSNorm

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm_module_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    mod = RMSNorm(64, eps=1e-5, device="cpu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
    xt = torch.from_numpy(x).to(tdt)
    ref = JaxRMSNorm(64, eps=1e-5)(jnp.asarray(x).astype(jdt),
                                   weight=jnp.asarray(w))
    tol = (dict(atol=1e-5, rtol=0) if dtype is np.float32
           else dict(atol=1e-6, rtol=2 ** -7))
    for out in (mod(xt), rms_norm_fn(xt, mod.weight, 1e-5)):
        assert out.dtype == tdt
        np.testing.assert_allclose(out.detach().float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)), **tol)


# --------------------------------------------------------- MHA rotary

# (rotary dim of d = 32, interleaved, kv heads, xPos scale base, packed)
MHA_CASES = {
    "full_rotate_half_gqa": (32, False, 2, None, False),
    "partial_interleaved_mqa": (16, True, 1, None, False),
    "partial_rotate_half_mha": (8, False, 4, None, False),
    "full_interleaved_gqa_xpos": (32, True, 2, 64.0, False),
    "packed_interleaved_gqa": (32, True, 2, None, True),
}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_mha_rotary_matches_jax(case):
    """One causal MHA layer with rotary: full and partial, interleaved and
    rotate-half, GQA, MQA and MHA, xPos, and the packed `cu_seqlens` branch
    (JAX's varlen kernel in interpret mode), which JAX rotates by stream
    position: the port must do the same."""
    rd, interleaved, hk, scale_base, packed = MHA_CASES[case]
    kw = dict(num_heads_kv=hk, rotary_emb_dim=rd, rotary_emb_base=10000.0,
              rotary_emb_scale_base=scale_base,
              rotary_emb_interleaved=interleaved, causal=True)
    jm = JaxMHA(embed_dim=128, num_heads=4, use_flash_attn=packed, **kw)
    rng = np.random.default_rng(1)
    if packed:
        x = rng.standard_normal((1, 40, 128)).astype(np.float32)
        cu = np.array([0, 11, 29, 40], np.int32)
        extra = dict(cu_seqlens=cu, max_seqlen=18)
    else:
        x = rng.standard_normal((2, 24, 128)).astype(np.float32)
        extra = {}
    params = seeded_params(jm.init, jnp.asarray(x[:, :8]), seed=2)
    jextra = {k: jnp.asarray(v) if k == "cu_seqlens" else v
              for k, v in extra.items()}
    ref = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, **jextra))(
        params, jnp.asarray(x)))
    port = MHA(128, 4, device="cpu", **kw)
    p = params["params"]
    port.load_state_dict({
        f"{n}.{t}": torch.from_numpy(np.array(p[n][j].T if j == "kernel"
                                              else p[n][j]))
        for n in ("Wqkv", "out_proj")
        for t, j in (("weight", "kernel"), ("bias", "bias"))})
    textra = {k: torch.from_numpy(v) if k == "cu_seqlens" else v
              for k, v in extra.items()}
    with torch.no_grad():
        out = port(torch.from_numpy(x), **textra).numpy()
    np.testing.assert_allclose(out, ref, atol=MHA_ATOL, rtol=0)


# ------------------------------------------------ the model's options

MODEL_OPTIONS = {
    "llama": LLAMA,
    # Falcon-7B's block: one tied norm, multi-query, rotate-half
    "parallel_tied_mqa": dict(parallel_block=True,
                              parallel_block_tied_norm=True, n_head_kv=1,
                              rotary_emb_fraction=1.0, qkv_proj_bias=False),
    # GPT-NeoX's block: two norms, partial rotary, residual in float32
    "parallel_untied_partial": dict(parallel_block=True,
                                    rotary_emb_fraction=0.25,
                                    residual_in_fp32=True),
}


@pytest.mark.parametrize("option", list(MODEL_OPTIONS))
def test_model_options_match_jax(option):
    """The no-cache logits of the tiny model as a Llama (RMSNorm, full
    interleaved rotary at base 5e5, GQA, SwiGLU, untied head, no biases)
    and with tied and untied parallel blocks."""
    extra = MODEL_OPTIONS[option]
    jm, params, port = build_pair(extra, seed=3)
    assert isinstance(port.transformer.layers[0], ParallelBlock) == (
        "parallel" in option)
    assert port.transformer.embeddings.wpe is None  # no positions: rotary
    ids = np.random.default_rng(4).integers(0, 311, (2, 24)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, x: jm.apply(p, x).logits)(
        params, jnp.asarray(ids)))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long()).logits.numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL, rtol=0)


@pytest.fixture(scope="module")
def llama_pair():
    return build_pair(LLAMA, seed=5)


def test_llama_cached_prefill_and_decode_match_jax(llama_pair):
    """A prefill of 17 tokens (the prefill kernel: s > 16), then 3 one-token
    decode steps, against JAX's cached forward (its prefill and decode
    kernels in interpret mode): logits and the live cache rows, rotated
    at each row's own positions, at every step."""
    jm, params, port = llama_pair
    ids = np.random.default_rng(6).integers(0, 311, (2, 20)).astype(np.int32)
    b, smax = 2, 32
    jip = JaxInferenceParams(max_seqlen=smax, max_batch_size=b,
                             lengths_per_sample=jnp.zeros((b,), jnp.int32))
    tip = InferenceParams(max_seqlen=smax, max_batch_size=b,
                          lengths_per_sample=torch.zeros(b, dtype=torch.int32))

    @jax.jit
    def jstep(p, x, ip):
        out = jm.apply(p, x, inference_params=ip)
        return out.logits, out.inference_params

    for x in [ids[:, :17]] + [ids[:, 17 + i:18 + i] for i in range(3)]:
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
                assert tuple(tc.shape) == (b, 2, smax, 32)  # hk = 2 heads
                np.testing.assert_allclose(tc[:, :, :n].numpy(),
                                           np.asarray(jc)[:, :, :n],
                                           atol=KV_ATOL, rtol=0)


def test_rotary_tables_are_built_once_a_model(llama_pair):
    """Every layer shares the model's one table; a forward neither
    rebuilds nor copies it."""
    port = llama_pair[2]
    rot = port.transformer.rotary_emb
    assert all(layer.mixer.rotary_emb is rot
               for layer in port.transformer.layers)
    with torch.no_grad():
        port(torch.zeros((1, 9), dtype=torch.long))
    cos = rot._cos
    with torch.no_grad():
        port(torch.zeros((1, 5), dtype=torch.long))
    assert rot._cos is cos and cos.shape[0] >= 9 and cos.shape[1] == 16


# ------------------------------------------------------------ serving

PROMPT_LENS = (7, 19, 33)
MAX_NEW = (6, 11, 9)
NEAR_TIE = 1e-4


def engine(port):
    return ServingEngine(port, max_batch=2, max_seqlen=128, chunk_steps=4,
                         prefill_buckets=(16, 32, 64))


def test_engine_greedy_on_a_llama_matches_jax(llama_pair):
    """Two waves (the third request waits for a slot), each prompt
    right-padded to its bucket at lengths 0: JAX's no-cache logits,
    teacher-forced on the engine's tokens, must pick each of them."""
    jm, params, port = llama_pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 311, (n,)) for n in PROMPT_LENS]
    eng = engine(port)
    uids = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, MAX_NEW)]
    results = eng.run()
    assert eng.stats.finished == 3 and eng.stats.prefill_waves == 2
    jlogits = jax.jit(lambda p, x: jm.apply(p, x).logits)
    for uid, p, m in zip(uids, prompts, MAX_NEW):
        toks = results[uid]
        assert len(toks) == m
        seq = np.concatenate([p, toks[:-1]]).astype(np.int32)
        rows = np.asarray(jlogits(params, jnp.asarray(seq)[None]))[0][
            len(p) - 1:]
        for row, t in zip(rows, toks):
            order = np.argsort(-row)
            assert t == order[0] or (
                t == order[1] and row[order[0]] - row[order[1]] < NEAR_TIE)


def test_engine_keeps_rows_at_their_positions(llama_pair):
    """After serving, a slot's cached K rows 0 .. len - 1 are the rows a
    forward of its whole sequence (prompt and tokens, unpadded) caches:
    the padded bucket's tail, rotated at positions past the prompt, was
    overwritten before it was read."""
    port = llama_pair[2]
    prompt = np.random.default_rng(8).integers(0, 311, (19,))
    eng = engine(port)
    uid = eng.submit(prompt, max_new_tokens=7)
    toks = eng.run()[uid]
    n = len(prompt) + len(toks) - 1  # the last token is not yet cached
    ip = InferenceParams(max_seqlen=128, max_batch_size=1,
                         lengths_per_sample=torch.zeros(1, dtype=torch.int32))
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]))[None]
    with torch.no_grad():
        port(seq, inference_params=ip)
    for li in range(TINY["n_layer"]):
        for served, ref in zip(eng.cache.key_value_memory_dict[li],
                               ip.key_value_memory_dict[li]):
            np.testing.assert_allclose(served[0, :, :n].numpy(),
                                       ref[0, :, :n].numpy(), atol=KV_ATOL,
                                       rtol=0)
