"""The served batch, and where its time goes on the card.

    python -m flash_attn_tpu_torch.serve_profile [--model llama3_8b|gptj_6b]

`serve_batch` defines the one serving traffic that both this profile and
`chip_smoke.py`'s serve phases drive: `ServingEngine` with 8 slots, and 16
requests of seeded prompt length 16-480, 64 new tokens each, two of them
sampled with top-k 20 at temperature 0.8.  The models, random weights from
a seed, bfloat16: `gpt2_small` (GPT-2 124M, the `serve` phase),
`llama3_8b` (Meta-Llama-3-8B's widths at a cut depth, the `llama_serve`
phase) and `gptj_6b` (GPT-J-6B, head dim 256, the `gptj_serve` phase).
`gptj_6b` in float32 and `btlm_3b` (BTLM-3B-8K: ALiBi, muP, head dim 80)
are also the models of `chip_smoke.py`'s `gptj_train` and `btlm_train`.

Run as a script, it serves that batch once to warm up, once timed without the
profiler and once under `torch.profiler`, and prints one JSON line: the wall
seconds of both runs, device busy seconds (the union of the profiled kernel
intervals), the device's idle share against the unprofiled wall (the
profiler slows the host, not the kernels), and device time by kernel name,
largest first.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np
import torch

from flash_attn_tpu_torch.models.btlm import btlm_config_to_gpt2_config
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.models.gptj import gptj_config_to_gpt2_config
from flash_attn_tpu_torch.models.llama import llama_config_to_gpt2_config
from flash_attn_tpu_torch.serving import ServingEngine

REQUESTS = 16
MAX_NEW_TOKENS = 64
SAMPLED = (5, 11)  # request indices drawn with top_k=20, temperature=0.8


def gpt2_small(seed: int = 0) -> GPTLMHeadModel:
    """OpenAI GPT-2 124M (HF `gpt2` config.json), random N(0, 0.02) weights,
    bfloat16, on CUDA."""
    cfg = GPTConfig(n_embd=768, n_head=12, n_layer=12, n_inner=3072,
                    vocab_size=50257, n_positions=1024,
                    activation_function="gelu_new", layer_norm_epsilon=1e-5)
    model = GPTLMHeadModel(cfg, dtype=torch.bfloat16)
    return model.init_weights(torch.Generator().manual_seed(seed)).eval()


# Meta-Llama-3-8B's published config (HF meta-llama/Meta-Llama-3-8B
# config.json), with its Hugging Face attribute names.
LLAMA3_8B = types.SimpleNamespace(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=8192,
    initializer_range=0.02, bos_token_id=128000, eos_token_id=128001,
    tie_word_embeddings=False)


def llama3_8b(seed: int = 0, n_layer: int = 8) -> GPTLMHeadModel:
    """Meta-Llama-3-8B's widths through `llama_config_to_gpt2_config`, cut
    to `n_layer` of its 32 layers, random N(0, 0.02) weights drawn on the
    card from `seed`, bfloat16, on CUDA."""
    cfg = llama_config_to_gpt2_config(LLAMA3_8B)
    cfg.n_layer = n_layer
    model = GPTLMHeadModel(cfg, dtype=torch.bfloat16)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model.init_weights(gen).eval()


# EleutherAI/gpt-j-6b's published config (HF config.json), with its Hugging
# Face attribute names: head dim 4096 / 16 = 256, 64 of them rotated.
GPTJ_6B = types.SimpleNamespace(
    vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28, n_head=16,
    rotary_dim=64, n_inner=None, activation_function="gelu_new",
    layer_norm_epsilon=1e-5, resid_pdrop=0.0, embd_pdrop=0.0,
    attn_pdrop=0.0, initializer_range=0.02, bos_token_id=50256,
    eos_token_id=50256, tie_word_embeddings=False)


def gptj_6b(seed: int = 0, n_layer: int = 28,
            dtype=torch.bfloat16) -> GPTLMHeadModel:
    """GPT-J-6B through `gptj_config_to_gpt2_config`, at `n_layer` of its
    28 layers, random N(0, 0.02) weights drawn on the card from `seed`, in
    `dtype` (float32 to train under autocast), on CUDA."""
    cfg = gptj_config_to_gpt2_config(GPTJ_6B)
    cfg.n_layer = n_layer
    model = GPTLMHeadModel(cfg, dtype=dtype)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model.init_weights(gen).eval()


# cerebras/btlm-3b-8k-base's published config (HF config.json), with its
# Hugging Face attribute names: head dim 2560 / 32 = 80, SwiGLU, ALiBi, and
# muP (softmax scale 1 / 80, logits times 2.22 * 0.1).
BTLM_3B_8K = types.SimpleNamespace(
    vocab_size=50257, n_positions=8192, n_embd=2560, n_layer=32, n_head=32,
    n_inner=6826, activation_function="swiglu", resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, layer_norm_epsilon=1e-5,
    initializer_range=0.02, bos_token_id=50256, eos_token_id=50256,
    position_embedding_type="alibi", mup_width_scale=0.1,
    mup_embeddings_scale=14.6, mup_output_alpha=2.22,
    mup_scale_qk_dot_by_d=True)


def btlm_3b(seed: int = 0, n_layer: int = 32,
            dtype=torch.bfloat16) -> GPTLMHeadModel:
    """BTLM-3B-8K through `btlm_config_to_gpt2_config`, at `n_layer` of its
    32 layers, random N(0, 0.02) weights drawn on the card from `seed`, in
    `dtype`, on CUDA."""
    cfg = btlm_config_to_gpt2_config(BTLM_3B_8K)
    cfg.n_layer = n_layer
    model = GPTLMHeadModel(cfg, dtype=dtype)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model.init_weights(gen).eval()


MODELS = {"gpt2_small": gpt2_small, "llama3_8b": llama3_8b,
          "gptj_6b": gptj_6b}


def engine(model, seed: int = 0) -> ServingEngine:
    return ServingEngine(model, max_batch=8, max_seqlen=1024, chunk_steps=8,
                         prefill_buckets=(64, 128, 256, 512),
                         generator=torch.Generator(device=model.device)
                         .manual_seed(seed))


def warm_up(model, seed: int = 0):
    """One short request: library handles and the allocator, not timed."""
    eng = engine(model, seed)
    rng = np.random.default_rng(seed)
    eng.submit(rng.integers(0, model.config.vocab_size, 32), max_new_tokens=9)
    eng.run()
    torch.cuda.synchronize()


def serve_batch(model, seed: int = 0):
    """A fresh engine with the batch submitted and not yet run.
    Returns (engine, prompts, uids)."""
    eng = engine(model, seed)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, 481, REQUESTS)
    prompts = [rng.integers(0, model.config.vocab_size, n) for n in lengths]
    uids = []
    for i, p in enumerate(prompts):
        sampling = dict(top_k=20, temperature=0.8) if i in SAMPLED else {}
        uids.append(eng.submit(p, max_new_tokens=MAX_NEW_TOKENS, **sampling))
    return eng, prompts, uids


def timed_run(eng):
    """eng.run() ended by a device sync; returns (results, wall seconds)."""
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def busy_seconds(events) -> float:
    """Length of the union of the device kernel intervals, in seconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6  # profiler times are in microseconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=list(MODELS), default="gpt2_small")
    model = MODELS[ap.parse_args().model]()
    warm_up(model)
    eng, _, _ = serve_batch(model)
    _, wall = timed_run(eng)
    eng, _, _ = serve_batch(model)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, profiled_wall = timed_run(eng)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = busy_seconds(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    stats = eng.stats
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "layers": model.config.n_layer, "wall_s": wall,
        "profiled_wall_s": profiled_wall,
        "generated_tokens": stats.generated_tokens,
        "decode_steps": stats.decode_steps,
        "prefill_waves": stats.prefill_waves,
        "device_kernels": len(kernels), "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "kernel_s_by_name": {k[:80]: v * 1e-6 for k, v in top},
    }))


if __name__ == "__main__":
    main()
