"""The served batch of GPT-2 small, and where its time goes on the card.

    python -m flash_attn_tpu_torch.serve_profile

`gpt2_small` and `serve_batch` define the one serving run that both this
profile and `chip_smoke.py`'s serve phase drive: GPT-2 small (124M, random
weights from a seed, bfloat16), `ServingEngine` with 8 slots, and 16 requests
of seeded prompt length 16-480, 64 new tokens each, two of them sampled with
top-k 20 at temperature 0.8.

Run as a script, it serves that batch once to warm up, once timed without the
profiler and once under `torch.profiler`, and prints one JSON line: the wall
seconds of both runs, device busy seconds (the union of the profiled kernel
intervals), the device's idle share against the unprofiled wall (the
profiler slows the host, not the kernels), and device time by kernel name,
largest first.  Needs CUDA.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
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
    model = gpt2_small()
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
        "device": torch.cuda.get_device_name(0), "wall_s": wall,
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
