#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds both CUDA kernels from `flash_attn_tpu_torch/csrc/`, holds each
against its plain PyTorch version at the serving path's shapes (and a few
more), times kernel, plain version and a PyTorch library call beside the
card's bound, then serves GPT-2 small (124M, random weights from a seed) at
full width and depth through `ServingEngine` and checks that the path went
through both kernels and that greedy tokens agree with an fp32 CPU
reference.  Prints one JSON line per phase, the kernel summary, the card's
name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
L2_BYTES = 50 * 2**20  # H100 SXM L2


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def input_copies(*tensors):
    """`tensors` and enough clones of them that calls made on each set in
    turn find none of their inputs in the L2 (together they hold at least
    four times its size), as in serving, where each layer's cache is read
    once per step.  Returns a list of tuples."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-4 * L2_BYTES // size))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def time_ms(fn, args, iters=20, warmup=3):
    """Median device time of one fn(*args[j]) call, from CUDA events
    recorded between `iters` calls issued back to back, after `warmup`
    calls; call j takes the input set args[j % len(args)].

    A spin kernel (`torch.cuda._sleep`) holds the stream while the host
    queues every call, so the host's own time per call (Python, argument
    checks, launch) does not show up as device time; the spin is lengthened
    until the host has queued everything before it ends."""
    import torch

    j = 0
    for _ in range(warmup):
        fn(*args[j % len(args)])
        j += 1
    torch.cuda.synchronize()
    cycles = 10_000_000
    for _ in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 2)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*args[j % len(args)])
            j += 1
            ev[i + 2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            times = sorted(ev[i + 1].elapsed_time(ev[i + 2])
                           for i in range(iters))
            return times[iters // 2]
        cycles *= 4
    raise RuntimeError("the host could not queue the calls ahead of the card")


def call_ms(fn, args, iters=20, warmup=3):
    """Median time of one fn(*args[j]) call issued alone on an idle stream
    (CUDA events around it): the device time plus the host's time to
    launch.  Less `time_ms`, it gives the host's cost per call, which the
    eager decode loop pays once per layer and step."""
    import torch

    for j in range(warmup):
        fn(*args[j % len(args)])
    times = []
    for j in range(warmup, warmup + iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args[j % len(args)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check_attention(name, o, lse, o_ref, lse_ref, o_pt, lse_pt, rows_ok):
    """Tolerance rule on valid rows: |kernel - fp32| <= 2 |bf16 plain -
    fp32| + 1e-5 for o and for the finite lse; +inf lse where the fp32
    reference has it."""
    import torch
    from flash_attn_tpu_torch.utils.testing import check_close

    sel = rows_ok[..., None].expand_as(o)
    err_o, err_o_pt = check_close(o[sel], o_ref[sel], o_pt[sel],
                                  label=f"{name} o")
    inf_ref = torch.isinf(lse_ref) & rows_ok
    if not torch.equal(torch.isinf(lse) & rows_ok, inf_ref):
        raise AssertionError(f"{name}: +inf lse rows differ from reference")
    fin = rows_ok & ~inf_ref
    err_l, err_l_pt = check_close(lse[fin], lse_ref[fin], lse_pt[fin],
                                  label=f"{name} lse")
    return err_o, err_o_pt, err_l, err_l_pt


def fwd_case(label, b, h, hk, sq, sk, d, seqused_q, seqused_k, gen,
             causal=True, window=(-1, -1), softcap=0.0, alibi=False,
             library=None):
    import torch
    from flash_attn_tpu_torch.kernels import flash_fwd as ff

    dev = "cuda"
    q = torch.randn(b, h, sq, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, hk, sk, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, hk, sk, d, generator=gen, device=dev).bfloat16()
    squ = torch.tensor(seqused_q, dtype=torch.int32, device=dev)
    sku = torch.tensor(seqused_k, dtype=torch.int32, device=dev)
    slopes = (torch.rand(b, h, generator=gen, device=dev) * 0.3
              if alibi else None)
    kw = dict(softmax_scale=d ** -0.5, causal=causal, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    o, lse = ff.flash_attn_fwd_bhsd(q, k, v, squ, sku, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = ff.flash_attn_fwd_bhsd_ref(
        q.float(), k.float(), v.float(), squ, sku, **kw)
    o_pt, lse_pt = ff.flash_attn_fwd_bhsd_ref(q, k, v, squ, sku, **kw)
    rows_ok = (torch.arange(sq, device=dev)[None, None, :]
               < squ[:, None, None]).expand(b, h, sq)
    err_o, err_o_pt, err_l, err_l_pt = check_attention(
        label, o, lse, o_ref, lse_ref, o_pt, lse_pt, rows_ok)

    # live (row, key) pairs from the same masks, rows < seqused_q only
    wl, wr = ff.normalize_window(window, causal, sk)
    has_upper, wr, has_lower, wl = ff.mask_params(causal, wl, wr)
    rows = torch.arange(sq, device=dev).view(1, sq, 1)
    cols = torch.arange(sk, device=dev).view(1, 1, sk)
    sk_b = sku.long().view(b, 1, 1)
    offset = sk_b - squ.long().view(b, 1, 1)
    live = (cols < sk_b) & (rows < squ.long().view(b, 1, 1))
    if has_upper:
        live &= cols <= rows + offset + wr
    if has_lower:
        live &= cols >= rows + offset - wl
    pairs = int(live.sum()) * h
    flops = 4 * d * pairs
    elt = 2
    bytes_ = (b * h * sq * d * elt            # q
              + 2 * hk * d * elt * int(sku.clamp(max=sk).sum())  # live k, v
              + b * h * sq * d * elt + b * h * sq * 4)           # o, lse
    bound_ms = max(flops / PEAK_FLOPS, bytes_ / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_FLOPS >= bytes_ / PEAK_BYTES \
        else "bytes"
    args = input_copies(q, k, v, squ, sku)
    before = ff.launches
    kernel_ms = time_ms(lambda *a: ff.flash_attn_fwd_bhsd(*a, **kw), args)
    kernel_call_ms = call_ms(lambda *a: ff.flash_attn_fwd_bhsd(*a, **kw),
                             args)
    plain_ms = time_ms(lambda *a: ff.flash_attn_fwd_bhsd_ref(*a, **kw), args)
    ff.launches = before  # timing launches are not the main path's
    library_ms = None
    if library is not None:
        library_ms = time_ms(library, input_copies(q, k, v, live))
    res = dict(phase="kernel_fwd", case=label, b=b, h=h, hk=hk, sq=sq, sk=sk,
               d=d, causal=causal, window=list(window), softcap=softcap,
               alibi=alibi, max_abs_err_o=err_o, plain_bf16_err_o=err_o_pt,
               max_abs_err_lse=err_l, plain_bf16_err_lse=err_l_pt,
               kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms, flops=flops,
               bytes=bytes_, share_of_bound=bound_ms / kernel_ms)
    emit(res)
    return res


def sdpa_masked(q, k, v, live):
    import torch.nn.functional as F

    # live (b, sq, sk) as a (b, 1, sq, sk) mask, True = attend
    return F.scaled_dot_product_attention(q, k, v, attn_mask=live[:, None])


def sdpa_causal(q, k, v, live):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def decode_case(label, b, h, hk, sq, smax, d, gen, num_splits=1,
                library=False):
    import torch
    import torch.nn.functional as F
    from flash_attn_tpu_torch.kernels import flash_decode as fd

    dev = "cuda"
    q = torch.randn(b, h, sq, d, generator=gen, device=dev).bfloat16()
    kc = torch.randn(b, hk, smax, d, generator=gen, device=dev).bfloat16()
    vc = torch.randn(b, hk, smax, d, generator=gen, device=dev).bfloat16()
    lens = torch.randint(17, smax + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    kw = dict(softmax_scale=d ** -0.5, causal=True, num_splits=num_splits)
    o, lse = fd.decode_attn_bhsd(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = fd.decode_attn_bhsd_ref(q.float(), kc.float(),
                                             vc.float(), lens, **kw)
    o_pt, lse_pt = fd.decode_attn_bhsd_ref(q, kc, vc, lens, **kw)
    rows_ok = torch.ones(b, h, sq, dtype=torch.bool, device=dev)
    err_o, err_o_pt, err_l, err_l_pt = check_attention(
        label, o, lse, o_ref, lse_ref, o_pt, lse_pt, rows_ok)
    elt = 2
    live_rows = int(lens.sum())
    bytes_ = 2 * hk * d * elt * live_rows + 2 * b * h * sq * d * elt
    flops = 4 * d * h * sq * live_rows
    bound_ms = max(bytes_ / PEAK_BYTES, flops / PEAK_FLOPS) * 1e3
    args = input_copies(q, kc, vc, lens)
    before = fd.launches
    kernel_ms = time_ms(lambda *a: fd.decode_attn_bhsd(*a, **kw), args)
    kernel_call_ms = call_ms(lambda *a: fd.decode_attn_bhsd(*a, **kw), args)
    plain_ms = time_ms(lambda *a: fd.decode_attn_bhsd_ref(*a, **kw), args)
    fd.launches = before
    library_ms = None
    if library:
        mask = (torch.arange(smax, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        library_ms = time_ms(
            lambda *a: F.scaled_dot_product_attention(*a[:3], attn_mask=a[3]),
            input_copies(q, kc, vc, mask))
    num_splits_eff = fd.split_layout(smax, num_splits, None)[0]
    res = dict(phase="kernel_decode", case=label, b=b, h=h, hk=hk, sq=sq,
               smax=smax, d=d, num_splits=num_splits,
               cache_seqlens=lens.tolist(), max_abs_err_o=err_o,
               plain_bf16_err_o=err_o_pt, max_abs_err_lse=err_l,
               plain_bf16_err_lse=err_l_pt, kernel_ms=kernel_ms,
               kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
               bound_ms=bound_ms,
               bound_by="bytes" if bytes_ / PEAK_BYTES >= flops / PEAK_FLOPS
               else "operations",
               library_ms=library_ms, bytes=bytes_,
               share_of_bound=bound_ms / kernel_ms,
               blocks=b * hk * num_splits_eff,
               sm_fill=b * hk * num_splits_eff / 132)
    emit(res)
    return res


def serve_phase(gen_seed=0):
    import numpy as np
    import torch
    from flash_attn_tpu_torch.kernels import flash_decode as fd
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel
    from flash_attn_tpu_torch.serve_profile import (MAX_NEW_TOKENS,
                                                    gpt2_small, serve_batch,
                                                    timed_run, warm_up)

    model = gpt2_small(gen_seed)  # OpenAI GPT-2 124M, bf16, on CUDA
    cfg = model.config
    warm_up(model, gen_seed)
    eng, prompts, uids = serve_batch(model, gen_seed)
    torch.cuda.reset_peak_memory_stats()
    ff.launches = 0
    fd.launches = 0
    results, wall = timed_run(eng)
    fwd_launches, dec_launches = ff.launches, fd.launches
    st = eng.stats
    res = dict(phase="serve", model="gpt2-124M (random weights, seed 0)",
               dtype="bfloat16", requests=len(prompts),
               finished=st.finished, prefill_waves=st.prefill_waves,
               prefill_tokens=st.prefill_tokens,
               generated_tokens=st.generated_tokens,
               decode_steps=st.decode_steps, wall_s=wall,
               generated_tok_per_s=st.generated_tokens / wall,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               flash_fwd_launches=fwd_launches,
               flash_decode_launches=dec_launches)
    if st.finished != len(prompts):
        raise AssertionError(f"finished {st.finished} of {len(prompts)}")
    for u in uids:
        if len(results[u]) != MAX_NEW_TOKENS:
            raise AssertionError(f"request {u}: {len(results[u])} tokens")
    if fwd_launches != st.prefill_waves * cfg.n_layer:
        raise AssertionError(f"flash_fwd launches {fwd_launches} != "
                             f"{st.prefill_waves} waves x {cfg.n_layer}")
    if dec_launches != st.decode_steps * cfg.n_layer:
        raise AssertionError(f"flash_decode launches {dec_launches} != "
                             f"{st.decode_steps} steps x {cfg.n_layer}")

    # Greedy tokens against the same weights in fp32 on the CPU (the plain
    # path), teacher-forced on the engine's own tokens.
    ref = GPTLMHeadModel(cfg, device="cpu", dtype=torch.float32)
    ref.load_state_dict({k: v.float().cpu()
                         for k, v in model.state_dict().items()})
    gaps, stds = [], []
    for i in (0, 1):
        toks = results[uids[i]]
        seq = torch.as_tensor(np.concatenate([prompts[i], toks[:-1]]))[None]
        with torch.no_grad():
            logits = ref(seq).logits[0, len(prompts[i]) - 1:].float()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite reference logits")
        picked = logits[torch.arange(len(toks)), torch.as_tensor(toks)]
        gaps.append(float((logits.max(dim=-1).values - picked).max()))
        stds.append(float(logits.std(dim=-1).mean()))
    res.update(greedy_max_logit_gap=max(gaps), ref_logit_std=sum(stds) / 2,
               greedy_margin=SERVE_MARGIN)
    emit(res)
    if max(gaps) > SERVE_MARGIN:
        raise AssertionError(f"greedy token logit gap {max(gaps):.4f} > "
                             f"margin {SERVE_MARGIN}")
    return res


# An engine token passes when its fp32 reference logit is within this margin
# of the reference maximum.  The bf16 engine rounds every activation to 8
# significant bits through 12 layers; at these random weights the reference
# logits have a standard deviation of about 0.55, so a wrong token picked by
# a broken kernel sits about one standard deviation or more below the
# maximum, while bf16 noise moves logits by a few thousandths.  0.05 (about a
# tenth of that deviation) separates the two.
SERVE_MARGIN = 0.05


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from flash_attn_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    info = _build.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              kernels=info))

    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd = {}
    fwd["a"] = fwd_case("a: serving prefill", 8, 12, 12, 512, 1024, 64,
                        [512] * 8, [512] * 8, gen, library=sdpa_masked)
    fwd["b"] = fwd_case("b: full-length causal", 2, 16, 16, 2048, 2048, 128,
                        [2048] * 2, [2048] * 2, gen, library=sdpa_causal)
    seqk = torch.randint(1, 1025, (2,), generator=gen, device="cuda").tolist()
    fwd["c"] = fwd_case("c: GQA ragged seqused_k", 2, 32, 8, 1024, 1024, 128,
                        [1024] * 2, seqk, gen)
    fwd["d"] = fwd_case("d: window+softcap+alibi", 2, 12, 12, 1024, 1024, 64,
                        [1024] * 2, [1024] * 2, gen, window=(256, 0),
                        softcap=30.0, alibi=True)
    fwd["e"] = fwd_case("e: seqused_k = 0", 2, 12, 12, 256, 256, 64,
                        [256, 256], [256, 0], gen)
    dec = {}
    dec["a"] = decode_case("a: serving decode", 8, 12, 12, 1, 1024, 64, gen,
                           library=True)
    dec["b"] = decode_case("b: GQA", 8, 32, 8, 1, 4096, 128, gen)
    dec["c"] = decode_case("c: sq = 4", 8, 12, 12, 4, 1024, 64, gen)
    dec["d"] = decode_case("d: num_splits = 4", 8, 12, 12, 1, 1024, 64, gen,
                           num_splits=4)

    serve = serve_phase()

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attn_tpu/kernels/flash_fwd.py:200",
             launches=serve["flash_fwd_launches"],
             max_abs_err=fwd["a"]["max_abs_err_o"], ms=fwd["a"]["kernel_ms"],
             plain_ms=fwd["a"]["plain_ms"], bound_ms=fwd["a"]["bound_ms"],
             bound_by=fwd["a"]["bound_by"],
             library_ms=fwd["a"]["library_ms"]),
        dict(name="flash_decode", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_decode.cu",
             replaces="flash_attn_tpu/kernels/flash_decode.py:117",
             launches=serve["flash_decode_launches"],
             max_abs_err=dec["a"]["max_abs_err_o"], ms=dec["a"]["kernel_ms"],
             plain_ms=dec["a"]["plain_ms"], bound_ms=dec["a"]["bound_ms"],
             bound_by=dec["a"]["bound_by"],
             library_ms=dec["a"]["library_ms"]),
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
