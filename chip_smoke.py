#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `flash_attn_tpu_torch/csrc/` (one `nvcc` per
source, all started together), holds each against its plain PyTorch version
at the shapes of the serving and training paths (and a few more), times
kernel, plain version and a PyTorch library call beside the card's bound.
Then it drives both main paths of the port at the full width and depth of
GPT-2 small (124M, random weights from a seed): it serves a batch through
`ServingEngine`, checking that greedy tokens agree with an fp32 CPU
reference, and it trains 20 steps through `training.trainer.Trainer` at the
JAX defaults (seq_len 1024, batch 8, bf16 autocast over fp32 weights),
checking finite losses from about ln(50257).  A further phase holds one
training step's gradients on the card against fp32 on the CPU and checks
that 30 steps on one batch bring its loss down.  The last path is the
paged KV-cache API at Llama-3-8B's attention widths: 16 decode steps of
its 32 layers through `flash_attn_with_kvcache` (rotary, append into 512
pages of 256 rows a layer), with bf16 and then int8 caches; the
`kernel_kvcache` cases before it hold the decode kernel against its plain
version on paged, fused, int8, fp8 and contiguous caches and a paged
chunked prefill, each plain version at the key split the kernel launched
(int8 also against the plain int8 version on the kernel's own 64-key
tiles, at one split and at that one).  The packed varlen kernels (the varlen modes of
`flash_fwd.cu` and `flash_bwd.cu`) are held against their plain versions
in `kernel_varlen` (cases (a)-(e)) and `kernel_varlen_bwd` (bitwise
deterministic), and the next path is BERT-base's encoder at full width and
depth (`bert`): 10 unpadded forwards of 64 sequences of 16-512 tokens
through `BertModel(unpad_varlen=True)`, against the padded path and fp32
on the CPU, and one gradient.  The dropout slice follows: the dense and
varlen kernels' dropout instantiations against their plain versions with
the same keep mask at GPT-2's, llama-1b's and ViT-B/16's training shapes
and on the BERT batch (`kernel_dropout` (i)-(iv), times with and without
dropout, SDPA with dropout as the library time), the kernels' own keep
masks read through o and dV against `dropout_keep` bit for bit
(`dropout_probe`), GPT-2 small trained 5 steps with attention dropout and
a 2-layer model's gradients against fp32 on the CPU (`dropout_gpt`), and
BERT-base unpadded with attention dropout (`dropout_bert`).  Then
programmable attention: the flex
kernels of `csrc/flex.cu` against their plain versions in `kernel_flex`
(cases (a)-(i): causal, sliding window, document mask through aux,
softcap, relative position, attn_bias, ragged lengths, the block-sparse
API, packed varlen) and `kernel_flex_bwd` (cases (a), (c)-(h), bitwise
deterministic), and the
`flex` path: forward and backward of Llama-3-8B's 32 attention layers
over an 8192-token packed sequence under the causal document mask.  The
LLaMA family follows: `llama_serve` serves the serve phase's batch with a
Llama at Meta-Llama-3-8B's widths (8 of its 32 layers, built through
`llama_config_to_gpt2_config`), greedy tokens against fp32 on the CPU;
`llama_train` trains the JAX package's llama-1b recipe (n_embd 2048, GQA
16 over 4, seq_len 2048, batch 8) at all 24 layers with block remat, an
EMA and an evaluation every 3 steps, reading a seeded .bin token shard,
then holds a 2-layer model's gradients at full width to fp32 on the CPU;
`remat_check` holds the gradients under each remat policy to those
without remat, orders their peak memory, and holds float16 autocast to
fp32 on the CPU; `vit_train` trains ViT-B/16 (imagenet-vit-b.yaml: 224
px, batch 64, synthetic images, device-side augmentation) after a
2-layer gradient check against fp32 on the CPU, and checkpoints it;
`eval_cli` runs `training.eval.main --checkpoint --ema` on that
checkpoint against `Trainer.evaluate(use_ema=True)`; `native_loader`
builds the C++ token loader with g++ and holds its rows to the memmap
dataset's and its order to the pinned one; `families` runs a cached
prefill and decode steps of Baichuan-7B, Pythia-1.4B, Falcon-7B and
StarCoderBase-1B at their published widths (2 layers each) against fp32
on the CPU.  The kernel cases at those paths' shapes are forward (g) and
(h), backward (e) and (f), and decode (e).  The last phase, `diag`, holds the diagnostic probes' kernels
(`csrc/diag_*.cu`) against their plain twins and runs the three probes
(`flash_attn_tpu_torch.diag`: the paged DMA stream, the decode-body ladder,
the varlen tick bisect) at the JAX scripts' full shapes.  The kernel launch
counts of each path are set to 0 just before it and read just after.  Prints one JSON line per phase, the kernel summary, the
card's name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_OPS_8BIT = 1979e12  # H100 SXM dense int8 / fp8 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
L2_BYTES = 50 * 2**20  # H100 SXM L2


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries `t_s`, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
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

    live = live_pairs(sq, sk, squ, sku, causal, window)
    pairs = int(live.sum()) * h
    flops = 4 * d * pairs
    elt = 2
    bytes_ = (b * h * sq * d * elt            # q
              + 2 * hk * d * elt * int(sku.clamp(max=sk).sum())  # live k, v
              + b * h * sq * d * elt + b * h * sq * 4)           # o, lse
    bound_ms, bound_by = bound(flops, bytes_)
    args = input_copies(q, k, v, squ, sku)
    before = ff.launches
    kernel_ms = time_ms(lambda *a: ff.flash_attn_fwd_bhsd(*a, **kw), args)
    kernel_call_ms = call_ms(lambda *a: ff.flash_attn_fwd_bhsd(*a, **kw),
                             args)
    kernel_device = kernel_device_ms(
        lambda *a: ff.flash_attn_fwd_bhsd(*a, **kw), args,
        ("flash_fwd_kernel",))["flash_fwd_kernel"]
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
               kernel_device_ms=kernel_device, rows=ff.fwd_rows(d),
               plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms, flops=flops,
               bytes=bytes_, share_of_bound=bound_ms / kernel_ms)
    emit(res)
    return res


def live_pairs(sq, sk, squ, sku, causal, window):
    """(b, sq, sk) bool: the (row, key) pairs the masks leave, on rows <
    seqused_q and keys < seqused_k (the kernels' own mask arithmetic)."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_fwd as ff

    b = squ.shape[0]
    wl, wr = ff.normalize_window(window, causal, sk)
    has_upper, wr, has_lower, wl = ff.mask_params(causal, wl, wr)
    rows = torch.arange(sq, device=squ.device).view(1, sq, 1)
    cols = torch.arange(sk, device=squ.device).view(1, 1, sk)
    sk_b = sku.long().clamp(max=sk).view(b, 1, 1)
    offset = sk_b - squ.long().view(b, 1, 1)
    live = (cols < sk_b) & (rows < squ.long().view(b, 1, 1))
    if has_upper:
        live &= cols <= rows + offset + wr
    if has_lower:
        live &= cols >= rows + offset - wl
    return live


def kernel_device_ms(fn, args, names, iters=20, attempts=3):
    """Median device time of each kernel whose name contains one of `names`,
    over `iters` calls fn(*args[j]) (cycling over the input sets), from
    `torch.profiler`'s device activity.  Returns {name: ms}.  The profiler
    may miss records now and then (19 of 20 were seen once, and once none
    of a kernel's 20 in a run that saw them all when repeated), so the
    median is over the records it kept, fewer than half of them may fail,
    and a window that keeps fewer is profiled again, up to `attempts`
    times."""
    import torch

    for j in range(3):
        fn(*args[j % len(args)])
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    for attempt in range(attempts):
        with torch.profiler.profile(activities=[cuda]) as prof:
            for j in range(iters):
                fn(*args[j % len(args)])
            torch.cuda.synchronize()
        seen = {name: sorted(e.time_range.elapsed_us() for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and name in e.name)
                for name in names}
        short = {name: len(t) for name, t in seen.items()
                 if len(t) < iters // 2}
        if not short:
            return {name: t[len(t) // 2] * 1e-3 for name, t in seen.items()}
    raise RuntimeError(f"profiler saw {short} launches in each of {attempts} "
                       f"windows, expected {iters} of each")


def bound(flops, bytes_, peak_flops=PEAK_FLOPS):
    """(bound ms, what bounds it) on the card's dense rate for the inputs'
    type (bf16 by default) and HBM rate."""
    t_ops, t_bytes = flops / peak_flops, bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_case(label, b, h, hk, sq, sk, d, seqused_q, seqused_k, gen,
             causal=True, window=(-1, -1), softcap=0.0, alibi=False,
             library=False, repeat=False):
    """The backward kernels against the plain version (fp32 oracle, bf16
    yardstick) on dq (rows < seqused_q), dk and dv; times of the whole
    backward, of each kernel (profiler; the dQ kernel's time includes the
    dO.O preprocess, which it forms), of the plain version and, with
    `library`, of SDPA's causal backward on the same inputs.  With
    `repeat`, a second call on the same inputs must be bitwise equal."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.utils.testing import check_close

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
    rows_ok = (torch.arange(sq, device=dev)[None, None, :]
               < squ[:, None, None]).expand(b, h, sq)
    # callers pass do = 0 on rows past seqused_q
    do = (torch.randn(b, h, sq, d, generator=gen, device=dev)
          * rows_ok[..., None]).bfloat16()
    before = ff.launches, fb.launches_dq, fb.launches_dkv
    o, lse = ff.flash_attn_fwd_bhsd(q, k, v, squ, sku, **kw)
    dq, dk, dv = fb.flash_attn_bwd_bhsd(do, q, k, v, o, lse, squ, sku, **kw)
    torch.cuda.synchronize()
    ref = fb.flash_attn_bwd_bhsd_ref(do.float(), q.float(), k.float(),
                                     v.float(), o.float(), lse, squ, sku, **kw)
    pt = fb.flash_attn_bwd_bhsd_ref(do, q, k, v, o, lse, squ, sku, **kw)
    sel = rows_ok[..., None].expand_as(dq)
    errs = {}
    for name, x, r, y, m in (("dq", dq, ref[0], pt[0], sel),
                             ("dk", dk, ref[1], pt[1], None),
                             ("dv", dv, ref[2], pt[2], None)):
        if m is not None:
            x, r, y = x[m], r[m], y[m]
        if not torch.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite {name}")
        errs[name] = check_close(x, r, y, label=f"{label} {name}")
    del ref, pt
    bitwise_repeat = None
    if repeat:
        again = fb.flash_attn_bwd_bhsd(do, q, k, v, o, lse, squ, sku, **kw)
        bitwise_repeat = all(torch.equal(x, y)
                             for x, y in zip((dq, dk, dv), again))
        if not bitwise_repeat:
            raise AssertionError(f"{label}: two runs differ")
    for i, n in enumerate(seqused_k):  # keys past seqused_k get no gradient
        if dk[i, :, n:].any() or dv[i, :, n:].any():
            raise AssertionError(f"{label}: dk/dv past seqused_k")
        if n == 0 and dq[i].any():
            raise AssertionError(f"{label}: dq of a row with no key")

    pairs = int(live_pairs(sq, sk, squ, sku, causal, window).sum()) * h
    elt = 2
    q_side = b * h * sq * d * elt      # q, o, do, dq each
    kv_side = b * hk * sk * d * elt    # k, v, dk, dv each
    stats = 2 * b * h * sq * 4         # lse, delta
    bound_ms, bound_by = bound(10 * d * pairs,
                               4 * q_side + 4 * kv_side + stats)
    dq_bound = bound(6 * d * pairs, 3 * q_side + 2 * kv_side + stats)
    dkv_bound = bound(8 * d * pairs, 2 * q_side + 4 * kv_side + stats)
    args = input_copies(do, q, k, v, o, lse, squ, sku)
    kernel_ms = time_ms(lambda *a: fb.flash_attn_bwd_bhsd(*a, **kw), args)
    dev_ms = kernel_device_ms(lambda *a: fb.flash_attn_bwd_bhsd(*a, **kw),
                              args, ("flash_bwd_dq_kernel",
                                     "flash_bwd_dkv_kernel"))
    # The plain backward issues ~45 kernels a call: 8 calls keep the host's
    # queue, which the timing fills while a spin kernel holds the card,
    # below CUDA's launch-queue depth.
    plain_ms = time_ms(lambda *a: fb.flash_attn_bwd_bhsd_ref(*a, **kw), args,
                       iters=8)
    ff.launches, fb.launches_dq, fb.launches_dkv = before  # not a main path
    library_ms = None
    if library:
        library_ms = sdpa_backward_ms(q, k, v, do, causal=causal)
    res = dict(phase="kernel_bwd", case=label, b=b, h=h, hk=hk, sq=sq, sk=sk,
               d=d, causal=causal, window=list(window), softcap=softcap,
               alibi=alibi, seqused_q=list(seqused_q),
               seqused_k=list(seqused_k),
               **{f"max_abs_err_{n}": e[0] for n, e in errs.items()},
               **{f"plain_bf16_err_{n}": e[1] for n, e in errs.items()},
               kernel_ms=kernel_ms,
               dq_kernel_ms=dev_ms["flash_bwd_dq_kernel"],
               dkv_kernel_ms=dev_ms["flash_bwd_dkv_kernel"],
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
               dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
               library_ms=library_ms, flops=10 * d * pairs,
               share_of_bound=bound_ms / kernel_ms,
               bitwise_repeat=bitwise_repeat, dq_items=fb.last_dq_items)
    emit(res)
    return res


def sdpa_backward_ms(q, k, v, do, causal=True):
    """Device time of the backward of `F.scaled_dot_product_attention(
    is_causal=causal)` on the same (b, h, s, d) inputs: one retained graph
    per input set, `torch.autograd.grad(out, (q, k, v), do,
    retain_graph=True)` timed.  A yardstick only: the port never calls
    it."""
    import torch
    import torch.nn.functional as F

    graphs = []
    gqa = k.shape[1] != q.shape[1]
    for qc, kc, vc, dc in input_copies(q, k, v, do):
        qc, kc, vc = (t.detach().requires_grad_() for t in (qc, kc, vc))
        out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=causal,
                                             enable_gqa=gqa)
        graphs.append((out, (qc, kc, vc), dc))
    return time_ms(lambda out, ins, dc: torch.autograd.grad(
        out, ins, dc, retain_graph=True), graphs)


def sdpa_masked(q, k, v, live):
    import torch.nn.functional as F

    # live (b, sq, sk) as a (b, 1, sq, sk) mask, True = attend
    return F.scaled_dot_product_attention(q, k, v, attn_mask=live[:, None])


def sdpa_full(q, k, v, live):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v)


def sdpa_causal(q, k, v, live):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=k.shape[1] != q.shape[1])


def decode_case(label, b, h, hk, sq, smax, d, gen, num_splits=0,
                block_k=None, library=False):
    import torch
    import torch.nn.functional as F
    from flash_attn_tpu_torch.kernels import flash_decode as fd

    dev = "cuda"
    q = torch.randn(b, h, sq, d, generator=gen, device=dev).bfloat16()
    kc = torch.randn(b, hk, smax, d, generator=gen, device=dev).bfloat16()
    vc = torch.randn(b, hk, smax, d, generator=gen, device=dev).bfloat16()
    lens = torch.randint(17, smax + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    kw = dict(softmax_scale=d ** -0.5, causal=True, num_splits=num_splits,
              block_k=block_k)
    o, lse = fd.decode_attn_bhsd(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    ns = fd.last_num_splits
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
    bound_ms, bound_by = bound(flops, bytes_)
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
            lambda *a: F.scaled_dot_product_attention(
                *a[:3], attn_mask=a[3], enable_gqa=hk != h),
            input_copies(q, kc, vc, mask))
    blocks = fd.row_tiles(h // hk * sq) * ns * b * hk
    res = dict(phase="kernel_decode", case=label, b=b, h=h, hk=hk, sq=sq,
               smax=smax, d=d, num_splits_requested=num_splits,
               num_splits=ns,
               cache_seqlens=lens.tolist(), max_abs_err_o=err_o,
               plain_bf16_err_o=err_o_pt, max_abs_err_lse=err_l,
               plain_bf16_err_lse=err_l_pt, kernel_ms=kernel_ms,
               kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, bytes=bytes_,
               share_of_bound=bound_ms / kernel_ms,
               blocks=blocks, sm_fill=blocks / fd.sm_count(q.device))
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


# The training runs: the JAX package's TrainConfig defaults (GPT-2 small,
# seq_len 1024, batch 8, bf16 autocast over fp32 weights, AdamW 6e-4 with a
# cosine schedule after 100 warmup steps, clip 1.0, synthetic tokens from
# seed 0).
TRAIN_STEPS = 20
TRAIN_WARMUP_STEPS = 2
PROFILE_STEPS = 3
EVAL_STEPS = 2
LN_VOCAB = 10.82490  # ln(50257): the loss of a uniform prediction


def train_config(**over):
    from flash_attn_tpu_torch.training.config import TrainConfig

    cfg = TrainConfig()
    cfg.trainer.resume = False
    cfg.trainer.log_every = 1
    cfg.trainer.eval_steps = EVAL_STEPS
    for key, val in over.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, val)
    return cfg


def train_phase():
    """Trainer.train() for TRAIN_STEPS steps after TRAIN_WARMUP_STEPS
    warm-up steps, kernel launches counted on those steps alone, then an
    evaluation counted apart."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.training.trainer import Trainer

    t = Trainer(train_config())
    n_layer = t.gpt_config.n_layer
    warm = [float(t.train_step(next(t.loader))[0])
            for _ in range(TRAIN_WARMUP_STEPS)]
    torch.cuda.synchronize()
    t.config.trainer.max_steps = t.step + TRAIN_STEPS
    logs = []
    torch.cuda.reset_peak_memory_stats()
    ff.launches = fb.launches_dq = fb.launches_dkv = 0
    t0 = time.perf_counter()
    t.train(log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(flash_fwd=ff.launches, flash_bwd_dq=fb.launches_dq,
                  flash_bwd_dkv=fb.launches_dkv)
    peak = torch.cuda.max_memory_allocated()
    ff.launches = fb.launches_dq = fb.launches_dkv = 0
    eval_loss = t.evaluate()
    eval_counts = dict(flash_fwd=ff.launches, flash_bwd_dq=fb.launches_dq,
                       flash_bwd_dkv=fb.launches_dkv)
    losses = warm + [m["loss"] for m in logs if "loss" in m]
    tflops = t.flops.flops_per_step * TRAIN_STEPS / wall / 1e12
    profile = profile_train_steps(t, PROFILE_STEPS, wall / TRAIN_STEPS)
    res = dict(phase="train", model="gpt2-124M (random weights, seed 0)",
               param_dtype="float32", compute_dtype="bfloat16",
               seq_len=t.config.data.seq_len,
               batch_size=t.config.data.batch_size, steps=TRAIN_STEPS,
               warmup_steps=TRAIN_WARMUP_STEPS, wall_s=wall,
               step_ms=wall / TRAIN_STEPS * 1e3,
               tokens_per_s=t.speed.tokens_per_step * TRAIN_STEPS / wall,
               model_tflops=tflops, share_of_989_tflops=tflops * 1e12
               / PEAK_FLOPS, flops_per_step=t.flops.flops_per_step,
               max_memory_allocated=peak, losses=losses,
               last_log=logs[-1], eval_loss=eval_loss,
               launches=counts, eval_launches=eval_counts, profile=profile)
    emit(res)
    want = n_layer * TRAIN_STEPS
    if counts != dict(flash_fwd=want, flash_bwd_dq=want, flash_bwd_dkv=want):
        raise AssertionError(f"train launches {counts}, expected {want} "
                             "of each kernel")
    if eval_counts != dict(flash_fwd=n_layer * EVAL_STEPS, flash_bwd_dq=0,
                           flash_bwd_dkv=0):
        raise AssertionError(f"eval launches {eval_counts}")
    if len(losses) != TRAIN_WARMUP_STEPS + TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses + [eval_loss]):
        raise AssertionError(f"losses {losses}, eval {eval_loss}")
    if abs(losses[0] - LN_VOCAB) > 0.5:
        raise AssertionError(f"first loss {losses[0]} not within 0.5 of "
                             f"ln(50257)")
    return res


def device_profiler():
    """A `torch.profiler` window that records the card's activity only:
    `profile_summary` reads nothing else, and the host ops' events took
    most of a window's time to collect (35 s of `llama_serve`'s window on
    an H100 machine's host)."""
    import torch

    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def profile_summary(prof, n, step_s, unit, share, match, top=10):
    """What a `torch.profiler` window over `n` steps (forwards) tells:
    device kernels and busy ms per step (the union of the kernel
    intervals), the device's idle share against the unprofiled step time
    `step_s`, the share of kernel time of kernels whose name contains
    `match`, and device ms per step by kernel name, largest first."""
    import torch
    from flash_attn_tpu_torch.serve_profile import busy_seconds

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = busy_seconds(kernels)
    total = sum(by_name.values())
    matched = sum(v for k, v in by_name.items() if match in k)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {f"device_kernels_per_{unit}": len(kernels) / n,
            f"device_busy_ms_per_{unit}": busy / n * 1e3,
            "device_idle_share": 1.0 - busy / (n * step_s),
            f"{share}_share_of_kernel_time": matched / total,
            f"kernel_ms_per_{unit}_by_name": {
                k[:80]: v / n * 1e-3 for k, v in ranked}}


def profile_train_steps(t, steps, step_s):
    """`steps` more train_steps under torch.profiler (after the main path's
    launch counts are read): device busy time per step (the union of the
    kernel intervals), the device's idle share against the unprofiled step
    time `step_s`, the attention kernels' share of kernel time, and device
    ms per step by kernel name, largest first."""
    import torch

    batches = [next(t.loader) for _ in range(steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with device_profiler() as prof:
        for batch in batches:
            t.train_step(batch)
        torch.cuda.synchronize()
    summary = profile_summary(prof, steps, step_s, "step", "attention",
                              "flash_")
    return dict(steps=steps, seconds=time.perf_counter() - t0, **summary)


def cosine(a, b):
    """Cosine of two flat vectors, in float64: over GPT-2's 124M gradient
    entries a float32 cosine is off by percents."""
    a, b = a.double(), b.double()
    return float(a @ b / (a.norm() * b.norm()))


def grads_of(t, batch):
    """One batch through the Trainer's loss and backward: (loss, {name:
    gradient}), the gradients cleared from the model."""
    loss = t.loss(batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in
             t.model.named_parameters()}
    t.optimizer.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_grads(card, cpu):
    """`card` (kernels, bf16 or fp16 autocast) and `cpu` (fp32, plain path),
    each (loss, {name: gradient}) of one batch on the same weights: the two
    losses, the cosine of the whole gradient and the least cosine of a
    matrix's, with its name."""
    import torch

    flat = [{n: g.float().cpu().flatten() for n, g in grads.items()}
            for _, grads in (card, cpu)]
    names = list(flat[0])
    cos_all = cosine(torch.cat([flat[0][n] for n in names]),
                     torch.cat([flat[1][n] for n in names]))
    cos_2d = {n: cosine(flat[0][n], flat[1][n]) for n, g in cpu[1].items()
              if g.ndim == 2}
    worst = min(cos_2d, key=cos_2d.get)
    return dict(loss_gpu=card[0], loss_cpu_fp32=cpu[0],
                loss_gap=abs(card[0] - cpu[0]), grad_cosine=cos_all,
                min_matrix_grad_cosine=cos_2d[worst],
                min_cosine_matrix=worst)


def card_vs_cpu_grads(gpu, cpu):
    """`compare_grads` of the Trainers `gpu` (on the card) and `cpu` (fp32
    on the CPU) on the CPU one's first batch."""
    batch = next(cpu.loader)
    return compare_grads(grads_of(gpu, batch), grads_of(cpu, batch))


def check_grads(label, res):
    if not (res["loss_gap"] <= 0.02 and res["grad_cosine"] >= 0.999
            and res["min_matrix_grad_cosine"] >= 0.99):
        raise AssertionError(f"{label}: card gradients disagree with fp32 "
                             "CPU")


def train_check_phase():
    """(1) One batch (b=1, s=1024) through the Trainer's loss and backward
    on the card (kernels, bf16 autocast) and in fp32 on the CPU (plain
    path), same weights: loss within 0.02, cosine of the whole gradient >=
    0.999 and of each matrix's >= 0.99.  (2) OVERFIT_STEPS train_steps on
    one repeated batch, constant schedule, no warmup: the loss falls by at
    least OVERFIT_DROP nats."""
    import torch
    from flash_attn_tpu_torch.training.trainer import Trainer

    gpu = Trainer(train_config(data__batch_size=1))
    cpu = Trainer(train_config(data__batch_size=1, model__dtype="float32"),
                  device="cpu")
    grads = card_vs_cpu_grads(gpu, cpu)
    del gpu, cpu

    t = Trainer(train_config(scheduler__name="constant",
                             scheduler__warmup_steps=0))
    one = next(t.loader)
    curve = [float(t.train_step(one)[0]) for _ in range(OVERFIT_STEPS)]
    del t
    torch.cuda.empty_cache()
    res = dict(phase="train_check", **grads, overfit_losses=curve,
               overfit_drop=curve[0] - curve[-1])
    emit(res)
    check_grads("train_check", res)
    if not all(math.isfinite(x) for x in curve) or \
            res["overfit_drop"] < OVERFIT_DROP:
        raise AssertionError(f"overfit drop {res['overfit_drop']} < "
                             f"{OVERFIT_DROP}")
    return res


OVERFIT_STEPS = 30
OVERFIT_DROP = 1.0


# The KV-cache slice runs at Llama-3-8B's attention widths (HF
# meta-llama/Meta-Llama-3-8B config.json: 32 layers, 32 heads, 8 kv heads,
# head dim 128, rope_theta 500000) on paged caches as bench.py:93-151
# drives the JAX package: page 256, 16384 cached tokens, batch 8.
LLAMA3 = dict(layers=32, h=32, hk=8, d=128, rope_theta=500000.0)
KV_BATCH, KV_PAGE, KV_NPAGES = 8, 256, 512  # 64 pages a sequence
KV_STEPS = 16


def quantise_paged_int8(cache, table):
    """int8 pages and per-(sequence, kv head) descales (b, hk) of a bf16
    paged cache, each sequence's amax over its own pages through the table
    (bench.py:118-125 takes the identity table)."""
    import torch

    hk = cache.shape[-2]
    out = torch.empty(cache.shape, dtype=torch.int8, device=cache.device)
    descale = torch.empty(table.shape[0], hk, device=cache.device)
    for i in range(table.shape[0]):
        pages = table[i].long()
        x = cache[pages].float()
        descale[i] = x.abs().amax(dim=(0, 1, 3)).clamp_min(1e-9) / 127.0
        out[pages] = (x / descale[i].view(hk, 1)).round().clamp(
            -127, 127).to(torch.int8)
    return out, descale


def live_pairs_ref_layout(lens, leftpad, sq, cap, causal, window, chunk):
    """(b, sq, cap) bool: the (query row, cache key) pairs the masks of
    `decode_attn_ref_layout` leave (leftpad, length, causal / window,
    attention_chunk)."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_fwd as ff

    b = lens.shape[0]
    dev = lens.device
    has_upper, wr, has_lower, wl = ff.mask_params(causal, *window)
    lp = (torch.zeros_like(lens) if leftpad is None else leftpad).long()
    rel = torch.arange(cap, device=dev).view(1, 1, cap) - lp.view(b, 1, 1)
    qpos = (torch.arange(sq, device=dev).view(1, sq, 1)
            + (lens.long() - lp - sq).view(b, 1, 1))
    live = (rel >= 0) & (rel < (lens.long() - lp).view(b, 1, 1))
    live = live.expand(b, sq, cap)
    if has_upper:
        live = live & (rel <= qpos + wr)
    if has_lower:
        live = live & (rel >= qpos - wl)
    if chunk:
        live = live & (torch.div(rel, chunk, rounding_mode="floor")
                       == torch.div(qpos, chunk, rounding_mode="floor"))
    return live


# The int8 rule above is loose: the plain int8 version's own error (P
# quantised as round(127 p)) is about as large as a typical |o| at 16384
# keys, so a wrong page could pass it.  So each int8 call is also held
# against the plain int8 version tiled as the kernel tiles (64-key tiles:
# 64-row pages, one split).  Both then quantise the same p against the same
# running maximum and differ only in float32 summation order, far less than
# one bf16 step of the output; so the two bf16 outputs are equal or one
# step apart, which is at most 2^-7 of |o| (the 1e-6 floor covers values
# near 0, a ten-thousandth of a typical |o|).  The float32 lse moves by far
# less than INT8_TILED_LSE_ATOL.  One wrong page of 64 moves o by ~40 % of
# |o| and lse by ~0.015.
INT8_TILED_O_RTOL = 2.0 ** -7
INT8_TILED_O_ATOL = 1e-6
INT8_TILED_LSE_ATOL = 1e-4


def int8_tiled_check(label, q, kc, vc, lens, splits=(1,), **kw):
    """The int8 kernel on 64-row pages of the same paged cache (a view;
    fused pages are re-fused) at each split count of `splits` (one, and the
    count the kernel resolved for the call under test), against the plain
    int8 version on the same pages at the same count: both cut the splits at
    the same keys.  Raises where |o - o_plain| > INT8_TILED_O_RTOL |o_plain|
    + INT8_TILED_O_ATOL or |lse - lse_plain| > INT8_TILED_LSE_ATOL; returns
    the errors by split count."""
    kw.pop("num_splits", None)
    return {str(n): _int8_tiled_one(label, q, kc, vc, lens, n, **kw)
            for n in dict.fromkeys(splits)}


def _int8_tiled_one(label, q, kc, vc, lens, num_splits, **kw):
    import torch
    from flash_attn_tpu_torch.kernels import flash_decode as fd

    fused = vc is None
    page = kc.shape[2] if fused else kc.shape[1]
    r = page // 64
    if fused:
        k64 = fd.fuse_kv_cache(kc[:, 0].reshape(-1, 64, *kc.shape[3:]),
                               kc[:, 1].reshape(-1, 64, *kc.shape[3:]))
        v64 = None
    else:
        k64 = kc.view(-1, 64, *kc.shape[2:])
        v64 = vc.view(-1, 64, *vc.shape[2:])
    table = kw["block_table"].long()
    t64 = (table[:, :, None] * r + torch.arange(r, device=table.device))
    kw = dict(kw, block_table=t64.reshape(table.shape[0], -1).int(),
              num_splits=num_splits)
    o, lse = fd.decode_attn_ref_layout(q, k64, v64, lens, **kw)
    o_pt, lse_pt = fd.decode_attn_ref_layout_ref(q, k64, v64, lens, **kw)
    o, o_pt = o.float(), o_pt.float()
    diff = (o - o_pt).abs()
    worst = float((diff / (INT8_TILED_O_RTOL * o_pt.abs()
                           + INT8_TILED_O_ATOL)).max())
    fin = torch.isfinite(lse_pt)
    if not torch.equal(fin, torch.isfinite(lse)):
        raise AssertionError(f"{label}: +inf lse rows differ (64-key tiles)")
    err_l = float((lse[fin] - lse_pt[fin]).abs().max())
    res = dict(o_max_abs_err=float(diff.max()), o_worst_over_limit=worst,
               o_elements_differing=int((diff > 0).sum()),
               o_elements=o.numel(), lse_max_abs_err=err_l)
    if worst > 1.0 or err_l > INT8_TILED_LSE_ATOL:
        raise AssertionError(f"{label}: int8 kernel against the plain int8 "
                             f"version on the same 64-key tiles, "
                             f"{num_splits} splits: {res}")
    return res


def kvcache_case(label, q, kc, vc, lens, library=None, **kw):
    """`decode_attn_ref_layout` against its plain version: the fp32 oracle
    on the dequantised cache and the plain version in the cache's own
    precision (the low-precision yardstick) under `check_close`; kernel,
    plain version and library timed beside the bound (each live K/V row of
    a kv head read once, q read and o, lse written once)."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_decode as fd
    from flash_attn_tpu_torch.utils.testing import dequantise_cache

    b, sq, h, d = q.shape
    fused = vc is None
    hk = kc.shape[-2]
    kw.setdefault("softmax_scale", d ** -0.5)
    kw.setdefault("causal", True)
    o, lse = fd.decode_attn_ref_layout(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    # the plain versions at the split count the kernel launched (for int8
    # the splits change the result: each restarts the quantisation)
    ns = fd.last_num_splits
    plain_kw = dict(kw, num_splits=ns)
    o_pt, lse_pt = fd.decode_attn_ref_layout_ref(q, kc, vc, lens,
                                                 **plain_kw)
    ref_kw = {k: v for k, v in plain_kw.items()
              if k not in ("k_descale", "v_descale")}
    quant = kc.element_size() == 1
    if quant:
        deq = dict(block_table=kw.get("block_table"),
                   cache_batch_idx=kw.get("cache_batch_idx"))
        if fused:
            kf = torch.stack([
                dequantise_cache(kc[:, 0], kw["k_descale"], **deq),
                dequantise_cache(kc[:, 1], kw["v_descale"], **deq)], dim=1)
            vf = None
        else:
            kf = dequantise_cache(kc, kw["k_descale"], **deq)
            vf = dequantise_cache(vc, kw["v_descale"], **deq)
    else:
        kf, vf = kc.float(), None if fused else vc.float()
    o_ref, lse_ref = fd.decode_attn_ref_layout_ref(q.float(), kf, vf, lens,
                                                   **ref_kw)
    del kf, vf
    rows_ok = torch.ones(b, h, sq, dtype=torch.bool, device=q.device)
    err_o, err_o_pt, err_l, err_l_pt = check_attention(
        label, o.transpose(1, 2), lse, o_ref.transpose(1, 2), lse_ref,
        o_pt.transpose(1, 2), lse_pt, rows_ok)
    if not torch.isfinite(o).all():
        raise AssertionError(f"{label}: non-finite output")
    tiled = None
    if kc.dtype == torch.int8:
        tiled = int8_tiled_check(label, q, kc, vc, lens, splits=(1, ns),
                                 **kw)

    if kw.get("block_table") is not None:
        cap = kw["block_table"].shape[1] * (kc.shape[2] if fused
                                            else kc.shape[1])
    else:
        cap = kc.shape[1]
    live = live_pairs_ref_layout(lens, kw.get("cache_leftpad"), sq, cap,
                                 kw["causal"], kw.get("window_size",
                                                      (-1, -1)),
                                 kw.get("attention_chunk", 0))
    live_keys = int(live.any(dim=1).sum())
    pairs = int(live.sum()) * h
    elt = kc.element_size()
    bytes_ = (2 * hk * d * elt * live_keys + 2 * b * sq * h * d * 2
              + b * h * sq * 4)
    bound_ms, bound_by = bound(4 * d * pairs, bytes_,
                               PEAK_OPS_8BIT if quant else PEAK_FLOPS)
    tensors = (q, kc, lens) if fused else (q, kc, vc, lens)

    def unpack(f):
        if fused:
            return lambda q_, kc_, lens_: f(q_, kc_, None, lens_, **kw)
        return lambda *a: f(*a, **kw)

    args = input_copies(*tensors)
    before = fd.launches
    kernel_ms = time_ms(unpack(fd.decode_attn_ref_layout), args)
    kernel_call_ms = call_ms(unpack(fd.decode_attn_ref_layout), args)
    # The plain version issues ~20 kernels per cache tile: timed one call
    # at a time, host included (call_ms), not queued behind a spin kernel.
    plain_ms = call_ms(unpack(fd.decode_attn_ref_layout_ref), args, iters=5,
                       warmup=1)
    fd.launches = before  # timing launches are not the main path's
    library_ms = library() if library is not None else None
    blocks = fd.row_tiles(h // hk * sq) * ns * b * hk
    res = dict(phase="kernel_kvcache", case=label, b=b, h=h, hk=hk, sq=sq,
               d=d, cache_dtype=str(kc.dtype), fused=fused,
               paged=kw.get("block_table") is not None,
               cache_seqlens=lens.tolist(), num_splits=ns,
               max_abs_err_o=err_o, plain_lowp_err_o=err_o_pt,
               max_abs_err_lse=err_l, plain_lowp_err_lse=err_l_pt,
               int8_tiled=tiled,
               kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, bytes=bytes_, flops=4 * d * pairs,
               live_keys=live_keys, share_of_bound=bound_ms / kernel_ms,
               blocks=blocks, sm_fill=blocks / fd.sm_count(q.device))
    emit(res)
    return res, o, lse


def sdpa_gqa_ms(kc, vc, table, q):
    """Device time of `scaled_dot_product_attention(enable_gqa=True)` on a
    contiguous (b, hk, s, d) copy of the paged cache: the same function
    without the page gather, as a yardstick the port never calls."""
    import torch
    import torch.nn.functional as F

    b = table.shape[0]
    hk, d = kc.shape[-2:]

    def contiguous(c):
        return c[table.long()].reshape(b, -1, hk, d).transpose(1, 2)\
            .contiguous()

    kq, vq = contiguous(kc), contiguous(vc)
    qq = q.transpose(1, 2).contiguous()
    ms = time_ms(lambda a, k_, v_: F.scaled_dot_product_attention(
        a, k_, v_, enable_gqa=True), input_copies(qq, kq, vq))
    return ms


def kernel_kvcache_phase(gen):
    """Cases (a)-(h) of the reference-layout decode kernel."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_decode as fd

    dev = "cuda"
    h, hk, d = LLAMA3["h"], LLAMA3["hk"], LLAMA3["d"]
    b, page = KV_BATCH, KV_PAGE
    pps = KV_NPAGES // b
    table = torch.randperm(KV_NPAGES, generator=gen, device=dev).view(
        b, pps).int()
    shape = (KV_NPAGES, page, hk, d)
    kc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
    lens = torch.full((b,), pps * page, dtype=torch.int32, device=dev)
    out = {}
    out["a"], _, _ = kvcache_case(
        "a: paged bf16 (bench shape)", q, kc, vc, lens,
        library=lambda: sdpa_gqa_ms(kc, vc, table, q), block_table=table)
    kq, kds = quantise_paged_int8(kc, table)
    vq, vds = quantise_paged_int8(vc, table)
    out["b"], _, _ = kvcache_case(
        "b: paged int8", q, kq, vq, lens, block_table=table,
        k_descale=kds, v_descale=vds)
    kvf = fd.fuse_kv_cache(kc, vc)
    del kc, vc
    out["c"], _, _ = kvcache_case("c: fused bf16", q, kvf, None, lens,
                                  block_table=table)
    del kvf
    kvf8 = fd.fuse_kv_cache(kq, vq)
    del kq, vq
    out["d"], _, _ = kvcache_case(
        "d: fused int8", q, kvf8, None, lens, block_table=table,
        k_descale=kds, v_descale=vds)
    del kvf8
    torch.cuda.empty_cache()

    # (e) contiguous fp8 e4m3, cache_batch_idx, cache_leftpad, ragged, splits
    smax, bc = 8192, b + 2
    x = torch.randn(2, bc, smax, hk, d, generator=gen, device=dev)
    amax = x.abs().amax(dim=(2, 4))  # (2, bc, hk)
    cbi = torch.randperm(bc, generator=gen, device=dev)[:b].int()
    kd, vd = (amax[i][cbi.long()] / 448.0 for i in (0, 1))
    k8, v8 = ((x[i] / (amax[i] / 448.0)[:, None, :, None]).to(
        torch.float8_e4m3fn) for i in (0, 1))
    del x
    leftpad = torch.randint(0, 200, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lens_e = torch.randint(1000, smax + 1, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    out["e"], _, _ = kvcache_case(
        "e: contiguous fp8, batch idx, leftpad, 4 splits", q, k8, v8,
        lens_e, cache_batch_idx=cbi, cache_leftpad=leftpad,
        num_splits=4, k_descale=kd, v_descale=vd)
    del k8, v8

    # (f) GQA, sq 4, window + softcap + ALiBi + attention_chunk, contiguous
    bf, smax = 4, 8192
    kcf = torch.randn(bf, smax, hk, d, generator=gen, device=dev).bfloat16()
    vcf = torch.randn(bf, smax, hk, d, generator=gen, device=dev).bfloat16()
    qf = torch.randn(bf, 4, h, d, generator=gen, device=dev).bfloat16()
    lens_f = torch.randint(2048, smax + 1, (bf,), generator=gen, device=dev,
                           dtype=torch.int32)
    slopes = torch.rand(bf, h, generator=gen, device=dev) * 0.01
    out["f"], _, _ = kvcache_case(
        "f: GQA sq 4, window+softcap+alibi+chunk", qf, kcf, vcf, lens_f,
        window_size=(1024, 0), softcap=30.0, alibi_slopes=slopes,
        attention_chunk=2048)
    del kcf, vcf

    out["g"] = paged_prefill_case(gen)

    # (h) a sequence with no key, and sinks
    kc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    lens_h = torch.randint(1, pps * page + 1, (b,), generator=gen,
                           device=dev, dtype=torch.int32)
    lens_h[0] = 0
    sinks = torch.randn(h, generator=gen, device=dev)
    out["h"], o, lse = kvcache_case(
        "h: cache_seqlens 0, sinks", q, kc, vc, lens_h,
        block_table=table, sinks=sinks)
    if not (torch.all(o[0] == 0) and torch.equal(lse[0], sinks[:, None])):
        raise AssertionError("h: the empty sequence is not o = 0, "
                             "lse = sink")
    del kc, vc
    torch.cuda.empty_cache()
    return out


def paged_prefill_case(gen):
    """(g) chunked prefill through `interface.flash_attn_varlen_func(
    block_table=)`: 4 sequences, new chunks of 64-512 tokens at the end of
    2048-4096 cached tokens (up to 2048 packed rows, several row tiles).
    Each sequence is held alone against the plain version (fp32 oracle and
    bf16 yardstick), which also checks the padding and scatter around the
    kernel."""
    import torch
    from flash_attn_tpu_torch import interface
    from flash_attn_tpu_torch.kernels import flash_decode as fd

    dev = "cuda"
    h, hk, d, page = LLAMA3["h"], LLAMA3["hk"], LLAMA3["d"], KV_PAGE
    b, pps = 4, 16
    npages = b * pps + 8
    table = torch.randperm(npages, generator=gen, device=dev)[
        :b * pps].view(b, pps).int()
    kc = torch.randn(npages, page, hk, d, generator=gen,
                     device=dev).bfloat16()
    vc = torch.randn(npages, page, hk, d, generator=gen,
                     device=dev).bfloat16()
    lens_k = torch.randint(2048, 4097, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    lens_q = torch.randint(64, 513, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    cu_q = torch.nn.functional.pad(lens_q.cumsum(0), (1, 0)).int()
    cu_k = torch.nn.functional.pad(lens_k.cumsum(0), (1, 0)).int()
    max_sq = int(lens_q.max())
    total = int(lens_q.sum())
    q = torch.randn(total, h, d, generator=gen, device=dev).bfloat16()
    kw = dict(causal=True, return_attn_probs=True, block_table=table)

    max_sk = int(lens_k.max())

    def run(q_, kc_, vc_):
        return interface.flash_attn_varlen_func(
            q_, kc_, vc_, cu_q, cu_k, max_sq, max_sk, **kw)

    o, lse, _ = run(q, kc, vc)
    torch.cuda.synchronize()
    errs = []
    for i in range(b):
        qi = q[int(cu_q[i]):int(cu_q[i + 1])][None]
        li = lens_k[i:i + 1]
        one = dict(softmax_scale=d ** -0.5, causal=True,
                   block_table=table[i:i + 1])
        o_pt, lse_pt = fd.decode_attn_ref_layout_ref(qi, kc, vc, li, **one)
        o_ref, lse_ref = fd.decode_attn_ref_layout_ref(
            qi.float(), kc.float(), vc.float(), li, **one)
        n = qi.shape[1]
        rows_ok = torch.ones(1, h, n, dtype=torch.bool, device=dev)
        errs.append(check_attention(
            f"g: sequence {i}", o[None, int(cu_q[i]):int(cu_q[i + 1])]
            .transpose(1, 2), lse[i:i + 1, :, :n], o_ref.transpose(1, 2),
            lse_ref, o_pt.transpose(1, 2), lse_pt, rows_ok))
        if not torch.all(torch.isposinf(lse[i, :, n:])):
            raise AssertionError("g: padding rows of the lse are not +inf")
    live = sum(int(lk) for lk in lens_k.tolist())
    pairs = sum(int(lq) * int(lk) - int(lq) * (int(lq) - 1) // 2
                for lq, lk in zip(lens_q.tolist(), lens_k.tolist())) * h
    bytes_ = 2 * hk * d * 2 * live + 2 * total * h * d * 2 + b * h * max_sq * 4
    bound_ms, bound_by = bound(4 * d * pairs, bytes_)
    args = input_copies(q, kc, vc)
    before = fd.launches
    kernel_ms = time_ms(lambda *a: run(*a), args)
    kernel_call_ms = call_ms(lambda *a: run(*a), args)
    fd.launches = before
    library_ms = sdpa_prefill_ms(q, kc, vc, table, cu_q, lens_q, lens_k)
    rows = h // hk * max_sq
    res = dict(phase="kernel_kvcache",
               case="g: paged varlen prefill (flash_attn_varlen_func)",
               b=b, h=h, hk=hk, d=d, lens_q=lens_q.tolist(),
               lens_k=lens_k.tolist(), packed_rows=rows,
               row_tiles=-(-rows // 64),
               max_abs_err_o=max(e[0] for e in errs),
               plain_lowp_err_o=max(e[1] for e in errs),
               max_abs_err_lse=max(e[2] for e in errs),
               plain_lowp_err_lse=max(e[3] for e in errs),
               kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               plain_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms,
               library="SDPA enable_gqa on a contiguous copy, bottom-right "
               "causal bool mask",
               flops=4 * d * pairs, bytes=bytes_,
               share_of_bound=bound_ms / kernel_ms)
    emit(res)
    return res


def sdpa_prefill_ms(q, kc, vc, table, cu_q, lens_q, lens_k):
    """Device time of one `scaled_dot_product_attention(enable_gqa=True)`
    over the chunked prefill's sequences, on a contiguous copy of their
    pages (b, hk, max_k, d) and their chunks left-padded to (b, h, max_q,
    d), with the bottom-right causal mask as a bool (b, 1, max_q, max_k)
    tensor: the same function without the page gather, as a yardstick the
    port never calls."""
    import torch
    import torch.nn.functional as F

    b = table.shape[0]
    h, d = q.shape[1:]
    hk = kc.shape[-2]
    max_q, max_k = int(lens_q.max()), int(lens_k.max())
    dev = q.device
    r = torch.arange(max_q, device=dev)[None, :]
    src = cu_q[:-1, None].long() + r - (max_q - lens_q[:, None].long())
    qq = q[src.clamp(0, q.shape[0] - 1)].transpose(1, 2).contiguous()

    def contiguous(c):
        return c[table.long()].reshape(b, -1, hk, d)[:, :max_k].transpose(
            1, 2).contiguous()

    kq, vq = contiguous(kc), contiguous(vc)
    col = torch.arange(max_k, device=dev)[None, None, :]
    pos = (lens_k[:, None, None].long() - max_q + r[:, :, None])
    mask = ((col <= pos) & (col < lens_k[:, None, None]))[:, None]
    return time_ms(lambda a, k_, v_, m: F.scaled_dot_product_attention(
        a, k_, v_, attn_mask=m, enable_gqa=True),
        input_copies(qq, kq, vq, mask))


def fwd_ptxas(varlen):
    """`ptxas_summary` of the `flash_fwd_kernel` instantiations of one mode
    (its first bool template argument is kVarlen)."""
    import re

    mode = re.compile(rf"Li\d+ELb{int(varlen)}E")
    return {k: v for k, v in ptxas_summary("flash_fwd").items()
            if k.startswith("flash_fwd_kernel") and mode.search(k)}


def ptxas_summary(name):
    """Registers, static shared memory, spills and warnings of each
    instantiation of kernel library `name`, from `nvcc -Xptxas -v`
    (`_build.build_info`): {"kernel<template arguments of the mangled
    name>": {registers, smem_bytes, spill_stores, spill_loads, warnings}}."""
    import re
    from flash_attn_tpu_torch.kernels import _build

    out, fn = {}, None
    for ln in _build.build_info.get(name, {}).get("ptxas", []):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            t = re.search(r"([a-z_]+_kernel)I(\w+?)Ev", fn)
            fn = f"{t.group(1)}<{t.group(2)}>" if t else fn
            out[fn] = {}
            continue
        if fn is None:
            continue
        if "ptxas warning" in ln:
            out[fn].setdefault("warnings", []).append(ln)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[fn].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[fn]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            out[fn]["smem_bytes"] = int(m.group(1))
    return out


def kvcache_phase():
    """The KV-cache path: attention-only decode of Llama-3-8B's 32 layers,
    KV_STEPS steps of one new token for each of KV_BATCH sequences through
    the public `flash_attn_with_kvcache` (rotary from the port's
    `RotaryEmbedding(128, base=500000)`, append into a paged cache of 512
    pages of 256 rows per layer, causal), first with bf16 caches, then with
    int8 caches (quantise-on-append with per-(sequence, kv head) descales).
    The kernel's launch count is set to 0 just before each run and read
    just after.  At the first and last step, layer 0's output and appended
    rows are held against the plain version on the same inputs; that check
    is left out of the wall time."""
    import torch
    from flash_attn_tpu_torch import interface
    from flash_attn_tpu_torch.kernels import flash_decode as fd
    from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding

    dev = "cuda"
    L, h, hk, d = (LLAMA3[k] for k in ("layers", "h", "hk", "d"))
    b, page = KV_BATCH, KV_PAGE
    pps = KV_NPAGES // b
    cos, sin = RotaryEmbedding(d, base=LLAMA3["rope_theta"]).cos_sin(
        pps * page)
    results = {}
    for run in ("bf16", "int8"):
        gen = torch.Generator(device=dev).manual_seed(1)
        table = torch.randperm(KV_NPAGES, generator=gen, device=dev).view(
            b, pps).int()
        lens0 = torch.randint(8192, pps * page - KV_STEPS + 1, (b,),
                              generator=gen, device=dev, dtype=torch.int32)
        torch.cuda.reset_peak_memory_stats()
        caches, descales = [], []
        shape = (KV_NPAGES, page, hk, d)
        for _ in range(L):
            if run == "bf16":
                pair = tuple(torch.randn(shape, generator=gen, device=dev,
                                         dtype=torch.bfloat16)
                             for _ in range(2))
                descales.append({})
            else:
                pair = tuple(torch.randint(-127, 128, shape, generator=gen,
                                           device=dev, dtype=torch.int8)
                             for _ in range(2))
                descales.append(dict(
                    k_descale=torch.rand(b, hk, generator=gen, device=dev)
                    * 0.01 + 0.01,
                    v_descale=torch.rand(b, hk, generator=gen, device=dev)
                    * 0.01 + 0.01))
            caches.append(pair)
        # q, k, v of every step and layer, drawn before the timed loop
        qs = torch.randn(KV_STEPS, L, b, 1, h, d, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        ks = torch.randn(KV_STEPS, L, b, 1, hk, d, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        vs = torch.randn(KV_STEPS, L, b, 1, hk, d, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        outs = []  # every output, checked for finite values after the run
        checks, check_s, peak = [], 0.0, 0
        lens = lens0.clone()
        torch.cuda.synchronize()
        fd.launches = 0
        t0 = time.perf_counter()
        for step in range(KV_STEPS):
            for layer in range(L):
                kc, vc = caches[layer]
                o = interface.flash_attn_with_kvcache(
                    qs[step, layer], kc, vc, k=ks[step, layer],
                    v=vs[step, layer], rotary_cos=cos, rotary_sin=sin,
                    cache_seqlens=lens, block_table=table, causal=True,
                    **descales[layer])
                outs.append(o)
                if layer == 0 and step in (0, KV_STEPS - 1):
                    torch.cuda.synchronize()
                    c0 = time.perf_counter()
                    peak = max(peak, torch.cuda.max_memory_allocated())
                    checks.append(kvcache_step_check(
                        f"kvcache {run} step {step}", o, qs[step, 0],
                        ks[step, 0], vs[step, 0], kc, vc, lens, table, cos,
                        sin, descales[0]))
                    torch.cuda.reset_peak_memory_stats()  # not the path's
                    check_s += time.perf_counter() - c0
            lens = lens + 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - check_s
        launches = fd.launches
        peak = max(peak, torch.cuda.max_memory_allocated())
        finite = bool(torch.isfinite(torch.stack(outs)).all())
        profile = profile_kvcache_step(
            caches, qs[-1], ks[-1], vs[-1], cos, sin, lens - 1, table,
            descales, wall / KV_STEPS)
        res = dict(phase="kvcache", run=run,
                   model="Llama-3-8B attention (32 layers, h 32, hk 8, "
                   "d 128), random caches (seed 1)",
                   batch=b, steps=KV_STEPS, page=page, npages=KV_NPAGES,
                   cache_seqlens_start=lens0.tolist(), wall_s=wall,
                   decode_tok_per_s=b * KV_STEPS / wall,
                   ms_per_call=wall / (KV_STEPS * L) * 1e3,
                   max_memory_allocated=peak,
                   flash_decode_ref_launches=launches, checks=checks,
                   profile=profile)
        emit(res)
        if launches != L * KV_STEPS:
            raise AssertionError(f"kvcache {run}: {launches} launches, "
                                 f"expected {L * KV_STEPS}")
        if not finite:
            raise AssertionError(f"kvcache {run}: non-finite output")
        results[run] = res
        del caches, kc, vc, o, outs, qs, ks, vs
        torch.cuda.empty_cache()
    return results


def profile_kvcache_step(caches, q, k, v, cos, sin, lens, table, descales,
                         step_s):
    """The last decode step once more (the same rows appended again) under
    `torch.profiler`, after the path's counts are read: device busy time
    (the union of the kernel intervals), the device's idle share against
    the unprofiled step time `step_s`, the reference-layout kernel's share
    of kernel time, and device ms by kernel name, largest first."""
    import torch
    from flash_attn_tpu_torch import interface

    torch.cuda.synchronize()
    with device_profiler() as prof:
        for layer, (kc, vc) in enumerate(caches):
            interface.flash_attn_with_kvcache(
                q[layer], kc, vc, k=k[layer], v=v[layer], rotary_cos=cos,
                rotary_sin=sin, cache_seqlens=lens, block_table=table,
                causal=True, **descales[layer])
        torch.cuda.synchronize()
    return profile_summary(prof, 1, step_s, "step", "flash_decode_ref",
                           "flash_decode_ref", top=6)


def kvcache_step_check(label, o, q, k, v, kc, vc, lens, table, cos, sin,
                       descales):
    """Layer 0 of one decode step, after the call: the appended rows equal
    the plain rotary (and quantisation) of k and v, and the kernel's output
    agrees with the plain version on the same rotated q and updated cache
    (fp32 oracle on the dequantised cache, the plain version in the
    cache's precision as the yardstick)."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_decode as fd
    from flash_attn_tpu_torch.utils.testing import (check_close,
                                                    dequantise_cache)

    b, page = lens.shape[0], kc.shape[1]
    pos = lens.long()[:, None]
    q_rot = fd._apply_rotary(q, cos, sin, pos, False)
    k_new = fd._apply_rotary(k, cos, sin, pos, False)
    v_new = v
    if kc.dtype == torch.int8:
        k_new = fd.quantise_append(k_new, descales["k_descale"], kc.dtype)
        v_new = fd.quantise_append(v_new, descales["v_descale"], kc.dtype)
    pid = table.long()[torch.arange(b, device=lens.device), lens.long()
                       // page]
    off = lens.long() % page
    if not (torch.equal(kc[pid, off], k_new[:, 0])
            and torch.equal(vc[pid, off], v_new[:, 0])):
        raise AssertionError(f"{label}: appended rows differ from plain")
    # the plain versions at the split count the kernel launched
    kw = dict(softmax_scale=q.shape[-1] ** -0.5, causal=True,
              block_table=table, num_splits=fd.last_num_splits)
    new_len = lens + 1
    o_pt, lse_pt = fd.decode_attn_ref_layout_ref(q_rot, kc, vc, new_len,
                                                 **kw, **descales)
    if descales:
        kf = dequantise_cache(kc, descales["k_descale"], block_table=table)
        vf = dequantise_cache(vc, descales["v_descale"], block_table=table)
    else:
        kf, vf = kc.float(), vc.float()
    o_ref, _ = fd.decode_attn_ref_layout_ref(q_rot.float(), kf, vf, new_len,
                                             **kw)
    err, err_pt = check_close(o, o_ref, o_pt, label=label)
    res = dict(step=label, max_abs_err_o=err, plain_lowp_err_o=err_pt)
    if kc.dtype == torch.int8:
        before = fd.launches  # a check's launch is not the path's
        res["int8_tiled"] = int8_tiled_check(
            label, q_rot, kc, vc, new_len,
            splits=(1, kw.pop("num_splits")), **kw, **descales)
        fd.launches = before
    return res


# The packed varlen path: BERT-base (bert-base-uncased config.json: hidden
# 768, 12 layers, 12 heads, intermediate 3072, vocab 30522, 512 positions, 2
# token types) on a batch of BERT_BATCH sequences of seeded lengths 16-512.
BERT_BATCH = 64
BERT_SEQ = 512
BERT_ITERS = 10
BERT_GRAD_SEQS = 16
# Unpadded against padded on the card, both bf16 through 12 post-norm
# layers: the hidden states (entries of order 1) differ by bf16 rounding in
# two attention kernels that sum in other orders, so their cosine over all
# valid rows is >= BERT_COSINE and the mean |difference| <= BERT_MEAN_ATOL
# (about two bf16 steps at 1).  The fp32 CPU comparison takes the repo's
# rule: the unpadded error <= 2 x the padded error + 1e-2.
BERT_COSINE = 0.9999
BERT_MEAN_ATOL = 1e-2
BERT_POOLED_ATOL = 5e-2
GRAD_COSINE = 0.999
DEV = "cuda"


def varlen_lengths(gen, n, lo, hi):
    """n seeded lengths in [lo, hi] (a CPU generator: the same on every
    device)."""
    import torch

    return torch.randint(lo, hi + 1, (n,), generator=gen).tolist()


def varlen_live_pairs(lens_q, lens_k, causal, window, max_sk):
    """Live (row, key) pairs of each sequence under the varlen kernels' own
    mask arithmetic (bottom-right, one-sided windows normalised to
    max_seqlen_k).  Returns (list of pair counts, list of live-key counts)."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_fwd as ff

    wl, wr = ff.normalize_window(window, causal, max_sk)
    has_upper, wr, has_lower, wl = ff.mask_params(causal, wl, wr)
    pairs, keys = [], []
    for lq, lk in zip(lens_q, lens_k):
        rows = torch.arange(lq).view(lq, 1)
        cols = torch.arange(lk).view(1, lk)
        live = torch.ones(lq, lk, dtype=torch.bool)
        if has_upper:
            live &= cols <= rows + (lk - lq) + wr
        if has_lower:
            live &= cols >= rows + (lk - lq) - wl
        pairs.append(int(live.sum()))
        keys.append(int(live.any(dim=0).sum()))
    return pairs, keys


def varlen_inputs(lens_q, lens_k, h, hk, d, gen, dtype):
    import torch

    def stream(lens, heads):
        return torch.randn(sum(lens), heads, d, generator=gen,
                           device=DEV).to(dtype)

    def cu(lens):
        return torch.tensor([0] + list(lens), device=DEV).cumsum(0).int()

    return (stream(lens_q, h), stream(lens_k, hk), stream(lens_k, hk),
            cu(lens_q), cu(lens_k))


def sdpa_varlen_library(q, k, v, cu_q, cu_k, lens_q, lens_k, causal,
                        backward=False, do=None, dropout_p=0.0):
    """The time of one PyTorch call computing the same packed attention
    (a yardstick only: the port never calls it), and which call: SDPA on
    `torch.nested` jagged tensors where this torch runs it on these inputs
    (equal q and k lengths, no empty sequence), else SDPA on the padded
    layout with a boolean mask of the live pairs.  With `backward`, the
    time of `torch.autograd.grad` through that call; with `dropout_p`,
    SDPA's own dropout."""
    import torch
    import torch.nn.functional as F

    h, hk = q.shape[1], k.shape[1]
    gqa = dict(enable_gqa=True) if hk != h else {}

    def njt(x, cu, lens):
        # the lengths' bounds given, so that building it reads no device
        # value on the host
        return torch.nested.nested_tensor_from_jagged(
            x, cu.long(), min_seqlen=min(lens),
            max_seqlen=max(lens)).transpose(1, 2)

    def run_njt(q_, k_, v_):
        return F.scaled_dot_product_attention(
            njt(q_, cu_q, lens_q), njt(k_, cu_k, lens_k),
            njt(v_, cu_k, lens_k), is_causal=causal, dropout_p=dropout_p,
            **gqa)

    which, fn = None, None
    if list(lens_q) == list(lens_k) and min(lens_q) > 0:
        try:  # chooses the yardstick only; no check depends on it
            ins = [x.detach().requires_grad_(backward) for x in (q, k, v)]
            out = run_njt(*ins)
            if backward:
                torch.autograd.grad(out, ins, torch.ones_like(out))
            torch.cuda.synchronize()
            which, fn = "sdpa_nested_jagged", run_njt
        except (RuntimeError, NotImplementedError, TypeError) as e:
            which = f"nested jagged SDPA refused ({type(e).__name__})"
    if fn is None:
        b, mq, mk = len(lens_q), max(lens_q), max(lens_k)
        lq = torch.tensor(lens_q, device=q.device)
        lk = torch.tensor(lens_k, device=q.device)
        rows = torch.arange(mq, device=q.device).view(1, mq, 1)
        cols = torch.arange(mk, device=q.device).view(1, 1, mk)
        live = (rows < lq.view(b, 1, 1)) & (cols < lk.view(b, 1, 1))
        if causal:
            live &= cols <= rows + (lk - lq).view(b, 1, 1)
        mask = live[:, None]
        idx_q = (cu_q[:-1, None].long() + torch.arange(mq, device=q.device)
                 ).clamp(max=q.shape[0] - 1)
        idx_k = (cu_k[:-1, None].long() + torch.arange(mk, device=q.device)
                 ).clamp(max=k.shape[0] - 1)

        def run_padded(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_[idx_q].transpose(1, 2), k_[idx_k].transpose(1, 2),
                v_[idx_k].transpose(1, 2), attn_mask=mask,
                dropout_p=dropout_p, **gqa)

        which = (which + "; " if which else "") + "sdpa_padded_bool_mask"
        fn = run_padded
    if backward:
        graphs = []
        for qc, kc, vc in input_copies(q, k, v):
            qc, kc, vc = (t.detach().requires_grad_() for t in (qc, kc, vc))
            out = fn(qc, kc, vc)
            graphs.append((out, (qc, kc, vc), torch.ones_like(out)))
        fn, args = (lambda out, ins, g: torch.autograd.grad(
            out, ins, g, retain_graph=True)), graphs
    else:
        args = input_copies(q, k, v)
    try:
        return time_ms(fn, args), which
    except RuntimeError as e:  # a call that reads a device value on the host
        if "could not queue" not in str(e):
            raise
        return call_ms(fn, args), which + " (call_ms: it syncs the host)"


def varlen_fwd_case(label, lens_q, lens_k, h, hk, d, gen, dtype="bfloat16",
                    causal=False, window=(-1, -1), softcap=0.0, alibi=False,
                    with_library=True):
    """The packed varlen forward (`varlen_attn_fwd`, flash_fwd.cu's varlen
    mode) against its plain version: the fp32 oracle and the plain version
    in the inputs' precision under the 2x rule, on every token (rows with
    no key: o = 0, lse = +inf as the oracle).  Kernel, plain version and
    library timed beside the bound."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.kernels import varlen as vl

    dt = getattr(torch, dtype)
    q, k, v, cu_q, cu_k = varlen_inputs(lens_q, lens_k, h, hk, d, gen, dt)
    mq, mk = max(lens_q), max(lens_k)
    slopes = (torch.rand(h, generator=gen, device=DEV) * 0.3
              if alibi else None)
    kw = dict(softmax_scale=d ** -0.5, causal=causal, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    args = (cu_q, cu_k, mq, mk)
    o, lse = vl.varlen_attn_fwd(q, k, v, *args, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = vl.varlen_attn_fwd_ref(q.float(), k.float(), v.float(),
                                            *args, **kw)
    o_pt, lse_pt = vl.varlen_attn_fwd_ref(q, k, v, *args, **kw)
    rows_ok = torch.ones(h, q.shape[0], dtype=torch.bool, device=DEV)
    err_o, err_o_pt, err_l, err_l_pt = check_attention(
        label, o.transpose(0, 1), lse, o_ref.transpose(0, 1), lse_ref,
        o_pt.transpose(0, 1), lse_pt, rows_ok)
    if not torch.isfinite(o).all():
        raise AssertionError(f"{label}: non-finite output")
    del o_ref, lse_ref, o_pt, lse_pt

    pairs, keys = varlen_live_pairs(lens_q, lens_k, causal, window, mk)
    live_pairs_h = sum(pairs) * h
    elt = q.element_size()
    bytes_ = (2 * q.numel() + k.numel() + v.numel()) * elt  # q, k, v, o
    bound_ms, bound_by = bound(4 * d * live_pairs_h, bytes_)
    copies = input_copies(q, k, v)
    fn = lambda *a: vl.varlen_attn_fwd(*a, *args, **kw)  # noqa: E731
    before = vl.launches_fwd
    kernel_ms = time_ms(fn, copies)
    kernel_call_ms = call_ms(fn, copies)
    # the kernel alone: the whole call also zeroes o and fills lse with +inf
    kernel_device = kernel_device_ms(fn, copies, ("flash_fwd_kernel",))[
        "flash_fwd_kernel"]
    # the plain version reads the lengths on the host (one sync a call)
    plain_ms = call_ms(lambda *a: vl.varlen_attn_fwd_ref(*a, *args, **kw),
                       copies, iters=3, warmup=1)
    vl.launches_fwd = before  # timing launches are not the main path's
    library_ms, library = None, None
    if with_library and softcap == 0.0 and not alibi and \
            window == (-1, -1):
        library_ms, library = sdpa_varlen_library(q, k, v, cu_q, cu_k,
                                                  lens_q, lens_k, causal)
    rows = ff.fwd_rows(d)
    tiles = sum(-(-n // rows) for n in lens_q) * h
    res = dict(phase="kernel_varlen", case=label, dtype=dtype, h=h, hk=hk,
               d=d, sequences=len(lens_q), total_q=sum(lens_q),
               total_k=sum(lens_k), max_seqlen_q=mq, max_seqlen_k=mk,
               causal=causal, window=list(window), softcap=softcap,
               alibi=alibi, max_abs_err_o=err_o, plain_lowp_err_o=err_o_pt,
               max_abs_err_lse=err_l, plain_lowp_err_lse=err_l_pt,
               kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               kernel_device_ms=kernel_device,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, library=library,
               flops=4 * d * live_pairs_h, bytes=bytes_,
               share_of_bound=bound_ms / kernel_device,
               rows=rows, blocks_live=tiles,
               blocks_launched=-(-mq // rows) * h * len(lens_q))
    emit(res)
    return res


def varlen_bwd_case(label, lens_q, lens_k, h, hk, d, gen, causal=False,
                    window=(-1, -1), softcap=0.0, alibi=False,
                    with_library=True):
    """The packed varlen backward (`varlen_attn_bwd`, flash_bwd.cu's varlen
    mode) against the plain backward (fp32 oracle, bf16 yardstick) on dq,
    dk and dv; two runs bitwise equal; keys no query sees get 0.  Whole
    backward, each kernel (profiler; the dQ kernel's time includes the dO.O
    preprocess), plain version and library timed."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import varlen as vl
    from flash_attn_tpu_torch.utils.testing import check_close

    q, k, v, cu_q, cu_k = varlen_inputs(lens_q, lens_k, h, hk, d, gen,
                                        torch.bfloat16)
    mq, mk = max(lens_q), max(lens_k)
    slopes = (torch.rand(h, generator=gen, device=DEV) * 0.3
              if alibi else None)
    kw = dict(softmax_scale=d ** -0.5, causal=causal, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    args = (cu_q, cu_k, mq, mk)
    before = vl.launches_fwd, vl.launches_dq, vl.launches_dkv
    o, lse = vl.varlen_attn_fwd(q, k, v, *args, **kw)
    do = torch.randn(q.shape, generator=gen, device=DEV).bfloat16()
    dq, dk, dv = vl.varlen_attn_bwd(do, q, k, v, o, lse, *args, **kw)
    torch.cuda.synchronize()
    ref = vl.varlen_attn_bwd_ref(do.float(), q.float(), k.float(), v.float(),
                                 o.float(), lse, *args, **kw)
    pt = vl.varlen_attn_bwd_ref(do, q, k, v, o, lse, *args, **kw)
    errs = {}
    for name, x, r, y in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, pt):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite {name}")
        errs[name] = check_close(x, r, y, label=f"{label} {name}")
    del ref, pt
    again = vl.varlen_attn_bwd(do, q, k, v, o, lse, *args, **kw)
    bitwise_repeat = all(torch.equal(x, y) for x, y in zip((dq, dk, dv),
                                                           again))
    if not bitwise_repeat:
        raise AssertionError(f"{label}: two runs differ")
    pairs, _ = varlen_live_pairs(lens_q, lens_k, causal, window, mk)
    starts = cu_k.tolist()
    for i, (lq, n) in enumerate(zip(lens_q, lens_k)):
        if lq == 0 and (dk[starts[i]:starts[i] + n].any()
                        or dv[starts[i]:starts[i] + n].any()):
            raise AssertionError(f"{label}: dk/dv of keys no query sees")

    live = sum(pairs) * h
    elt = 2
    q_side = q.numel() * elt   # q, o, do, dq each
    kv_side = k.numel() * elt  # k, v, dk, dv each
    stats = 2 * h * q.shape[0] * 4  # lse, delta
    bound_ms, bound_by = bound(10 * d * live, 4 * q_side + 4 * kv_side
                               + stats)
    dq_bound = bound(6 * d * live, 3 * q_side + 2 * kv_side + stats)
    dkv_bound = bound(8 * d * live, 2 * q_side + 4 * kv_side + stats)
    copies = input_copies(do, q, k, v, o, lse)
    fn = lambda *a: vl.varlen_attn_bwd(*a, *args, **kw)  # noqa: E731
    kernel_ms = time_ms(fn, copies)
    dev_ms = kernel_device_ms(fn, copies, ("flash_bwd_dq_kernel",
                                           "flash_bwd_dkv_kernel"))
    plain_ms = call_ms(lambda *a: vl.varlen_attn_bwd_ref(*a, *args, **kw),
                       copies, iters=3, warmup=1)
    vl.launches_fwd, vl.launches_dq, vl.launches_dkv = before
    library_ms, library = None, None
    if with_library and softcap == 0.0 and not alibi and \
            window == (-1, -1):
        library_ms, library = sdpa_varlen_library(
            q, k, v, cu_q, cu_k, lens_q, lens_k, causal, backward=True)
    res = dict(phase="kernel_varlen_bwd", case=label, h=h, hk=hk, d=d,
               sequences=len(lens_q), total_q=sum(lens_q),
               total_k=sum(lens_k), causal=causal, window=list(window),
               softcap=softcap, alibi=alibi,
               **{f"max_abs_err_{n}": e[0] for n, e in errs.items()},
               **{f"plain_bf16_err_{n}": e[1] for n, e in errs.items()},
               bitwise_repeat=bitwise_repeat, kernel_ms=kernel_ms,
               dq_kernel_ms=dev_ms["flash_bwd_dq_kernel"],
               dkv_kernel_ms=dev_ms["flash_bwd_dkv_kernel"],
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
               dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
               library_ms=library_ms, library=library, flops=10 * d * live,
               share_of_bound=bound_ms / kernel_ms, dq_items=fb.last_dq_items)
    emit(res)
    return res


def kernel_varlen_phases():
    """Cases (a)-(e) of the packed varlen forward and (a), (b), (d) and an
    empty-k-sequence case of the backward."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(4)
    lens = torch.Generator().manual_seed(4)
    bert_lens = bert_batch_lengths()
    docs = varlen_lengths(lens, 8, 128, 4096)
    cross_q = varlen_lengths(lens, 16, 1, 1024)
    cross_k = varlen_lengths(lens, 16, 1, 2048)
    cross_q[3], cross_k[7] = 0, 0  # an empty q and an empty k sequence
    win = varlen_lengths(lens, 16, 64, 2048)
    half = varlen_lengths(lens, 32, 16, 1024)
    fwd, bwd = {}, {}
    fwd["a"] = varlen_fwd_case("a: BERT-base shape", bert_lens, bert_lens,
                               12, 12, 64, gen)
    fwd["b"] = varlen_fwd_case("b: packed causal GQA", docs, docs, 32, 8,
                               128, gen, causal=True)
    fwd["c"] = varlen_fwd_case("c: cross lengths, empty q and k sequences",
                               cross_q, cross_k, 16, 4, 128, gen,
                               causal=True)
    fwd["d"] = varlen_fwd_case("d: window (256, 0) + softcap 30 + ALiBi",
                               win, win, 12, 12, 64, gen, window=(256, 0),
                               softcap=30.0, alibi=True)
    fwd["e"] = varlen_fwd_case("e: fp16 causal", half, half, 16, 16, 128,
                               gen, dtype="float16", causal=True)
    bwd["a"] = varlen_bwd_case("a: BERT-base shape", bert_lens, bert_lens,
                               12, 12, 64, gen)
    bwd["b"] = varlen_bwd_case("b: packed causal GQA", docs, docs, 32, 8,
                               128, gen, causal=True)
    bwd["d"] = varlen_bwd_case("d: window (256, 0) + softcap 30 + ALiBi",
                               win, win, 12, 12, 64, gen, window=(256, 0),
                               softcap=30.0, alibi=True)
    bwd["c"] = varlen_bwd_case("c: cross lengths, empty q and k sequences",
                               cross_q, cross_k, 16, 4, 128, gen,
                               causal=True)
    torch.cuda.empty_cache()
    return fwd, bwd


def bert_batch_lengths():
    """The BERT batch's seeded lengths (16-512), shared by the model phase
    and kernel case (a)."""
    import torch

    return varlen_lengths(torch.Generator().manual_seed(0), BERT_BATCH, 16,
                          BERT_SEQ)


def bert_batch(dev, vocab):
    """input_ids, token_type_ids (segment A then B at a seeded split) and
    the attention mask of BERT_BATCH sequences padded to BERT_SEQ."""
    import torch

    gen = torch.Generator().manual_seed(1)
    lens = torch.tensor(bert_batch_lengths())
    ids = torch.randint(0, vocab, (BERT_BATCH, BERT_SEQ), generator=gen)
    pos = torch.arange(BERT_SEQ)[None, :]
    mask = pos < lens[:, None]
    split = (torch.rand(BERT_BATCH, generator=gen) * lens).long()
    types = ((pos >= split[:, None]) & mask).long()
    return ids.to(dev), types.to(dev), mask.to(dev)


def bert_counts():
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.kernels import varlen as vl

    return dict(varlen_fwd=vl.launches_fwd, varlen_dq=vl.launches_dq,
                varlen_dkv=vl.launches_dkv, flash_fwd=ff.launches,
                flash_bwd_dq=fb.launches_dq, flash_bwd_dkv=fb.launches_dkv)


def reset_bert_counts():
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.kernels import varlen as vl

    vl.launches_fwd = vl.launches_dq = vl.launches_dkv = 0
    ff.launches = fb.launches_dq = fb.launches_dkv = 0


def bert_grads(model, ids, types, mask, proj, unpad, deterministic=True):
    """Parameter gradients of sum(hidden * proj) on the valid rows, as one
    float32 vector on the CPU (in named_parameters order)."""
    import torch

    h, _ = model(ids, mask, types, unpad_varlen=unpad,
                 deterministic=deterministic)
    loss = (h.float() * proj * mask[..., None]).sum()
    params = [p for n, p in model.named_parameters()
              if not n.startswith("pooler")]
    grads = torch.autograd.grad(loss, params)
    return torch.cat([g.float().flatten().cpu() for g in grads])


def profile_bert_forwards(model, ids, mask, types, n, step_s):
    """`n` more unpadded forwards under `torch.profiler` (after the path's
    counts are read): device busy time per forward (the union of the
    kernel intervals), the device's idle share against the unprofiled
    forward time `step_s`, the varlen kernel's share of kernel time, and
    device ms per forward by kernel name, largest first."""
    import torch

    torch.cuda.synchronize()
    with torch.no_grad(), device_profiler() as prof:
        for _ in range(n):
            model(ids, mask, types, unpad_varlen=True)
        torch.cuda.synchronize()
    return dict(forwards=n, **profile_summary(
        prof, n, step_s, "forward", "attention", "flash_fwd"))


def bert_phase():
    """BertModel at BERT-base's full width and depth, bf16 weights from seed
    0, unpad_varlen=True: BERT_ITERS timed forwards of one batch (exactly 12
    varlen forward launches and no dense launch each), against the padded
    path (12 dense launches with seqused) and fp32 on the CPU; then one
    gradient on BERT_GRAD_SEQS sequences (12 + 12 + 12 varlen launches)
    against the padded path's and fp32 on the CPU."""
    import torch
    from flash_attn_tpu_torch.models.bert import BertConfig, BertModel

    cfg = BertConfig()  # bert-base-uncased
    L = cfg.num_hidden_layers
    model = BertModel(cfg, device=DEV, dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(0)).eval()
    ids, types, mask = bert_batch(DEV, cfg.vocab_size)
    tokens = int(mask.sum())
    with torch.no_grad():
        for _ in range(2):
            model(ids, mask, types, unpad_varlen=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_bert_counts()
        t0 = time.perf_counter()
        for _ in range(BERT_ITERS):
            h, pooled = model(ids, mask, types, unpad_varlen=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = bert_counts()
        peak = torch.cuda.max_memory_allocated()
        profile = profile_bert_forwards(model, ids, mask, types, 3,
                                        wall / BERT_ITERS)
        reset_bert_counts()
        t0 = time.perf_counter()
        h_pad, pooled_pad = model(ids, mask, types)
        torch.cuda.synchronize()
        padded_ms = (time.perf_counter() - t0) * 1e3
        pad_counts = bert_counts()
    want = dict(varlen_fwd=L * BERT_ITERS, varlen_dq=0, varlen_dkv=0,
                flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0)
    if counts != want:
        raise AssertionError(f"bert: launches {counts}, expected {want}")
    if pad_counts != dict(want, varlen_fwd=0, flash_fwd=L):
        raise AssertionError(f"bert padded: launches {pad_counts}")
    if not torch.isfinite(h).all() or not torch.isfinite(pooled).all():
        raise AssertionError("bert: non-finite output")
    if h[~mask].any():
        raise AssertionError("bert: padded rows of the unpadded output "
                             "are not 0")
    a, b = h[mask].double(), h_pad[mask].double()
    vs_padded = dict(
        cosine=float(a.flatten() @ b.flatten() / (a.norm() * b.norm())),
        mean_abs_diff=float((a - b).abs().mean()),
        max_abs_diff=float((a - b).abs().max()),
        pooled_max_abs_diff=float((pooled - pooled_pad).abs().max()))

    # fp32 on the CPU, first 4 sequences (the plain path)
    ref = BertModel(cfg, device="cpu").eval()
    ref.load_state_dict({k: v.float().cpu()
                         for k, v in model.state_dict().items()})
    n = 4
    sel = mask[:n].cpu()
    with torch.no_grad():
        h_ref, _ = ref(ids[:n].cpu(), sel, types[:n].cpu(),
                       unpad_varlen=True)
    err_unp = float((h[:n].cpu()[sel].float() - h_ref[sel]).abs().max())
    err_pad = float((h_pad[:n].cpu()[sel].float() - h_ref[sel]).abs().max())

    # one gradient, on BERT_GRAD_SEQS sequences
    g = BERT_GRAD_SEQS
    proj = torch.randn(g, BERT_SEQ, cfg.hidden_size,
                       generator=torch.Generator().manual_seed(2))
    gi, gt, gm = ids[:g], types[:g], mask[:g]
    reset_bert_counts()
    g_unp = bert_grads(model, gi, gt, gm, proj.to(DEV), True)
    torch.cuda.synchronize()
    grad_counts = bert_counts()
    g_pad = bert_grads(model, gi, gt, gm, proj.to(DEV), False)
    g_cpu = bert_grads(ref, gi.cpu(), gt.cpu(), gm.cpu(), proj, True)
    del ref
    want_g = dict(varlen_fwd=L, varlen_dq=L, varlen_dkv=L, flash_fwd=0,
                  flash_bwd_dq=0, flash_bwd_dkv=0)
    res = dict(phase="bert",
               model="BERT-base (bert-base-uncased widths, 12 layers, "
               "random weights, seed 0)", dtype="bfloat16",
               sequences=BERT_BATCH, padded_to=BERT_SEQ, tokens=tokens,
               lengths_min=int(mask.sum(1).min()),
               lengths_max=int(mask.sum(1).max()), forwards=BERT_ITERS,
               wall_s=wall, forward_ms=wall / BERT_ITERS * 1e3,
               sequences_per_s=BERT_BATCH * BERT_ITERS / wall,
               tokens_per_s=tokens * BERT_ITERS / wall,
               padded_forward_ms=padded_ms, max_memory_allocated=peak,
               profile=profile,
               launches=counts, padded_launches=pad_counts,
               vs_padded=vs_padded, cpu_fp32_max_abs_err_unpadded=err_unp,
               cpu_fp32_max_abs_err_padded=err_pad,
               grad_sequences=g, grad_launches=grad_counts,
               grad_cosine_vs_padded=cosine(g_unp, g_pad),
               grad_cosine_vs_cpu_fp32=cosine(g_unp, g_cpu),
               grad_cosine_padded_vs_cpu_fp32=cosine(g_pad, g_cpu))
    emit(res)
    if not (vs_padded["cosine"] >= BERT_COSINE
            and vs_padded["mean_abs_diff"] <= BERT_MEAN_ATOL
            and vs_padded["pooled_max_abs_diff"] <= BERT_POOLED_ATOL):
        raise AssertionError(f"bert: unpadded and padded disagree "
                             f"{vs_padded}")
    if not err_unp <= 2 * err_pad + 1e-2:
        raise AssertionError(f"bert: fp32 CPU error {err_unp} > 2 x padded "
                             f"{err_pad} + 1e-2")
    if grad_counts != want_g:
        raise AssertionError(f"bert grad: launches {grad_counts}, expected "
                             f"{want_g}")
    if not (res["grad_cosine_vs_padded"] >= GRAD_COSINE
            and res["grad_cosine_vs_cpu_fp32"] >= GRAD_COSINE):
        raise AssertionError("bert: gradients disagree")
    del model, h, h_pad
    torch.cuda.empty_cache()
    return res


# The flex path: Llama-3-8B's attention widths (meta-llama/Meta-Llama-3-8B
# config.json: 32 layers, 32 heads, 8 kv heads, head dim 128) over one packed
# 8192-token pretraining sequence of seeded documents of 128-4096 tokens,
# under the causal document mask that Llama 3 pretraining uses between
# documents; blocks of 128, head-invariant tables.
FLEX_LAYERS = 32
FLEX_SEQ = 8192
FLEX_BLOCK = 128
FLEX_PROFILE_LAYERS = 3


def doc_lengths(gen, total, lo, hi):
    """Seeded document lengths of lo-hi tokens filling `total` tokens (the
    last one cut to fit)."""
    import torch

    lens = []
    while sum(lens) < total:
        lens.append(int(torch.randint(lo, hi + 1, (1,), generator=gen)))
    lens[-1] -= sum(lens) - total
    return lens


def doc_ids(lens):
    """(1, sum(lens)) int32 document ids on the card."""
    import torch

    return torch.repeat_interleave(
        torch.arange(len(lens)), torch.tensor(lens)).int()[None].to(DEV)


def causal_mod(b, h, q_idx, kv_idx):
    return q_idx >= kv_idx


def doc_mod(b, h, q_idx, kv_idx, qa, ka):
    return qa == ka


def doc_causal_mod(b, h, q_idx, kv_idx, qa, ka):
    return (qa == ka) & (q_idx >= kv_idx)


def window_causal_mod(b, h, q_idx, kv_idx):
    return (q_idx >= kv_idx) & (q_idx - kv_idx < 256)


def late_rows_mod(b, h, q_idx, kv_idx):
    return (q_idx >= 200) & (kv_idx <= q_idx + 500)


def flex_keep(bm, bits, sq, sk):
    """(b, th, sq, sk) bool: what the block lists keep (full blocks whole,
    partial blocks through the bits, keys < sk), the mask a dense library
    call needs for the same function."""
    import torch
    from flash_attn_tpu_torch.kernels import flex

    b, th, nq, _ = bm.kv_idx.shape
    nk, bq, bk = bm.q_idx.shape[2], bm.block_q, bm.block_k
    keep = torch.zeros(b, th, nq, nk, bq, bk, dtype=torch.bool, device=DEV)
    for num, idx, partial in ((bm.full_kv_num, bm.full_kv_idx, False),
                              (bm.kv_num, bm.kv_idx, True)):
        valid = torch.arange(idx.shape[-1], device=DEV) < num[..., None]
        bi, hi, qi, j = valid.nonzero(as_tuple=True)
        kb = idx[bi, hi, qi, j].long()
        if partial:
            slot = bits.slot[bi, hi, qi, kb].long()
            keep[bi, hi, qi, kb] = flex._unpack_bits(bits.words[slot], bk)
        else:
            keep[bi, hi, qi, kb] = True
    keep = keep.permute(0, 1, 2, 4, 3, 5).reshape(b, th, nq * bq, nk * bk)
    return keep[:, :, :sq, :sk]


def bias_live_bytes(keep, bias):
    """Bytes of the bias elements some kept pair reads (keep reduced over
    the bias's broadcast dimensions), float32; 0 without a bias."""
    if bias is None:
        return 0
    if bias.shape[0] == 1:
        keep = keep.any(0, keepdim=True)
    if bias.shape[1] == 1:
        keep = keep.any(1, keepdim=True)
    return int(keep.sum()) * (bias.shape[1] // keep.shape[1]) * 4


def flex_library_mask(keep, h, score_mod, bias):
    """SDPA's attn_mask for the same function: the bool keep mask, or, with
    a relative-position mod or a bias, a float mask carrying those terms
    (-inf where masked); None for a softcap, which SDPA cannot apply."""
    import torch
    from flash_attn_tpu_torch.kernels import flex

    if score_mod is not None and score_mod.code == flex._MOD_SOFTCAP:
        return None
    if score_mod is None and bias is None:
        return keep
    sq, sk = keep.shape[-2:]
    terms = torch.zeros(1, h, sq, sk, device=DEV)
    if bias is not None:
        terms = terms + bias
    if score_mod is not None:
        rel = (torch.arange(sq, device=DEV)[:, None]
               - torch.arange(sk, device=DEV)[None, :]).abs().float()
        terms = terms - score_mod.slopes.to(DEV).view(1, h, 1, 1) * rel
    return torch.where(keep, terms, -math.inf)


def sdpa_flex_inputs(q, k, v):
    """(b, h, s, d) copies of the flex inputs for SDPA, kv heads repeated
    to the query heads outside the timed call (SDPA's masked kernels take
    no GQA)."""
    g = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2).contiguous(),
            k.repeat_interleave(g, 2).transpose(1, 2).contiguous(),
            v.repeat_interleave(g, 2).transpose(1, 2).contiguous())


def flex_inputs(label, b, h, hk, sq, sk, d, gen, mask_mod, block=128,
                aux=None, score_mod=None, bias=None, head_invariant=True,
                block_mask=None):
    """One flex case: seeded bf16 q (b, sq, h, d), k, v (b, sk, hk, d), its
    BlockMask (built here, timed, unless given) and partial-block bits."""
    import torch
    from flash_attn_tpu_torch.kernels import flex

    q = torch.randn(b, sq, h, d, generator=gen, device=DEV).bfloat16()
    k = torch.randn(b, sk, hk, d, generator=gen, device=DEV).bfloat16()
    v = torch.randn(b, sk, hk, d, generator=gen, device=DEV).bfloat16()
    block_mask_ms = None
    if block_mask is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block_mask = flex.create_block_mask(
            mask_mod, b, h, sq, sk, block_q=block, block_k=block, q_aux=aux,
            kv_aux=aux, head_invariant=head_invariant, device=DEV)
        torch.cuda.synchronize()
        block_mask_ms = (time.perf_counter() - t0) * 1e3
    bits = flex.partial_block_bits(block_mask, mask_mod, aux, aux, sk)
    return dict(label=label, q=q, k=k, v=v, bm=block_mask, mask_mod=mask_mod,
                bits=bits, kw=(block_mask, bits, score_mod, d ** -0.5, aux,
                               aux, bias),
                block_mask_ms=block_mask_ms, score_mod=score_mod, bias=bias,
                aux=aux)


def flex_fwd_case(c, **extra):
    """`flex_fwd_kernel` against `flex_attn_fwd_ref` (fp32 oracle, bf16
    yardstick) on o and lse; kernel (cold inputs), mask preparation (the
    partial-block bits, once per call), plain version and SDPA on the
    materialised mask (dense work) timed beside the bound: 4*d FLOPs per
    live pair (full blocks' elements plus the bits' kept pairs) against q,
    k, v, o (and the bias's live elements) bytes.  `extra` goes into the case's JSON line."""
    import torch
    from flash_attn_tpu_torch.kernels import flex

    q, k, v, kw, label = c["q"], c["k"], c["v"], c["kw"], c["label"]
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o, lse = flex.flex_attn_fwd(q, k, v, *kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = flex.flex_attn_fwd_ref(q.float(), k.float(), v.float(),
                                            *kw)
    o_pt, lse_pt = flex.flex_attn_fwd_ref(q, k, v, *kw)
    if not torch.isfinite(o).all():
        raise AssertionError(f"{label}: non-finite output")
    rows_ok = torch.ones(b, h, sq, dtype=torch.bool, device=DEV)
    err_o, err_o_pt, err_l, err_l_pt = check_attention(
        label, o.transpose(1, 2), lse, o_ref.transpose(1, 2), lse_ref,
        o_pt.transpose(1, 2), lse_pt, rows_ok)
    empty_rows = int(torch.isinf(lse_ref).sum())
    del o_ref, lse_ref, o_pt, lse_pt
    keep = flex_keep(c["bm"], c["bits"], sq, sk)
    live = int(keep.sum()) * (h // keep.shape[1])
    bias = c["bias"]
    bytes_ = ((2 * q.numel() + k.numel() + v.numel()) * 2 + b * h * sq * 4
              + bias_live_bytes(keep, bias))
    bound_ms, bound_by = bound(4 * d * live, bytes_)
    prep = (lambda: flex.partial_block_bits(c["bm"], c["mask_mod"], c["aux"],
                                            c["aux"], sk))
    mask_prep_ms = call_ms(prep, [()], iters=5, warmup=1)
    copies = input_copies(q, k, v)
    fn = lambda *a: flex.flex_attn_fwd(*a, *kw)  # noqa: E731
    before = flex.launches_fwd
    kernel_ms = time_ms(fn, copies)
    kernel_call_ms = call_ms(fn, copies)
    plain_ms = call_ms(lambda *a: flex.flex_attn_fwd_ref(*a, *kw), copies,
                       iters=3, warmup=1)
    flex.launches_fwd = before  # timing launches are not the main path's
    library_ms = None
    mask = flex_library_mask(keep, h, c["score_mod"], bias)
    if mask is not None:
        import torch.nn.functional as F

        library_ms = time_ms(
            lambda qh, kh, vh, m: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=m, scale=d ** -0.5),
            input_copies(*sdpa_flex_inputs(q, k, v), mask))
    bm = c["bm"]
    res = dict(phase="kernel_flex", case=label, b=b, h=h, hk=k.shape[2],
               sq=sq, sk=sk, d=d, block_q=bm.block_q, block_k=bm.block_k,
               tile=flex.fwd_tile(bm.block_q, bm.block_k),
               head_invariant=bm.kv_num.shape[1] == 1,
               score_mod=repr(c["score_mod"]),
               bias=None if bias is None else list(bias.shape),
               block_density=bm.sparsity, partial_blocks=int(
                   c["bits"].words.shape[0]),
               live_pairs=live, empty_rows=empty_rows,
               max_abs_err_o=err_o, plain_bf16_err_o=err_o_pt,
               max_abs_err_lse=err_l, plain_bf16_err_lse=err_l_pt,
               kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               mask_prep_ms=mask_prep_ms,
               block_mask_ms=c["block_mask_ms"], plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               library=None if mask is None else
               "sdpa, materialised mask (dense work)",
               flops=4 * d * live, bytes=bytes_,
               share_of_bound=bound_ms / kernel_ms, **extra)
    emit(res)
    return res


def flex_bwd_case(c):
    """`flex_bwd_dq_kernel` and `flex_bwd_dkv_kernel` against
    `flex_attn_bwd_ref` (fp32 oracle, bf16 yardstick) on dq, dk, dv and
    dbias; a second call bitwise equal; each kernel's device time
    (profiler), the plain version and SDPA's backward on the materialised
    mask timed beside the bounds (6*d and 8*d FLOPs per live pair; the
    bias's live elements read, dbias written once in the bias's shape)."""
    import torch
    from flash_attn_tpu_torch.kernels import flex
    from flash_attn_tpu_torch.utils.testing import check_close

    q, k, v, kw, label = c["q"], c["k"], c["v"], c["kw"], c["label"]
    b, sq, h, d = q.shape
    sk = k.shape[1]
    gen = torch.Generator(device=DEV).manual_seed(11)
    before = flex.launches_fwd, flex.launches_dq, flex.launches_dkv
    o, lse = flex.flex_attn_fwd(q, k, v, *kw)
    do = torch.randn(q.shape, generator=gen, device=DEV).bfloat16()
    grads = flex.flex_attn_bwd(do, q, k, v, o, lse, *kw)
    torch.cuda.synchronize()
    ref = flex.flex_attn_bwd_ref(do.float(), q.float(), k.float(), v.float(),
                                 o.float(), lse, *kw)
    pt = flex.flex_attn_bwd_ref(do, q, k, v, o, lse, *kw)
    errs = {}
    for name, x, r, y in zip(("dq", "dk", "dv", "dbias"), grads, ref, pt):
        if x is None:
            continue
        if not torch.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite {name}")
        errs[name] = check_close(x, r, y, label=f"{label} {name}")
    del ref, pt
    again = flex.flex_attn_bwd(do, q, k, v, o, lse, *kw)
    if not all(x is None or torch.equal(x, y) for x, y in zip(grads, again)):
        raise AssertionError(f"{label}: two backward runs differ")
    del again
    keep = flex_keep(c["bm"], c["bits"], sq, sk)
    live = int(keep.sum()) * (h // keep.shape[1])
    bias = c["bias"]
    q_side, kv_side = q.numel() * 2, k.numel() * 2
    stats = 2 * b * h * sq * 4
    bias_b = bias_live_bytes(keep, bias)
    dbias_b = 0 if bias is None else bias.numel() * 4
    dq_bound = bound(6 * d * live, 3 * q_side + 2 * kv_side + stats + bias_b
                     + dbias_b)
    dkv_bound = bound(8 * d * live, 2 * q_side + 4 * kv_side + stats + bias_b)
    copies = input_copies(do, q, k, v, o, lse)
    fn = lambda *a: flex.flex_attn_bwd(*a, *kw)  # noqa: E731
    kernel_ms = time_ms(fn, copies, iters=10)
    dev_ms = kernel_device_ms(fn, copies, ("flex_bwd_dq_kernel",
                                           "flex_bwd_dkv_kernel"), iters=10)
    plain_ms = call_ms(lambda *a: flex.flex_attn_bwd_ref(*a, *kw), copies,
                       iters=2, warmup=1)
    flex.launches_fwd, flex.launches_dq, flex.launches_dkv = before
    library_ms = None
    mask = flex_library_mask(keep, h, c["score_mod"], bias)
    if mask is not None:
        import torch.nn.functional as F

        graphs = []
        for qc, kc, vc, dc in input_copies(*sdpa_flex_inputs(q, k, v),
                                           do.transpose(1, 2).contiguous()):
            ins = [t.detach().requires_grad_() for t in (qc, kc, vc)]
            out = F.scaled_dot_product_attention(*ins, attn_mask=mask,
                                                 scale=d ** -0.5)
            graphs.append((out, ins, dc))
        library_ms = time_ms(lambda out, ins, dc: torch.autograd.grad(
            out, ins, dc, retain_graph=True), graphs, iters=10)
        del graphs
    res = dict(phase="kernel_flex_bwd", case=label, b=b, h=h, hk=k.shape[2],
               sq=sq, sk=sk, d=d,
               tile=flex.bwd_tile(c["bm"].block_q, c["bm"].block_k),
               **{f"max_abs_err_{n}": e[0] for n, e in errs.items()},
               **{f"plain_bf16_err_{n}": e[1] for n, e in errs.items()},
               bitwise_repeat=True, kernel_ms=kernel_ms,
               dq_kernel_ms=dev_ms["flex_bwd_dq_kernel"],
               dkv_kernel_ms=dev_ms["flex_bwd_dkv_kernel"],
               plain_ms=plain_ms, dq_bound_ms=dq_bound[0],
               dq_bound_by=dq_bound[1], dkv_bound_ms=dkv_bound[0],
               dkv_bound_by=dkv_bound[1], library_ms=library_ms,
               library=None if mask is None else
               "sdpa backward, materialised mask (dense work)",
               live_pairs=live,
               dq_share_of_bound=dq_bound[0] / dev_ms["flex_bwd_dq_kernel"],
               dkv_share_of_bound=dkv_bound[0]
               / dev_ms["flex_bwd_dkv_kernel"])
    emit(res)
    return res


def compiled_flex_ms(c):
    """torch.nn.attention.flex_attention under torch.compile on the inputs
    of case `c` (a document mask), as a second yardstick, forward (`ms`)
    and backward (`bwd_ms`: dQ, dK and dV together from one autograd.grad
    of the compiled forward's output): no check depends on them, and a
    failure to compile is recorded as such, each apart."""
    import torch

    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        docs = c["aux"][0]
        q, k, v = (x.transpose(1, 2).contiguous()
                   for x in (c["q"], c["k"], c["v"]))
        sq = q.shape[2]
        bm = create_block_mask(lambda b, h, qi, ki: docs[qi] == docs[ki],
                               None, None, sq, sq, device=DEV,
                               BLOCK_SIZE=c["bm"].block_q)
        fn = torch.compile(flex_attention)
        t0 = time.perf_counter()
        fn(q, k, v, block_mask=bm, enable_gqa=True)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        ms = time_ms(lambda a, b_, c_: fn(a, b_, c_, block_mask=bm,
                                           enable_gqa=True),
                     input_copies(q, k, v))
        res = dict(ms=ms, compile_s=compile_s)
    except Exception as e:  # a yardstick only
        return dict(error=f"{type(e).__name__}: {str(e)[:300]}")
    try:
        gen = torch.Generator(device=DEV).manual_seed(11)
        do = torch.randn(q.shape, generator=gen, device=DEV).bfloat16()
        graphs = []
        for qc, kc, vc, dc in input_copies(q, k, v, do):
            ins = [t.detach().requires_grad_() for t in (qc, kc, vc)]
            graphs.append((fn(*ins, block_mask=bm, enable_gqa=True), ins,
                           dc))
        t0 = time.perf_counter()
        torch.autograd.grad(*graphs[0], retain_graph=True)
        torch.cuda.synchronize()
        res["bwd_compile_s"] = time.perf_counter() - t0
        res["bwd_ms"] = time_ms(lambda out, ins, dc: torch.autograd.grad(
            out, ins, dc, retain_graph=True), graphs, iters=10)
        del graphs
    except Exception as e:  # a yardstick only
        res["bwd_error"] = f"{type(e).__name__}: {str(e)[:300]}"
    return res


def flex_varlen_case(gen):
    """Case (i): `flash_attn_varlen_packed_func` (the flex path, blocks of
    128) on the `bert` batch's 64 sequences, within `check_close` of the
    fp32 oracle against the varlen kernel's own error
    (`flash_attn_varlen_func`'s packed route, row 10's kernel); then its
    flex forward against the plain version like the other cases."""
    import torch
    from flash_attn_tpu_torch.kernels import flex
    from flash_attn_tpu_torch.kernels import varlen as vl
    from flash_attn_tpu_torch.kernels import varlen_packed as vp
    from flash_attn_tpu_torch.utils.testing import check_close

    lens = bert_batch_lengths()
    q, k, v, cu, _ = varlen_inputs(lens, lens, 12, 12, 64, gen,
                                   torch.bfloat16)
    m, total, blk = max(lens), q.shape[0], 128
    before = flex.launches_fwd, vl.launches_fwd
    o_flex = vp.flash_attn_varlen_packed_func(q, k, v, cu, cu, m, m,
                                              block_q=blk, block_k=blk)
    args = (cu, cu, m, m)
    o_var, _ = vl.varlen_attn_fwd(q, k, v, *args, softmax_scale=0.125)
    flex.launches_fwd, vl.launches_fwd = before
    o_ref, _ = vl.varlen_attn_fwd_ref(q.float(), k.float(), v.float(), *args,
                                      softmax_scale=0.125)
    err, err_varlen = check_close(o_flex, o_ref, o_var,
                                  label="i: packed varlen vs varlen kernel")
    tp = -(-total // blk) * blk
    aux = vp._segment_aux(cu, total, tp)[None]
    bm = vp.varlen_block_mask(cu, cu, tp, tp, causal=False, block_q=blk,
                              block_k=blk, nheads=1)
    c = flex_inputs("i: packed varlen (BERT batch)", 1, 12, 12, total, total,
                    64, gen, vp.make_varlen_mask_mod(False), aux=aux,
                    block_mask=bm)
    c["q"], c["k"], c["v"] = q[None], k[None], v[None]
    return flex_fwd_case(c, vs_varlen_kernel_err=err,
                         varlen_kernel_err=err_varlen)


def kernel_flex_phases():
    """Cases (a)-(i) of the flex forward, (a) and (c)-(h) of the backward,
    and torch.compile'd flex_attention at case (c)."""
    import torch
    from flash_attn_tpu_torch import blocksparse
    from flash_attn_tpu_torch.kernels import flex

    gen = torch.Generator(device=DEV).manual_seed(7)
    lens = torch.Generator().manual_seed(7)
    cases = {
        "a": flex_inputs("a: GPT-2 small, causal", 8, 12, 12, 1024, 1024,
                         64, gen, causal_mod),
        "b": flex_inputs("b: sliding window 256 + causal", 4, 16, 16, 2048,
                         2048, 128, gen, window_causal_mod),
        "c": flex_inputs("c: document mask through aux, Llama-3-8B widths",
                         1, 32, 8, FLEX_SEQ, FLEX_SEQ, 128, gen, doc_mod,
                         aux=doc_ids(doc_lengths(lens, FLEX_SEQ, 128, 4096))),
        "d": flex_inputs("d: softcap 30 + causal", 4, 16, 16, 2048, 2048,
                         128, gen, causal_mod, score_mod=flex.softcap(30.0)),
        "e": flex_inputs("e: relative position (ALiBi slopes), GQA, causal",
                         2, 32, 8, 2048, 2048, 128, gen, causal_mod,
                         score_mod=flex.relative_position(
                             2.0 ** (-8.0 * torch.arange(1, 33) / 32))),
        "f": flex_inputs("f: attn_bias (1, h, sq, sk) + causal", 2, 16, 16,
                         2048, 2048, 64, gen, causal_mod,
                         bias=torch.randn(1, 16, 2048, 2048, generator=gen,
                                          device=DEV) * 0.5),
        "g": flex_inputs("g: ragged sq 1000, sk 1500, empty rows", 2, 16, 16,
                         1000, 1500, 64, gen, late_rows_mod),
    }
    layout = torch.rand(8, 8, generator=torch.Generator().manual_seed(8)) \
        < 0.4
    layout |= torch.eye(8, dtype=torch.bool)
    cases["h"] = flex_inputs(
        "h: flash_blocksparse_attn_func, seeded 8x8 layout of 512-blocks", 2,
        16, 16, 4096, 4096, 64, gen, None,
        block_mask=blocksparse.convert_blockmask(
            layout, 2, 16, 4096, 4096, block_q=512, block_k=512, device=DEV))
    fwd = {key: flex_fwd_case(c) for key, c in cases.items()}
    # the entry point reads q, k, v from qkv in place: the same kernel on
    # the same values gives the same bits
    c = cases["h"]
    before = flex.launches_fwd
    o_bs = blocksparse.flash_blocksparse_attn_func(
        torch.stack([c["q"], c["k"], c["v"]], dim=2), layout, block_q=512,
        block_k=512)
    flex.launches_fwd = before
    if not torch.equal(o_bs, flex.flex_attn_fwd(c["q"], c["k"], c["v"],
                                                 *c["kw"])[0]):
        raise AssertionError("h: flash_blocksparse_attn_func differs from "
                             "flex_attn_fwd on the same block mask")
    flex.launches_fwd = before
    fwd["i"] = flex_varlen_case(gen)
    bwd = {key: flex_bwd_case(cases[key])
           for key in ("a", "c", "d", "e", "f", "g", "h")}
    compiled = compiled_flex_ms(cases["c"])
    emit(dict(phase="kernel_flex_compiled", case=cases["c"]["label"],
              **compiled))
    del cases
    torch.cuda.empty_cache()
    return fwd, bwd, compiled


def flex_phase():
    """The flex path at Llama-3-8B's attention widths: for each of its 32
    layers, seeded q, k, v and dO through `flex_attention` forward and
    backward under the causal document mask (one BlockMask, head-invariant,
    128-blocks, built once); exactly 32 + 32 + 32 flex launches; layer 0's
    o, lse and gradients against the plain version; attention tokens/s,
    forward and backward ms a layer, the mask preparation, block density,
    peak memory and the device's idle share over 3 profiled layers."""
    import torch
    from flash_attn_tpu_torch.kernels import flex
    from flash_attn_tpu_torch.utils.testing import check_close

    s, h, hk, d = FLEX_SEQ, 32, 8, 128
    lens = doc_lengths(torch.Generator().manual_seed(5), s, 128, 4096)
    doc = doc_ids(lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bm = flex.create_block_mask(doc_causal_mod, 1, h, s, s,
                                block_q=FLEX_BLOCK, block_k=FLEX_BLOCK,
                                q_aux=doc, kv_aux=doc, head_invariant=True,
                                device=DEV)
    torch.cuda.synchronize()
    block_mask_ms = (time.perf_counter() - t0) * 1e3
    gen = torch.Generator(device=DEV).manual_seed(6)

    def layer_inputs():
        q = torch.randn(1, s, h, d, generator=gen, device=DEV).bfloat16()
        k = torch.randn(1, s, hk, d, generator=gen, device=DEV).bfloat16()
        v = torch.randn(1, s, hk, d, generator=gen, device=DEV).bfloat16()
        do = torch.randn(1, s, h, d, generator=gen, device=DEV).bfloat16()
        return [x.requires_grad_() for x in (q, k, v)] + [do]

    def attention(q, k, v):
        return flex.flex_attention(q, k, v, mask_mod=doc_causal_mod,
                                   block_mask=bm, q_aux=doc, kv_aux=doc,
                                   return_lse=True)

    q, k, v, do = layer_inputs()  # warm-up, outside the counts
    attention(q, k, v)[0].backward(do)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in ("launches_fwd", "launches_dq", "launches_dkv"):
        setattr(flex, name, 0)
    fwd_ms, bwd_ms = [], []
    for layer in range(FLEX_LAYERS):
        q, k, v, do = layer_inputs()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        o, lse = attention(q, k, v)
        ev[1].record()
        o.backward(do)
        ev[2].record()
        torch.cuda.synchronize()
        fwd_ms.append(ev[0].elapsed_time(ev[1]))
        bwd_ms.append(ev[1].elapsed_time(ev[2]))
        if layer == 0:
            first = (q, k, v, do, o.detach(), lse,
                     [x.grad for x in (q, k, v)])
    counts = dict(flex_fwd=flex.launches_fwd, flex_dq=flex.launches_dq,
                  flex_dkv=flex.launches_dkv)
    peak = torch.cuda.max_memory_allocated()
    want = dict(flex_fwd=FLEX_LAYERS, flex_dq=FLEX_LAYERS,
                flex_dkv=FLEX_LAYERS)
    if counts != want:
        raise AssertionError(f"flex: launches {counts}, expected {want}")

    # layer 0 against the plain version
    q, k, v, do, o, lse, grads = first
    bits = flex.partial_block_bits(bm, doc_causal_mod, doc, doc, s)
    kw = (bm, bits, None, d ** -0.5, doc, doc, None)
    q, k, v = (x.detach() for x in (q, k, v))
    o_ref, lse_ref = flex.flex_attn_fwd_ref(q.float(), k.float(), v.float(),
                                            *kw)
    o_pt, lse_pt = flex.flex_attn_fwd_ref(q, k, v, *kw)
    rows_ok = torch.ones(1, h, s, dtype=torch.bool, device=DEV)
    errs = dict(zip(("o", "o_plain_bf16", "lse", "lse_plain_bf16"),
                    check_attention("flex layer 0", o.transpose(1, 2), lse,
                                    o_ref.transpose(1, 2), lse_ref,
                                    o_pt.transpose(1, 2), lse_pt, rows_ok)))
    del o_ref, o_pt
    ref = flex.flex_attn_bwd_ref(do.float(), q.float(), k.float(), v.float(),
                                 o.float(), lse, *kw)
    pt = flex.flex_attn_bwd_ref(do, q, k, v, o, lse, *kw)
    for name, x, r, y in zip(("dq", "dk", "dv"), grads, ref, pt):
        if not torch.isfinite(x).all():
            raise AssertionError(f"flex layer 0: non-finite {name}")
        errs[name], errs[f"{name}_plain_bf16"] = check_close(
            x, r, y, label=f"flex layer 0 {name}")
    del ref, pt, first, grads
    mask_prep_ms = call_ms(
        lambda: flex.partial_block_bits(bm, doc_causal_mod, doc, doc, s),
        [()], iters=5, warmup=1)

    # the device's idle share over FLEX_PROFILE_LAYERS more layers
    ins = [layer_inputs() for _ in range(FLEX_PROFILE_LAYERS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for q, k, v, do in ins:
        attention(q, k, v)[0].backward(do)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / FLEX_PROFILE_LAYERS
    with device_profiler() as prof:
        for q, k, v, do in ins:
            attention(q, k, v)[0].backward(do)
        torch.cuda.synchronize()
    profile = dict(layers=FLEX_PROFILE_LAYERS, **profile_summary(
        prof, FLEX_PROFILE_LAYERS, step_s, "layer", "flex", "flex_"))
    del ins, prof
    layer_ms = sum(fwd_ms) + sum(bwd_ms)
    res = dict(phase="flex",
               model="Llama-3-8B attention (32 layers, 32 heads, 8 kv heads, "
               "head dim 128), bf16, random q/k/v/dO per layer",
               tokens=s, documents=len(lens), doc_min=min(lens),
               doc_max=max(lens), block=FLEX_BLOCK,
               block_density=bm.sparsity, block_mask_ms=block_mask_ms,
               mask_prep_ms=mask_prep_ms, layers=FLEX_LAYERS,
               forward_ms_per_layer=sum(fwd_ms) / FLEX_LAYERS,
               backward_ms_per_layer=sum(bwd_ms) / FLEX_LAYERS,
               attention_tokens_per_s=s * FLEX_LAYERS / (layer_ms * 1e-3),
               max_memory_allocated=peak, launches=counts,
               layer0_errs=errs, profile=profile)
    emit(res)
    torch.cuda.empty_cache()
    return res


DIAG_LADDER_ITERS = 16  # the CLI's 64 chained calls a leg, cut for time


def ladder_oracle(q, kc, vc, int8):
    """float64 `full` of the decode ladder: sum_j exp(s_j - max s) v_j over
    the whole cache (x 0.0883883 for int8), s the probe's scaled scores."""
    import torch
    from flash_attn_tpu_torch.diag import int8_decode

    b, hk, rows, d = q.shape
    smax = kc.shape[1]
    kf = kc.double().view(b, smax, hk, d).transpose(1, 2)
    vf = vc.double().view(b, smax, hk, d).transpose(1, 2)
    s = q.double() @ kf.transpose(-1, -2)
    if int8:
        s = s.float().double()
    s = s * float(torch.tensor(int8_decode.SCALE, dtype=torch.float32))
    out = torch.exp(s - s.amax(-1, keepdim=True)) @ vf
    return (out * int8_decode.SCALE if int8 else out)[:, None]


def sum_check(label, got, ref, extra=0.0):
    """|got - ref| <= 1e-5 max|ref| + extra (sums, summation order only);
    returns the error."""
    err = (got.double() - ref.double()).abs().max().item()
    tol = 1e-5 * ref.double().abs().max().item() + extra
    if not err <= tol:
        raise AssertionError(f"{label}: sum err {err:.3e} > {tol:.3e}")
    return err


def diag_ladder_checks():
    """Every ladder stage, bf16 and int8, at the script's shape (b=8, hk=8,
    smax=8192, d=128, bk=1024) at one split and at the split that fills the
    card, against its 64-key twin (`max_every=64`, the kernel's own
    function) and its bk twin (JAX's); `full` against the float64 oracle
    (2x rule, each twin's error the yardstick).  pquant may differ by one
    bf16 rounding of a block sum (bf16) or one step of round(127 p) a row
    (int8), where exp2f and the twin's exp2 straddle a rounding boundary
    or P is quantised against another max."""
    from flash_attn_tpu_torch.diag import int8_decode as ld
    from flash_attn_tpu_torch.utils.testing import check_close

    out = {}
    for int8 in (False, True):
        q, kc, vc = ld.make_inputs(int8)
        fill = ld.fill_splits(8, 8, 8192, 1024, int8=int8)
        oracle = ladder_oracle(q, kc, vc, int8)
        for splits in sorted({1, fill}):
            for stage in ld.STAGES:
                got = ld.decode_ladder(stage, q, kc, vc, bk=1024,
                                       splits=splits)
                label = f"ladder {'int8' if int8 else 'bf16'} {stage} " \
                    f"splits={splits}"
                if stage != "full" and got[..., 1:].any():
                    raise AssertionError(f"{label}: columns 1.. not 0")
                errs = []
                for every in (64, 1024):
                    ref = ld.decode_ladder_ref(stage, q, kc, vc, bk=1024,
                                               splits=splits,
                                               max_every=every)
                    at = f"{label} max_every={every}"
                    if stage == "full":
                        errs.append(check_close(got, oracle.float(), ref,
                                                label=at)[0])
                        continue
                    extra = 0.0
                    if stage == "pquant":
                        extra = (1.0 if int8 else
                                 2.0 ** -8 * ref.abs().max().item())
                    errs.append(sum_check(at, got, ref, extra))
                out[label] = max(errs)
        del q, kc, vc, oracle
    return out


def diag_stream_checks():
    """Every stream variant of the script at its full 512 MiB shape against
    the plain twin (sums, 1e-5 of their magnitude), and one bitwise
    repeat."""
    import torch
    from flash_attn_tpu_torch.diag import dma_stream as ds

    out = {}
    for R, bundle, shuffled, fused in ds.VARIANTS:
        arr, table, _ = ds.make_case(R, bundle, shuffled, fused)
        got = ds.dma_stream(arr, table, bundle=bundle, fused=fused)
        ref = ds.dma_stream_ref(arr, table, bundle=bundle, fused=fused)
        label = f"stream R={R} bundle={bundle} shuf={shuffled} fused={fused}"
        out[label] = sum_check(label, got, ref)
        if (R, bundle, shuffled, fused) == (512, 2, True, False):
            again = ds.dma_stream(arr, table, bundle=bundle, fused=fused)
            if not torch.equal(got, again):
                raise AssertionError("stream: repeat run not bitwise equal")
    return out


def diag_bisect_checks():
    """The bisect levels that write o (K3..K10) at the script's widths (H=16,
    D=128, BQ=BK=1024, BH=4, 16 blocks of tokens) on live tables of 10 or 8
    ticks (the plain twin walks ticks in Python: the script's 256 would be
    slow), aux of 300-token documents so that boundary ticks mask; o and
    lse against the twin run in float64 by the 2x rule (the bf16 twin's
    error the yardstick: the kernel's scores are tensor-core sums, whose
    rounding the float32 twin does not share).  Returns {variant: max |o -
    float64 twin|}."""
    import torch
    from flash_attn_tpu_torch.diag import varlen_overhead_bisect as vb
    from flash_attn_tpu_torch.utils.testing import check_close

    gen = torch.Generator(device=DEV).manual_seed(7)
    q, k, v = (torch.randn(vb.H, vb.TOTAL_P, vb.D, generator=gen,
                           device=DEV).bfloat16() for _ in range(3))
    qa, ka = (x.to(DEV) for x in vb.make_aux(vb.TOTAL_P, vb.BK))
    out = {}
    for variant in ("K3", "K4", "K6", "K7", "K8", "K9", "K10"):
        kind = {"K9": "code", "K10": "k10"}.get(variant, "init")
        qi, ki, fl, code = (torch.tensor(x, dtype=torch.int32, device=DEV)
                            for x in vb.live_tables(kind, n_bodies=2))
        lse_lanes = variant in ("K7", "K8")

        def run(fns, q, k, v, qi=qi, ki=ki, fl=fl, code=code,
                variant=variant, lse_lanes=lse_lanes):
            if variant in ("K3", "K4"):
                return fns[0](int(variant[1]), qi, ki, fl, q, k, v, qa,
                              ka), None
            if variant == "K9":
                return fns[2](qi, ki, fl, code, q, k, v, qa, ka), None
            if variant == "K10":
                return fns[3](2, 4, qi, ki, fl, q, k, v), None
            res = fns[1](qi, ki, fl, q, k, v, qa, ka, lse_lanes=lse_lanes,
                         four_variants=variant in ("K6", "K8"))
            return res[0], (res[1] if lse_lanes else None)

        o, lse = run((vb.launch, vb.launch2, vb.launch3, vb.launch4), q, k, v)
        twins = (vb.launch_ref, vb.launch2_ref, vb.launch3_ref, vb.launch4_ref)
        o_pt, lse_pt = run(twins, q, k, v)
        o_ref, lse_ref = run(twins, q.double(), k.double(), v.double())
        rows = vb.finalized_rows(qi.cpu(), fl.cpu()).to(DEV)
        if not (o_ref[:, rows].abs().amax(-1) > 0).all():
            raise AssertionError(f"bisect {variant}: a finalized row saw "
                                 "no key: the check would be empty")
        err, _ = check_close(o[:, rows], o_ref[:, rows], o_pt[:, rows],
                             label=f"bisect {variant} o")
        if lse_lanes:
            check_close(lse[:, rows], lse_ref[:, rows], lse_pt[:, rows],
                        label=f"bisect {variant} lse")
        out[variant] = err
    del q, k, v
    return out


def diag_phase():
    """The three diagnostic probes on the card at the JAX scripts' full
    shapes.  First each probe kernel against its plain twin (launches not
    counted); then the probes' own entry points (`main`) with the launch
    counts set to 0 just before and read just after: `dma_stream` (30
    variants, 512 MiB each; every GB/s at most the card's 3.35 TB/s),
    `int8_decode` (the ladder at one split and at the filling split, the
    int8 bk sweep, the end-to-end decode; DIAG_LADDER_ITERS chained calls a
    leg) and `varlen_overhead_bisect` k04 k58 k9 k10 (all-empty tables of
    256 ticks).  Then each probe's headline kernel, its plain twin and a
    library call are timed for the kernels line, and the ladder's `full`
    rung beside the production decode kernel on the same cache."""
    import torch
    from flash_attn_tpu_torch.diag import dma_stream as ds
    from flash_attn_tpu_torch.diag import int8_decode as ld
    from flash_attn_tpu_torch.diag import varlen_overhead_bisect as vb

    t0 = time.perf_counter()
    checks = dict(ladder=diag_ladder_checks(), stream=diag_stream_checks(),
                  bisect=diag_bisect_checks())
    check_s = time.perf_counter() - t0

    mods = dict(diag_dma_stream=ds, diag_int8_decode=ld,
                diag_varlen_bisect=vb)
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    stream = ds.main([])
    ladder = ld.main([], iters=DIAG_LADDER_ITERS)
    bis = vb.main(["k04", "k58", "k9", "k10"])
    path_s = time.perf_counter() - t0
    launches = {name: m.launches for name, m in mods.items()}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"diag: {name} was not launched")
    fastest = max(r["gbps"] for r in stream)
    if fastest > PEAK_BYTES / 1e9:
        raise AssertionError(f"stream: {fastest:.1f} GB/s is above the "
                             "card's memory rate: pages were not streamed")

    # headline numbers for the kernels line
    R, bundle, shuffled, fused = ds.VARIANTS[0]
    arr, table, steps = ds.make_case(R, bundle, shuffled, fused)
    sbytes = ds.stream_bytes(R, bundle, fused, steps)
    src = arr.view(-1)[: sbytes // 2]
    dst = torch.empty_like(src)
    stream_lib = time_ms(lambda s, d: d.copy_(s), [(src, dst)])
    stream_plain = call_ms(lambda a, t: ds.dma_stream_ref(
        a, t, bundle=bundle, fused=fused), [(arr, table)], iters=5)
    del dst

    # the full rung at the filling split and at one, beside the production
    # decode kernel on the same cache at the same split (device time, input
    # sets cycled through 4x the L2), bf16 and int8
    against = {}
    for int8 in (False, True):
        name = "int8" if int8 else "bf16"
        inputs = input_copies(*ld.make_inputs(int8))
        for key, splits in (("split1", 1),
                            ("fill", ladder["fill_splits"][name])):
            against[f"{name} full {key}"] = time_ms(
                lambda *a, n=splits: ld.decode_ladder("full", *a, bk=1024,
                                                      splits=n), inputs)
            against[f"{name} production {key}"] = time_ms(
                lambda *a, n=splits: ld.production_decode(*a, splits=n),
                inputs)
        del inputs
    print("diag: full rung against the production decode kernel (ms): "
          + json.dumps(against), flush=True)

    q, kc, vc = ld.make_inputs(False)
    b, hk, rows, d = q.shape
    kh = kc.view(b, 8192, hk, d).transpose(1, 2).contiguous()
    vh = vc.view(b, 8192, hk, d).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ladder_lib = time_ms(lambda q_, k_, v_: sdpa(q_, k_, v_, scale=ld.SCALE),
                         input_copies(q, kh, vh))
    ladder_plain = call_ms(lambda *a: ld.decode_ladder_ref(
        "full", *a, bk=1024), [(q, kc, vc)], iters=3)
    ladder_bytes = (ld.kv_bytes(False) + q.numel() * 2
                    + b * hk * rows * d * 4)
    full_err = (ld.decode_ladder("full", q, kc, vc, bk=1024,
                                 splits=ladder["fill_splits"]["bf16"]).double()
                - ladder_oracle(q, kc, vc, False)).abs().max().item()
    del q, kc, vc, kh, vh

    qT, kT, vT, qa, ka, qi, ki, fl = vb._inputs()
    bis_plain = call_ms(lambda *a: vb.launch_ref(4, *a),
                        [(qi, ki, fl, qT, kT, vT, qa, ka)], iters=3)
    # an all-empty table of one block index: K4 reads its tables and the
    # aux words of one q block and one key block
    bis_bytes = 3 * vb.T * 4 + vb.BQ * 4 + vb.BK * 4
    del qT, kT, vT

    res = dict(phase="diag", check_s=check_s, path_s=path_s,
               launches=launches, checks=checks,
               stream=stream, ladder=ladder, full_against_production=against,
               bisect=bis)
    emit(res)
    torch.cuda.empty_cache()
    s1 = ladder["split1"]
    return dict(
        stream=dict(ms=stream[0]["ms"], plain_ms=stream_plain,
                    library_ms=stream_lib, bytes=sbytes,
                    bound_ms=sbytes / PEAK_BYTES * 1e3,
                    max_abs_err=max(checks["stream"].values()),
                    by_variant={f"{'fused' if r['fused'] else 'plain'} "
                                f"R={r['R']} bundle={r['bundle']} "
                                f"shuf={int(r['shuffled'])}": dict(
                                    ms=r["ms"], gbps=r["gbps"])
                                for r in stream}),
        ladder=dict(ms=against["bf16 full fill"],
                    ms_one_split=against["bf16 full split1"],
                    production_ms=against["bf16 production fill"],
                    against=against, plain_ms=ladder_plain,
                    library_ms=ladder_lib, bytes=ladder_bytes,
                    bound_ms=ladder_bytes / PEAK_BYTES * 1e3,
                    max_abs_err=full_err,
                    by_stage={k: v * 1e3 for k, v in s1.items()},
                    fill_splits=ladder["fill_splits"],
                    by_stage_fill={k: v * 1e3
                                   for k, v in ladder["fill"].items()}),
        bisect=dict(ms=bis["K4"]["ms"], plain_ms=bis_plain,
                    bound_ms=bis_bytes / PEAK_BYTES * 1e3,
                    max_abs_err=max(checks["bisect"].values()),
                    us_per_tick={k: v["us_per_tick"] for k, v in bis.items()},
                    us_per_empty_cta=bis["K0 per CTA"]["us_per_cta"]),
        launches=launches)


# The native C++ token loader's example order on a pinned case: a shard of
# the tokens 0, 1, ..., n_tokens - 1 (uint16), so that a row's first token
# over seq_len is its example.  `tests/test_torch_train_rest.py` holds the
# CPU build to the same order, and to the JAX package's loader.
NATIVE_CASE = dict(n_tokens=4097, seq_len=64, batch=4, seed=7, batches=2)
NATIVE_ORDER = [25, 30, 37, 32, 38, 13, 46, 54]


def native_order(native_loader, path):
    """The examples of the first NATIVE_CASE["batches"] batches, in batch
    order, that `native_loader.NativeLMLoader` gives over `path`."""
    c = NATIVE_CASE
    ld = native_loader.NativeLMLoader([path], c["seq_len"], c["batch"],
                                      seed=c["seed"])
    got = dict(iter(ld))
    ld.close()
    return [int(got[i][r, 0]) // c["seq_len"] for i in range(c["batches"])
            for r in range(c["batch"])]


# The Llama paths.  `llama_serve` serves the serve phase's traffic with
# Meta-Llama-3-8B's widths (HF meta-llama/Meta-Llama-3-8B config.json,
# `serve_profile.LLAMA3_8B`) cut to LLAMA_SERVE_LAYERS of its 32 layers;
# `llama_train` trains the JAX package's own llama recipe
# (flash_attn_tpu/training/configs/experiment/pile-llama-1b.yaml) at full
# width on one card, cut to LLAMA_TRAIN_LAYERS layers.
LLAMA_SERVE_LAYERS = 8
# A served token passes when its fp32 reference logit is within this share
# of the reference logits' standard deviation of the maximum: GPT-2's
# SERVE_MARGIN is 0.05 at a deviation of about 0.55, a share of 0.09.  At
# these random weights the deviation is about 1.28 and bf16 rounding through
# the 8 layers put picked tokens up to 0.066 of it below the maximum
# (PERF.md); a wrong token from a broken kernel sits about a deviation
# below it.
LLAMA_MARGIN_SHARE = 0.1
# The recipe's 24 layers do not fit on one 80 GB card without remat
# (measured on an H100 80GB: 19.6 GB plus 3.9 GB a layer); with
# `model.remat_blocks` (policy "none")
# a layer keeps only its block inputs, and all 24 are trained.
LLAMA_TRAIN_LAYERS = 24
LLAMA_SHARD_TOKENS = 16 * 2**20  # the seeded .bin shard: 8191 examples
LLAMA_EVAL_EVERY = 3
LLAMA_EMA_DECAY = 0.999
LLAMA_TRAIN_STEPS = 5
LLAMA_PROFILE_STEPS = 2
LLAMA_CHECK_SEQ = 256


def cpu_reference(model, dtype=None):
    """A copy of `model` (its config and weights) on the CPU, in `dtype`
    (None: float32): the plain path."""
    import torch
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel

    ref = GPTLMHeadModel(model.config, device="cpu",
                         dtype=dtype or torch.float32)
    with torch.no_grad():
        for (name, p), q in zip(ref.named_parameters(), model.parameters()):
            p.copy_(q)
    return ref.eval()


def llama_serve_phase(gen_seed=0):
    """`ServingEngine` on the Llama at Llama-3-8B widths: the serve phase's
    16 requests, launch counts, greedy tokens against fp32 on the CPU, and
    the batch once more under `torch.profiler`."""
    import numpy as np
    import torch
    from flash_attn_tpu_torch.kernels import flash_decode as fd
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.serve_profile import (MAX_NEW_TOKENS,
                                                    llama3_8b, serve_batch,
                                                    timed_run, warm_up)

    t0 = time.perf_counter()
    model = llama3_8b(gen_seed, LLAMA_SERVE_LAYERS)
    cfg = model.config
    init_s = time.perf_counter() - t0
    warm_up(model, gen_seed)
    warm_s = time.perf_counter() - t0 - init_s
    eng, prompts, uids = serve_batch(model, gen_seed)
    torch.cuda.reset_peak_memory_stats()
    ff.launches = fd.launches = 0
    results, wall = timed_run(eng)
    fwd_launches, dec_launches = ff.launches, fd.launches
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    prof_eng, _, _ = serve_batch(model, gen_seed)
    t0 = time.perf_counter()
    with device_profiler() as prof:
        timed_run(prof_eng)
    profile = profile_summary(prof, 1, wall, "run", "attention", "flash_")
    profile["seconds"] = time.perf_counter() - t0
    res = dict(phase="llama_serve",
               model="Meta-Llama-3-8B widths (random weights, seed 0)",
               reduced=f"{LLAMA_SERVE_LAYERS} of 32 layers",
               params=sum(p.numel() for p in model.parameters()),
               dtype="bfloat16", init_s=init_s, warm_s=warm_s,
               requests=len(prompts),
               finished=st.finished, prefill_waves=st.prefill_waves,
               prefill_tokens=st.prefill_tokens,
               generated_tokens=st.generated_tokens,
               decode_steps=st.decode_steps, wall_s=wall,
               generated_tok_per_s=st.generated_tokens / wall,
               max_memory_allocated=peak, flash_fwd_launches=fwd_launches,
               flash_decode_launches=dec_launches, profile=profile)
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

    # Greedy tokens teacher-forced through the same weights in fp32 on the
    # CPU (the plain path).
    t0 = time.perf_counter()
    ref = cpu_reference(model)
    del model, eng, prof_eng
    torch.cuda.empty_cache()
    gaps, stds = [], []
    for i in (0, 1):
        toks = results[uids[i]]
        seq = torch.as_tensor(np.concatenate([prompts[i], toks[:-1]]))[None]
        with torch.no_grad():
            logits = ref(seq, num_last_tokens=len(toks)).logits[0].float()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite reference logits")
        picked = logits[torch.arange(len(toks)), torch.as_tensor(toks)]
        gaps.append(float((logits.max(dim=-1).values - picked).max()))
        stds.append(float(logits.std(dim=-1).mean()))
    del ref
    margin = LLAMA_MARGIN_SHARE * sum(stds) / 2
    res.update(greedy_max_logit_gap=max(gaps), ref_logit_std=sum(stds) / 2,
               greedy_margin=margin, reference_s=time.perf_counter() - t0)
    emit(res)
    if max(gaps) > margin:
        raise AssertionError(f"greedy token logit gap {max(gaps):.4f} > "
                             f"margin {margin:.4f}")
    return res


def llama_train_config(**over):
    """The JAX package's llama recipe (pile-llama-1b.yaml): n_embd 2048, 24
    layers, 16 heads over 4 kv heads, vocab 50257, RMSNorm, full rotary,
    SwiGLU (n_inner 4 x 2048), untied head; bf16 over fp32 weights; AdamW
    2e-4, wd 0.1, beta2 0.95, clip 1.0; cosine after 2000 warmup steps;
    seq_len 2048, batch 8.  On one card: mesh 1x1 and no optimizer-state
    sharding (not ported), synthetic tokens (The Pile is not in the
    repository)."""
    cfg = train_config()
    m = cfg.model
    m.name, m.n_embd, m.n_layer, m.n_head, m.n_head_kv = (
        "llama-1b", 2048, 24, 16, 4)
    m.vocab_size, m.max_position_embeddings = 50257, 2048
    m.rms_norm, m.rotary_emb_fraction = True, 1.0
    m.activation_function, m.tie_word_embeddings = "swiglu", False
    m.dtype = "bfloat16"
    o = cfg.optimizer
    o.lr, o.weight_decay, o.beta2, o.grad_clip = 2e-4, 0.1, 0.95, 1.0
    cfg.scheduler.name = "cosine"
    cfg.scheduler.warmup_steps, cfg.scheduler.decay_steps = 2000, 300000
    cfg.data.seq_len, cfg.data.batch_size = 2048, 8
    for key, val in over.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, val)
    return cfg


def palm_flops_per_token(model, seq_len):
    """Training FLOPs a token from the model's own parameters: 6 N (N the
    parameters of every matrix product: all but the input embedding) plus
    12 L h d s of attention (PaLM's formula, Chowdhery et al. 2022, App. B;
    the causal mask is not discounted)."""
    c = model.config
    n = sum(p.numel() for name, p in model.named_parameters()
            if "embeddings" not in name)
    head_dim = c.head_dim or c.n_embd // c.n_head
    return 6 * n + 12 * c.n_layer * c.n_head * head_dim * seq_len


def write_token_shard(path, n_tokens, vocab, seed=0):
    """A seeded uniform uint16 token shard (`data.dataset=<shard>.bin`), in
    chunks so the host holds a few MB at a time."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(0, n_tokens, 2**22):
            rng.integers(0, vocab, min(2**22, n_tokens - i),
                         dtype=np.uint16).tofile(f)
    return path


class CountedEval:
    """Inside a `with` block, the trainer's evaluate counts its kernel
    launches and host time apart from the training steps' (the evaluations
    inside `train()`); after it, evaluate is the class's method again and
    nothing refers back to the trainer."""

    def __init__(self, trainer):
        from flash_attn_tpu_torch.kernels import flash_fwd as ff

        self.ff, self.trainer, self.inner = ff, trainer, None
        self.calls, self.launches, self.seconds, self.losses = 0, 0, 0.0, []

    def __enter__(self):
        self.inner = self.trainer.evaluate
        self.trainer.evaluate = self
        return self

    def __exit__(self, *exc):
        del self.trainer.evaluate
        self.trainer = self.inner = None

    def __call__(self, use_ema=False):
        import torch

        torch.cuda.synchronize()
        before, t0 = self.ff.launches, time.perf_counter()
        loss = self.inner(use_ema=use_ema)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.launches += self.ff.launches - before
        self.calls += 1
        self.losses.append(loss)
        return loss


def llama_train_phase(shard):
    """Trainer.train() on the llama recipe at its 24 layers with block
    remat ("none"), EMA and an evaluation every LLAMA_EVAL_EVERY steps,
    reading the seeded .bin `shard`: LLAMA_TRAIN_STEPS steps after
    TRAIN_WARMUP_STEPS warm-up steps, launches counted on those steps (the
    evaluations' apart), then LLAMA_PROFILE_STEPS steps under
    `torch.profiler`; then evaluate() and evaluate(use_ema=True)."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    t = Trainer(llama_train_config(
        model__n_layer=LLAMA_TRAIN_LAYERS, model__remat_blocks=True,
        model__remat_policy="none", data__dataset=shard,
        trainer__ema_decay=LLAMA_EMA_DECAY,
        trainer__eval_every=LLAMA_EVAL_EVERY))
    init_s = time.perf_counter() - t0
    n_layer = t.gpt_config.n_layer
    params = sum(p.numel() for p in t.model.parameters())
    warm = [float(t.train_step(next(t.loader))[0])
            for _ in range(TRAIN_WARMUP_STEPS)]
    torch.cuda.synchronize()
    t.config.trainer.max_steps = t.step + LLAMA_TRAIN_STEPS
    logs = []
    torch.cuda.reset_peak_memory_stats()
    ff.launches = fb.launches_dq = fb.launches_dkv = 0
    t0 = time.perf_counter()
    with CountedEval(t) as evals:
        t.train(log_fn=logs.append)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(flash_fwd=ff.launches - evals.launches,
                  flash_bwd_dq=fb.launches_dq, flash_bwd_dkv=fb.launches_dkv)
    eval_launches = dict(flash_fwd=evals.launches, evaluations=evals.calls)
    peak = torch.cuda.max_memory_allocated()
    losses = warm + [m["loss"] for m in logs if "loss" in m]
    seq, batch = t.config.data.seq_len, t.config.data.batch_size
    tokens = t.speed.tokens_per_step * LLAMA_TRAIN_STEPS
    step_s = (wall - evals.seconds) / LLAMA_TRAIN_STEPS
    flops = palm_flops_per_token(t.model, seq) * tokens
    profile = profile_train_steps(t, LLAMA_PROFILE_STEPS, step_s)
    live_eval, ema_eval = t.evaluate(), t.evaluate(use_ema=True)
    ema_gap = max(float((p.detach().float() - e).abs().max())
                  for p, e in zip(t.model.parameters(), t.ema_params))
    del t
    torch.cuda.empty_cache()
    res = dict(phase="llama_train",
               model="llama-1b, pile-llama-1b.yaml (random weights, seed 0)",
               reduced="one card: mesh 4x2 -> 1x1, optimizer-state sharding "
               "off; block remat on (policy none); a local seeded .bin "
               f"shard of {LLAMA_SHARD_TOKENS} uniform tokens for The Pile",
               layers=n_layer, params=params, param_dtype="float32",
               compute_dtype="bfloat16", remat_policy="none",
               ema_decay=LLAMA_EMA_DECAY, eval_every=LLAMA_EVAL_EVERY,
               seq_len=seq, batch_size=batch, steps=LLAMA_TRAIN_STEPS,
               warmup_steps=TRAIN_WARMUP_STEPS, init_s=init_s, wall_s=wall,
               eval_s=evals.seconds, step_ms=step_s * 1e3,
               tokens_per_s=tokens / (step_s * LLAMA_TRAIN_STEPS),
               model_tflops=flops / (step_s * LLAMA_TRAIN_STEPS) / 1e12,
               share_of_989_tflops=flops / (step_s * LLAMA_TRAIN_STEPS)
               / PEAK_FLOPS,
               flops_formula="6 N + 12 L h d s a token (PaLM); the remat "
               "recompute (a second forward a layer) is not counted",
               max_memory_allocated=peak, losses=losses,
               eval_losses_in_loop=evals.losses, eval_loss=live_eval,
               eval_loss_ema=ema_eval, ema_max_abs_gap=ema_gap,
               launches=counts, eval_launches=eval_launches, profile=profile)
    emit(res)
    want = n_layer * LLAMA_TRAIN_STEPS
    if counts != dict(flash_fwd=2 * want, flash_bwd_dq=want,
                      flash_bwd_dkv=want):
        raise AssertionError(f"llama_train launches {counts}, expected "
                             f"{2 * want} forwards (remat) and {want} of "
                             "each backward kernel")
    steps = range(TRAIN_WARMUP_STEPS + 1,
                  TRAIN_WARMUP_STEPS + LLAMA_TRAIN_STEPS + 1)
    if evals.launches != evals.calls * EVAL_STEPS * n_layer or \
            evals.calls != sum(s % LLAMA_EVAL_EVERY == 0 for s in steps):
        raise AssertionError(f"llama_train evaluations {eval_launches}")
    if len(losses) != TRAIN_WARMUP_STEPS + LLAMA_TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses + evals.losses
            + [live_eval, ema_eval]):
        raise AssertionError(f"llama_train losses {losses}, evaluations "
                             f"{evals.losses}, {live_eval}, {ema_eval}")
    if abs(losses[0] - LN_VOCAB) > 0.5:
        raise AssertionError(f"llama_train first loss {losses[0]} not "
                             f"within 0.5 of ln(50257)")
    if not ema_gap > 0.0:
        raise AssertionError("llama_train: the EMA equals the live weights")
    if peak >= 80e9:
        raise AssertionError(f"llama_train peak {peak} B")
    return res


REMAT_POLICIES = ("none", "dots", "dots_no_batch")


def llama_check_phases(shard):
    """The llama recipe at full width, 2 layers, as one Trainer on the card
    (bf16) and its fp32 copy on the CPU, whose gradients on one batch of
    LLAMA_CHECK_SEQ tokens are computed once and serve both checks.
    `llama_train_check`: the card's gradients against them
    (`check_grads`).  `remat_check`: (1) the card's gradients under each
    remat policy against its own without remat (bitwise expected: the
    kernels are deterministic), the forward launched twice a layer under
    each; (2) on a batch of the recipe's size from `shard`, the peak memory
    of one forward and backward under each policy and without; (3) float16
    autocast with remat against the fp32 CPU gradients (`check_grads`)."""
    import numpy as np
    import torch
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.training.trainer import Trainer

    small = dict(model__n_layer=2, data__seq_len=LLAMA_CHECK_SEQ,
                 data__batch_size=1)
    t = Trainer(llama_train_config(**small))
    cpu = Trainer(llama_train_config(model__dtype="float32", **small),
                  device="cpu")
    batch = next(cpu.loader)
    ref = grads_of(cpu, batch)
    del cpu
    base_loss, base = grads_of(t, batch)
    check = dict(phase="llama_train_check", layers=2,
                 seq_len=LLAMA_CHECK_SEQ,
                 **compare_grads((base_loss, base), ref))
    emit(check)
    check_grads("llama_train_check", check)

    cfg = t.model.config
    by_policy = {}
    for policy in REMAT_POLICIES:
        cfg.remat_blocks, cfg.remat_policy = True, policy
        before = ff.launches
        loss, grads = grads_of(t, batch)
        fwd = ff.launches - before
        flat = [torch.cat([g[n].flatten().float() for n in base])
                for g in (grads, base)]
        by_policy[policy] = dict(
            loss=loss, loss_equal=loss == base_loss,
            bitwise_equal=all(torch.equal(grads[n], base[n]) for n in base),
            max_abs_diff=max(float((grads[n] - base[n]).abs().max())
                             for n in base),
            grad_cosine=cosine(*[x.cpu() for x in flat]),
            forward_launches=fwd)
    del base, grads, flat

    data = llama_train_config().data
    seq, rows = data.seq_len, data.batch_size
    full = np.fromfile(shard, np.uint16, rows * (seq + 1)).astype(
        np.int32).reshape(rows, seq + 1)
    peaks = {}
    for policy in (None,) + REMAT_POLICIES:
        cfg.remat_blocks, cfg.remat_policy = policy is not None, \
            policy or "none"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated()
        grads_of(t, full)
        torch.cuda.synchronize()
        peaks[policy or "no_remat"] = (torch.cuda.max_memory_allocated()
                                       - base_alloc)
    del t
    torch.cuda.empty_cache()

    f16 = Trainer(llama_train_config(model__dtype="float16",
                                     model__remat_blocks=True, **small))
    fp16 = compare_grads(grads_of(f16, batch), ref)
    del f16, ref
    torch.cuda.empty_cache()
    res = dict(phase="remat_check", layers=2, seq_len=LLAMA_CHECK_SEQ,
               by_policy=by_policy, peak_bytes_above_weights=peaks,
               peak_batch=f"{rows} x {seq} tokens of the .bin shard",
               float16=fp16)
    emit(res)
    for policy, r in by_policy.items():
        if not r["bitwise_equal"] and r["grad_cosine"] < GRAD_COSINE:
            raise AssertionError(f"remat {policy}: gradients differ from "
                                 f"no remat: {r}")
        if r["forward_launches"] != 4:  # recomputed under every policy
            raise AssertionError(f"remat {policy}: {r['forward_launches']} "
                                 "forward launches for 2 layers, not 4")
    if not peaks["none"] < peaks["dots"] <= peaks["no_remat"]:
        raise AssertionError(f"remat peaks not ordered: {peaks}")
    check_grads("remat_check float16", fp16)
    return check, res


# ViT-B/16 on ImageNet-sized inputs: the JAX package's recipe
# (flash_attn_tpu/training/configs/experiment/imagenet-vit-b.yaml) as
# written: 224 px, patch 16, 1000 classes, batch 64, bf16 over fp32 weights,
# AdamW 1e-3, wd 0.05, beta2 0.999, clip 1, cosine after 10000 warm-up
# steps, synthetic images, device-side augmentation.
VIT_BATCH = 64
VIT_TOKENS = (224 // 16) ** 2 + 1  # 196 patches and the class token
VIT_WARMUP_STEPS = 3
VIT_STEPS = 20
VIT_PROFILE_STEPS = 3
VIT_CHECK_BATCH = 8
VIT_EMA_DECAY = 0.999
LN_CLASSES = math.log(1000)


def vit_train_config(**over):
    """imagenet-vit-b.yaml's settings (the YAML is not read here, so that
    no YAML parser is needed; `tests/test_torch_train_rest.py` holds the
    two equal)."""
    cfg = train_config()
    m = cfg.model
    m.task, m.name, m.n_embd, m.n_layer, m.n_head = (
        "image", "vit-base-patch16-224", 768, 12, 12)
    m.patch_size, m.image_size, m.num_classes = 16, 224, 1000
    m.dtype = "bfloat16"
    o = cfg.optimizer
    o.lr, o.weight_decay, o.beta2, o.grad_clip = 1e-3, 0.05, 0.999, 1.0
    cfg.scheduler.name = "cosine"
    cfg.scheduler.warmup_steps, cfg.scheduler.decay_steps = 10000, 300000
    cfg.data.dataset, cfg.data.batch_size = "synthetic", VIT_BATCH
    for key, val in over.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, val)
    return cfg


def vit_flops_per_image(model, tokens):
    """Training FLOPs an image, PaLM's formula over T tokens: 6 times each
    matrix's parameters times the rows it multiplies (the blocks' over all
    T, the patch projection's over the T - 1 patches, the head's over one
    pooled row) plus 12 L h d T^2 of (non-causal) attention."""
    def matrices(module):
        return sum(p.numel() for p in module.parameters() if p.ndim >= 2)

    blk = model.blocks[0].mixer
    return (6 * (matrices(model.blocks) * tokens
                 + matrices(model.patch_embed) * (tokens - 1)
                 + matrices(model.head))
            + 12 * len(model.blocks) * blk.num_heads * blk.head_dim
            * tokens * tokens)


def vit_train_phase(ckpt_dir):
    """(1) A 2-layer ViT-B/16-width model's gradients on the card against
    fp32 on the CPU (`check_grads`); (2) the recipe: VIT_WARMUP_STEPS
    warm-up steps, VIT_STEPS timed steps of Trainer.train() with launches
    counted, one evaluation counted apart, a checkpoint at the last step
    (with an EMA of decay VIT_EMA_DECAY, for `eval_cli --ema`), then
    VIT_PROFILE_STEPS steps under `torch.profiler`."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.training.trainer import Trainer

    small = dict(model__n_layer=2, data__batch_size=VIT_CHECK_BATCH,
                 data__max_examples=VIT_CHECK_BATCH)
    gpu = Trainer(vit_train_config(**small))
    cpu = Trainer(vit_train_config(model__dtype="float32", **small),
                  device="cpu")
    check = dict(phase="vit_train_check", layers=2, batch=VIT_CHECK_BATCH,
                 **card_vs_cpu_grads(gpu, cpu))
    del gpu, cpu
    torch.cuda.empty_cache()
    emit(check)
    check_grads("vit_train_check", check)

    t0 = time.perf_counter()
    t = Trainer(vit_train_config(trainer__ema_decay=VIT_EMA_DECAY,
                                 trainer__checkpoint_dir=ckpt_dir))
    init_s = time.perf_counter() - t0
    n_layer = len(t.model.blocks)
    params = sum(p.numel() for p in t.model.parameters())
    warm = [float(t.train_step(next(t.loader))[0])
            for _ in range(VIT_WARMUP_STEPS)]
    torch.cuda.synchronize()
    t.config.trainer.max_steps = t.step + VIT_STEPS
    logs = []
    torch.cuda.reset_peak_memory_stats()
    ff.launches = fb.launches_dq = fb.launches_dkv = 0
    t0 = time.perf_counter()
    t.train(log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(flash_fwd=ff.launches, flash_bwd_dq=fb.launches_dq,
                  flash_bwd_dkv=fb.launches_dkv)
    peak = torch.cuda.max_memory_allocated()
    ff.launches = fb.launches_dq = fb.launches_dkv = 0
    eval_loss = t.evaluate()
    eval_counts = dict(flash_fwd=ff.launches, flash_bwd_dq=fb.launches_dq,
                       flash_bwd_dkv=fb.launches_dkv)
    t.save_checkpoint()
    step = t.step
    losses = warm + [m["loss"] for m in logs if "loss" in m]
    images = VIT_BATCH * VIT_STEPS
    flops = vit_flops_per_image(t.model, VIT_TOKENS) * images
    profile = profile_train_steps(t, VIT_PROFILE_STEPS, wall / VIT_STEPS)
    del t
    torch.cuda.empty_cache()
    res = dict(phase="vit_train",
               model="ViT-B/16, imagenet-vit-b.yaml (random weights, seed 0)",
               reduced="none of scale: synthetic images (the recipe's own "
               "default); EMA on (decay 0.999) so that eval_cli --ema reads "
               "an EMA", params=params, param_dtype="float32",
               compute_dtype="bfloat16", image_size=224, tokens=VIT_TOKENS,
               batch_size=VIT_BATCH, steps=VIT_STEPS,
               warmup_steps=VIT_WARMUP_STEPS, init_s=init_s, wall_s=wall,
               step_ms=wall / VIT_STEPS * 1e3, images_per_s=images / wall,
               model_tflops=flops / wall / 1e12,
               share_of_989_tflops=flops / wall / PEAK_FLOPS,
               flops_formula="6 (N_blocks T + N_patch (T - 1) + N_head) + "
               "12 L h d T^2 an image (PaLM's, non-causal)",
               max_memory_allocated=peak, losses=losses,
               eval_loss=eval_loss, launches=counts,
               eval_launches=eval_counts, checkpoint_step=step,
               profile=profile)
    emit(res)
    want = n_layer * VIT_STEPS
    if counts != dict(flash_fwd=want, flash_bwd_dq=want, flash_bwd_dkv=want):
        raise AssertionError(f"vit_train launches {counts}, expected {want} "
                             "of each kernel")
    if eval_counts != dict(flash_fwd=n_layer * EVAL_STEPS, flash_bwd_dq=0,
                           flash_bwd_dkv=0):
        raise AssertionError(f"vit_train eval launches {eval_counts}")
    if len(losses) != VIT_WARMUP_STEPS + VIT_STEPS or not all(
            math.isfinite(x) for x in losses + [eval_loss]):
        raise AssertionError(f"vit_train losses {losses}, eval {eval_loss}")
    if abs(losses[0] - LN_CLASSES) > 0.5:
        raise AssertionError(f"vit_train first loss {losses[0]} not within "
                             "0.5 of ln(1000)")
    return res


def config_overrides(cfg):
    """Every field of a TrainConfig as `section.field=value` overrides,
    which `training.run.parse_overrides` reads back (values by repr)."""
    import dataclasses

    return [f"{sec.name}.{f.name}={getattr(getattr(cfg, sec.name), f.name)!r}"
            for sec in dataclasses.fields(cfg)
            for f in dataclasses.fields(getattr(cfg, sec.name))]


def eval_cli_phase(ckpt_dir, step):
    """`training.eval.main` with --checkpoint and --ema on the vit_train
    checkpoint, against `Trainer.evaluate(use_ema=True)` of a Trainer built
    in-process from the same config and checkpoint (both read the loader
    from its start): equal to 1e-5 relative."""
    import io
    from contextlib import redirect_stdout

    import torch
    from flash_attn_tpu_torch.training import eval as eval_cli
    from flash_attn_tpu_torch.training.trainer import Trainer

    cfg = vit_train_config(trainer__ema_decay=VIT_EMA_DECAY,
                           trainer__checkpoint_dir=ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        result = eval_cli.main(["--checkpoint", path, "--ema",
                                *config_overrides(cfg)])
    cli_s = time.perf_counter() - t0
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    torch.cuda.empty_cache()
    t = Trainer(cfg)
    t.load_checkpoint(path, loader=False)
    ref = t.evaluate(use_ema=True)
    live = t.evaluate()
    del t
    torch.cuda.empty_cache()
    res = dict(phase="eval_cli", printed=printed, cli_s=cli_s,
               trainer_eval_loss_ema=ref, trainer_eval_loss_live=live,
               rel_diff=abs(printed["eval_loss"] - ref) / abs(ref))
    emit(res)
    if printed != result or printed["step"] != step or not printed["ema"]:
        raise AssertionError(f"eval_cli printed {printed}")
    if res["rel_diff"] > 1e-5:
        raise AssertionError(f"eval_cli loss {printed['eval_loss']} != "
                             f"Trainer.evaluate(use_ema=True) {ref}")
    return res


NATIVE_BATCHES = 4


def native_loader_phase(shard, workdir):
    """The C++ loader, built with g++ at first use: over the llama_train
    shard, every row of its first NATIVE_BATCHES batches equals a row of
    the memmap `LMDataset` over the same shard at an offset aligned to
    seq_len; on the pinned arange shard its order is NATIVE_ORDER."""
    import numpy as np
    from flash_attn_tpu_torch.training import native_loader
    from flash_attn_tpu_torch.training.data import lm_dataset_from_bin

    t0 = time.perf_counter()
    lib = native_loader.build()
    build_s = time.perf_counter() - t0
    seq = 2048
    ds = lm_dataset_from_bin(shard, seq)
    ld = native_loader.NativeLMLoader([shard], seq, 8, seed=0)
    got = [next(ld) for _ in range(NATIVE_BATCHES)]
    ld.close()
    starts = np.asarray(ds.tokens[: len(ds) * seq]).reshape(len(ds), seq)
    found = []
    for idx, batch in got:
        for row in batch:
            cand = np.flatnonzero((starts[:, :4] == row[:4]).all(axis=1))
            hits = [int(e) for e in cand
                    if np.array_equal(np.asarray(ds[e], np.int32), row)]
            if len(hits) != 1:
                raise AssertionError(f"native_loader: batch {idx} row "
                                     f"matches examples {hits}")
            found.append(hits[0])
    arange = os.path.join(workdir, "arange.bin")
    np.arange(NATIVE_CASE["n_tokens"], dtype=np.uint16).tofile(arange)
    order = native_order(native_loader, arange)
    res = dict(phase="native_loader", library=str(lib), build_s=build_s,
               batches=sorted(i for i, _ in got), examples=found,
               num_batches=ld.num_batches, pinned_order=order)
    emit(res)
    if order != NATIVE_ORDER:
        raise AssertionError(f"native_loader order {order} != "
                             f"{NATIVE_ORDER}")
    return res


# The GPT-family models, each at its published widths (the values below;
# the configs themselves are not in the repository), 2 layers, bf16,
# random weights: a cached prefill, then decode steps, teacher-forced.
def family_configs():
    from types import SimpleNamespace as NS

    from flash_attn_tpu_torch.models.baichuan import \
        baichuan_config_to_gpt2_config
    from flash_attn_tpu_torch.models.bigcode import \
        bigcode_config_to_gpt2_config
    from flash_attn_tpu_torch.models.falcon import \
        falcon_config_to_gpt2_config
    from flash_attn_tpu_torch.models.gpt_neox import \
        gpt_neox_config_to_gpt2_config

    return {
        # HF baichuan-inc/Baichuan-7B config.json
        "Baichuan-7B": baichuan_config_to_gpt2_config(NS(
            vocab_size=64000, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32,
            rms_norm_eps=1e-6)),
        # HF EleutherAI/pythia-1.4b config.json (GPT-NeoX)
        "Pythia-1.4B": gpt_neox_config_to_gpt2_config(NS(
            vocab_size=50304, hidden_size=2048, intermediate_size=8192,
            num_hidden_layers=24, num_attention_heads=16, hidden_act="gelu",
            layer_norm_eps=1e-5, rotary_pct=0.25, rotary_emb_base=10000,
            tie_word_embeddings=False, use_parallel_residual=True)),
        # HF tiiuae/falcon-7b config.json
        "Falcon-7B": falcon_config_to_gpt2_config(NS(
            vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
            num_attention_heads=71, multi_query=True, parallel_attn=True,
            new_decoder_architecture=False, bias=False,
            layer_norm_epsilon=1e-5)),
        # HF bigcode/starcoderbase-1b config.json
        "StarCoderBase-1B": bigcode_config_to_gpt2_config(NS(
            vocab_size=49152, n_positions=8192, n_embd=2048, n_layer=24,
            n_head=16, n_inner=8192, multi_query=True,
            activation_function="gelu_pytorch_tanh",
            layer_norm_epsilon=1e-5)),
    }


FAMILY_LAYERS, FAMILY_BATCH, FAMILY_PREFILL, FAMILY_DECODE = 2, 2, 64, 8


def cached_logits(model, ids, device):
    """The logits of the last token of a cached prefill of FAMILY_PREFILL
    tokens of `ids`, then of each one-token step through the rest, on
    `device`: (prefill's, last step's)."""
    import torch
    from flash_attn_tpu_torch.modules.mha import InferenceParams

    b, n = ids.shape
    ip = InferenceParams(max_seqlen=n, max_batch_size=b,
                         lengths_per_sample=torch.zeros(
                             b, dtype=torch.int32, device=device))
    ids = ids.to(device)
    with torch.no_grad():
        first = model(ids[:, :FAMILY_PREFILL], inference_params=ip,
                      num_last_tokens=1).logits[:, 0]
        for j in range(FAMILY_PREFILL, n):
            last = model(ids[:, j:j + 1], inference_params=ip).logits[:, 0]
    return first.float().cpu(), last.float().cpu()


def families_phase():
    """Each family of `family_configs` cut to FAMILY_LAYERS layers, bf16 on
    the card: a cached prefill of FAMILY_PREFILL seeded tokens (the prefill
    kernel), then FAMILY_DECODE one-token steps (the decode kernel).  The
    prefill's and the last step's logits are held by the tolerance rule
    (`check_close`: |card - fp32| <= 2 |bf16 plain - fp32| + 1e-5) to one
    no-cache fp32 forward of the same tokens on the CPU, with the same
    cached steps in bf16 on the CPU (the plain kernels) as the yardstick;
    and the launch counts."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_decode as fd
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel
    from flash_attn_tpu_torch.utils.testing import check_close

    out, counts = {}, dict(flash_fwd=0, flash_decode=0)
    n = FAMILY_PREFILL + FAMILY_DECODE
    for i, (name, cfg) in enumerate(family_configs().items()):
        cfg.n_layer = FAMILY_LAYERS
        model = GPTLMHeadModel(cfg, dtype=torch.bfloat16)
        model.init_weights(torch.Generator(device="cuda").manual_seed(i))
        model.eval()
        ids = torch.randint(0, cfg.vocab_size, (FAMILY_BATCH, n),
                            generator=torch.Generator().manual_seed(i))
        ff.launches = fd.launches = 0
        card = cached_logits(model, ids, "cuda")
        torch.cuda.synchronize()
        launches = dict(flash_fwd=ff.launches, flash_decode=fd.launches)
        plain = cached_logits(cpu_reference(model, torch.bfloat16), ids,
                              "cpu")
        ref = cpu_reference(model)
        del model
        torch.cuda.empty_cache()
        with torch.no_grad():
            logits = ref(ids).logits.float()
        del ref
        errs = [check_close(c, logits[:, j], p, label=f"{name} {what}")
                for c, p, j, what in (
                    (card[0], plain[0], FAMILY_PREFILL - 1, "prefill"),
                    (card[1], plain[1], n - 1, "last step"))]
        h, hk = cfg.n_head, cfg.n_head_kv or cfg.n_head
        res = dict(phase="families", model=name, layers=FAMILY_LAYERS,
                   n_embd=cfg.n_embd, heads=h, kv_heads=hk,
                   head_dim=cfg.n_embd // h, rotary_dim=cfg.rotary_dim(),
                   parallel_block=cfg.parallel_block,
                   tied_norm=cfg.parallel_block_tied_norm,
                   vocab=cfg.vocab_size, batch=FAMILY_BATCH,
                   prefill=FAMILY_PREFILL, decode_steps=FAMILY_DECODE,
                   max_abs_err_prefill=errs[0][0],
                   plain_bf16_err_prefill=errs[0][1],
                   max_abs_err_last=errs[1][0],
                   plain_bf16_err_last=errs[1][1],
                   ref_logit_std=float(logits.std(dim=-1).mean()),
                   launches=launches)
        emit(res)
        want = dict(flash_fwd=FAMILY_LAYERS,
                    flash_decode=FAMILY_LAYERS * FAMILY_DECODE)
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}")
        for k in counts:
            counts[k] += launches[k]
        out[name] = res
    return dict(models=out, launches=counts)


# Attention dropout (the kDropout kernels of flash_fwd.cu and flash_bwd.cu):
# p = 0.1 and a seed other than 0 in the kernel cases, as a trainer with
# attention dropout runs them.
DROPOUT_P = 0.1
DROPOUT_SEED = 1234567
DROPOUT_KEEP_TOL = 0.005  # kept share of the probes' elements: 0.9 +- this
DROPOUT_TRAIN_STEPS = 5
DROPOUT_WARMUP_STEPS = 2
DROPOUT_BERT_ITERS = 5


def dropout_counts():
    """The dropout instantiations' launch counts, and every launch of the
    dense and varlen kernels."""
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.kernels import varlen as vl

    return dict(flash_fwd=ff.launches, flash_bwd_dq=fb.launches_dq,
                flash_bwd_dkv=fb.launches_dkv, varlen_fwd=vl.launches_fwd,
                varlen_dq=vl.launches_dq, varlen_dkv=vl.launches_dkv,
                flash_fwd_dropout=ff.launches_dropout,
                flash_bwd_dq_dropout=fb.launches_dq_dropout,
                flash_bwd_dkv_dropout=fb.launches_dkv_dropout,
                varlen_fwd_dropout=vl.launches_fwd_dropout,
                varlen_dq_dropout=vl.launches_dq_dropout,
                varlen_dkv_dropout=vl.launches_dkv_dropout)


def set_dropout_counts(counts):
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.kernels import varlen as vl

    mods = dict(flash_fwd=(ff, "launches"), flash_bwd_dq=(fb, "launches_dq"),
                flash_bwd_dkv=(fb, "launches_dkv"),
                varlen_fwd=(vl, "launches_fwd"), varlen_dq=(vl, "launches_dq"),
                varlen_dkv=(vl, "launches_dkv"))
    for name, (mod, attr) in mods.items():
        setattr(mod, attr, counts[name])
        setattr(mod, attr + "_dropout", counts[name + "_dropout"])


def sdpa_dropout_ms(q, k, v, do, causal):
    """Device times of SDPA's forward and backward with dropout_p =
    DROPOUT_P on the same (b, h, s, d) inputs: the same work as the port's
    dropout kernels, but PyTorch's own random mask (its Philox stream), not
    the port's.  A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    gqa = k.shape[1] != q.shape[1]

    def fwd(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_, k_, v_, dropout_p=DROPOUT_P, is_causal=causal,
            enable_gqa=gqa)

    fwd_ms = time_ms(fwd, input_copies(q, k, v))
    graphs = []
    for qc, kc, vc, dc in input_copies(q, k, v, do):
        qc, kc, vc = (t.detach().requires_grad_() for t in (qc, kc, vc))
        graphs.append((fwd(qc, kc, vc), (qc, kc, vc), dc))
    bwd_ms = time_ms(lambda out, ins, dc: torch.autograd.grad(
        out, ins, dc, retain_graph=True), graphs)
    return fwd_ms, bwd_ms


def dropout_case(label, b, h, hk, s, d, causal, gen):
    """The dense dropout kernels at one shape: forward and (dq, dk, dv)
    against the plain version with the same keep mask (fp32 oracle, bf16
    yardstick, `check_close`), the backward bitwise repeatable; device
    times with and without dropout, each backward kernel apart (profiler),
    the plain version's (`call_ms`) and SDPA's with dropout.  The bounds
    are the no-dropout ones."""
    import torch
    from flash_attn_tpu_torch.kernels import flash_bwd as fb
    from flash_attn_tpu_torch.kernels import flash_fwd as ff
    from flash_attn_tpu_torch.utils.testing import check_close

    before = dropout_counts()
    q = torch.randn(b, h, s, d, generator=gen, device=DEV).bfloat16()
    k = torch.randn(b, hk, s, d, generator=gen, device=DEV).bfloat16()
    v = torch.randn(b, hk, s, d, generator=gen, device=DEV).bfloat16()
    do = torch.randn(b, h, s, d, generator=gen, device=DEV).bfloat16()
    lens = torch.full((b,), s, dtype=torch.int32, device=DEV)
    kw = dict(softmax_scale=d ** -0.5, causal=causal)
    dkw = dict(kw, dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    o, lse = ff.flash_attn_fwd_bhsd(q, k, v, lens, lens, **dkw)
    grads = fb.flash_attn_bwd_bhsd(do, q, k, v, o, lse, lens, lens, **dkw)
    again = fb.flash_attn_bwd_bhsd(do, q, k, v, o, lse, lens, lens, **dkw)
    torch.cuda.synchronize()
    if dropout_counts()["flash_fwd_dropout"] != before["flash_fwd_dropout"] \
            + 1:
        raise AssertionError(f"{label}: the dropout forward did not run")
    bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))
    if not bitwise:
        raise AssertionError(f"{label}: two dropout backwards differ")
    del again
    o_ref, lse_ref = ff.flash_attn_fwd_bhsd_ref(
        q.float(), k.float(), v.float(), lens, lens, **dkw)
    o_pt, lse_pt = ff.flash_attn_fwd_bhsd_ref(q, k, v, lens, lens, **dkw)
    ok = torch.ones(b, h, s, dtype=torch.bool, device=DEV)
    err_o, err_o_pt, _, _ = check_attention(f"{label} dropout", o, lse,
                                            o_ref, lse_ref, o_pt, lse_pt, ok)
    del o_ref, o_pt
    ref = fb.flash_attn_bwd_bhsd_ref(do.float(), q.float(), k.float(),
                                     v.float(), o.float(), lse, lens, lens,
                                     **dkw)
    pt = fb.flash_attn_bwd_bhsd_ref(do, q, k, v, o, lse, lens, lens, **dkw)
    errs = {}
    for name, x, r, y in zip(("dq", "dk", "dv"), grads, ref, pt):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite {name}")
        errs[name] = check_close(x, r, y, label=f"{label} dropout {name}")
    del ref, pt
    torch.cuda.empty_cache()

    live = live_pairs(s, s, lens, lens, causal, (-1, -1))
    pairs = int(live.sum()) * h
    q_side, kv_side = b * h * s * d * 2, b * hk * s * d * 2
    fwd_bound = bound(4 * d * pairs, 2 * q_side + 2 * kv_side + b * h * s * 4)
    stats = 2 * b * h * s * 4
    bwd_bound = bound(10 * d * pairs, 4 * q_side + 4 * kv_side + stats)
    dq_bound = bound(6 * d * pairs, 3 * q_side + 2 * kv_side + stats)
    dkv_bound = bound(8 * d * pairs, 2 * q_side + 4 * kv_side + stats)
    fargs = input_copies(q, k, v, lens, lens)
    bargs = input_copies(do, q, k, v, o, lse, lens, lens)
    times = {}
    for tag, w in (("dropout", dkw), ("no_dropout", kw)):
        times[tag] = dict(
            fwd_ms=time_ms(lambda *a: ff.flash_attn_fwd_bhsd(*a, **w), fargs),
            fwd_kernel_ms=kernel_device_ms(
                lambda *a: ff.flash_attn_fwd_bhsd(*a, **w), fargs,
                ("flash_fwd_kernel",))["flash_fwd_kernel"],
            bwd_ms=time_ms(lambda *a: fb.flash_attn_bwd_bhsd(*a, **w), bargs),
            **{f"{n[10:-7]}_kernel_ms": t for n, t in kernel_device_ms(
                lambda *a: fb.flash_attn_bwd_bhsd(*a, **w), bargs,
                ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")).items()})
    plain_fwd = call_ms(lambda *a: ff.flash_attn_fwd_bhsd_ref(*a, **dkw),
                        fargs, iters=3, warmup=1)
    plain_bwd = call_ms(lambda *a: fb.flash_attn_bwd_bhsd_ref(*a, **dkw),
                        bargs, iters=3, warmup=1)
    lib_fwd, lib_bwd = sdpa_dropout_ms(q, k, v, do, causal)
    set_dropout_counts(before)  # comparisons, not a main path
    res = dict(phase="kernel_dropout", case=label, b=b, h=h, hk=hk, s=s, d=d,
               causal=causal, dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED,
               max_abs_err_o=err_o, plain_bf16_err_o=err_o_pt,
               **{f"max_abs_err_{n}": e[0] for n, e in errs.items()},
               **{f"plain_bf16_err_{n}": e[1] for n, e in errs.items()},
               bitwise_repeat=bitwise, **times["dropout"],
               no_dropout={k_: v_ for k_, v_ in times["no_dropout"].items()},
               fwd_over_no_dropout=times["dropout"]["fwd_kernel_ms"]
               / times["no_dropout"]["fwd_kernel_ms"],
               bwd_over_no_dropout=times["dropout"]["bwd_ms"]
               / times["no_dropout"]["bwd_ms"],
               plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
               library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
               library="SDPA with dropout_p=0.1 (its own random mask, not "
               "the port's)", fwd_bound_ms=fwd_bound[0],
               fwd_bound_by=fwd_bound[1], bwd_bound_ms=bwd_bound[0],
               bwd_bound_by=bwd_bound[1], dq_bound_ms=dq_bound[0],
               dkv_bound_ms=dkv_bound[0])
    emit(res)
    return res


def dropout_varlen_case(label, lens, h, d, gen):
    """The packed varlen dropout kernels on the BERT batch's lengths
    (non-causal): as `dropout_case`, the plain versions per sequence at
    packed-stream coordinates; SDPA's library time as
    `sdpa_varlen_library`'s, with dropout."""
    import torch
    from flash_attn_tpu_torch.kernels import varlen as vl
    from flash_attn_tpu_torch.utils.testing import check_close

    before = dropout_counts()
    q, k, v, cu, _ = varlen_inputs(lens, lens, h, h, d, gen, torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device=DEV).bfloat16()
    ms = max(lens)
    kw = dict(softmax_scale=d ** -0.5)
    dkw = dict(kw, dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    o, lse = vl.varlen_attn_fwd(q, k, v, cu, cu, ms, ms, **dkw)
    grads = vl.varlen_attn_bwd(do, q, k, v, o, lse, cu, cu, ms, ms, **dkw)
    again = vl.varlen_attn_bwd(do, q, k, v, o, lse, cu, cu, ms, ms, **dkw)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))
    if not bitwise:
        raise AssertionError(f"{label}: two dropout backwards differ")
    o_ref, lse_ref = vl.varlen_attn_fwd_ref(q.float(), k.float(), v.float(),
                                            cu, cu, ms, ms, **dkw)
    o_pt, _ = vl.varlen_attn_fwd_ref(q, k, v, cu, cu, ms, ms, **dkw)
    err_o, err_o_pt = check_close(o, o_ref, o_pt, label=f"{label} o")
    if not torch.allclose(lse, lse_ref, atol=1e-3, rtol=1e-4):
        raise AssertionError(f"{label}: lse differs from the plain version")
    ref = vl.varlen_attn_bwd_ref(do.float(), q.float(), k.float(), v.float(),
                                 o.float(), lse, cu, cu, ms, ms, **dkw)
    pt = vl.varlen_attn_bwd_ref(do, q, k, v, o, lse, cu, cu, ms, ms, **dkw)
    errs = {n: check_close(x, r, y, label=f"{label} {n}")
            for n, x, r, y in zip(("dq", "dk", "dv"), grads, ref, pt)}
    del ref, pt, o_ref, o_pt

    pairs, keys = varlen_live_pairs(lens, lens, False, (-1, -1), ms)
    n_pairs = sum(pairs) * h
    tok = sum(lens) * h * d * 2
    fwd_bound = bound(4 * d * n_pairs, 4 * tok + sum(lens) * h * 4)
    bwd_bound = bound(10 * d * n_pairs, 8 * tok + 2 * sum(lens) * h * 4)
    fargs = input_copies(q, k, v, cu, cu)
    bargs = input_copies(do, q, k, v, o, lse, cu, cu)
    times = {}
    for tag, w in (("dropout", dkw), ("no_dropout", kw)):
        times[tag] = dict(
            fwd_kernel_ms=kernel_device_ms(
                lambda *a: vl.varlen_attn_fwd(*a, ms, ms, **w), fargs,
                ("flash_fwd_kernel",))["flash_fwd_kernel"],
            bwd_ms=time_ms(lambda *a: vl.varlen_attn_bwd(*a, ms, ms, **w),
                           bargs),
            **{f"{n[10:-7]}_kernel_ms": t for n, t in kernel_device_ms(
                lambda *a: vl.varlen_attn_bwd(*a, ms, ms, **w), bargs,
                ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")).items()})
    plain_fwd = call_ms(lambda *a: vl.varlen_attn_fwd_ref(*a, ms, ms, **dkw),
                        fargs, iters=2, warmup=1)
    plain_bwd = call_ms(lambda *a: vl.varlen_attn_bwd_ref(*a, ms, ms, **dkw),
                        bargs, iters=2, warmup=1)
    lib_fwd, which = sdpa_varlen_library(q, k, v, cu, cu, lens, lens, False,
                                         dropout_p=DROPOUT_P)
    lib_bwd, _ = sdpa_varlen_library(q, k, v, cu, cu, lens, lens, False,
                                     backward=True, dropout_p=DROPOUT_P)
    set_dropout_counts(before)
    res = dict(phase="kernel_dropout", case=label, sequences=len(lens),
               tokens=sum(lens), h=h, d=d, causal=False,
               dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED,
               max_abs_err_o=err_o, plain_bf16_err_o=err_o_pt,
               **{f"max_abs_err_{n}": e[0] for n, e in errs.items()},
               **{f"plain_bf16_err_{n}": e[1] for n, e in errs.items()},
               bitwise_repeat=bitwise, **times["dropout"],
               no_dropout=times["no_dropout"],
               fwd_over_no_dropout=times["dropout"]["fwd_kernel_ms"]
               / times["no_dropout"]["fwd_kernel_ms"],
               bwd_over_no_dropout=times["dropout"]["bwd_ms"]
               / times["no_dropout"]["bwd_ms"],
               plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
               library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
               library=which + ", dropout_p=0.1 (its own random mask)",
               fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
               bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
    emit(res)
    return res


def dropout_probe_phase():
    """The kernels' own keep masks against the plain `dropout_keep`, bit for
    bit (`utils.testing.dropout_probe_dense` / `_varlen`): the forward's
    through o, the dK/dV kernel's through dV, dense (GPT-2's heads) and
    varlen with the probe sequence after two of 20000 tokens (packed
    coordinates from 40000); the kept share of all probe elements within
    0.9 +- DROPOUT_KEEP_TOL."""
    import torch
    from flash_attn_tpu_torch.utils import testing

    before = dropout_counts()
    res, kept, total = dict(phase="dropout_probe"), 0, 0
    for name, masks in (
            ("dense", testing.dropout_probe_dense(8, 12, 64, DROPOUT_P,
                                                  DROPOUT_SEED, DEV)),
            ("varlen", testing.dropout_probe_varlen(
                [20000, 20000], 12, 64, DROPOUT_P, DROPOUT_SEED, DEV))):
        fwd, dkv, want = masks
        res[name] = dict(fwd_equal=bool(torch.equal(fwd, want)),
                         dkv_equal=bool(torch.equal(dkv, want)),
                         fwd_mismatches=int((fwd != want).sum()),
                         dkv_mismatches=int((dkv != want).sum()),
                         elements=want.numel())
        kept += int(fwd.sum()) + int(dkv.sum())
        total += 2 * want.numel()
    set_dropout_counts(before)
    res["kept_share"] = kept / total
    emit(res)
    for name in ("dense", "varlen"):
        if not (res[name]["fwd_equal"] and res[name]["dkv_equal"]):
            raise AssertionError(f"dropout probe {name}: the kernels' keep "
                                 f"masks differ from dropout_keep {res[name]}")
    if abs(res["kept_share"] - (1 - DROPOUT_P)) > DROPOUT_KEEP_TOL:
        raise AssertionError(f"dropout probe: kept share {res['kept_share']}")
    return res


def dropout_gpt_phase():
    """GPT-2 124M (the train phase's config, attn_pdrop = DROPOUT_P, resid
    and embd 0) at seq_len 1024, batch 8: DROPOUT_TRAIN_STEPS AdamW steps
    with `deterministic=False` through `chunked_lm_loss` after
    DROPOUT_WARMUP_STEPS (exactly 12 dropout launches of each kernel a step,
    none without dropout), its loss unlike the deterministic one on the
    same batch; then a 2-layer full-width model's gradients on the card
    against fp32 on the CPU with the same masks (`check_grads`)."""
    import torch
    from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel
    from flash_attn_tpu_torch.training.loss import chunked_lm_loss
    from flash_attn_tpu_torch.training.optim import make_optimizer

    tc = train_config()
    cfg = tc.model.to_gpt_config()
    cfg.attn_pdrop = DROPOUT_P
    model = GPTLMHeadModel(cfg, device=DEV).init_weights(
        torch.Generator().manual_seed(0))
    opt, sched = make_optimizer(tc.optimizer, tc.scheduler, model)
    b, s = tc.data.batch_size, tc.data.seq_len
    ids = torch.randint(0, cfg.vocab_size, (b, s + 1), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(5))

    def loss_of(deterministic):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return chunked_lm_loss(model, ids,
                                   chunk_tokens=tc.trainer.ce_chunk_tokens,
                                   deterministic=deterministic)

    def step():
        loss = loss_of(False)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(),
                                       tc.optimizer.grad_clip)
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    with torch.no_grad():
        first_drop, first_det = float(loss_of(False)), float(loss_of(True))
    for _ in range(DROPOUT_WARMUP_STEPS):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_dropout_counts({k: 0 for k in dropout_counts()})
    t0 = time.perf_counter()
    losses = [step() for _ in range(DROPOUT_TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dropout_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    del model, opt, sched
    torch.cuda.empty_cache()

    cfg2 = tc.model.to_gpt_config()
    cfg2.attn_pdrop, cfg2.n_layer = DROPOUT_P, 2
    gpu = GPTLMHeadModel(cfg2, device=DEV).init_weights(
        torch.Generator().manual_seed(1))
    cpu = cpu_reference(gpu)
    one = ids[:1]

    def grads(model, dev):
        with torch.autocast(dev, dtype=torch.bfloat16, enabled=dev == "cuda"):
            loss = chunked_lm_loss(model, one.to(dev), chunk_tokens=0,
                                   deterministic=False)
        loss.backward()
        return loss.item(), {n: p.grad.detach() for n, p in
                             model.named_parameters()}

    check = compare_grads(grads(gpu, "cuda"), grads(cpu, "cpu"))
    del gpu, cpu
    torch.cuda.empty_cache()
    L = cfg.n_layer
    want = {k: 0 for k in counts}
    want.update({n: L * DROPOUT_TRAIN_STEPS for n in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_dropout",
        "flash_bwd_dq_dropout", "flash_bwd_dkv_dropout")})
    res = dict(phase="dropout_gpt", model="gpt2-124M (random weights, seed "
               "0), attn_pdrop 0.1, resid_pdrop 0, embd_pdrop 0",
               seq_len=s, batch_size=b, steps=DROPOUT_TRAIN_STEPS,
               step_ms=wall / DROPOUT_TRAIN_STEPS * 1e3,
               tokens_per_s=b * s * DROPOUT_TRAIN_STEPS / wall,
               max_memory_allocated=peak, losses=losses,
               first_loss_dropout=first_drop,
               first_loss_deterministic=first_det, launches=counts,
               train_check=check)
    emit(res)
    if counts != want:
        raise AssertionError(f"dropout_gpt: launches {counts}, expected "
                             f"{want}")
    if not all(math.isfinite(x) for x in losses) or \
            abs(first_drop - LN_VOCAB) > 0.5:
        raise AssertionError(f"dropout_gpt: losses {first_drop}, {losses}")
    if first_drop == first_det:
        raise AssertionError("dropout_gpt: the loss with dropout equals the "
                             "loss without")
    check_grads("dropout_gpt train_check", check)
    return res


def dropout_bert_phase():
    """BERT-base (attention_probs_dropout_prob = DROPOUT_P, hidden 0) at the
    bert phase's batch, unpadded, `deterministic=False`: DROPOUT_BERT_ITERS
    timed forwards (exactly 12 varlen dropout launches each), unlike the
    deterministic forward; against fp32 on the CPU with the same masks on
    the first 4 sequences (error within 2x the deterministic one's + 1e-2);
    one gradient on BERT_GRAD_SEQS sequences (12 + 12 + 12 dropout
    launches), cosine >= GRAD_COSINE against fp32 on the CPU."""
    import torch
    from flash_attn_tpu_torch.models.bert import BertConfig, BertModel

    cfg = BertConfig(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=DROPOUT_P)
    L = cfg.num_hidden_layers
    model = BertModel(cfg, device=DEV, dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(0))
    ids, types, mask = bert_batch(DEV, cfg.vocab_size)
    fwd = dict(unpad_varlen=True, deterministic=False)
    with torch.no_grad():
        model(ids, mask, types, **fwd)
        torch.cuda.synchronize()
        set_dropout_counts({k: 0 for k in dropout_counts()})
        t0 = time.perf_counter()
        for _ in range(DROPOUT_BERT_ITERS):
            h, _ = model(ids, mask, types, **fwd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dropout_counts()
        h_det, _ = model(ids, mask, types, unpad_varlen=True)
    ref = BertModel(cfg, device="cpu")
    ref.load_state_dict({k: v.float().cpu()
                         for k, v in model.state_dict().items()})
    n = 4
    sel = mask[:n].cpu()
    cpu_in = (ids[:n].cpu(), sel, types[:n].cpu())
    with torch.no_grad():
        h_ref, _ = ref(*cpu_in, **fwd)
        h_ref_det, _ = ref(*cpu_in, unpad_varlen=True)
    err = float((h[:n].cpu()[sel].float() - h_ref[sel]).abs().max())
    err_det = float((h_det[:n].cpu()[sel].float() - h_ref_det[sel]).abs()
                    .max())
    differs = float((h[mask].float() - h_det[mask].float()).abs().max())

    g = BERT_GRAD_SEQS
    proj = torch.randn(g, BERT_SEQ, cfg.hidden_size,
                       generator=torch.Generator().manual_seed(2))
    set_dropout_counts({k: 0 for k in dropout_counts()})
    g_card = bert_grads(model, ids[:g], types[:g], mask[:g], proj.to(DEV),
                        True, deterministic=False)
    torch.cuda.synchronize()
    grad_counts = dropout_counts()
    g_cpu = bert_grads(ref, ids[:g].cpu(), types[:g].cpu(), mask[:g].cpu(),
                       proj, True, deterministic=False)
    del ref, model
    torch.cuda.empty_cache()
    want = {k: 0 for k in counts}
    want.update(varlen_fwd=L * DROPOUT_BERT_ITERS,
                varlen_fwd_dropout=L * DROPOUT_BERT_ITERS)
    want_g = {k: 0 for k in counts}
    want_g.update({n: L for n in ("varlen_fwd", "varlen_dq", "varlen_dkv",
                                  "varlen_fwd_dropout", "varlen_dq_dropout",
                                  "varlen_dkv_dropout")})
    res = dict(phase="dropout_bert", model="BERT-base (12 layers, random "
               "weights, seed 0), attention_probs_dropout_prob 0.1, "
               "hidden_dropout_prob 0", sequences=BERT_BATCH,
               tokens=int(mask.sum()), forwards=DROPOUT_BERT_ITERS,
               forward_ms=wall / DROPOUT_BERT_ITERS * 1e3,
               sequences_per_s=BERT_BATCH * DROPOUT_BERT_ITERS / wall,
               launches=counts, cpu_fp32_max_abs_err=err,
               cpu_fp32_max_abs_err_deterministic=err_det,
               max_abs_diff_from_deterministic=differs,
               grad_sequences=g, grad_launches=grad_counts,
               grad_cosine_vs_cpu_fp32=cosine(g_card, g_cpu))
    emit(res)
    if counts != want:
        raise AssertionError(f"dropout_bert: launches {counts}, expected "
                             f"{want}")
    if grad_counts != want_g:
        raise AssertionError(f"dropout_bert grad: launches {grad_counts}")
    if not torch.isfinite(h).all() or h[~mask].any():
        raise AssertionError("dropout_bert: non-finite output or padded "
                             "rows not 0")
    if not err <= 2 * err_det + 1e-2:
        raise AssertionError(f"dropout_bert: fp32 CPU error {err} > 2 x "
                             f"{err_det} + 1e-2")
    if not differs > 0:
        raise AssertionError("dropout_bert: output equals the "
                             "deterministic one")
    if not res["grad_cosine_vs_cpu_fp32"] >= GRAD_COSINE:
        raise AssertionError("dropout_bert: gradients disagree")
    return res


def dropout_entry(cases, keys, which, launches, probe):
    """The `dropout` entry of a kernels-line row: the first of `keys`'
    cases' times with and without dropout (`which`: "fwd", the forward
    kernel alone; "dq" or "dkv", one backward kernel, profiler; "bwd", the
    whole backward), plain, library (SDPA with dropout) and bound (the
    no-dropout one) ms and error; the path's dropout launches and the mask
    probe's result; every case by_case."""
    def one(r):
        if which == "fwd":
            ms, no = r["fwd_kernel_ms"], r["no_dropout"]["fwd_kernel_ms"]
            lib, plain, bnd = (r["library_fwd_ms"], r["plain_fwd_ms"],
                               r["fwd_bound_ms"])
            err = r["max_abs_err_o"]
        else:
            key = "bwd_ms" if which == "bwd" else f"{which}_kernel_ms"
            ms, no = r[key], r["no_dropout"][key]
            lib, plain = r["library_bwd_ms"], r["plain_bwd_ms"]
            bnd = r["bwd_bound_ms" if which == "bwd" else f"{which}_bound_ms"]
            err = max(r[f"max_abs_err_{n}"] for n in (
                ("dq",) if which == "dq" else ("dk", "dv") if which == "dkv"
                else ("dq", "dk", "dv")))
        return dict(case=r["case"], ms=ms, ms_no_dropout=no,
                    over_no_dropout=ms / no, plain_ms=plain, library_ms=lib,
                    bound_ms=bnd, max_abs_err=err)

    return dict(one(cases[keys[0]]), launches=launches, mask_probe=probe,
                library="SDPA with dropout_p=0.1: its own random mask, the "
                "same work", dropout_p=DROPOUT_P,
                by_case={k: one(cases[k]) for k in keys})


def dropout_phases(gen):
    """Kernel cases (i)-(iv), the mask probe, and the GPT-2 and BERT-base
    paths with attention dropout."""
    cases = dict(
        i=dropout_case("i: GPT-2 training shape", 8, 12, 12, 1024, 64, True,
                       gen),
        ii=dropout_case("ii: llama-1b training shape", 8, 16, 4, 2048, 128,
                        True, gen),
        iii=dropout_case("iii: ViT-B/16 training shape", VIT_BATCH, 12, 12,
                         VIT_TOKENS, 64, False, gen),
        iv=dropout_varlen_case("iv: the BERT batch", bert_batch_lengths(),
                               12, 64, gen))
    probe = dropout_probe_phase()
    gpt = dropout_gpt_phase()
    bert = dropout_bert_phase()
    return cases, probe, gpt, bert


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
    spills = {k: v for name in ("flex", "flash_bwd", "flash_fwd",
                                "diag_int8_decode", "diag_varlen_bisect")
              for k, v in ptxas_summary(name).items()
              if k.startswith(("flex_fwd_kernel", "flex_bwd_", "flash_bwd_",
                               "flash_fwd_kernel", "decode_ladder_kernel",
                               "bisect_kernel"))
              and (v.get("spill_stores") or v.get("spill_loads"))}
    if spills:
        raise AssertionError(f"Hopper kernels spill registers: {spills}")

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
    fwd["f"] = fwd_case("f: training shape", 8, 12, 12, 1024, 1024, 64,
                        [1024] * 8, [1024] * 8, gen, library=sdpa_causal)
    fwd["g"] = fwd_case("g: llama-1b training shape", 8, 16, 4, 2048, 2048,
                        128, [2048] * 8, [2048] * 8, gen,
                        library=sdpa_causal)
    fwd["h"] = fwd_case("h: ViT-B/16 training shape", VIT_BATCH, 12, 12,
                        VIT_TOKENS, VIT_TOKENS, 64, [VIT_TOKENS] * VIT_BATCH,
                        [VIT_TOKENS] * VIT_BATCH, gen, causal=False,
                        library=sdpa_full)
    dec = {}
    dec["a"] = decode_case("a: serving decode", 8, 12, 12, 1, 1024, 64, gen,
                           library=True)
    dec["b"] = decode_case("b: GQA", 8, 32, 8, 1, 4096, 128, gen)
    dec["c"] = decode_case("c: sq = 4", 8, 12, 12, 4, 1024, 64, gen)
    dec["d"] = decode_case("d: num_splits = 4", 8, 12, 12, 1, 1024, 64, gen,
                           num_splits=4, block_k=256)
    dec["e"] = decode_case("e: Llama-3-8B serving decode", 8, 32, 8, 1, 1024,
                           128, gen, library=True)

    bwd = {}
    bwd["a"] = bwd_case("a: training shape", 8, 12, 12, 1024, 1024, 64,
                        [1024] * 8, [1024] * 8, gen, library=True,
                        repeat=True)
    bwd["b"] = bwd_case("b: GQA", 2, 32, 8, 2048, 2048, 128, [2048] * 2,
                        [2048] * 2, gen)
    bwd["c"] = bwd_case("c: window+softcap+alibi", 2, 12, 12, 1024, 1024, 64,
                        [1024] * 2, [1024] * 2, gen, window=(256, 0),
                        softcap=30.0, alibi=True)
    bwd["d"] = bwd_case("d: ragged, seqused_k = 0", 3, 12, 12, 1024, 1024,
                        64, [1024, 700, 1024], [1024, 500, 0], gen)
    bwd["e"] = bwd_case("e: llama-1b training shape", 8, 16, 4, 2048, 2048,
                        128, [2048] * 8, [2048] * 8, gen, library=True)
    bwd["f"] = bwd_case("f: ViT-B/16 training shape", VIT_BATCH, 12, 12,
                        VIT_TOKENS, VIT_TOKENS, 64, [VIT_TOKENS] * VIT_BATCH,
                        [VIT_TOKENS] * VIT_BATCH, gen, causal=False,
                        library=True, repeat=True)

    kvc = kernel_kvcache_phase(gen)
    vfwd, vbwd = kernel_varlen_phases()

    serve = serve_phase()
    train = train_phase()
    train_check_phase()
    kvpath = kvcache_phase()
    kv_launches = sum(r["flash_decode_ref_launches"] for r in kvpath.values())
    kv_by_run = {run: r["flash_decode_ref_launches"]
                 for run, r in kvpath.items()}
    bert = bert_phase()
    dcases, dprobe, dgpt, dbert = dropout_phases(gen)
    ffwd, fbwd, fcompiled = kernel_flex_phases()
    flexpath = flex_phase()
    lserve = llama_serve_phase()
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        shard = write_token_shard(os.path.join(workdir, "tokens.bin"),
                                  LLAMA_SHARD_TOKENS, 50257)
        ltrain = llama_train_phase(shard)
        llama_check_phases(shard)
        ckpt_dir = os.path.join(workdir, "vit_ckpt")
        vit = vit_train_phase(ckpt_dir)
        eval_cli_phase(ckpt_dir, vit["checkpoint_step"])
        native_loader_phase(shard, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    fam = families_phase()
    dg = diag_phase()

    a = bwd["a"]
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
             replaces="flash_attn_tpu/kernels/flash_fwd.py:200",
             launches=serve["flash_fwd_launches"]
             + train["launches"]["flash_fwd"]
             + lserve["flash_fwd_launches"]
             + ltrain["launches"]["flash_fwd"]
             + vit["launches"]["flash_fwd"]
             + fam["launches"]["flash_fwd"]
             + dgpt["launches"]["flash_fwd"],
             launches_by_path=dict(
                 serve=serve["flash_fwd_launches"],
                 train=train["launches"]["flash_fwd"],
                 dropout_gpt=dgpt["launches"]["flash_fwd"],
                 llama_serve=lserve["flash_fwd_launches"],
                 llama_train=ltrain["launches"]["flash_fwd"],
                 llama_train_evaluations=ltrain["eval_launches"]["flash_fwd"],
                 vit_train=vit["launches"]["flash_fwd"],
                 vit_evaluation=vit["eval_launches"]["flash_fwd"],
                 families=fam["launches"]["flash_fwd"]),
             max_abs_err=fwd["a"]["max_abs_err_o"], ms=fwd["a"]["kernel_ms"],
             kernel_device_ms=fwd["a"]["kernel_device_ms"],
             plain_ms=fwd["a"]["plain_ms"], bound_ms=fwd["a"]["bound_ms"],
             bound_by=fwd["a"]["bound_by"],
             library_ms=fwd["a"]["library_ms"], ptxas=fwd_ptxas(False),
             dropout=dropout_entry(dcases, ("i", "ii", "iii"), "fwd",
                                   dgpt["launches"]["flash_fwd_dropout"],
                                   dprobe["dense"]["fwd_equal"]),
             by_case={k: dict(ms=r["kernel_ms"],
                              kernel_device_ms=r["kernel_device_ms"],
                              plain_ms=r["plain_ms"],
                              bound_ms=r["bound_ms"],
                              library_ms=r["library_ms"],
                              max_abs_err=r["max_abs_err_o"])
                      for k, r in fwd.items()}),
        dict(name="flash_decode", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_decode_ref.cu",
             kernel="flash_decode_ref_kernel, heads-first (bc, hk, smax, d) "
             "caches through decode_attn_bhsd",
             replaces="flash_attn_tpu/kernels/flash_decode.py:117",
             launches=serve["flash_decode_launches"]
             + lserve["flash_decode_launches"]
             + fam["launches"]["flash_decode"],
             launches_by_path=dict(
                 serve=serve["flash_decode_launches"],
                 llama_serve=lserve["flash_decode_launches"],
                 families=fam["launches"]["flash_decode"]),
             max_abs_err=dec["a"]["max_abs_err_o"], ms=dec["a"]["kernel_ms"],
             plain_ms=dec["a"]["plain_ms"], bound_ms=dec["a"]["bound_ms"],
             bound_by=dec["a"]["bound_by"],
             library_ms=dec["a"]["library_ms"],
             num_splits=dec["a"]["num_splits"], blocks=dec["a"]["blocks"],
             sm_fill=dec["a"]["sm_fill"],
             by_case={k: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["bound_ms"],
                              library_ms=r["library_ms"],
                              num_splits=r["num_splits"],
                              max_abs_err=r["max_abs_err_o"])
                      for k, r in dec.items()}),
        dict(name="flash_bwd_dq", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_bwd.cu",
             replaces="flash_attn_tpu/kernels/flash_bwd.py:121",
             launches=train["launches"]["flash_bwd_dq"]
             + ltrain["launches"]["flash_bwd_dq"]
             + vit["launches"]["flash_bwd_dq"]
             + dgpt["launches"]["flash_bwd_dq"],
             launches_by_path=dict(
                 train=train["launches"]["flash_bwd_dq"],
                 dropout_gpt=dgpt["launches"]["flash_bwd_dq"],
                 llama_train=ltrain["launches"]["flash_bwd_dq"],
                 vit_train=vit["launches"]["flash_bwd_dq"]),
             max_abs_err=a["max_abs_err_dq"], ms=a["dq_kernel_ms"],
             dropout=dropout_entry(dcases, ("i", "ii", "iii"), "dq",
                                   dgpt["launches"]["flash_bwd_dq_dropout"],
                                   "held through the gradient check"),
             plain_ms=a["plain_ms"], bound_ms=a["dq_bound_ms"],
             bound_by=a["dq_bound_by"], library_ms=a["library_ms"],
             by_case={k: dict(ms=r["dq_kernel_ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["dq_bound_ms"],
                              whole_ms=r["kernel_ms"],
                              whole_bound_ms=r["bound_ms"],
                              library_ms=r["library_ms"],
                              max_abs_err=r["max_abs_err_dq"])
                      for k, r in bwd.items()},
             ptxas={k: v for k, v in ptxas_summary("flash_bwd").items()
                    if k.startswith("flash_bwd_dq_kernel")}),
        dict(name="flash_bwd_dkv", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_bwd.cu",
             replaces="flash_attn_tpu/kernels/flash_bwd.py:232",
             launches=train["launches"]["flash_bwd_dkv"]
             + ltrain["launches"]["flash_bwd_dkv"]
             + vit["launches"]["flash_bwd_dkv"]
             + dgpt["launches"]["flash_bwd_dkv"],
             launches_by_path=dict(
                 train=train["launches"]["flash_bwd_dkv"],
                 dropout_gpt=dgpt["launches"]["flash_bwd_dkv"],
                 llama_train=ltrain["launches"]["flash_bwd_dkv"],
                 vit_train=vit["launches"]["flash_bwd_dkv"]),
             max_abs_err=max(a["max_abs_err_dk"], a["max_abs_err_dv"]),
             ms=a["dkv_kernel_ms"], plain_ms=a["plain_ms"],
             dropout=dropout_entry(dcases, ("i", "ii", "iii"), "dkv",
                                   dgpt["launches"]["flash_bwd_dkv_dropout"],
                                   dprobe["dense"]["dkv_equal"]),
             bound_ms=a["dkv_bound_ms"], bound_by=a["dkv_bound_by"],
             library_ms=a["library_ms"],
             by_case={k: dict(ms=r["dkv_kernel_ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["dkv_bound_ms"],
                              library_ms=r["library_ms"],
                              max_abs_err=max(r["max_abs_err_dk"],
                                              r["max_abs_err_dv"]))
                      for k, r in bwd.items()},
             ptxas={k: v for k, v in ptxas_summary("flash_bwd").items()
                    if k.startswith("flash_bwd_dkv_kernel")}),
        dict(name="flash_decode_ref", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_decode_ref.cu",
             kernel="flash_decode_ref_kernel, reference-layout caches "
             "through decode_attn_ref_layout",
             replaces="flash_attn_tpu/kernels/flash_decode.py:407 and "
             ":1083 (_decode_paged_pipe_kernel)",
             launches=kv_launches, launches_by_run=kv_by_run,
             case=kvc["a"]["case"],
             max_abs_err=kvc["a"]["max_abs_err_o"], ms=kvc["a"]["kernel_ms"],
             plain_ms=kvc["a"]["plain_ms"], bound_ms=kvc["a"]["bound_ms"],
             bound_by=kvc["a"]["bound_by"],
             library_ms=kvc["a"]["library_ms"],
             num_splits=kvc["a"]["num_splits"], blocks=kvc["a"]["blocks"],
             sm_fill=kvc["a"]["sm_fill"],
             ptxas=ptxas_summary("flash_decode_ref"),
             by_case={k: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["bound_ms"],
                              library_ms=r["library_ms"],
                              num_splits=r.get("num_splits"),
                              max_abs_err=r["max_abs_err_o"])
                      for k, r in kvc.items()}),
        dict(name="flash_fwd_varlen", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
             kernel="flash_fwd_kernel in its varlen mode (flash_fwd_varlen)",
             replaces="flash_attn_tpu/kernels/varlen_sched.py:211",
             launches=bert["launches"]["varlen_fwd"]
             + bert["grad_launches"]["varlen_fwd"]
             + dbert["launches"]["varlen_fwd"]
             + dbert["grad_launches"]["varlen_fwd"],
             launches_by_path=dict(
                 bert_forward=bert["launches"]["varlen_fwd"],
                 bert_grad=bert["grad_launches"]["varlen_fwd"],
                 dropout_bert_forward=dbert["launches"]["varlen_fwd"],
                 dropout_bert_grad=dbert["grad_launches"]["varlen_fwd"]),
             dropout=dropout_entry(
                 dcases, ("iv",), "fwd",
                 dbert["launches"]["varlen_fwd_dropout"]
                 + dbert["grad_launches"]["varlen_fwd_dropout"],
                 dprobe["varlen"]["fwd_equal"]),
             case=vfwd["a"]["case"], max_abs_err=vfwd["a"]["max_abs_err_o"],
             ms=vfwd["a"]["kernel_device_ms"],
             whole_call_ms=vfwd["a"]["kernel_ms"],
             plain_ms=vfwd["a"]["plain_ms"],
             bound_ms=vfwd["a"]["bound_ms"], bound_by=vfwd["a"]["bound_by"],
             library_ms=vfwd["a"]["library_ms"],
             library=vfwd["a"]["library"], rows=vfwd["a"]["rows"],
             ptxas=fwd_ptxas(True),
             by_case={k: dict(ms=r["kernel_device_ms"],
                              whole_call_ms=r["kernel_ms"],
                              plain_ms=r["plain_ms"],
                              bound_ms=r["bound_ms"],
                              library_ms=r["library_ms"], rows=r["rows"],
                              max_abs_err=r["max_abs_err_o"])
                      for k, r in vfwd.items()}),
        dict(name="flash_bwd_varlen", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_bwd.cu",
             kernel="flash_bwd_dq_kernel (with the dO.O preprocess) then "
             "flash_bwd_dkv_kernel in their varlen mode (flash_bwd_varlen)",
             replaces="flash_attn_tpu/kernels/varlen_sched.py:643",
             launches=bert["grad_launches"]["varlen_dq"]
             + dbert["grad_launches"]["varlen_dq"],
             launches_dkv=bert["grad_launches"]["varlen_dkv"]
             + dbert["grad_launches"]["varlen_dkv"],
             launches_by_path=dict(
                 bert_grad=bert["grad_launches"]["varlen_dq"],
                 dropout_bert_grad=dbert["grad_launches"]["varlen_dq"]),
             dropout=dropout_entry(
                 dcases, ("iv",), "bwd",
                 dbert["grad_launches"]["varlen_dq_dropout"],
                 dprobe["varlen"]["dkv_equal"]),
             case=vbwd["a"]["case"],
             max_abs_err=max(vbwd["a"][f"max_abs_err_{n}"]
                             for n in ("dq", "dk", "dv")),
             ms=vbwd["a"]["kernel_ms"], dq_ms=vbwd["a"]["dq_kernel_ms"],
             dkv_ms=vbwd["a"]["dkv_kernel_ms"],
             plain_ms=vbwd["a"]["plain_ms"], bound_ms=vbwd["a"]["bound_ms"],
             bound_by=vbwd["a"]["bound_by"],
             dq_bound_ms=vbwd["a"]["dq_bound_ms"],
             dkv_bound_ms=vbwd["a"]["dkv_bound_ms"],
             library_ms=vbwd["a"]["library_ms"],
             library=vbwd["a"]["library"],
             by_case={k: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["bound_ms"],
                              library_ms=r["library_ms"],
                              bitwise_repeat=r["bitwise_repeat"])
                      for k, r in vbwd.items()}),
        dict(name="flex_fwd", route="cuda",
             source="flash_attn_tpu_torch/csrc/flex.cu",
             kernel="flex_fwd_kernel (also serves flex.py:521, "
             "_flex_fwd_hb_kernel)",
             replaces="flash_attn_tpu/kernels/flex.py:430",
             launches=flexpath["launches"]["flex_fwd"],
             launches_by_path=dict(flex=flexpath["launches"]["flex_fwd"]),
             case=ffwd["c"]["case"], max_abs_err=ffwd["c"]["max_abs_err_o"],
             ms=ffwd["c"]["kernel_ms"], plain_ms=ffwd["c"]["plain_ms"],
             bound_ms=ffwd["c"]["bound_ms"], bound_by=ffwd["c"]["bound_by"],
             library_ms=ffwd["c"]["library_ms"],
             library=ffwd["c"]["library"],
             mask_prep_ms=ffwd["c"]["mask_prep_ms"],
             compiled_torch_flex=fcompiled,
             ptxas={k: v for k, v in ptxas_summary("flex").items()
                    if k.startswith("flex_fwd_kernel")},
             by_case={k: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["bound_ms"],
                              library_ms=r["library_ms"],
                              mask_prep_ms=r["mask_prep_ms"],
                              max_abs_err=r["max_abs_err_o"])
                      for k, r in ffwd.items()}),
        dict(name="flex_bwd_dq", route="cuda",
             source="flash_attn_tpu_torch/csrc/flex.cu",
             kernel="flex_bwd_dq_kernel",
             replaces="flash_attn_tpu/kernels/flex.py:912",
             launches=flexpath["launches"]["flex_dq"],
             launches_by_path=dict(flex=flexpath["launches"]["flex_dq"]),
             case=fbwd["c"]["case"], max_abs_err=fbwd["c"]["max_abs_err_dq"],
             ms=fbwd["c"]["dq_kernel_ms"], plain_ms=fbwd["c"]["plain_ms"],
             bound_ms=fbwd["c"]["dq_bound_ms"],
             bound_by=fbwd["c"]["dq_bound_by"],
             library_ms=fbwd["c"]["library_ms"],
             library=fbwd["c"]["library"],
             compiled_torch_flex_bwd_ms=fcompiled.get("bwd_ms"),
             ptxas={k: v for k, v in ptxas_summary("flex").items()
                    if k.startswith("flex_bwd_dq_kernel")},
             by_case={k: dict(ms=r["dq_kernel_ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["dq_bound_ms"],
                              library_ms=r["library_ms"],
                              bitwise_repeat=r["bitwise_repeat"])
                      for k, r in fbwd.items()}),
        dict(name="flex_bwd_dkv", route="cuda",
             source="flash_attn_tpu_torch/csrc/flex.cu",
             kernel="flex_bwd_dkv_kernel",
             replaces="flash_attn_tpu/kernels/flex.py:1010",
             launches=flexpath["launches"]["flex_dkv"],
             launches_by_path=dict(flex=flexpath["launches"]["flex_dkv"]),
             case=fbwd["c"]["case"],
             max_abs_err=max(fbwd["c"]["max_abs_err_dk"],
                             fbwd["c"]["max_abs_err_dv"]),
             ms=fbwd["c"]["dkv_kernel_ms"], plain_ms=fbwd["c"]["plain_ms"],
             bound_ms=fbwd["c"]["dkv_bound_ms"],
             bound_by=fbwd["c"]["dkv_bound_by"],
             library_ms=fbwd["c"]["library_ms"],
             library=fbwd["c"]["library"],
             compiled_torch_flex_bwd_ms=fcompiled.get("bwd_ms"),
             ptxas={k: v for k, v in ptxas_summary("flex").items()
                    if k.startswith("flex_bwd_dkv_kernel")},
             by_case={k: dict(ms=r["dkv_kernel_ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["dkv_bound_ms"],
                              library_ms=r["library_ms"],
                              bitwise_repeat=r["bitwise_repeat"])
                      for k, r in fbwd.items()}),
        dict(name="diag_varlen_bisect", route="cuda",
             source="flash_attn_tpu_torch/csrc/diag_varlen_bisect.cu",
             kernel="bisect_kernel, levels K0..K10 (K5 runs K4); ms: K4 on "
             "the script's all-empty table of 256 ticks",
             replaces="benchmarks/diag_varlen_overhead_bisect.py:144",
             also_replaces=["benchmarks/diag_varlen_overhead_bisect.py:334",
                            "benchmarks/diag_varlen_overhead_bisect.py:485",
                            "benchmarks/diag_varlen_overhead_bisect.py:599"],
             launches=dg["launches"]["diag_varlen_bisect"],
             max_abs_err=dg["bisect"]["max_abs_err"], ms=dg["bisect"]["ms"],
             plain_ms=dg["bisect"]["plain_ms"],
             bound_ms=dg["bisect"]["bound_ms"], bound_by="bytes",
             library_ms=None, us_per_tick=dg["bisect"]["us_per_tick"],
             ptxas=ptxas_summary("diag_varlen_bisect"),
             us_per_empty_cta=dg["bisect"]["us_per_empty_cta"]),
        dict(name="diag_int8_decode", route="cuda",
             source="flash_attn_tpu_torch/csrc/diag_int8_decode.cu",
             kernel="decode_ladder_kernel; ms: bf16 full at the filling "
             "split, ms_one_split at one; production_ms: flash_decode_ref on "
             "the same cache at the filling split",
             replaces="benchmarks/diag_int8_decode.py:144",
             launches=dg["launches"]["diag_int8_decode"],
             max_abs_err=dg["ladder"]["max_abs_err"], ms=dg["ladder"]["ms"],
             ms_one_split=dg["ladder"]["ms_one_split"],
             production_ms=dg["ladder"]["production_ms"],
             full_against_production_ms=dg["ladder"]["against"],
             ptxas=ptxas_summary("diag_int8_decode"),
             plain_ms=dg["ladder"]["plain_ms"],
             bound_ms=dg["ladder"]["bound_ms"], bound_by="bytes",
             library_ms=dg["ladder"]["library_ms"],
             library="SDPA on the contiguous (b, hk, smax, d) cache, "
             "8 query rows a kv head",
             by_stage_ms=dg["ladder"]["by_stage"],
             fill_splits=dg["ladder"]["fill_splits"],
             by_stage_fill_ms=dg["ladder"]["by_stage_fill"]),
        dict(name="diag_dma_stream", route="cuda",
             source="flash_attn_tpu_torch/csrc/diag_dma_stream.cu",
             kernel="dma_stream_kernel + dma_stream_reduce; ms: plain R=256 "
             "bundle=1 sequential",
             replaces="benchmarks/diag_dma_stream.py:92",
             launches=dg["launches"]["diag_dma_stream"],
             max_abs_err=dg["stream"]["max_abs_err"], ms=dg["stream"]["ms"],
             plain_ms=dg["stream"]["plain_ms"],
             bound_ms=dg["stream"]["bound_ms"], bound_by="bytes",
             library_ms=dg["stream"]["library_ms"],
             library="device-to-device copy_ of the same bytes (reads and "
             "writes them)",
             by_variant=dg["stream"]["by_variant"]),
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
