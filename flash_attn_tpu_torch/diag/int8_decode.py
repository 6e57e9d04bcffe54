"""Staged ablation of the decode body, int8 and bf16 (counterpart of
`benchmarks/diag_int8_decode.py`).

Decode is bandwidth-bound: an int8 cache halves the streamed bytes, so it
should approach 2x bf16 tokens/s.  This ladder of stripped kernels
(`csrc/diag_int8_decode.cu`: `csrc/flash_decode_ref.cu`'s per-tile decode
body cut after each stage) over the slab layout (b, smax, hk*d), the
reference-layout decode's contiguous cache, shows where the time goes:

  dma    : stream the K/V slabs, touch them once (pure bandwidth)
  qk     : + per-head QK^T (s8 mma, int32 sums, for int8; bf16 mma)
  cast   : + score cast/scale to f32
  soft   : + online-softmax update (max/exp2/sum, m/l state)
  pquant : + P re-quantisation (round(127 p) for int8; bf16 cast for bf16)
  full   : + PV matmul + accumulator update (the whole decode body)

    python -m flash_attn_tpu_torch.diag.int8_decode [stage,stage,...]

runs the ladder at one key split (the JAX schedule: a block per (kv head,
batch)) and at the split that fills the card, each beside the production
decode kernel on the same cache at the same split (`production_decode`),
the int8 transfer-size sweep (bk = 1024, 2048, 4096) and the end-to-end
decode through the port's `flash_attn_with_kvcache`.

`decode_ladder` launches the kernel (CUDA tensors only) and
`decode_ladder_ref` is its plain twin.  Outputs are (b, 1, hk, 8, d) fp32:
stages qk..pquant add one row sum into column 0 of each head's rows (soft
and pquant: each bk-key block's p against the running max at the block's
end, no rescale across blocks); full is the unnormalised accumulator; dma
(whose JAX kernel writes no output) sums, over key blocks, each block's
first 8 key rows over d, K plus V.

The kernel is the production decode body (`csrc/flash_decode_ref.cu`),
whose running max moves once per 64-key tile; JAX's moves once per bk-key
block.  soft and bf16 full agree up to rounding; pquant and int8 full
quantise p against the other max.  `decode_ladder_ref(max_every=64)`
computes the kernel's own function, `max_every=bk` (the default) JAX's.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from flash_attn_tpu_torch.diag import device_line, require_cuda
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.flash_decode import _semaphores
from flash_attn_tpu_torch.utils.benchmark import benchmark_chained

KERNEL = "diag_int8_decode"
STAGES = ("dma", "qk", "cast", "soft", "pquant", "full")
LOG2E = 1.4426950408889634
SCALE = 0.0883883  # the probe's fixed score scale (1/sqrt(128))
ROWS = 8  # query rows a kv head (g * sq padded to a sublane tile in JAX)
TILE = 64  # keys a tile of the kernel, and its keys per max update
PRODUCTION_ROWS = 4  # g * sq of the production kernel's decode step

# Number of times the CUDA kernel was launched (the twin does not count).
launches = 0


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.diag_decode_ladder.argtypes = [I, I] + [P] * 7 + [I] * 6 + [P]
        lib.diag_decode_ladder.restype = I
        lib.diag_decode_ladder_occupancy.argtypes = [I] * 3 + [P]
        lib.diag_decode_ladder_occupancy.restype = I
        _build.declare_error_string(lib)
        lib._typed = True
    return lib


def _check_shapes(stage, q, kc, vc, bk, splits):
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    b, hk, rows, d = q.shape
    if rows != ROWS:
        raise ValueError(f"q must be (b, hk, {ROWS}, d), got {tuple(q.shape)}")
    smax = kc.shape[1]
    if kc.shape != (b, smax, hk * d) or vc.shape != kc.shape:
        raise ValueError("k and v slabs must be (b, smax, hk * d)")
    if smax % splits or (smax // splits) % bk:
        raise ValueError(f"smax / splits ({smax} / {splits}) must be a "
                         f"multiple of bk ({bk})")
    return b, hk, d, smax


def decode_ladder_ref(stage, q, kc, vc, *, bk: int, splits: int = 1,
                      max_every: int | None = None):
    """Plain twin of `decode_ladder` (same signature and result).

    The key blocks of each split are walked in order, with the running max
    reset at each split; splits merge as the kernel's do.  The running max
    moves once per `max_every` keys (default bk, JAX's function; 64 is the
    kernel's): soft and pquant keep a block sum, rescaled with each move,
    and add it into column 0 at the block's end.  Scores and P V are float
    matrix products: exact integer sums in float64 for int8, float32 for
    bf16 (TF32 off, the default)."""
    b, hk, d, smax = _check_shapes(stage, q, kc, vc, bk, splits)
    every = bk if max_every is None else max_every
    if every <= 0 or bk % every:
        raise ValueError(f"max_every ({every}) must divide bk ({bk})")
    int8 = q.dtype == torch.int8
    mm = torch.float64 if int8 else torch.float32
    kh = kc.view(b, smax, hk, d).transpose(1, 2)  # (b, hk, smax, d)
    vh = vc.view(b, smax, hk, d).transpose(1, 2)
    qm = q.to(mm)
    sk = smax // splits
    parts, ms = [], []
    for s in range(splits):
        acc = torch.zeros(b, hk, ROWS, d, dtype=torch.float32, device=q.device)
        m = torch.full((b, hk, ROWS, 1), -torch.inf, device=q.device)
        l = torch.zeros(b, hk, ROWS, 1, device=q.device)
        for k0 in range(s * sk, (s + 1) * sk, bk):
            kb, vb = kh[:, :, k0:k0 + bk], vh[:, :, k0:k0 + bk]
            if stage == "dma":
                acc[..., 0] += (kb[:, :, :ROWS].float().sum(-1)
                                + vb[:, :, :ROWS].float().sum(-1))
                continue
            raw = torch.matmul(qm, kb.to(mm).transpose(-1, -2))
            if int8:
                st32 = raw.to(torch.int32)
                if stage == "qk":
                    acc[..., 0] += st32.sum(-1).to(torch.int32).float()
                    continue
                st = st32.float() * SCALE
            else:
                st = raw.float()
                if stage == "qk":
                    acc[..., 0] += st.sum(-1)
                    continue
                st = st * SCALE
            if stage == "cast":
                acc[..., 0] += st.sum(-1)
                continue
            block_sum = torch.zeros_like(l)
            for u0 in range(0, bk, every):
                su = st[..., u0:u0 + every]
                m_curr = torch.maximum(m, su.amax(-1, keepdim=True))
                alpha = torch.exp2((m - m_curr) * LOG2E)
                p = torch.exp2((su - m_curr) * LOG2E)
                l = l * alpha + p.sum(-1, keepdim=True)
                m = m_curr
                if stage == "soft":
                    block_sum = block_sum * alpha + p.sum(-1, keepdim=True)
                    continue
                pq = torch.round(p * 127.0) if int8 else p.to(torch.bfloat16)
                if stage == "pquant":
                    block_sum = (block_sum * alpha
                                 + pq.float().sum(-1, keepdim=True))
                    continue
                pv = torch.matmul(pq.to(mm), vb[:, :, u0:u0 + every].to(mm))
                pv = pv.float()
                if int8:
                    pv = pv * (SCALE / 127.0)
                acc = acc * alpha + pv
            if stage == "soft":
                acc[..., 0] += block_sum[..., 0]
            elif stage == "pquant":
                # JAX sums the bf16 p in bf16: one rounding of the block sum
                acc[..., 0] += (block_sum if int8
                                else block_sum.bfloat16().float())[..., 0]
        parts.append(acc)
        ms.append(m)
    if stage == "full":
        mmax = torch.stack(ms).amax(0)
        out = sum(torch.exp2((mj - mmax) * LOG2E) * pj
                  for mj, pj in zip(ms, parts))
    else:
        out = sum(parts[1:], parts[0])
    return out[:, None]


def decode_ladder(stage, q, kc, vc, *, bk: int, splits: int = 1):
    """One ladder stage through `csrc/diag_int8_decode.cu`.  q (b, hk, 8, d)
    int8 or bf16; kc, vc (b, smax, hk * d) of q's dtype; d in {64, 128};
    bk a multiple of 64 dividing smax / splits.  Returns (b, 1, hk, 8, d)
    fp32 (see the module docstring).  CUDA tensors only."""
    global launches
    require_cuda("decode_ladder", q, kc, vc)
    b, hk, d, smax = _check_shapes(stage, q, kc, vc, bk, splits)
    if q.dtype not in (torch.int8, torch.bfloat16) or kc.dtype != q.dtype \
            or vc.dtype != q.dtype:
        raise ValueError("q, k and v must all be int8 or all bf16")
    if d not in (64, 128) or bk % TILE:
        raise ValueError(f"d must be 64 or 128 and bk a multiple of {TILE}")
    for t in (q, kc, vc):
        if not t.is_contiguous():
            raise ValueError("q, k and v must be contiguous")
    dev = q.device
    out = torch.empty(b, 1, hk, ROWS, d, dtype=torch.float32, device=dev)
    # each split's (m, l) of the rows; with splits > 1 the splits' rows and
    # the merge's counters, which the kernel leaves zeroed
    stats = torch.empty(b, hk, splits, ROWS, 2, dtype=torch.float32,
                        device=dev)
    part = sems = None
    if splits > 1:
        part = torch.empty(b, hk, splits, ROWS, d, dtype=torch.float32,
                           device=dev)
        sems = _semaphores(dev, b * hk)
    lib = _lib()
    err = lib.diag_decode_ladder(
        STAGES.index(stage), int(q.dtype == torch.int8), q.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), stats.data_ptr(),
        None if sems is None else sems.data_ptr(),
        b, hk, smax, d, bk, splits, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, KERNEL)
    launches += 1
    return out


def production_decode(q, kc, vc, *, splits):
    """One launch of the production decode kernel (`csrc/flash_decode_ref.cu`
    through `kernels.flash_decode`), the kernel whose time the rungs split,
    on the ladder's cache read as its contiguous (b, smax, hk, d) layout:
    the first PRODUCTION_ROWS of q's rows (a decode step's g * sq at
    Llama-3-8B's 32 heads over 8), no mask, the ladder's scale, the key
    split `splits`.  An int8 q goes in as the quantised query (q_scale 1).
    Counts in `flash_decode.launches`.  Returns o (b, hk, rows, d) fp32."""
    from flash_attn_tpu_torch.kernels import flash_decode as fd

    b, hk, _, d = q.shape
    smax = kc.shape[1]
    int8 = q.dtype == torch.int8
    dev = q.device
    lens = torch.full((b,), smax, dtype=torch.int32, device=dev)
    o, _ = fd._launch(
        q[:, :, :PRODUCTION_ROWS].contiguous(), kc.view(b, smax, hk, d),
        vc.view(b, smax, hk, d), lens, h=hk * PRODUCTION_ROWS, sq=1,
        q_code=0, cache_code=2 if int8 else 0, softmax_scale=SCALE,
        causal=False, window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
        splits=splits, split_keys=smax // splits, smax=smax,
        q_scale=torch.ones(b, hk, device=dev) if int8 else None)
    return o


def fill_splits(b, hk, smax, bk, stage="full", int8=False, d=128):
    """The largest key split, in whole bk-key blocks, whose blocks (b * hk *
    splits) all run at once on the card: SMs times the kernel's blocks per
    SM."""
    lib = _lib()
    n = ctypes.c_int(0)
    _build.check(lib, lib.diag_decode_ladder_occupancy(
        STAGES.index(stage), int(int8), d, ctypes.byref(n)), KERNEL)
    slots = torch.cuda.get_device_properties(0).multi_processor_count * n.value
    splits = 1
    while (smax // (2 * splits)) % bk == 0 and smax // (2 * splits) >= bk \
            and b * hk * 2 * splits <= slots:
        splits *= 2
    return splits


def make_inputs(int8, b=8, hk=8, smax=8192, d=128, seed=0):
    """q (b, hk, 8, d) and the K/V slabs (b, smax, hk * d), made on the card
    from `seed`: integers in [-127, 127) for int8, N(0, 1) for bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if int8:
        def draw(*shape):
            return torch.randint(-127, 127, shape, generator=gen,
                                 device="cuda", dtype=torch.int8)
    else:
        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
    kc = draw(b, smax, hk * d)
    vc = draw(b, smax, hk * d)
    return draw(b, hk, ROWS, d), kc, vc


def kv_bytes(int8, b=8, hk=8, smax=8192, d=128):
    return 2 * b * smax * hk * d * (1 if int8 else 2)


def run_stage(stage, int8, b=8, hk=8, smax=8192, bk=1024, d=128,
              iters=64, reps=3, splits=1, inputs=None):
    q, kc, vc = inputs or make_inputs(int8, b, hk, smax, d)

    def step(q, kc, vc):
        decode_ladder(stage, q, kc, vc, bk=bk, splits=splits)
        return q

    dt = benchmark_chained(step, q, kc, vc, iters=iters, reps=reps)
    kvb = kv_bytes(int8, b, hk, smax, d)
    print(f"{'int8' if int8 else 'bf16'} {stage:6s}: {dt*1e6:8.1f} us  "
          f"stream {kvb/dt/1e9:7.1f} GB/s", flush=True)
    return dt


def end_to_end(iters=64, reps=3):
    """The real decode kernel through the port's `flash_attn_with_kvcache`:
    b=8, sq=1, h=32, hk=8, d=128, smax=8192, bf16 then int8 caches (descale
    0.03).  Returns {name: seconds per call, name + "_host_bound": whether
    the host could not queue the calls ahead of the card}."""
    from flash_attn_tpu_torch.interface import flash_attn_with_kvcache

    b, sq, h, hk, d, smax = 8, 1, 32, 8, 128, 8192
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").bfloat16()
    lens = torch.full((b,), smax - 1, dtype=torch.int32, device="cuda")
    kcf = torch.randn(b, smax, hk, d, generator=gen, device="cuda")
    vcf = torch.randn(b, smax, hk, d, generator=gen, device="cuda")
    res = {}
    for name, dt8 in (("bf16", False), ("int8", True)):
        if dt8:
            ds = 0.03
            kd = torch.full((b, hk), ds, device="cuda")
            kc = torch.clamp(torch.round(kcf / ds), -127, 127).to(torch.int8)
            vc = torch.clamp(torch.round(vcf / ds), -127, 127).to(torch.int8)
            kw = dict(k_descale=kd, v_descale=kd)
        else:
            kc, vc = kcf.bfloat16(), vcf.bfloat16()
            kw = {}

        def step(q, kc, vc, kw=kw):
            flash_attn_with_kvcache(q, kc, vc, cache_seqlens=lens,
                                    causal=True, **kw)
            return q

        t = benchmark_chained(step, q, kc, vc, iters=iters, reps=reps)
        kvb = 2 * b * smax * hk * d * (1 if dt8 else 2)
        held = (" (host-bound: timed without the spin, host time included)"
                if t.host_bound else "")
        print(f"e2e {name}: {t*1e6:8.1f} us  {kvb/t/1e9:7.1f} GB/s "
              f"{b*sq/t:,.0f} tok/s{held}", flush=True)
        res[name] = t
        res[f"{name}_host_bound"] = t.host_bound
    return res


def ladder(stages, splits_of, iters, reps):
    """{"<dtype> <stage>": seconds} of `stages` for bf16 then int8, at the
    split `splits_of(int8)`, and "<dtype> production": the production
    decode kernel on the same cache at the same split."""
    out = {}
    for int8 in (False, True):
        inputs = make_inputs(int8)
        splits = splits_of(int8)
        name = "int8" if int8 else "bf16"
        for st in stages:
            out[f"{name} {st}"] = run_stage(
                st, int8, iters=iters, reps=reps, splits=splits,
                inputs=inputs)

        def step(q, kc, vc):
            production_decode(q, kc, vc, splits=splits)
            return q

        dt = benchmark_chained(step, *inputs, iters=iters, reps=reps)
        print(f"{name} production (flash_decode_ref, {PRODUCTION_ROWS} rows): "
              f"{dt*1e6:8.1f} us  stream {kv_bytes(int8)/dt/1e9:7.1f} GB/s",
              flush=True)
        out[f"{name} production"] = dt
    return out


def main(argv=None, iters=64, reps=3):
    """Returns {section: {key: seconds}}."""
    argv = sys.argv[1:] if argv is None else argv
    stages = list(STAGES)
    if argv and not argv[0].startswith("-"):
        stages = argv[0].split(",")
    print(device_line(), flush=True)
    res = {}
    print("--- ladder at one key split (a block per kv head and batch, "
          "JAX's schedule) ---", flush=True)
    res["split1"] = ladder(stages, lambda int8: 1, iters, reps)
    fills = {"bf16": fill_splits(8, 8, 8192, 1024, int8=False),
             "int8": fill_splits(8, 8, 8192, 1024, int8=True)}
    print(f"--- ladder at the split that fills the card (bf16 "
          f"{fills['bf16']}, int8 {fills['int8']} splits) ---", flush=True)
    res["fill"] = ladder(
        stages, lambda int8: fills["int8" if int8 else "bf16"], iters, reps)
    res["fill_splits"] = fills
    # transfer-size hypothesis: per-transfer BYTES set the DMA regime, so
    # int8 at bk=2048 should recover the bandwidth bf16 gets at bk=1024
    print("--- int8 transfer-size sweep (dma + full) ---", flush=True)
    inputs = make_inputs(True)
    res["bk_sweep"] = {
        f"int8 bk={bk} {st}": run_stage(st, True, bk=bk, iters=iters,
                                        reps=reps, inputs=inputs)
        for bk in (1024, 2048, 4096) for st in ("dma", "full")}
    print("--- end-to-end decode (real kernel) ---", flush=True)
    res["e2e"] = end_to_end(iters=iters, reps=reps)
    return res


if __name__ == "__main__":
    main()
