"""Flash-attention forward on (b, h, s, d) operands (counterpart of
`flash_attn_tpu/kernels/flash_fwd.py::flash_attn_fwd_bhsd:1129`, whose
general path runs the Pallas `_fwd_kernel:200`, launched at `:1517`).

`flash_attn_fwd_bhsd` launches the hand-written Hopper kernel
`csrc/flash_fwd.cu` (`wgmma`, a TMA ring of K/V stages, 64- or 128-row
tiles by head dim, arithmetic masks) for CUDA tensors and runs `flash_attn_fwd_bhsd_ref`, the
plain PyTorch version with the same signature, for CPU tensors.  The same
kernel also serves the JAX package's full-length causal/local forward
(`_fwd_sched_kernel:870`): its per-q-tile loop bounds skip the KV tiles a
mask removes, which is what the TPU's tile tables do.  Its packed varlen mode
(`flash_fwd_varlen`) is launched by `kernels/varlen.py`.

Semantics carried over from the JAX kernel:
* per-batch `seqused_q` / `seqused_k`; masks are bottom-right aligned with
  offset = seqused_k[b] - seqused_q[b]; rows at or past seqused_q[b] are not
  masked and hold no meaningful value;
* a one-sided window is normalised to seqlen_k on its open side (`:1184`);
* a row with no valid key gives o = 0 and lse = +inf;
* GQA reads kv head h // g, with no K/V repeat in the kernel;
* lse is (b, h, sq) float32 in natural log;
* attention dropout (`_fwd_kernel:340-344`): the keep mask is a stateless
  hash of (seed, batch, q head, row, key), `dropout_keep`, reproduced bit
  for bit; the lse and row sums are those of the undropped P, and kept
  entries are scaled by 1 / (1 - p) rounded to float32.  The CUDA kernel
  folds that scale into its epilogue's 1 / l.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from flash_attn_tpu_torch.kernels import _build

KERNEL = "flash_fwd"
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}

# Number of times the CUDA kernel was launched (plain CPU runs do not count),
# and how many of those launches ran its dropout instantiation.
launches = 0
launches_dropout = 0


def fwd_rows(d: int) -> int:
    """q rows a block of the CUDA forward owns, dense and varlen
    (`csrc/flash_fwd.cu::FwdTiles` states the same rule): 64 at d = 64 (one
    consumer warpgroup, two blocks an SM, so that one block's loads, start
    and stores overlap the other's products), 128 at d = 128 (two consumer
    warpgroups taking the tensor cores in turns).

    Chosen by `diag/flash_ab.py --variants rows64,rows128` (kernel device
    ms, medians of two runs, NVIDIA H100 80GB HBM3, 700.00 W).  d = 64,
    64 / 128 rows: f2 (training shape) 0.05579 / 0.05839, f1 (serving
    prefill) 0.02350 / 0.02419, fd (window + softcap + ALiBi) 0.02544 /
    0.02843, f10 (the BERT batch, varlen) 0.08845 / 0.10367, fvd 0.12993 /
    0.14257, fvw 0.07934 / 0.09075, fvm 0.22496 / 0.24677.  d = 128: fb
    (full-length causal) 0.09621 / 0.08373, fvb (packed causal GQA) 0.98483
    / 0.87038; fc (GQA, ragged seqused_k) 0.04116 / 0.04484 is the one case
    against the rule."""
    return 64 if d == 64 else 128


def normalize_window(window_size, causal: bool, sk: int):
    """One-sided windows become bounded by seqlen_k on the open side
    (`flash_fwd.py:1181-1187`)."""
    wl, wr = int(window_size[0]), int(window_size[1])
    if wl >= 0 and wr < 0:
        wr = sk
    elif wr >= 0 and wl < 0 and not causal:
        wl = sk
    return wl, wr


def mask_params(causal: bool, wl: int, wr: int):
    """(has_upper, right bound, has_lower, left bound) of the mask; causal
    is a right bound of 0 (`FwdParams.wr`)."""
    has_upper = causal or wr >= 0
    return has_upper, (0 if causal else wr), wl >= 0, wl


# The keep mask's hash (`flash_fwd.py::_mix32:68`, `dropout_keep:80`):
# the lowbias32 mixer's multipliers and the coordinate constants, as uint32.
_H1, _H2 = 0x7FEB352D, 0x846CA68B
_C1, _C2, _C3, _C4 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2**32 for int64 x in [0, 2**32): the product taken in two
    16-bit halves of c, so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """lowbias32 on uint32 values held in int64: every shift is logical."""
    x = x ^ (x >> 16)
    x = _mul32(x, _H1)
    x = x ^ (x >> 15)
    x = _mul32(x, _H2)
    return x ^ (x >> 16)


def dropout_threshold(dropout_p: float) -> int:
    """The integer form of JAX's `u >= dropout_p`: u = (x & 0xFFFFFF) *
    2**-24 against dropout_p rounded to float32 (a weak-typed Python float
    against a float32 array), so keep <=> (x & 0xFFFFFF) >= ceil(float32(p)
    * 2**24), an exact compare.  0 for no dropout."""
    return math.ceil(float(np.float32(dropout_p)) * 2.0 ** 24)


def dropout_scale(dropout_p: float) -> float:
    """1 / (1 - p) as JAX applies it: the Python double rounded to float32."""
    return float(np.float32(1.0 / (1.0 - dropout_p)))


def dropout_seed_value(dropout_seed) -> int:
    """The seed as the kernels hash it: None is 0 (`interface.py:141`); an
    int (or a one-element tensor) is taken as int32, wrapping around."""
    s = 0 if dropout_seed is None else int(dropout_seed)
    return (s + 2 ** 31) % 2 ** 32 - 2 ** 31


def dropout_keep(seed, b, h, rows, cols, dropout_p: float):
    """The dropout keep mask from absolute positions (`flash_fwd.py::
    dropout_keep:80`), bit for bit: keep = u >= p with u = (mix32(rows C3 +
    cols C4 + (seed ^ b C1 ^ h C2)) & 0xFFFFFF) 2**-24, all in uint32
    wraparound.  seed is an int; b, h, rows, cols ints or integer tensors
    that broadcast.  A stateless hash: the forward and both backward
    kernels reproduce the mask from (seed, batch, q head, row, col) alone,
    whatever their tiles."""
    def u32(x):
        if isinstance(x, torch.Tensor):
            return x.long() & _M32
        return int(x) & _M32

    base = u32(seed) ^ _mul32(u32(b), _C1) ^ _mul32(u32(h), _C2)
    x = (_mul32(u32(rows), _C3) + _mul32(u32(cols), _C4) + base) & _M32
    return (_mix32(x) & 0xFFFFFF) >= dropout_threshold(dropout_p)


def dropout_mask(seed, dropout_p: float, b: int, h: int, sq: int, sk: int,
                 device, offsets=None):
    """(b, h, sq, sk) bool keep mask of a dense call: batch index, q head,
    row and key of the tensors (`_fwd_kernel:340`).  With `offsets` = (q
    offsets (b,), k offsets (b,)), the packed varlen route's coordinates
    instead (`varlen_sched.py:307`, `flash_bwd.py::_bwd_keep:110`): batch
    0, row + q offset, key + k offset of each entry.  Built a few batch
    entries at a time (2**26 elements at most, or one entry), so that its
    int64 temporaries stay small."""
    heads = torch.arange(h, device=device).view(1, h, 1, 1)
    rows = torch.arange(sq, device=device).view(1, 1, sq, 1)
    cols = torch.arange(sk, device=device).view(1, 1, 1, sk)
    keep = torch.empty((b, h, sq, sk), dtype=torch.bool, device=device)
    step = max(1, 2 ** 26 // max(1, h * sq * sk))
    for i in range(0, b, step):
        n = min(step, b - i)
        if offsets is None:
            bi = torch.arange(i, i + n, device=device).view(n, 1, 1, 1)
            keep[i:i + n] = dropout_keep(seed, bi, heads, rows, cols,
                                         dropout_p)
        else:
            qo, ko = (torch.as_tensor(x[i:i + n], device=device).view(
                n, 1, 1, 1) for x in offsets)
            keep[i:i + n] = dropout_keep(seed, 0, heads, rows + qo, cols + ko,
                                         dropout_p)
    return keep


def check_dropout(dropout_p: float):
    """`interface.py::_check_dropout:146`."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")


def _unsupported(q, dv, sinks, dropout_p, attention_chunk):
    if q.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        raise NotImplementedError("fp8 attention is not ported yet")
    if sinks is not None:
        raise NotImplementedError("attention sinks are not ported yet")
    check_dropout(dropout_p)
    if attention_chunk:
        raise NotImplementedError("attention_chunk is not ported yet")
    if dv != q.shape[-1]:
        raise NotImplementedError("dv != d is not ported yet")


def masked_softmax_pv(s, mask, v, keep=None, rp: float = 1.0):
    """Softmax of float32 scores `s` with `mask` (True = out) applied, then
    P @ v in v's dtype.  Empty rows give o = 0 and lse = +inf.  With a
    dropout `keep` mask, P becomes where(keep, P, 0) * rp before the
    product; the lse is that of the undropped P (`_fwd_kernel:336-348`).
    Shared by the plain forward and decode versions."""
    s = s.masked_fill(mask, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = m.masked_fill(torch.isneginf(m), 0.0)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l == 0.0, torch.inf, m_safe + torch.log(l))
    p = p / torch.where(l == 0.0, 1.0, l)
    if keep is not None:
        p = torch.where(keep, p, 0.0) * rp
    o = torch.matmul(p.to(v.dtype), v)
    return o, lse.squeeze(-1)


def flash_attn_fwd_bhsd_ref(q, k, v, seqused_q, seqused_k, *,
                            softmax_scale: float, causal: bool = False,
                            window_size=(-1, -1), softcap: float = 0.0,
                            alibi_slopes=None, sinks=None,
                            dropout_p: float = 0.0, attention_chunk: int = 0,
                            dropout_seed=None, dropout_packed_offsets=None):
    """Plain PyTorch version of `flash_attn_fwd_bhsd` (same signature, plus
    `dropout_packed_offsets`: the (q offsets (b,), k offsets (b,)) of the
    packed varlen route's mask coordinates, `dropout_mask`).

    The two matrix products run in the inputs' dtype, so a bf16 call is the
    low-precision yardstick of the tolerance rule; masking and softmax run in
    float32."""
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    _unsupported(q, v.shape[-1], sinks, dropout_p, attention_chunk)
    g = h // hk
    dev = q.device
    wl, wr = normalize_window(window_size, causal, sk)
    has_upper, wr, has_lower, wl = mask_params(causal, wl, wr)
    kx = k.repeat_interleave(g, dim=1) if g > 1 else k
    vx = v.repeat_interleave(g, dim=1) if g > 1 else v
    s = torch.matmul(q, kx.transpose(-1, -2)).float() * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    sq_b = torch.as_tensor(seqused_q, device=dev).long().view(b, 1, 1, 1)
    sk_b = torch.as_tensor(seqused_k, device=dev).long().clamp(max=sk)
    sk_b = sk_b.view(b, 1, 1, 1)
    offset = sk_b - sq_b
    rows = torch.arange(sq, device=dev).view(1, 1, sq, 1)
    cols = torch.arange(sk, device=dev).view(1, 1, 1, sk)
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=dev).float()
        slopes = slopes.reshape(-1, h).expand(b, h).reshape(b, h, 1, 1)
        s = s - slopes * (rows + offset - cols).abs().float()
    mask = cols >= sk_b
    if has_upper:
        mask = mask | (cols > rows + offset + wr)
    if has_lower:
        mask = mask | (cols < rows + offset - wl)
    keep = None
    if dropout_p > 0.0:
        keep = dropout_mask(dropout_seed_value(dropout_seed), dropout_p, b, h,
                            sq, sk, dev, dropout_packed_offsets)
    o, lse = masked_softmax_pv(s, mask, vx, keep, dropout_scale(dropout_p))
    return o.to(q.dtype), lse


def flash_attn_fwd_bhsd(q, k, v, seqused_q, seqused_k, *,
                        softmax_scale: float, causal: bool = False,
                        window_size=(-1, -1), softcap: float = 0.0,
                        alibi_slopes=None, sinks=None,
                        dropout_p: float = 0.0, attention_chunk: int = 0,
                        dropout_seed=None):
    """Forward attention.  q: (b, h, sq, d); k, v: (b, hk, sk, d);
    seqused_q/k: (b,) int32.  Returns o (b, h, sq, d) in q's dtype and lse
    (b, h, sq) float32.  With `dropout_p` > 0, P is dropped by the keep
    mask of `dropout_keep` at (seed, batch, q head, row, key) and scaled by
    1 / (1 - p) before P V; the lse is the undropped one.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flash_fwd.cu` (bf16 or fp16, d in {64, 128}) or raise."""
    global launches, launches_dropout
    kwargs = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap,
                  alibi_slopes=alibi_slopes, sinks=sinks,
                  dropout_p=dropout_p, attention_chunk=attention_chunk,
                  dropout_seed=dropout_seed)
    if q.device.type == "cpu":
        return flash_attn_fwd_bhsd_ref(q, k, v, seqused_q, seqused_k, **kwargs)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attn_fwd_bhsd: no kernel for {q.device}")
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    _unsupported(q, v.shape[-1], sinks, dropout_p, attention_chunk)
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"flash_fwd kernel: dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_fwd kernel: head dim {d}")
    if k.shape != (b, hk, sk, d) or v.shape != k.shape or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    seqused_q = _lengths(seqused_q, b, q.device)
    seqused_k = _lengths(seqused_k, b, q.device)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=q.device).float()
        slopes = slopes.reshape(-1, h).expand(b, h).contiguous()
    wl, wr = normalize_window(window_size, causal, sk)
    has_upper, wr, has_lower, wl = mask_params(causal, wl, wr)

    q, k, v = (_aligned(x) for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), seqused_q.data_ptr(), seqused_k.data_ptr(),
        slopes.data_ptr() if slopes is not None else None,
        b, h, hk, sq, sk, d, _DTYPE_CODE[q.dtype], float(softmax_scale),
        int(has_upper), wr, int(has_lower), wl, float(softcap),
        *dropout_args(dropout_p, dropout_seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, KERNEL)
    launches += 1
    launches_dropout += dropout_p > 0.0
    return o, lse


def dropout_args(dropout_p: float, dropout_seed):
    """The C entry points' (seed, threshold, 1 / (1 - p)): the kernels keep
    (x & 0xFFFFFF) >= threshold, and a threshold of 0 runs the kernels
    without dropout."""
    if dropout_p <= 0.0:
        return 0, 0, 1.0
    return (dropout_seed_value(dropout_seed), dropout_threshold(dropout_p),
            dropout_scale(dropout_p))


def _aligned(x):
    """x, or a copy of it where its data does not start 16-byte aligned
    (the kernels' tensor maps need it)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _lengths(x, b, device):
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    if t.shape != (b,):
        raise ValueError(f"lengths must have shape ({b},), got {tuple(t.shape)}")
    return t.contiguous()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C entry point's parameters, in order (a pointer must be c_void_p, or
# ctypes cuts it to 32 bits).
FWD_ARGTYPES = ((_P,) * 8 + (_I,) * 7 + (_F, _I, _I, _I, _I, _F)
                + (_I, _I, _F, _P))


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        lib.flash_fwd.argtypes = list(FWD_ARGTYPES)
        lib.flash_fwd.restype = ctypes.c_int
        _build.declare_error_string(lib)
        lib._typed = True
    return lib
