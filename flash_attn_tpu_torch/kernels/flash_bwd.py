"""Flash-attention backward on (b, h, s, d) operands (counterpart of
`flash_attn_tpu/kernels/flash_bwd.py::flash_attn_bwd_bhsd:1011`, whose
Pallas kernels are `_bwd_dq_kernel:121`, `_bwd_dkv_kernel:232`,
`_bwd_fused_kernel:507` and `_bwd_fused_sched_kernel:851`).

`flash_attn_bwd_bhsd` launches the hand-written Hopper kernels of
`csrc/flash_bwd.cu` (`flash_bwd_dq_kernel`, then `flash_bwd_dkv_kernel`,
which reads the lse and delta rows the first one writes) for CUDA tensors
and runs `flash_attn_bwd_bhsd_ref`, the plain PyTorch version with the same
signature, for CPU tensors.  The two-kernel split serves every call the
JAX package sends to any of its four kernels, and is deterministic bit for
bit (no atomics; see the note in the source).  Its packed varlen mode
(`flash_bwd_varlen`) is launched by `kernels/varlen.py`.

The dO.O preprocess, which the JAX package leaves to XLA (`:1063-1067`),
is folded into the dQ kernel on CUDA: delta = rowsum(dO * O) - dlse, in
float32; the plain version computes it in torch (`_delta`).  Masks,
windows, GQA, softcap and ALiBi follow the forward
(`kernels/flash_fwd.py`); rows at or past seqused_q contribute nothing
(callers pass do = 0 there), keys at or past seqused_k get dk = dv = 0, and
a row with lse = +inf gets dq = 0.  dk and dv come back reduced over each
GQA group.  Dropout recomputes the forward's keep mask from (seed, batch, q
head, row, key): dP is dropped and scaled by 1 / (1 - p), dV takes the
dropped, scaled P, and dS the undropped P (`_bwd_dkv_kernel:300-314`).
"""

from __future__ import annotations

import ctypes

import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.flash_fwd import (HEAD_DIMS, _DTYPE_CODE,
                                                    _aligned, _lengths,
                                                    _unsupported,
                                                    dropout_args,
                                                    dropout_mask,
                                                    dropout_scale,
                                                    dropout_seed_value,
                                                    mask_params,
                                                    normalize_window)

KERNEL = "flash_bwd"

# Launches of each CUDA kernel (plain CPU runs do not count), and of their
# dropout instantiations among them.
launches_dq = 0
launches_dkv = 0
launches_dq_dropout = 0
launches_dkv_dropout = 0
# q tiles each block of the last dQ launch owned (`dq_items`).
last_dq_items = 0


def _delta(do, o, dlse):
    delta = (do.float() * o.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


STATS_TILE = 128  # the dQ kernel's q rows
STATS_GAP = 132   # `csrc/flash_bwd.cu::kStatsGap`


def stats_row0(cu_q_i: int, i: int) -> int:
    """Row 0 of varlen sequence i's stats within a head, the rule of
    `csrc/flash_bwd.cu::stats_row0`: cu_q[i] rounded up to 4, plus
    `STATS_GAP` * i."""
    return (cu_q_i + 3) // 4 * 4 + STATS_GAP * i


def stats_rows(sq: int) -> int:
    """Rows of one head's stats (lse in log2 units, then delta: the rows
    the dQ kernel writes and the dK/dV kernel reads) of a dense call: sq
    rounded up to the dQ kernel's 128-row tile."""
    return -(-sq // STATS_TILE) * STATS_TILE


def varlen_stats_rows(b: int, total_q: int) -> int:
    """The same for a varlen call of b sequences packed into total_q rows:
    room for every sequence's `stats_row0` and its rows rounded up to 128,
    a multiple of 4."""
    return -(-(total_q + STATS_GAP * b) // 4) * 4


def dq_items(d: int, q_tiles: int, heads: int, b: int,
             sm_count: int) -> int:
    """q tiles of 128 rows each block of the CUDA dQ kernel owns
    (`csrc/flash_bwd.cu::DqTiles`): 2 at d = 64 where the grid of one-tile
    blocks (q_tiles x heads x b) holds at least 4 an SM, so that half as
    many blocks still fill the card twice over; else 1.  A second tile
    hides its loads and start behind the first one's products; on a grid of
    fewer blocks the halved grid leaves SMs idle in its last wave."""
    return 2 if d == 64 and q_tiles * heads * b >= 4 * sm_count else 1


def _dq_items_for(device, d, q_tiles, heads, b):
    """`dq_items` on `device`'s SM count, recorded in `last_dq_items`."""
    global last_dq_items
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    last_dq_items = dq_items(d, q_tiles, heads, b, sms)
    return last_dq_items


def flash_attn_bwd_bhsd_ref(do, q, k, v, o, lse, seqused_q, seqused_k, *,
                            softmax_scale: float, causal: bool = False,
                            window_size=(-1, -1), softcap: float = 0.0,
                            alibi_slopes=None, dlse=None, sinks=None,
                            dropout_p: float = 0.0, attention_chunk: int = 0,
                            dropout_seed=None, dropout_packed_offsets=None):
    """Plain PyTorch version of `flash_attn_bwd_bhsd` (same signature, plus
    `dropout_packed_offsets` as `flash_fwd.flash_attn_fwd_bhsd_ref`'s).

    Computes the gradients explicitly from the saved lse: p = exp(s - lse),
    dp = dO V^T, ds = p (dp - delta), with the products in the inputs' dtype
    (so a bf16 call is the low-precision yardstick of the tolerance rule) and
    the softmax algebra in float32.  With dropout (`_bwd_dkv_kernel:
    300-314`): dp is dropped and scaled, dV takes the dropped, scaled P,
    and dS the undropped one."""
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    _unsupported(q, v.shape[-1], sinks, dropout_p, attention_chunk)
    g = h // hk
    dev, dt = q.device, q.dtype
    wl, wr = normalize_window(window_size, causal, sk)
    has_upper, wr, has_lower, wl = mask_params(causal, wl, wr)
    kx = k.repeat_interleave(g, dim=1) if g > 1 else k
    vx = v.repeat_interleave(g, dim=1) if g > 1 else v
    s = torch.matmul(q, kx.transpose(-1, -2)).float() * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
        dcap = 1.0 - (s / softcap) ** 2
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
    mask = (cols >= sk_b) | (rows >= sq_b)
    if has_upper:
        mask = mask | (cols > rows + offset + wr)
    if has_lower:
        mask = mask | (cols < rows + offset - wl)
    # masked: exp(-inf - lse) = 0, also where lse = +inf
    p = torch.exp(s.masked_fill(mask, -torch.inf) - lse.float()[..., None])
    dp = torch.matmul(do, vx.transpose(-1, -2)).float()
    pd = p
    if dropout_p > 0.0:
        keep = dropout_mask(dropout_seed_value(dropout_seed), dropout_p, b, h,
                            sq, sk, dev, dropout_packed_offsets)
        rp = dropout_scale(dropout_p)
        pd = torch.where(keep, p, 0.0) * rp
        dp = torch.where(keep, dp, 0.0) * rp
        del keep
    ds = p * (dp - _delta(do, o, dlse)[..., None])
    if softcap > 0.0:
        ds = ds * dcap
    dq = torch.matmul(ds.to(dt), kx).float() * softmax_scale
    dk = torch.matmul(ds.transpose(-1, -2).to(dt), q).float() * softmax_scale
    dv = torch.matmul(pd.transpose(-1, -2).to(dt), do).float()
    if g > 1:
        dk = dk.view(b, hk, g, sk, d).sum(2)
        dv = dv.view(b, hk, g, sk, d).sum(2)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd_bhsd(do, q, k, v, o, lse, seqused_q, seqused_k, *,
                        softmax_scale: float, causal: bool = False,
                        window_size=(-1, -1), softcap: float = 0.0,
                        alibi_slopes=None, dlse=None, sinks=None,
                        dropout_p: float = 0.0, attention_chunk: int = 0,
                        dropout_seed=None):
    """Backward attention.  do, q, o: (b, h, sq, d); k, v: (b, hk, sk, d);
    lse (and dlse, the cotangent of lse, or None): (b, h, sq) float32;
    seqused_q/k: (b,) int32.  Returns (dq, dk, dv) in the inputs' dtypes.
    `dropout_p` and `dropout_seed` must be the forward's: the kernels
    recompute its keep mask.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flash_bwd.cu` (bf16 or fp16, d in {64, 128}) or raise."""
    global launches_dq, launches_dkv, launches_dq_dropout
    global launches_dkv_dropout
    kwargs = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap,
                  alibi_slopes=alibi_slopes, dlse=dlse, sinks=sinks,
                  dropout_p=dropout_p, attention_chunk=attention_chunk,
                  dropout_seed=dropout_seed)
    if q.device.type == "cpu":
        return flash_attn_bwd_bhsd_ref(do, q, k, v, o, lse, seqused_q,
                                       seqused_k, **kwargs)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attn_bwd_bhsd: no kernel for {q.device}")
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    _unsupported(q, v.shape[-1], sinks, dropout_p, attention_chunk)
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"flash_bwd kernel: dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_bwd kernel: head dim {d}")
    if (k.shape != (b, hk, sk, d) or v.shape != k.shape or h % hk
            or do.shape != q.shape or o.shape != q.shape
            or lse.shape != (b, h, sq)):
        raise ValueError(f"shapes do {tuple(do.shape)} q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"o {tuple(o.shape)} lse {tuple(lse.shape)}")
    for name, t in (("do", do), ("q", q), ("k", k), ("v", v), ("o", o)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse: {lse.dtype} on {lse.device}")
    if sq == 0 or sk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    seqused_q = _lengths(seqused_q, b, q.device)
    seqused_k = _lengths(seqused_k, b, q.device)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=q.device).float()
        slopes = slopes.reshape(-1, h).expand(b, h).contiguous()
    wl, wr = normalize_window(window_size, causal, sk)
    has_upper, wr, has_lower, wl = mask_params(causal, wl, wr)
    lse = lse.contiguous()
    if dlse is not None:
        if dlse.shape != lse.shape or dlse.device != q.device:
            raise ValueError(f"dlse: {tuple(dlse.shape)} on {dlse.device}")
        dlse = dlse.float().contiguous()
    do, q, k, v, o = (_aligned(x) for x in (do, q, k, v, o))
    rows = stats_rows(sq)
    stats = torch.empty(2 * b * h * rows, dtype=torch.float32,
                        device=q.device)

    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib()
    err = lib.flash_bwd(
        do.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(),
        dlse.data_ptr() if dlse is not None else None, stats.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), seqused_q.data_ptr(),
        seqused_k.data_ptr(),
        slopes.data_ptr() if slopes is not None else None,
        b, h, hk, sq, sk, d, _DTYPE_CODE[q.dtype], float(softmax_scale),
        int(has_upper), wr, int(has_lower), wl, float(softcap), rows,
        _dq_items_for(q.device, d, -(-sq // STATS_TILE), h, b),
        *dropout_args(dropout_p, dropout_seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, KERNEL)
    launches_dq += 1
    launches_dkv += 1
    launches_dq_dropout += dropout_p > 0.0
    launches_dkv_dropout += dropout_p > 0.0
    return dq, dk, dv


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_bwd.argtypes = ([P] * 14 + [I] * 7
                                  + [F, I, I, I, I, F, I, I, I, I, F, P])
        lib.flash_bwd.restype = I
        _build.declare_error_string(lib)
        lib._typed = True
    return lib
