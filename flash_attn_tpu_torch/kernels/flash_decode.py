"""Split-KV decode attention over a contiguous KV cache (counterpart of
`flash_attn_tpu/kernels/flash_decode.py::decode_attn_bhsd:227`, which runs
the Pallas `_decode_kernel:117`, launched at `:369`).

`decode_attn_bhsd` launches the hand-written Hopper kernel
`csrc/flash_decode.cu` for CUDA tensors and runs `decode_attn_bhsd_ref`, the
plain PyTorch version with the same signature, for CPU tensors.

As in the JAX kernel, the q heads of one kv head are packed into rows
(packed row r is query position r % sq of head group r // sq,
`flash_decode.py:281`); each (batch, kv head, split) writes float32 partial
O and LSE, and `combine_attn_partials` merges the splits (`:395-403`).
Masks use offset = cache_seqlens[b] - sq, so the newest query row sees
every cached key.
"""

from __future__ import annotations

import ctypes

import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.combine import combine_attn_partials
from flash_attn_tpu_torch.kernels.flash_fwd import (
    HEAD_DIMS, _DTYPE_CODE, mask_params, masked_softmax_pv)

KERNEL = "flash_decode"
MAX_ROWS = 128  # packed rows g * sq the kernel's shared memory holds

# Number of times the CUDA kernel was launched (plain CPU runs do not count).
launches = 0


def _unsupported(block_table, cache_leftpad, attention_chunk):
    if block_table is not None:
        raise NotImplementedError("paged KV decode is not ported yet")
    if cache_leftpad is not None:
        raise NotImplementedError("cache_leftpad is not ported yet")
    if attention_chunk:
        raise NotImplementedError("attention_chunk is not ported yet")


def split_layout(smax: int, num_splits: int, block_k: int | None):
    """(num_splits, keys per split) as the JAX wrapper computes them: the
    cache is cut into block_k-key blocks and the blocks are shared out."""
    block_k = min(block_k or 1024, -(-smax // 8) * 8)
    nk = -(-smax // block_k)
    num_splits = max(1, min(int(num_splits), nk))
    bps = -(-nk // num_splits)
    return num_splits, bps * block_k


def decode_attn_bhsd_ref(q, k_cache, v_cache, cache_seqlens, *,
                         softmax_scale: float, causal: bool = True,
                         window_size=(-1, -1), softcap: float = 0.0,
                         alibi_slopes=None, block_table=None,
                         cache_batch_idx=None, cache_leftpad=None,
                         num_splits: int = 1, block_k: int | None = None,
                         attention_chunk: int = 0):
    """Plain PyTorch version of `decode_attn_bhsd` (same signature).

    `num_splits` and `block_k` only change how the kernel cuts the work, not
    the result, so this version ignores them.  The matrix products run in
    the inputs' dtype; masking and softmax run in float32."""
    _unsupported(block_table, cache_leftpad, attention_chunk)
    b, h, sq, d = q.shape
    _, hk, smax, _ = k_cache.shape
    g = h // hk
    dev = q.device
    if cache_batch_idx is not None:
        idx = torch.as_tensor(cache_batch_idx, device=dev).long()
        kc, vc = k_cache[idx], v_cache[idx]
    else:
        kc, vc = k_cache[:b], v_cache[:b]
    if g > 1:
        kc = kc.repeat_interleave(g, dim=1)
        vc = vc.repeat_interleave(g, dim=1)
    has_upper, wr, has_lower, wl = mask_params(
        causal, int(window_size[0]), int(window_size[1]))
    s = torch.matmul(q, kc.transpose(-1, -2)).float() * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    lens = torch.as_tensor(cache_seqlens, device=dev).long().clamp(max=smax)
    lens = lens.view(b, 1, 1, 1)
    offset = lens - sq
    pos = torch.arange(sq, device=dev).view(1, 1, sq, 1)
    cols = torch.arange(smax, device=dev).view(1, 1, 1, smax)
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=dev).float()
        slopes = slopes.reshape(-1, h).expand(b, h).reshape(b, h, 1, 1)
        s = s - slopes * (pos + offset - cols).abs().float()
    mask = cols >= lens
    if has_upper:
        mask = mask | (cols > pos + offset + wr)
    if has_lower:
        mask = mask | (cols < pos + offset - wl)
    o, lse = masked_softmax_pv(s, mask, vc)
    return o.to(q.dtype), lse


def decode_attn_bhsd(q, k_cache, v_cache, cache_seqlens, *,
                     softmax_scale: float, causal: bool = True,
                     window_size=(-1, -1), softcap: float = 0.0,
                     alibi_slopes=None, block_table=None,
                     cache_batch_idx=None, cache_leftpad=None,
                     num_splits: int = 1, block_k: int | None = None,
                     attention_chunk: int = 0):
    """Decode attention.  q: (b, h, sq, d); caches: (bc, hk, smax, d);
    cache_seqlens: (b,) keys in use, the new tokens included.  Returns
    o (b, h, sq, d) in q's dtype and lse (b, h, sq) float32.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flash_decode.cu` (bf16 or fp16, d in {64, 128}) or raise."""
    global launches
    if q.device.type == "cpu":
        return decode_attn_bhsd_ref(
            q, k_cache, v_cache, cache_seqlens, softmax_scale=softmax_scale,
            causal=causal, window_size=window_size, softcap=softcap,
            alibi_slopes=alibi_slopes, block_table=block_table,
            cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad,
            num_splits=num_splits, block_k=block_k,
            attention_chunk=attention_chunk)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attn_bhsd: no kernel for {q.device}")
    _unsupported(block_table, cache_leftpad, attention_chunk)
    b, h, sq, d = q.shape
    bc, hk, smax, _ = k_cache.shape
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"flash_decode kernel: dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_decode kernel: head dim {d}")
    if h % hk or v_cache.shape != k_cache.shape or k_cache.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k_cache "
                         f"{tuple(k_cache.shape)} v_cache "
                         f"{tuple(v_cache.shape)}")
    g = h // hk
    rows = g * sq
    if rows > MAX_ROWS:
        raise NotImplementedError(
            f"flash_decode kernel: g * sq = {rows} > {MAX_ROWS} packed rows")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lens = torch.as_tensor(cache_seqlens, dtype=torch.int32, device=q.device)
    if lens.shape != (b,):
        raise ValueError(f"cache_seqlens must have shape ({b},)")
    lens = lens.contiguous()
    cbi = None
    if cache_batch_idx is not None:
        cbi = torch.as_tensor(cache_batch_idx, dtype=torch.int32,
                              device=q.device).contiguous()
        if cbi.shape != (b,):
            raise ValueError(f"cache_batch_idx must have shape ({b},)")
    elif b > bc:
        raise ValueError(f"batch {b} > cache batch {bc}")
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=q.device).float()
        slopes = slopes.reshape(-1, h).expand(b, h).contiguous()
    has_upper, wr, has_lower, wl = mask_params(
        causal, int(window_size[0]), int(window_size[1]))
    num_splits, split_keys = split_layout(smax, num_splits, block_k)

    o_parts = torch.empty((b, hk, num_splits, rows, d), dtype=torch.float32,
                          device=q.device)
    lse_parts = torch.empty((b, hk, num_splits, rows), dtype=torch.float32,
                            device=q.device)
    lib = _lib()
    err = lib.flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        o_parts.data_ptr(), lse_parts.data_ptr(), lens.data_ptr(),
        cbi.data_ptr() if cbi is not None else None,
        slopes.data_ptr() if slopes is not None else None,
        b, h, hk, sq, d, smax, num_splits, split_keys, _DTYPE_CODE[q.dtype],
        float(softmax_scale), int(has_upper), wr, int(has_lower), wl,
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, KERNEL)
    launches += 1
    if num_splits > 1:
        o, lse = combine_attn_partials(o_parts, lse_parts, axis=2)
    else:
        o, lse = o_parts[:, :, 0], lse_parts[:, :, 0]
    o = o.reshape(b, h, sq, d).to(q.dtype)
    return o, lse.reshape(b, h, sq)


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode.argtypes = [P] * 8 + [I] * 9 + [F, I, I, I, I, F, P]
        lib.flash_decode.restype = I
        _build.declare_error_string(lib)
        lib._typed = True
    return lib
