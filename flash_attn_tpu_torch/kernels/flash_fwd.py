"""Flash-attention forward on (b, h, s, d) operands (counterpart of
`flash_attn_tpu/kernels/flash_fwd.py::flash_attn_fwd_bhsd:1129`, whose
general path runs the Pallas `_fwd_kernel:200`, launched at `:1517`).

`flash_attn_fwd_bhsd` launches the hand-written Hopper kernel
`csrc/flash_fwd.cu` for CUDA tensors and runs `flash_attn_fwd_bhsd_ref`, the
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
* lse is (b, h, sq) float32 in natural log.
"""

from __future__ import annotations

import ctypes

import torch

from flash_attn_tpu_torch.kernels import _build

KERNEL = "flash_fwd"
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}

# Number of times the CUDA kernel was launched (plain CPU runs do not count).
launches = 0


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


def _unsupported(q, dv, sinks, dropout_p, attention_chunk):
    if q.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        raise NotImplementedError("fp8 attention is not ported yet")
    if sinks is not None:
        raise NotImplementedError("attention sinks are not ported yet")
    if dropout_p > 0.0:
        raise NotImplementedError("attention dropout is not ported yet")
    if attention_chunk:
        raise NotImplementedError("attention_chunk is not ported yet")
    if dv != q.shape[-1]:
        raise NotImplementedError("dv != d is not ported yet")


def masked_softmax_pv(s, mask, v):
    """Softmax of float32 scores `s` with `mask` (True = out) applied, then
    P @ v in v's dtype.  Empty rows give o = 0 and lse = +inf.  Shared by the
    plain forward and decode versions."""
    s = s.masked_fill(mask, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = m.masked_fill(torch.isneginf(m), 0.0)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l == 0.0, torch.inf, m_safe + torch.log(l))
    p = p / torch.where(l == 0.0, 1.0, l)
    o = torch.matmul(p.to(v.dtype), v)
    return o, lse.squeeze(-1)


def flash_attn_fwd_bhsd_ref(q, k, v, seqused_q, seqused_k, *,
                            softmax_scale: float, causal: bool = False,
                            window_size=(-1, -1), softcap: float = 0.0,
                            alibi_slopes=None, sinks=None,
                            dropout_p: float = 0.0, attention_chunk: int = 0):
    """Plain PyTorch version of `flash_attn_fwd_bhsd` (same signature).

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
    o, lse = masked_softmax_pv(s, mask, vx)
    return o.to(q.dtype), lse


def flash_attn_fwd_bhsd(q, k, v, seqused_q, seqused_k, *,
                        softmax_scale: float, causal: bool = False,
                        window_size=(-1, -1), softcap: float = 0.0,
                        alibi_slopes=None, sinks=None,
                        dropout_p: float = 0.0, attention_chunk: int = 0):
    """Forward attention.  q: (b, h, sq, d); k, v: (b, hk, sk, d);
    seqused_q/k: (b,) int32.  Returns o (b, h, sq, d) in q's dtype and lse
    (b, h, sq) float32.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flash_fwd.cu` (bf16 or fp16, d in {64, 128}) or raise."""
    global launches
    kwargs = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap,
                  alibi_slopes=alibi_slopes, sinks=sinks,
                  dropout_p=dropout_p, attention_chunk=attention_chunk)
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

    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), seqused_q.data_ptr(), seqused_k.data_ptr(),
        slopes.data_ptr() if slopes is not None else None,
        b, h, hk, sq, sk, d, _DTYPE_CODE[q.dtype], float(softmax_scale),
        int(has_upper), wr, int(has_lower), wl, float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, KERNEL)
    launches += 1
    return o, lse


def _lengths(x, b, device):
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    if t.shape != (b,):
        raise ValueError(f"lengths must have shape ({b},), got {tuple(t.shape)}")
    return t.contiguous()


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [P] * 8 + [I] * 7 + [F, I, I, I, I, F, P]
        lib.flash_fwd.restype = I
        _build.declare_error_string(lib)
        lib._typed = True
    return lib
