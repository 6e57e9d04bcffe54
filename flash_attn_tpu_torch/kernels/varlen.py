"""Packed variable-length attention, forward and backward (counterpart of
`flash_attn_tpu/kernels/varlen_sched.py`: the Pallas kernels
`_varlen_sched_kernel:211` (launched at `:440`) and `_varlen_bwd_kernel:643`
(launched at `:874`), the `custom_vjp` `_sched_core:908` and
`flash_attn_varlen_sched_func:1040`).

q is a packed (total_q, h, d) stream and k, v (total_k, hk, d) streams, cut
into sequences by `cu_seqlens_q` / `cu_seqlens_k` (b + 1,) int32: token t of
sequence i attends only the keys of sequence i.  Causal and window masks are
bottom-right per sequence (offset len_k - len_q); ALiBi uses the distance
counted from the sequences' ends.  Output o (total_q, h, d) and lse
(h, total_q) float32; a row with no key gives o = 0 and lse = +inf, and so
does a token outside every sequence (past cu_seqlens_q[-1]).

`varlen_attn_fwd` / `varlen_attn_bwd` launch the varlen modes of the
hand-written Hopper kernels `csrc/flash_fwd.cu` (`flash_fwd_varlen`) and
`csrc/flash_bwd.cu` (`flash_bwd_varlen`: the dQ kernel, which also forms
the dO.O preprocess, then the dK/dV kernel; deterministic bit for bit) on
CUDA tensors, and run their plain versions `varlen_attn_fwd_ref` /
`varlen_attn_bwd_ref`, which loop over the sequences, on CPU tensors.
They read and write the packed streams in place: the JAX wrapper's
`swapaxes` to (h, total, d) (`:380-382`) is a layout need of the TPU, not
part of the function.  Attention dropout hashes its keep mask
(`flash_fwd.dropout_keep`) at packed-stream coordinates, as the JAX kernels
do (`:307-314`, `:717-730`): batch 0, the q head, and the row's and the
key's token indices in the streams.

The TPU's way of skipping tile pairs has no counterpart here: `token_aux`
(per-token segment words), `build_varlen_schedule`,
`build_varlen_bwd_schedule` (device-built tables of live tile pairs) and
`block_sizes.varlen_block_sizes` are not ported, because the CUDA grids over
per-sequence q tiles do their work (see the notes in `csrc/flash_fwd.cu`
and `csrc/flash_bwd.cu`).  `block_q`, `block_k` and `block_h` are accepted
and ignored.

The forward's row tile is the dense forward's, `flash_fwd.fwd_rows`: 64
rows at d = 64, 128 at d = 128.  Measured against one tile for every d
(`diag/flash_ab.py --variants rows64,rows128`, kernel device ms, NVIDIA
H100 80GB HBM3, 700.00 W): the BERT batch (d = 64, 64 sequences of 16-512
tokens) 0.08845 at 64 rows against 0.10367 at 128, 128-row tiles pad its
short sequences more; packed causal GQA documents of 128-4096 tokens (d =
128) 0.87038 at 128 against 0.98483 at 64 rows (64-key tiles there, so
that two blocks fit an SM).  Nor is the JAX backward's fallback to the padded dense backward
when its whole-stream dQ scratch outgrows VMEM (`:983-1037`,
`_PACKED_BWD_DQ_LIMIT:506`): that is a TPU memory limit, and the CUDA
kernels cover every size.
"""

from __future__ import annotations

import ctypes
import math

import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.flash_bwd import (_dq_items_for, dq_rows,
                                                    flash_attn_bwd_bhsd_ref,
                                                    lib_name,
                                                    varlen_stats_rows)
from flash_attn_tpu_torch.kernels.flash_fwd import (MAX_BWD_HEAD_DIM,
                                                    MAX_HEAD_DIM,
                                                    _DTYPE_CODE, _aligned,
                                                    check_dropout,
                                                    dropout_args,
                                                    flash_attn_fwd_bhsd_ref,
                                                    kernel_head_dim,
                                                    mask_params,
                                                    normalize_window,
                                                    pad_head_dim,
                                                    unpad_head_dim)

KERNEL_FWD = "flash_fwd"
MAX_SEQLEN = 0xFFFF  # per-sequence limit of the JAX aux words (`:1063`)

# Launches of each CUDA kernel (plain CPU runs do not count), and of their
# dropout instantiations among them.
launches_fwd = 0
launches_dq = 0
launches_dkv = 0
launches_fwd_dropout = 0
launches_dq_dropout = 0
launches_dkv_dropout = 0


def _bounds(cu):
    """The (start, end) of each sequence, as Python ints (a host read)."""
    c = [int(x) for x in torch.as_tensor(cu).tolist()]
    return list(zip(c[:-1], c[1:]))


def _per_seq_slopes(alibi_slopes, h, device):
    if alibi_slopes is None:
        return None
    return torch.as_tensor(alibi_slopes, device=device).float().reshape(1, h)


def varlen_attn_fwd_ref(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, *, softmax_scale: float,
                        causal: bool = False, window_size=(-1, -1),
                        softcap: float = 0.0, alibi_slopes=None,
                        dropout_p: float = 0.0, dropout_seed=None):
    """Plain PyTorch version of `varlen_attn_fwd` (same signature): each
    sequence through the plain dense forward, one at a time, its dropout
    mask at packed-stream coordinates."""
    total_q, h, d = q.shape
    window = normalize_window(window_size, causal, int(max_seqlen_k))
    slopes = _per_seq_slopes(alibi_slopes, h, q.device)
    o = torch.zeros_like(q)
    lse = torch.full((h, total_q), math.inf, dtype=torch.float32,
                     device=q.device)
    for (q0, q1), (k0, k1) in zip(_bounds(cu_seqlens_q),
                                  _bounds(cu_seqlens_k)):
        if q1 == q0 or k1 == k0:  # no row, or no key: o = 0, lse = +inf
            continue
        used = (torch.tensor([q1 - q0]), torch.tensor([k1 - k0]))
        oi, li = flash_attn_fwd_bhsd_ref(
            q[q0:q1].transpose(0, 1)[None], k[k0:k1].transpose(0, 1)[None],
            v[k0:k1].transpose(0, 1)[None], *used,
            softmax_scale=softmax_scale, causal=causal, window_size=window,
            softcap=softcap, alibi_slopes=slopes, dropout_p=dropout_p,
            dropout_seed=dropout_seed, dropout_packed_offsets=([q0], [k0]))
        o[q0:q1] = oi[0].transpose(0, 1)
        lse[:, q0:q1] = li[0]
    return o, lse


def varlen_attn_bwd_ref(do, q, k, v, o, lse, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, *, softmax_scale: float,
                        causal: bool = False, window_size=(-1, -1),
                        softcap: float = 0.0, alibi_slopes=None,
                        dropout_p: float = 0.0, dropout_seed=None):
    """Plain PyTorch version of `varlen_attn_bwd` (same signature): each
    sequence through the plain dense backward, one at a time, its dropout
    mask at packed-stream coordinates."""
    h = q.shape[1]
    window = normalize_window(window_size, causal, int(max_seqlen_k))
    slopes = _per_seq_slopes(alibi_slopes, h, q.device)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for (q0, q1), (k0, k1) in zip(_bounds(cu_seqlens_q),
                                  _bounds(cu_seqlens_k)):
        if q1 == q0 or k1 == k0:  # nothing attends: zero gradients
            continue
        used = (torch.tensor([q1 - q0]), torch.tensor([k1 - k0]))

        def bhsd(x, a, b_):
            return x[a:b_].transpose(0, 1)[None]

        g = flash_attn_bwd_bhsd_ref(
            bhsd(do, q0, q1), bhsd(q, q0, q1), bhsd(k, k0, k1),
            bhsd(v, k0, k1), bhsd(o, q0, q1), lse[None, :, q0:q1], *used,
            softmax_scale=softmax_scale, causal=causal, window_size=window,
            softcap=softcap, alibi_slopes=slopes, dropout_p=dropout_p,
            dropout_seed=dropout_seed, dropout_packed_offsets=([q0], [k0]))
        dq[q0:q1] = g[0][0].transpose(0, 1)
        dk[k0:k1] = g[1][0].transpose(0, 1)
        dv[k0:k1] = g[2][0].transpose(0, 1)
    return dq, dk, dv


def _check_cuda(q, k, v, cu_q, cu_k, extra=(), max_d=MAX_HEAD_DIM):
    """Raise on what the CUDA kernels do not take (head dims up to `max_d`:
    `kernel_head_dim`)."""
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"varlen kernel: dtype {q.dtype}")
    total_q, h, d = q.shape
    kernel_head_dim(d, max_d)
    if k.dim() != 3 or k.shape[2] != d or v.shape != k.shape or h % k.shape[1]:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}")
    for name, t in (("cu_seqlens_q", cu_q), ("cu_seqlens_k", cu_k)):
        if t.dtype != torch.int32 or t.device != q.device or t.dim() != 1:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; need int32 (b + 1,) on {q.device}")
    if cu_q.shape != cu_k.shape:
        raise ValueError("cu_seqlens_q and cu_seqlens_k differ in length")


def _cuda_common(q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_k, causal,
                 window_size, alibi_slopes):
    b = cu_seqlens_q.shape[0] - 1
    h = q.shape[1]
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=q.device).float()
        slopes = slopes.reshape(1, h).expand(b, h).contiguous()
    wl, wr = normalize_window(window_size, causal, int(max_seqlen_k))
    return b, slopes, mask_params(causal, wl, wr)


def varlen_attn_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                    max_seqlen_k, *, softmax_scale: float,
                    causal: bool = False, window_size=(-1, -1),
                    softcap: float = 0.0, alibi_slopes=None,
                    dropout_p: float = 0.0, dropout_seed=None):
    """Packed varlen forward.  q: (total_q, h, d); k, v: (total_k, hk, d);
    cu_seqlens_q/k: (b + 1,) int32; max_seqlen_q/k: the longest sequence
    (Python ints); alibi_slopes: (h,) or None.  A one-sided window is
    normalised to max_seqlen_k on its open side.  Returns o (total_q, h, d)
    in q's dtype and lse (h, total_q) float32.  Dropout hashes its keep
    mask at packed-stream coordinates (`varlen_sched.py:307-314`): batch 0,
    q head, the row's and the key's token index in the streams.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flash_fwd.cu`'s varlen mode (bf16 or fp16, d up to 256) or
    raise."""
    global launches_fwd, launches_fwd_dropout
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap,
              alibi_slopes=alibi_slopes, dropout_p=dropout_p,
              dropout_seed=dropout_seed)
    if q.device.type == "cpu":
        return varlen_attn_fwd_ref(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                   max_seqlen_q, max_seqlen_k, **kw)
    if q.device.type != "cuda":
        raise RuntimeError(f"varlen_attn_fwd: no kernel for {q.device}")
    _check_cuda(q, k, v, cu_seqlens_q, cu_seqlens_k)
    d = q.shape[-1]
    q, k, v = (_aligned(x.contiguous()) for x in pad_head_dim(q, k, v))
    total_q, h, dp = q.shape
    b, slopes, (has_upper, wr, has_lower, wl) = _cuda_common(
        q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_k, causal, window_size,
        alibi_slopes)
    # zeros and +inf: tokens outside every sequence are not written
    o = torch.zeros_like(q)
    lse = torch.full((h, total_q), math.inf, dtype=torch.float32,
                     device=q.device)
    lib = _lib_fwd()
    err = lib.flash_fwd_varlen(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), cu_seqlens_q.data_ptr(), cu_seqlens_k.data_ptr(),
        slopes.data_ptr() if slopes is not None else None,
        b, h, k.shape[1], int(max_seqlen_q), int(max_seqlen_k), total_q,
        k.shape[0], dp, _DTYPE_CODE[q.dtype], float(softmax_scale),
        int(has_upper), wr, int(has_lower), wl, float(softcap),
        *dropout_args(dropout_p, dropout_seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, KERNEL_FWD)
    launches_fwd += 1
    launches_fwd_dropout += dropout_p > 0.0
    return unpad_head_dim(d, o)[0], lse


def varlen_attn_bwd(do, q, k, v, o, lse, cu_seqlens_q, cu_seqlens_k,
                    max_seqlen_q, max_seqlen_k, *, softmax_scale: float,
                    causal: bool = False, window_size=(-1, -1),
                    softcap: float = 0.0, alibi_slopes=None,
                    dropout_p: float = 0.0, dropout_seed=None):
    """Packed varlen backward.  do, o as q (total_q, h, d); lse (h, total_q)
    float32; the rest as `varlen_attn_fwd`, dropout as the forward's.
    Returns (dq, dk, dv) in the inputs' dtypes, dk and dv reduced over each
    GQA group.  Rows with lse = +inf get dq = 0, keys no query sees get dk =
    dv = 0, and tokens outside every sequence get 0.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flash_bwd.cu`'s varlen mode (d up to 256), whose dQ kernel also
    forms the dO.O preprocess delta = rowsum(dO * O), or raise."""
    global launches_dq, launches_dkv, launches_dq_dropout
    global launches_dkv_dropout
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap,
              alibi_slopes=alibi_slopes, dropout_p=dropout_p,
              dropout_seed=dropout_seed)
    if q.device.type == "cpu":
        return varlen_attn_bwd_ref(do, q, k, v, o, lse, cu_seqlens_q,
                                   cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                                   **kw)
    if q.device.type != "cuda":
        raise RuntimeError(f"varlen_attn_bwd: no kernel for {q.device}")
    _check_cuda(q, k, v, cu_seqlens_q, cu_seqlens_k,
                extra=(("do", do), ("o", o)), max_d=MAX_BWD_HEAD_DIM)
    total_q, h, d = q.shape
    if do.shape != q.shape or o.shape != q.shape or \
            lse.shape != (h, total_q):
        raise ValueError(f"shapes do {tuple(do.shape)} o {tuple(o.shape)} "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse: {lse.dtype} on {lse.device}")
    q, k, v, o, do = (_aligned(x.contiguous())
                      for x in pad_head_dim(q, k, v, o, do))
    lse = lse.contiguous()
    b, slopes, (has_upper, wr, has_lower, wl) = _cuda_common(
        q, k, cu_seqlens_q, cu_seqlens_k, max_seqlen_k, causal, window_size,
        alibi_slopes)
    rows = varlen_stats_rows(b, total_q)
    stats = torch.empty(2 * h * rows, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    kd = kernel_head_dim(d)
    lib = _lib_bwd(lib_name(kd))
    err = lib.flash_bwd_varlen(
        do.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), cu_seqlens_q.data_ptr(),
        cu_seqlens_k.data_ptr(),
        slopes.data_ptr() if slopes is not None else None,
        b, h, k.shape[1], int(max_seqlen_q), int(max_seqlen_k), total_q,
        k.shape[0], q.shape[-1], _DTYPE_CODE[q.dtype], float(softmax_scale),
        int(has_upper), wr, int(has_lower), wl, float(softcap), rows,
        _dq_items_for(q.device, kd, -(-int(max_seqlen_q) // dq_rows(kd)), h,
                      b),
        *dropout_args(dropout_p, dropout_seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, lib_name(kd))
    launches_dq += 1
    launches_dkv += 1
    launches_dq_dropout += dropout_p > 0.0
    launches_dkv_dropout += dropout_p > 0.0
    return unpad_head_dim(d, dq, dk, dv)


class FlashAttnVarlenFunc(torch.autograd.Function):
    """Packed varlen attention with the varlen backward as its gradient (the
    `custom_vjp` `_sched_core`, `varlen_sched.py:908`).  Returns o; saves
    q, k, v, o and lse, and the dropout's p and seed, from which the
    backward recomputes the keep mask."""

    @staticmethod
    def forward(ctx, q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                max_seqlen_k, softmax_scale, causal, window_size, softcap,
                alibi_slopes, dropout_p=0.0, dropout_seed=None):
        kw = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap,
                  alibi_slopes=alibi_slopes, dropout_p=dropout_p,
                  dropout_seed=dropout_seed)
        o, lse = varlen_attn_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                 max_seqlen_q, max_seqlen_k, **kw)
        ctx.save_for_backward(q, k, v, o, lse, cu_seqlens_q, cu_seqlens_k)
        ctx.max_seqlens = (max_seqlen_q, max_seqlen_k)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, cu_q, cu_k = ctx.saved_tensors
        dq, dk, dv = varlen_attn_bwd(do, q, k, v, o, lse, cu_q, cu_k,
                                     *ctx.max_seqlens, **ctx.kw)
        return (dq, dk, dv) + (None,) * 11


def flash_attn_varlen_sched_func(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                 max_seqlen_q=None, max_seqlen_k=None, *,
                                 softmax_scale=None, causal=False,
                                 window_size=(-1, -1), softcap=0.0,
                                 alibi_slopes=None, dropout_p=0.0,
                                 dropout_seed=None, block_q=None,
                                 block_k=None, block_h=None):
    """Packed varlen attention, differentiable (`varlen_sched.py:1040`).

    q: (total_q, h, d); k, v: (total_k, hk, d); cu_seqlens: (b + 1,) int32
    on q's device.  The JAX function's checks stay: per-sequence lengths up
    to 65535, max_seqlen_q/k required, a one-sided window normalised to
    max_seqlen_k (not to total_k).  Whether cu_seqlens_q is cu_seqlens_k
    (`same_stream`, `:1068`) changes the TPU's pruning only, and nothing
    here.  `block_q/k/h` are ignored.  Dropout (`dropout_seed` None is 0)
    hashes packed-stream positions."""
    del block_q, block_k, block_h
    check_dropout(dropout_p)
    total_q, h, d = q.shape
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    if max_seqlen_q is None or max_seqlen_k is None:
        raise ValueError("max_seqlen_q/max_seqlen_k are required")
    for name, ms in (("q", max_seqlen_q), ("k", max_seqlen_k)):
        if int(ms) > MAX_SEQLEN:
            raise ValueError(
                f"packed varlen supports per-sequence lengths up to "
                f"{MAX_SEQLEN}; max_seqlen_{name}={int(ms)} exceeds it")
    window = normalize_window(window_size, causal, int(max_seqlen_k))
    cu_q = torch.as_tensor(cu_seqlens_q, dtype=torch.int32, device=q.device)
    cu_k = torch.as_tensor(cu_seqlens_k, dtype=torch.int32, device=q.device)
    slopes = (None if alibi_slopes is None else
              torch.as_tensor(alibi_slopes, device=q.device).float()
              .reshape(h))
    return FlashAttnVarlenFunc.apply(
        q, k, v, cu_q, cu_k, int(max_seqlen_q), int(max_seqlen_k),
        float(softmax_scale), bool(causal), window, float(softcap), slopes,
        float(dropout_p), dropout_seed)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# `flash_fwd_varlen`'s parameters, in order: the dense entry point's with
# total_q and total_k (the K/V tensor maps' rows) after the max lengths.
VARLEN_FWD_ARGTYPES = ((_P,) * 8 + (_I,) * 9 + (_F, _I, _I, _I, _I, _F)
                       + (_I, _I, _F, _P))


def _lib_fwd():
    lib = _build.load(KERNEL_FWD)
    if not getattr(lib, "_typed_varlen", False):
        lib.flash_fwd_varlen.argtypes = list(VARLEN_FWD_ARGTYPES)
        lib.flash_fwd_varlen.restype = ctypes.c_int
        _build.declare_error_string(lib)
        lib._typed_varlen = True
    return lib


def _lib_bwd(name):
    """The backward library `name` (`flash_bwd.lib_name`), typed."""
    lib = _build.load(name)
    if not getattr(lib, "_typed_varlen", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_bwd_varlen.argtypes = ([P] * 13 + [I] * 9
                                         + [F, I, I, I, I, F, I, I, I, I,
                                            F, P])
        lib.flash_bwd_varlen.restype = I
        _build.declare_error_string(lib)
        lib._typed_varlen = True
    return lib
