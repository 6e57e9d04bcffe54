"""Public flash-attention functions with gradients (counterpart of
`flash_attn_tpu/interface.py`: `_make_core:48-120`, `flash_attn_func:209`,
`flash_attn_qkvpacked_func:310`, `flash_attn_kvpacked_func:329`).

Inputs are in the (batch, seqlen, nheads, head_dim) layout; the kernels run
on (b, h, s, d).  `FlashAttnFunc` is the `torch.autograd.Function` that takes
the place of the JAX `custom_vjp`: its forward is `flash_attn_fwd_bhsd`, which
saves q, k, v, o and lse, and its backward is `flash_attn_bwd_bhsd`.

* `deterministic` is accepted and ignored: the backward is always
  deterministic (`interface.py:15`).
* `return_attn_probs=True` returns (out, lse, None) and carries the lse's
  gradient (`dlse`) into the backward.
* Not ported yet, and raising `NotImplementedError`: `dropout_p > 0`, `qv`,
  `sinks`, fp8 descale and `attention_chunk`.
"""

from __future__ import annotations

import math

import torch

from flash_attn_tpu_torch.kernels.flash_bwd import flash_attn_bwd_bhsd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attn_fwd_bhsd


class FlashAttnFunc(torch.autograd.Function):
    """(q, k, v) in (b, h, s, d), contiguous -> (o, lse) with the backward
    kernel as its gradient; full lengths (seqused = s for every row)."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale, causal, window_size, softcap,
                alibi_slopes):
        b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
        seqused_q = torch.full((b,), sq, dtype=torch.int32, device=q.device)
        seqused_k = torch.full((b,), sk, dtype=torch.int32, device=q.device)
        kw = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap,
                  alibi_slopes=alibi_slopes)
        o, lse = flash_attn_fwd_bhsd(q, k, v, seqused_q, seqused_k, **kw)
        ctx.save_for_backward(q, k, v, o, lse, seqused_q, seqused_k)
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, seqused_q, seqused_k = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = flash_attn_bwd_bhsd(do, q, k, v, o, lse, seqused_q,
                                         seqused_k, dlse=dlse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attn_func(q, k, v, dropout_p=0.0, softmax_scale=None, causal=False,
                    window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
                    deterministic=False, return_attn_probs=False,
                    q_descale=None, k_descale=None, v_descale=None,
                    sinks=None, dropout_seed=None, attention_chunk=0,
                    qv=None):
    """Multi-head attention, (b, s, h, d) layout (`interface.py:209`).

    q: (b, sq, h, d); k, v: (b, sk, hk, d) with h % hk == 0.  Returns out
    (b, sq, h, d), or (out, lse (b, h, sq) float32, None) when
    `return_attn_probs`.  Runs on the tensors' device: the CUDA kernels on
    CUDA tensors, the plain versions on CPU tensors."""
    del deterministic, dropout_seed  # always deterministic; no dropout yet
    if dropout_p > 0.0:
        raise NotImplementedError("attention dropout is not ported yet")
    if qv is not None:
        raise NotImplementedError("qv is not ported yet")
    if sinks is not None:
        raise NotImplementedError("attention sinks are not ported yet")
    if any(x is not None for x in (q_descale, k_descale, v_descale)):
        raise NotImplementedError("fp8 descale is not ported yet")
    if attention_chunk:
        raise NotImplementedError("attention_chunk is not ported yet")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = FlashAttnFunc.apply(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), float(softmax_scale), bool(causal),
        (int(window_size[0]), int(window_size[1])), float(softcap),
        alibi_slopes)
    o = o.transpose(1, 2)
    return (o, lse, None) if return_attn_probs else o


def flash_attn_qkvpacked_func(qkv, dropout_p=0.0, softmax_scale=None,
                              causal=False, window_size=(-1, -1), softcap=0.0,
                              alibi_slopes=None, deterministic=False,
                              return_attn_probs=False):
    """qkv: (b, s, 3, h, d) (`interface.py:310`)."""
    return flash_attn_func(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout_p, softmax_scale, causal, window_size,
                           softcap, alibi_slopes, deterministic,
                           return_attn_probs)


def flash_attn_kvpacked_func(q, kv, dropout_p=0.0, softmax_scale=None,
                             causal=False, window_size=(-1, -1), softcap=0.0,
                             alibi_slopes=None, deterministic=False,
                             return_attn_probs=False):
    """kv: (b, s, 2, hk, d) (`interface.py:329`)."""
    return flash_attn_func(q, kv[:, :, 0], kv[:, :, 1], dropout_p,
                           softmax_scale, causal, window_size, softcap,
                           alibi_slopes, deterministic, return_attn_probs)
