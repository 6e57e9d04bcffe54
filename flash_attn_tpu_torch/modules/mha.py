"""Multi-head self-attention (counterpart of `flash_attn_tpu/modules/mha.py`:
`InferenceParams:39`, `MHA:126`, the no-cache branches at `:233-299`,
`MHA._cached_attention:329-388`).

Without a cache, attention runs through the differentiable functions of
`interface`: with `cu_seqlens`, x is a packed (1, total, d) stream and
attention is `flash_attn_varlen_func` (`:233-250`); otherwise the dense
kernels' autograd `Function`, where a prefix `key_padding_mask` gives
per-batch `seqused` lengths and its padded rows are zeroed (`:251-266`).
With a cache, attention runs through the forward-only prefill and decode
kernels.

Rotary (`rotary_emb_dim > 0`) rotates q and k before the branches, as JAX
does: without a cache at positions 0 .. s - 1 over tables of s rows (so a
packed (1, total) stream is rotated by stream position, not per sequence,
`:226-233`), with one at each row's cached length over tables of
`max_seqlen` rows (`:351-360`), before the cache append.  The tables are a
`RotaryEmbedding` that a model shares between its layers, and a model
computes one call's factors once for all of them (`rotary_factors`).

Only the self-attention, single-device case is ported; cross attention,
tensor parallelism and the sharded / ring paths are queued.  KV caches keep
the JAX layout (b, hk, smax, d), which the decode kernel reads without
transposes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.interface import _attn_bhsd, flash_attn_varlen_func
from flash_attn_tpu_torch.kernels.flash_decode import decode_attn_bhsd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attn_fwd_bhsd
from flash_attn_tpu_torch.layers.rotary import (RotaryEmbedding,
                                                apply_rotary_factors)

DECODE_MAX_SEQLEN = 16  # s <= this runs the decode kernel (mha.py:367)


@dataclasses.dataclass
class InferenceParams:
    """KV-cache state for generation.  Unlike the JAX pytree, this object is
    updated in place: layers write into the caches and `GPTModel` advances
    `lengths_per_sample` once per forward."""

    max_seqlen: int
    max_batch_size: int
    lengths_per_sample: Optional[torch.Tensor] = None  # (b,) int32 cached
    key_value_memory_dict: dict = dataclasses.field(default_factory=dict)


def alibi_slopes(h: int, device=None) -> torch.Tensor:
    """The standard ALiBi slope schedule 2^(-8i/h), (h,) float32
    (`MHA._alibi_slopes`)."""
    def slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(h).is_integer():
        s = slopes(h)
    else:
        n = 2 ** math.floor(math.log2(h))
        s = slopes(n) + slopes(2 * n)[0::2][: h - n]
    return torch.tensor(s, dtype=torch.float32, device=device)


def rotary_factors(rotary_emb: RotaryEmbedding, seqlen: int,
                   inference_params: Optional[InferenceParams] = None):
    """The factors that rotate one call's q and k (`rotary.rotary_factors`):
    positions 0 .. seqlen - 1 over tables of seqlen rows without a cache,
    each row's cached length onwards over tables of `max_seqlen` rows with
    one."""
    if inference_params is None:
        return rotary_emb.factors(seqlen)
    return rotary_emb.factors(seqlen, inference_params.lengths_per_sample,
                              inference_params.max_seqlen)


class MHA(nn.Module):
    """Self-attention: Wqkv -> (rotary) -> attention kernel -> out_proj.

    With `rotary_emb_dim > 0` the first rotary_emb_dim features of each q
    and k head are rotated; `rotary_emb` is the model's shared table (a new
    one on this module's device when None)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 num_heads_kv: Optional[int] = None,
                 head_dim: Optional[int] = None, qkv_proj_bias: bool = True,
                 out_proj_bias: bool = True,
                 softmax_scale: Optional[float] = None, causal: bool = True,
                 layer_idx: int = 0, rotary_emb_dim: int = 0,
                 rotary_emb_base: float = 10000.0,
                 rotary_emb_scale_base: Optional[float] = None,
                 rotary_emb_interleaved: bool = False, window_size=(-1, -1),
                 softcap: float = 0.0, use_alibi: bool = False, *,
                 rotary_emb: Optional[RotaryEmbedding] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.rotary_emb_dim = rotary_emb_dim
        self.rotary_emb = None
        if rotary_emb_dim > 0:
            self.rotary_emb = rotary_emb or RotaryEmbedding(
                rotary_emb_dim, base=rotary_emb_base,
                interleaved=rotary_emb_interleaved,
                scale_base=rotary_emb_scale_base, device=device)
        self.num_heads = num_heads
        self.num_heads_kv = num_heads_kv or num_heads
        self.head_dim = head_dim or embed_dim // num_heads
        self.softmax_scale = softmax_scale or 1.0 / math.sqrt(self.head_dim)
        self.causal = causal
        self.layer_idx = layer_idx
        self.window_size = tuple(window_size)
        self.softcap = softcap
        h, hk, d = self.num_heads, self.num_heads_kv, self.head_dim
        self.Wqkv = nn.Linear(embed_dim, (h + 2 * hk) * d, bias=qkv_proj_bias,
                              device=device, dtype=dtype)
        self.out_proj = nn.Linear(h * d, embed_dim, bias=out_proj_bias,
                                  device=device, dtype=dtype)
        self.register_buffer(
            "alibi", alibi_slopes(h, device) if use_alibi else None,
            persistent=False)

    def _kernel_kwargs(self, b):
        return dict(softmax_scale=self.softmax_scale,
                    window_size=self.window_size, softcap=self.softcap,
                    alibi_slopes=(None if self.alibi is None
                                  else self.alibi.expand(b, -1)))

    def forward(self, x, inference_params: Optional[InferenceParams] = None,
                key_padding_mask=None, cu_seqlens=None, max_seqlen=None,
                rotary=None):
        """x: (b, s, embed_dim), or (1, total, embed_dim) packed with
        `cu_seqlens` (b + 1,) int32 and `max_seqlen`; key_padding_mask:
        (b, s) bool prefix mask, True = valid token.  A cache ignores both,
        as in JAX.  `rotary`: this call's `rotary_factors`, computed here
        when None."""
        b, s, _ = x.shape
        h, hk, d = self.num_heads, self.num_heads_kv, self.head_dim
        qkv = self.Wqkv(x)
        if self.rotary_emb is None:
            q = qkv[..., : h * d].reshape(b, s, h, d)
            k = qkv[..., h * d: (h + hk) * d].reshape(b, s, hk, d)
        else:
            if rotary is None:
                rotary = rotary_factors(self.rotary_emb, s, inference_params)
            # q and k heads side by side, rotated in one pass
            qk = apply_rotary_factors(
                qkv[..., : (h + hk) * d].reshape(b, s, h + hk, d), *rotary,
                interleaved=self.rotary_emb.interleaved)
            q, k = qk[:, :, :h], qk[:, :, h:]
        v = qkv[..., (h + hk) * d:].reshape(b, s, hk, d)
        if inference_params is None and cu_seqlens is not None:
            ctx = flash_attn_varlen_func(
                q.reshape(b * s, h, d), k.reshape(b * s, hk, d),
                v.reshape(b * s, hk, d), cu_seqlens, cu_seqlens, max_seqlen,
                max_seqlen, causal=self.causal,
                **self._kernel_kwargs(1)).reshape(b, s, h, d)
        elif inference_params is None:
            lengths = (None if key_padding_mask is None
                       else key_padding_mask.sum(-1, dtype=torch.int32))
            o, _ = _attn_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=self.causal,
                              seqused_q=lengths, seqused_k=lengths,
                              **self._kernel_kwargs(b))
            ctx = o.transpose(1, 2)
            if key_padding_mask is not None:
                ctx = torch.where(key_padding_mask[:, :, None, None].bool(),
                                  ctx, 0)
        else:
            ctx = self._cached_attention(q, k, v,
                                         inference_params).transpose(1, 2)
        return self.out_proj(ctx.reshape(b, s, h * d))

    def _cached_attention(self, q, k, v, inference_params):
        """Append k/v to this layer's cache at each row's length, then
        attend over the cache: decode kernel for s <= 16, prefill kernel
        otherwise.  Returns ctx (b, h, s, d)."""
        hk, d = self.num_heads_kv, self.head_dim
        b, s = q.shape[0], q.shape[1]
        ip = inference_params
        lengths = ip.lengths_per_sample
        if self.layer_idx not in ip.key_value_memory_dict:
            kc = torch.zeros((ip.max_batch_size, hk, ip.max_seqlen, d),
                             dtype=q.dtype, device=q.device)
            ip.key_value_memory_dict[self.layer_idx] = (kc, torch.zeros_like(kc))
        kc, vc = ip.key_value_memory_dict[self.layer_idx]
        # In-place write of the new rows, where JAX scatters functionally.
        bidx = torch.arange(b, device=q.device)[:, None]
        sidx = lengths[:, None] + torch.arange(s, device=q.device,
                                               dtype=lengths.dtype)[None, :]
        kc[bidx, :, sidx] = k
        vc[bidx, :, sidx] = v
        new_len = lengths + s
        qt = q.transpose(1, 2).contiguous()
        if s <= DECODE_MAX_SEQLEN:
            ctx, _ = decode_attn_bhsd(qt, kc, vc, new_len, causal=True,
                                      **self._kernel_kwargs(b))
        else:
            seqused_q = torch.full((b,), s, dtype=torch.int32, device=q.device)
            ctx, _ = flash_attn_fwd_bhsd(qt, kc[:b], vc[:b], seqused_q, new_len,
                                         causal=self.causal,
                                         **self._kernel_kwargs(b))
        return ctx
