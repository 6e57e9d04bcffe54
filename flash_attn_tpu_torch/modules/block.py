"""Transformer blocks (counterpart of `flash_attn_tpu/modules/block.py`:
`_Norm:19`, `Block:39`, pre-norm at `:85-112`, post-norm at `:113-127`,
`ParallelBlock:130`).

Both kinds pass their mixer keyword arguments (`key_padding_mask`,
`cu_seqlens`, `max_seqlen`) through to the mixer, as JAX's `**mixer_kwargs`
does, and `deterministic` with them: the mixer's attention dropout runs
when it is False.  The blocks' own residual dropouts and stochastic depth
(`resid_dropout1/2`, `drop_path1/2`, drawn with `jax.random` in JAX) are not
ported: the models that set them raise on `deterministic=False`.
"""

from __future__ import annotations

import torch
from torch import nn

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.ops.layer_norm import _norm


class _Norm(nn.Module):
    """LayerNorm or RMSNorm with float32 math, output in the module dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, is_rms: bool = False,
                 use_bias: bool = True, *, device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.eps = eps
        self.is_rms = is_rms
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
                     if use_bias and not is_rms else None)

    def forward(self, x):
        return _norm(x, self.weight, self.bias, self.eps,
                     self.is_rms).to(self.dtype)


class Block(nn.Module):
    """Pre-norm block: (hidden, residual) -> (hidden, residual); pass
    residual=None to the first block.  Post-norm block (`prenorm=False`,
    BERT's): h -> (norm1(mixer(h) + h) then norm2(mlp(.) + .), None)."""

    def __init__(self, dim: int, mixer: nn.Module, mlp: nn.Module, *,
                 prenorm: bool = True, residual_in_fp32: bool = False,
                 rms_norm: bool = False, norm_eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.prenorm = prenorm
        self.dtype = dtype
        self.residual_in_fp32 = residual_in_fp32
        self.norm1 = _Norm(dim, norm_eps, is_rms=rms_norm, device=device,
                           dtype=dtype)
        self.norm2 = _Norm(dim, norm_eps, is_rms=rms_norm, device=device,
                           dtype=dtype)
        self.mixer = mixer
        self.mlp = mlp

    def forward(self, hidden_states, residual=None, inference_params=None,
                deterministic: bool = True, **mixer_kwargs):
        mixer_kwargs["deterministic"] = deterministic
        if not self.prenorm:
            m = self.mixer(hidden_states, inference_params=inference_params,
                           **mixer_kwargs)
            h = self.norm1(m + hidden_states)
            return self.norm2(self.mlp(h) + h), None
        res_dtype = (torch.float32 if self.residual_in_fp32
                     else hidden_states.dtype)
        h = hidden_states.to(res_dtype)
        residual = h if residual is None else h + residual
        h = self.mixer(self.norm1(residual.to(self.dtype)),
                       inference_params=inference_params, **mixer_kwargs)
        residual = h.to(res_dtype) + residual
        h = self.mlp(self.norm2(residual.to(self.dtype)))
        return h, residual


class ParallelBlock(nn.Module):
    """GPT-J / NeoX / Falcon parallel block: (h1, h2, residual) -> (attn
    out, mlp out, residual) with residual = h1 + h2 + residual (in float32
    under `residual_in_fp32`), attn out = mixer(norm1(residual)) and mlp out
    = mlp(norm2(residual)); with `tied_norm` the MLP takes norm1's output
    and there is no norm2.  Pass h2 = residual = None to the first block.
    With a cache the same triple comes back: the caches are updated in
    place."""

    def __init__(self, dim: int, mixer: nn.Module, mlp: nn.Module, *,
                 tied_norm: bool = False, residual_in_fp32: bool = False,
                 rms_norm: bool = False, norm_eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.dtype = dtype
        self.residual_in_fp32 = residual_in_fp32
        self.norm1 = _Norm(dim, norm_eps, is_rms=rms_norm, device=device,
                           dtype=dtype)
        self.norm2 = (None if tied_norm else
                      _Norm(dim, norm_eps, is_rms=rms_norm, device=device,
                            dtype=dtype))
        self.mixer = mixer
        self.mlp = mlp

    def forward(self, hidden_states1, hidden_states2=None, residual=None,
                inference_params=None, deterministic: bool = True,
                **mixer_kwargs):
        mixer_kwargs["deterministic"] = deterministic
        res_dtype = (torch.float32 if self.residual_in_fp32
                     else hidden_states1.dtype)
        acc = hidden_states1.to(res_dtype)
        if hidden_states2 is not None:
            acc = acc + hidden_states2.to(res_dtype)
        residual = acc if residual is None else acc + residual
        hn1 = self.norm1(residual.to(self.dtype))
        hn2 = hn1 if self.norm2 is None else self.norm2(
            residual.to(self.dtype))
        attn_out = self.mixer(hn1, inference_params=inference_params,
                              **mixer_kwargs)
        return attn_out, self.mlp(hn2), residual
