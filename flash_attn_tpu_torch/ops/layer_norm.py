"""LayerNorm / RMSNorm (counterpart of `flash_attn_tpu/ops/layer_norm.py:24-46`).

The math runs in float32 and the result is cast back to the input's dtype.
These passes are bandwidth-bound and stay plain tensor code, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import torch


def _norm(x, weight, bias, eps, is_rms):
    """float32 result of the normalisation, scaled and shifted."""
    xf = x.float()
    if is_rms:
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    else:
        xc = xf - xf.mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt(xc.pow(2).mean(dim=-1, keepdim=True) + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def layer_norm(x, weight, bias, epsilon=1e-5):
    return _norm(x, weight, bias, epsilon, is_rms=False).to(x.dtype)


def rms_norm(x, weight, epsilon=1e-6, bias=None):
    return _norm(x, weight, bias, epsilon, is_rms=True).to(x.dtype)
