"""RMSNorm (counterpart of `flash_attn_tpu/ops/rms_norm.py`: `rms_norm_fn`,
`RMSNorm:11`), over `ops/layer_norm.py::rms_norm`.

The JAX class takes its weight at each call; this one owns it as a
parameter, as a PyTorch module does.
"""

from __future__ import annotations

import torch
from torch import nn

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.ops.layer_norm import rms_norm

rms_norm_fn = rms_norm


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, float32 math, output in x's
    dtype.  `device=None` means CUDA and raises RuntimeError without it."""

    def __init__(self, hidden_size: int, eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=default_device(device), dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)
