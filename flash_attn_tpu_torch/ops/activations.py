"""Activations (counterpart of `flash_attn_tpu/ops/activations.py`).

Elementwise passes that stay plain tensor code.  `gelu_approx` keeps the
exact tanh constants of the JAX package (0.79788456, 0.044715), which is the
"gelu_new" of GPT-2.
"""

from __future__ import annotations

import torch


def gelu_approx(x):
    """tanh-approximate GELU in float32, cast back (`activations.py:21`)."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(0.79788456 * xf * (1.0 + 0.044715 * xf * xf)))
    return out.to(x.dtype)


def gelu_exact(x):
    """erf GELU in float32, cast back (`activations.py:29`): Hugging Face's
    "gelu" and the ViT's activation."""
    return torch.nn.functional.gelu(x.float()).to(x.dtype)


def sqrelu_fwd(x):
    """Squared ReLU (`activations.py:37`)."""
    r = torch.relu(x)
    return r * r


def swiglu_fwd(x, y):
    """silu(x) * y with the silu in float32 (`activations.py:48`)."""
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype) * y
