"""Device selection (counterpart of `flash_attn_tpu/env.py`).

The JAX package falls back to Pallas interpret mode off the TPU; the port has
no such switch.  Entry points run on CUDA unless the caller names another
device, and nothing moves to the CPU by itself.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means CUDA, which must be present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda", torch.cuda.current_device())
