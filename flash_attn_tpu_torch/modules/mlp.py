"""MLP blocks (counterpart of `flash_attn_tpu/modules/mlp.py`: `Mlp:34`,
`GatedMlp:66`, `ACT2FN:23`)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.ops.activations import (gelu_approx, sqrelu_fwd,
                                                  swiglu_fwd)

ACT2FN = {
    "gelu_approx": gelu_approx,
    "gelu": gelu_approx,
    "gelu_new": gelu_approx,
    "relu": torch.relu,
    "sqrelu": sqrelu_fwd,
    "sigmoid": torch.sigmoid,
    "silu": lambda x: x * torch.sigmoid(x.float()).to(x.dtype),
}


class Mlp(nn.Module):
    """fc1 -> activation -> fc2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 activation: Callable = gelu_approx, bias1: bool = True,
                 bias2: bool = True, *, device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.activation = activation
        self.fc1 = nn.Linear(in_features, hidden_features, bias=bias1,
                             device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features,
                             bias=bias2, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(self.activation(self.fc1(x)))


class GatedMlp(nn.Module):
    """fc1 gives (gate | up); gated activation; fc2.  `hidden_features`
    None takes 8/3 of the input rounded up to `multiple_of`."""

    def __init__(self, in_features: int,
                 hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None,
                 activation: Callable = torch.sigmoid, bias1: bool = True,
                 bias2: bool = True, multiple_of: int = 128, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        if hidden_features is None:
            hidden_features = int(8 * in_features / 3)
            hidden_features = -(-hidden_features // multiple_of) * multiple_of
        self.activation = activation
        self.fc1 = nn.Linear(in_features, 2 * hidden_features, bias=bias1,
                             device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features,
                             bias=bias2, device=device, dtype=dtype)

    def forward(self, x):
        gate, up = self.fc1(x).chunk(2, dim=-1)
        if self.activation is swiglu_fwd:
            y = swiglu_fwd(gate, up)
        else:
            y = self.activation(gate) * up
        return self.fc2(y)
