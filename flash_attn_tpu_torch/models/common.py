"""Weights of the port's models: random initialisation from a seed, and
carrying the JAX models' weights across (no JAX counterpart: the JAX
package initialises and loads flax parameter trees directly).

`JaxParams` walks a flax parameter tree (nested dicts of numpy arrays, with
or without the top "params" key) and builds the port's `state_dict`: a Dense
kernel (in, out) becomes an `nn.Linear` weight (out, in), an embedding table
and a norm's weight and bias carry over as they are.
"""

from __future__ import annotations

import numpy as np
import torch


class JaxParams:
    def __init__(self, params):
        self.flat = {}
        self.sd = {}
        self._walk(params.get("params", params), "")

    def _walk(self, node, prefix):
        for key, val in node.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, dict):
                self._walk(val, path)
            else:
                self.flat[path] = np.asarray(val)

    def has(self, jax_path):
        return jax_path in self.flat

    def take(self, jax_path, name, transpose=False):
        arr = self.flat.pop(jax_path)
        self.sd[name] = torch.from_numpy(np.array(arr.T if transpose else arr))

    def dense(self, jax_prefix, name):
        self.take(f"{jax_prefix}/kernel", f"{name}.weight", transpose=True)
        if f"{jax_prefix}/bias" in self.flat:
            self.take(f"{jax_prefix}/bias", f"{name}.bias")

    def norm(self, jax_prefix, name):
        self.take(f"{jax_prefix}/weight", f"{name}.weight")
        if f"{jax_prefix}/bias" in self.flat:
            self.take(f"{jax_prefix}/bias", f"{name}.bias")

    def state_dict(self):
        """The state_dict; raises ValueError if an array was left unused."""
        if self.flat:
            raise ValueError(f"unused JAX parameters: {sorted(self.flat)}")
        return self.sd


@torch.no_grad()
def init_weights(module, generator=None, std: float = 0.02):
    """Matrices and embeddings ~ N(0, std) drawn from `generator` (on the
    CPU, so a seed gives the same weights on every device); biases 0, norm
    weights 1 (the only 1-D weights are norms')."""
    for name, p in module.named_parameters():
        if p.ndim == 2:
            w = torch.empty(p.shape, dtype=torch.float32)
            w.normal_(0.0, std, generator=generator)
            p.copy_(w)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return module
