"""Weights of the port's models: random initialisation from a seed,
carrying the JAX models' weights across (no JAX counterpart: the JAX
package initialises and loads flax parameter trees directly), and the
canonical layout every family remap produces (counterpart of
`flash_attn_tpu/models/common.py`).

`JaxParams` walks a flax parameter tree (nested dicts of numpy arrays, with
or without the top "params" key) and builds the port's `state_dict`: a Dense
kernel (in, out) becomes an `nn.Linear` weight (out, in), an embedding table
and a norm's weight and bias carry over as they are.

`canonical_to_state_dict` takes the role of the JAX `canonical_to_flax:53`.
Every family converter writes a dict in the reference checkpoint's layout
("transformer.layers.{l}.mixer.Wqkv.weight", (out, in) matrices), which is
the port's own state_dict but for the embedding names, so nothing is
transposed.  As in JAX, `GatedMlp`'s fc1 is packed [gate ; up] (the
reference packs [up ; gate]) and the converters write it in that order.
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

    def take(self, jax_path, name, axes=None):
        """Move one array, its axes permuted by `axes` where given."""
        arr = self.flat.pop(jax_path)
        if axes is not None:
            arr = arr.transpose(axes)
        self.sd[name] = torch.from_numpy(np.array(arr))

    def dense(self, jax_prefix, name):
        self.take(f"{jax_prefix}/kernel", f"{name}.weight", axes=(1, 0))
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


# Keys of a canonical dict that carry no weight (`canonical_to_flax:88-90`):
# rotary frequencies and the attention-mask buffers of HF checkpoints.
_SKIPPED = ("rotary", "masked_bias", "inv_freq")


def as_tensors(state_dict):
    """A new dict of the state dict's values as tensors (numpy arrays are
    shared, not copied)."""
    return {k: torch.as_tensor(v) for k, v in state_dict.items()}


def canonical_to_state_dict(cd, config):
    """The port's GPTLMHeadModel state_dict from a canonical dict (tensors
    or numpy arrays).  Raises ValueError if a key is left unused, but for
    the weightless ones `canonical_to_flax` skips, and NotImplementedError
    on OPT's `project_in` (`word_embed_proj_dim` is not ported)."""
    cd = as_tensors(cd)
    if "transformer.embeddings.project_in.weight" in cd:
        raise NotImplementedError("word_embed_proj_dim is not ported")
    emb = "transformer.embeddings."
    sd = {emb + "wte.weight": cd.pop(emb + "word_embeddings.weight")}
    if emb + "position_embeddings.weight" in cd:
        sd[emb + "wpe.weight"] = cd.pop(emb + "position_embeddings.weight")
    names = ["transformer.ln_f"]
    for i in range(config.n_layer):
        pre = f"transformer.layers.{i}."
        names += [pre + n for n in ("norm1", "norm2", "mixer.Wqkv",
                                    "mixer.out_proj", "mlp.fc1", "mlp.fc2")]
    if not config.tie_word_embeddings:
        names.append("lm_head")
    for name in names:
        for n in ("weight", "bias"):
            if f"{name}.{n}" in cd:
                sd[f"{name}.{n}"] = cd.pop(f"{name}.{n}")
    left = [k for k in cd if not any(s in k for s in _SKIPPED)
            and not k.endswith(".attn.bias")]
    if left:
        raise ValueError(f"unmapped keys: {left[:8]}")
    return {k: v.contiguous() for k, v in sd.items()}


@torch.no_grad()
def init_weights(module, generator=None, std: float = 0.02):
    """Matrices and embeddings ~ N(0, std) drawn from `generator` on its
    device (a CPU generator gives the same weights on every device; a CUDA
    one draws a large model faster); biases 0, norm weights 1 (the only 1-D
    weights are norms')."""
    gen_device = generator.device if generator is not None else "cpu"
    for name, p in module.named_parameters():
        if p.ndim == 2:
            w = torch.empty(p.shape, dtype=torch.float32, device=gen_device)
            w.normal_(0.0, std, generator=generator)
            p.copy_(w)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return module
