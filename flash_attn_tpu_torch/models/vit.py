"""Vision Transformer (counterpart of `flash_attn_tpu/models/vit.py`:
`VisionTransformer:20`, the factories `vit_{base,small,large}_patch16_224`
`:135-150`, `remap_state_dict_hf_vit:153`).

timm's ViT on the port's blocks: `PatchEmbed` over NHWC images, the class
token (concatenated after the position add under `no_embed_class`), pre-norm
`Block`s of a non-causal `MHA` (the dense attention kernels) and an erf-GELU
`Mlp`, then the final norm on the sequence, or on the pooled feature
(`fc_norm`, the default of `global_pool="avg"`), and the head.  The
attention dropout (`attn_drop_rate`) runs in the dense non-causal kernels
under `deterministic=False` (JAX's argument, default True; seed 0 in every
block, as JAX's MHA passes no seed).  The position / residual dropout and
stochastic depth (`drop_rate`, `drop_path_rate`, drawn with `jax.random` in
JAX) are not ported: a rate above 0 raises `NotImplementedError`.

`state_dict_from_jax_params` carries the JAX model's parameters across;
`remap_state_dict_hf_vit` reads a Hugging Face `ViTModel` /
`ViTForImageClassification` state dict.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.layers.patch_embed import PatchEmbed
from flash_attn_tpu_torch.models.common import JaxParams, as_tensors
from flash_attn_tpu_torch.modules.block import Block, _Norm
from flash_attn_tpu_torch.modules.mha import MHA
from flash_attn_tpu_torch.modules.mlp import Mlp
from flash_attn_tpu_torch.ops.activations import gelu_exact


class VisionTransformer(nn.Module):
    """(b, h, w, c) NHWC images -> (b, num_classes) logits, or the pooled
    feature with `pre_logits` or `num_classes=0`.  `device=None` means CUDA
    and raises RuntimeError when there is none."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, no_embed_class: bool = False,
                 global_pool: str = "token", fc_norm: Optional[bool] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        rates = dict(drop_rate=drop_rate, drop_path_rate=drop_path_rate)
        if any(v > 0 for v in rates.values()):
            raise NotImplementedError(
                f"dropout is not ported yet: {rates}")
        self.embed_dim = embed_dim
        self.no_embed_class = no_embed_class
        self.global_pool = global_pool
        self.patch_embed = PatchEmbed(img_size, patch_size, embed_dim,
                                      device=device, dtype=dtype)
        n_tok = self.patch_embed.num_patches + (0 if no_embed_class else 1)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, n_tok, embed_dim, device=device, dtype=torch.float32))
        self.cls_token = nn.Parameter(torch.zeros(
            1, 1, embed_dim, device=device, dtype=torch.float32))
        hidden = int(embed_dim * mlp_ratio)
        self.blocks = nn.ModuleList(
            Block(embed_dim,
                  MHA(embed_dim, num_heads, causal=False, layer_idx=i,
                      dropout=attn_drop_rate, device=device, dtype=dtype),
                  Mlp(embed_dim, hidden, activation=gelu_exact,
                      device=device, dtype=dtype),
                  device=device, dtype=dtype)
            for i in range(depth))
        use_fc_norm = global_pool == "avg" if fc_norm is None else fc_norm
        norm = _Norm(embed_dim, device=device, dtype=dtype)
        self.fc_norm = norm if use_fc_norm else None
        self.norm = None if use_fc_norm else norm
        self.head = (nn.Linear(embed_dim, num_classes, device=device,
                               dtype=dtype) if num_classes > 0 else None)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None,
                     std: float = 0.02):
        """Matrices, the patch projection and the position embedding ~ N(0,
        std) drawn from `generator` (on the CPU, so a seed gives the same
        weights on every device); the class token, biases 0, norm weights
        1."""
        gen_device = generator.device if generator is not None else "cpu"
        for name, p in self.named_parameters():
            if p.ndim >= 2 and name != "cls_token":
                w = torch.empty(p.shape, dtype=torch.float32,
                                device=gen_device)
                w.normal_(0.0, std, generator=generator)
                p.copy_(w)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def _pos_embed(self, x):
        pe = self.pos_embed.to(x.dtype)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        if self.no_embed_class:
            return torch.cat([cls, x + pe], dim=1)
        return torch.cat([cls, x], dim=1) + pe

    def forward_features(self, x, deterministic: bool = True):
        x = self._pos_embed(self.patch_embed(x))
        residual = None
        for blk in self.blocks:
            x, residual = blk(x, residual, deterministic=deterministic)
        x = x.float() + residual.float()
        return x if self.norm is None else self.norm(x)

    def forward_head(self, x, pre_logits: bool = False):
        if self.global_pool == "avg":
            feat = x[:, 1:].mean(dim=1)
        else:
            feat = x[:, 0]
        if self.fc_norm is not None:
            feat = self.fc_norm(feat)
        if pre_logits or self.head is None:
            return feat
        return self.head(feat)

    def forward(self, x, pre_logits: bool = False,
                deterministic: bool = True):
        """`deterministic=False` runs the attention dropout."""
        return self.forward_head(
            self.forward_features(x, deterministic=deterministic),
            pre_logits=pre_logits)


def vit_base_patch16_224(**kwargs):
    return VisionTransformer(patch_size=16, embed_dim=768, depth=12,
                             num_heads=12, **kwargs)


def vit_small_patch16_224(**kwargs):
    return VisionTransformer(patch_size=16, embed_dim=384, depth=12,
                             num_heads=6, **kwargs)


def vit_large_patch16_224(**kwargs):
    return VisionTransformer(patch_size=16, embed_dim=1024, depth=24,
                             num_heads=16, **kwargs)


def state_dict_from_jax_params(params, depth: int):
    """The port's VisionTransformer state_dict from the JAX model's flax
    parameters (nested dicts of numpy arrays, with or without the top
    "params" key): Dense kernels transposed to (out, in), the patch
    projection's (p, p, in, out) kernel to Conv2d's (out, in, p, p).  Raises
    ValueError if an array is left unused."""
    p = JaxParams(params)
    p.take("patch_embed/proj/kernel", "patch_embed.proj.weight",
           axes=(3, 2, 0, 1))
    p.take("patch_embed/proj/bias", "patch_embed.proj.bias")
    p.take("pos_embed", "pos_embed")
    p.take("cls_token", "cls_token")
    for i in range(depth):
        jp, tp = f"blocks_{i}", f"blocks.{i}"
        p.norm(f"{jp}/norm1", f"{tp}.norm1")
        p.norm(f"{jp}/norm2", f"{tp}.norm2")
        p.dense(f"{jp}/mixer/Wqkv", f"{tp}.mixer.Wqkv")
        p.dense(f"{jp}/mixer/out_proj", f"{tp}.mixer.out_proj")
        p.dense(f"{jp}/mlp/fc1", f"{tp}.mlp.fc1")
        p.dense(f"{jp}/mlp/fc2", f"{tp}.mlp.fc2")
    if p.has("fc_norm_layer/weight"):
        p.norm("fc_norm_layer", "fc_norm")
    else:
        p.norm("norm", "norm")
    if p.has("head/kernel"):
        p.dense("head", "head")
    return p.state_dict()


def remap_state_dict_hf_vit(state_dict, depth: int):
    """A Hugging Face `ViTModel` or `ViTForImageClassification` state dict
    (tensors or numpy arrays) as the port's state_dict (JAX `:153`): q, k
    and v packed into Wqkv; the classifier, where there is one, as the
    head; the pooler dropped.  Raises ValueError on any other unused key."""
    sd = {k.removeprefix("vit."): v for k, v in as_tensors(state_dict).items()}
    out = {
        "cls_token": sd.pop("embeddings.cls_token"),
        "pos_embed": sd.pop("embeddings.position_embeddings"),
        "patch_embed.proj.weight": sd.pop(
            "embeddings.patch_embeddings.projection.weight"),
        "patch_embed.proj.bias": sd.pop(
            "embeddings.patch_embeddings.projection.bias"),
        "norm.weight": sd.pop("layernorm.weight"),
        "norm.bias": sd.pop("layernorm.bias"),
    }
    for i in range(depth):
        hf, our = f"encoder.layer.{i}.", f"blocks.{i}."
        att = hf + "attention.attention."
        for n in ("weight", "bias"):
            out[f"{our}mixer.Wqkv.{n}"] = torch.cat(
                [sd.pop(f"{att}{x}.{n}") for x in ("query", "key", "value")])
            for src, dst in (("attention.output.dense", "mixer.out_proj"),
                             ("layernorm_before", "norm1"),
                             ("layernorm_after", "norm2"),
                             ("intermediate.dense", "mlp.fc1"),
                             ("output.dense", "mlp.fc2")):
                out[f"{our}{dst}.{n}"] = sd.pop(f"{hf}{src}.{n}")
    for n in ("weight", "bias"):
        if f"classifier.{n}" in sd:
            out[f"head.{n}"] = sd.pop(f"classifier.{n}")
    left = [k for k in sd if not k.startswith("pooler.")]
    if left:
        raise ValueError(f"unmapped keys: {left[:8]}")
    return {k: v.contiguous() for k, v in out.items()}

