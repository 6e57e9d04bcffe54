"""Image-to-patch embedding (counterpart of
`flash_attn_tpu/layers/patch_embed.py::PatchEmbed:12-32`).

The input stays NHWC, as in JAX.  The projection is an `nn.Conv2d` with
kernel and stride `patch_size`, run on an NCHW view of the input; its
weight is (embed_dim, in_chans, p, p), where flax's `Conv` kernel is (p, p,
in_chans, embed_dim).
"""

from __future__ import annotations

import torch
from torch import nn

from flash_attn_tpu_torch.env import default_device


class PatchEmbed(nn.Module):
    """(b, h, w, c) images -> (b, num_patches, embed_dim), patches in row
    order."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, in_chans: int = 3, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.img_size = img_size
        self.patch_size = patch_size
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size, device=device, dtype=dtype)

    def forward(self, x):
        x = self.proj(x.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)
