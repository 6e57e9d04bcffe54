"""Block-sparse attention with a user-supplied block layout (counterpart of
`flash_attn_tpu/blocksparse.py`: `convert_blockmask:22`,
`flash_blocksparse_attn_func:82`, `FlashBlocksparseAttention:109`).

A boolean (nq, nk) layout (or one with leading H or B, H dimensions) becomes
a flex `BlockMask`; the attention runs on the flex path
(`kernels/flex.py`), at any block size the flex kernels take (multiples of
64 on CUDA).  As in JAX, selected blocks strictly below the causal diagonal
are listed *full* (computed unmasked) and diagonal-crossing ones *partial*
(causal mask from the partial-block bits); a padded last kv block is always
partial.
"""

from __future__ import annotations

import math

import torch

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.kernels.flex import (BlockMask, _pack_indices,
                                               flex_attention)


def convert_blockmask(blockmask, B: int, H: int, q_len: int, kv_len: int, *,
                      block_q: int, block_k: int, causal: bool = False,
                      device=None) -> BlockMask:
    """(nq, nk) / (H, nq, nk) / (B, H, nq, nk) bool layout -> `BlockMask`
    (`:22`), on `device` (default: the layout's, if it is a tensor, else
    CUDA)."""
    nq, nk = -(-q_len // block_q), -(-kv_len // block_k)
    if device is None and isinstance(blockmask, torch.Tensor):
        device = blockmask.device
    device = default_device(device)
    bm = torch.as_tensor(blockmask, device=device).to(torch.bool)
    bm = bm.reshape((1,) * (4 - bm.dim()) + tuple(bm.shape)).expand(
        B, H, nq, nk)
    qb = torch.arange(nq, device=device)[:, None]
    kb = torch.arange(nk, device=device)[None, :]
    offset = kv_len - q_len  # bottom-right aligned, as the reference
    if causal:
        # below the diagonal: every column <= every row + offset
        full_below = (kb + 1) * block_k - 1 <= qb * block_q + offset
        crossing = (kb * block_k <= qb * block_q + (block_q - 1) + offset
                    ) & ~full_below
    else:
        full_below = torch.ones(nq, nk, dtype=torch.bool, device=device)
        crossing = torch.zeros(nq, nk, dtype=torch.bool, device=device)
    if kv_len % block_k:  # a padded tail always needs the mask
        crossing[:, -1] |= full_below[:, -1]
        full_below[:, -1] = False
    full, partial = bm & full_below, bm & crossing
    kv_num, kv_idx = _pack_indices(partial)
    full_kv_num, full_kv_idx = _pack_indices(full)
    q_num, q_idx = _pack_indices(partial.transpose(-1, -2))
    full_q_num, full_q_idx = _pack_indices(full.transpose(-1, -2))
    return BlockMask(block_q, block_k, q_len, kv_len, kv_num, kv_idx,
                     full_kv_num, full_kv_idx, q_num, q_idx, full_q_num,
                     full_q_idx)


def flash_blocksparse_attn_func(qkv, blockmask, *, causal: bool = False,
                                softmax_scale=None, block_q: int = 512,
                                block_k: int = 512):
    """Packed-QKV block-sparse attention (`:82`).  qkv: (b, s, 3, h, d);
    blockmask: (nq, nk) bool, or broadcastable with leading H / B, H
    dimensions.  q, k and v are read from qkv in place."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise RuntimeError(
            f"flash_blocksparse_attn_func: no kernel for {qkv.device}")
    b, s, _, h, d = qkv.shape
    q, k, v = qkv.unbind(2)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    bmask = convert_blockmask(blockmask, b, h, s, s, block_q=block_q,
                              block_k=block_k, causal=causal,
                              device=qkv.device)
    mask_mod = (lambda b_, h_, qi, ki: qi >= ki) if causal else None
    return flex_attention(q, k, v, mask_mod=mask_mod, block_mask=bmask,
                          softmax_scale=softmax_scale)


class FlashBlocksparseAttention:
    """Callable mirroring the reference FA1 blocksparse module (`:109`):
    constructed with a layout, called with packed qkv."""

    def __init__(self, sparsity_config=None, *, blockmask=None,
                 softmax_scale=None, block_q: int = 512, block_k: int = 512):
        if blockmask is None and sparsity_config is not None:
            blockmask = sparsity_config
        self.blockmask = blockmask
        self.softmax_scale = softmax_scale
        self.block_q = block_q
        self.block_k = block_k

    def __call__(self, qkv, *, causal: bool = False, blockmask=None):
        return flash_blocksparse_attn_func(
            qkv, self.blockmask if blockmask is None else blockmask,
            causal=causal, softmax_scale=self.softmax_scale,
            block_q=self.block_q, block_k=self.block_k)
