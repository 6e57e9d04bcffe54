"""Rotary position embeddings (counterpart of
`flash_attn_tpu/layers/rotary.py:20-194`).

Plain PyTorch: the rotation is a few elementwise products, as in the JAX
package, which leaves it to XLA.  Layout (batch, seqlen, nheads, headdim);
the cos/sin tables are (seqlen, rotary_dim / 2).  The tables of
`RotaryEmbedding` are computed with numpy in float32, as the JAX class
computes them, so both packages rotate by the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attn_tpu_torch.env import default_device


def rotate_half(x, interleaved=False):
    if not interleaved:
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _expand(c, interleaved):
    """(..., rd/2) -> (..., rd), each value repeated for its rotated pair."""
    if not interleaved:
        return torch.cat([c, c], dim=-1)
    return torch.stack([c, c], dim=-1).reshape(*c.shape[:-1], -1)


def apply_rotary_factors(x, c, sn, interleaved=False):
    """x rotated on its first rd = c.shape[-1] features by float32 c, sn
    (`rotary_factors`, or any factors that broadcast against x[..., :rd]);
    the rest passes through."""
    rd = c.shape[-1]
    x_rot = x[..., :rd].float()
    out = (x_rot * c + rotate_half(x_rot, interleaved) * sn).to(x.dtype)
    if rd == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rd:]], dim=-1)


def rotary_factors(cos, sin, seqlen, interleaved=False, seqlen_offsets=0):
    """The float32 factors (c, sn) that rotate a (b, seqlen, h, d) tensor at
    positions seqlen_offsets + 0 .. seqlen - 1, each (1 or b, seqlen, 1,
    rotary_dim): every table value repeated for its rotated pair.
    `seqlen_offsets` is an int or a (b,) tensor; cos/sin are (s_max,
    rotary_dim / 2)."""
    if isinstance(seqlen_offsets, int):
        c = cos[seqlen_offsets:seqlen_offsets + seqlen][None]
        sn = sin[seqlen_offsets:seqlen_offsets + seqlen][None]
        if c.shape[1] != seqlen:
            raise IndexError(f"positions up to {seqlen_offsets + seqlen} "
                             f"past the table's {cos.shape[0]} rows")
    else:
        off = torch.as_tensor(seqlen_offsets, device=cos.device).long()
        idx = off[:, None] + torch.arange(seqlen, device=cos.device)[None, :]
        c, sn = cos[idx], sin[idx]
    return (_expand(c.float(), interleaved)[:, :, None, :],
            _expand(sn.float(), interleaved)[:, :, None, :])


def apply_rotary_emb(x, cos, sin, interleaved=False, seqlen_offsets=0,
                     inplace=False, cu_seqlens=None, max_seqlen=None):
    """x: (b, s, h, d), or (total, h, d) with `cu_seqlens`; cos/sin:
    (s_max, rotary_dim / 2).  `seqlen_offsets` is an int or a (b,) tensor.
    With `inplace` the result is also written into x."""
    del max_seqlen
    if cu_seqlens is not None:
        total = x.shape[0]
        cu = torch.as_tensor(cu_seqlens, device=x.device).long()
        t = torch.arange(total, device=x.device)
        seg = (torch.searchsorted(cu, t, right=True) - 1).clamp(
            0, cu.shape[0] - 2)
        pos = t - cu[seg]
        if isinstance(seqlen_offsets, int):
            pos = pos + seqlen_offsets
        else:
            pos = pos + torch.as_tensor(seqlen_offsets,
                                        device=x.device).long()[seg]
        pos = pos.clamp(0, cos.shape[0] - 1)
        c = _expand(cos[pos].float(), interleaved)[:, None, :]
        sn = _expand(sin[pos].float(), interleaved)[:, None, :]
    else:
        c, sn = rotary_factors(cos, sin, x.shape[1], interleaved,
                               seqlen_offsets)
    out = apply_rotary_factors(x, c, sn, interleaved)
    if inplace:
        x.copy_(out)
        return x
    return out


def apply_rotary_emb_qkv_(qkv, cos, sin, cos_k=None, sin_k=None,
                          interleaved=False, seqlen_offsets=0,
                          num_heads_q=None):
    """qkv: (b, s, 3, h, d), or (b, s, h_total, d) packed for GQA with
    `num_heads_q` (`rotary.py:95`).  Returns the rotated tensor."""
    cos_k = cos if cos_k is None else cos_k
    sin_k = sin if sin_k is None else sin_k
    if qkv.ndim == 5:
        q = apply_rotary_emb(qkv[:, :, 0], cos, sin, interleaved,
                             seqlen_offsets)
        k = apply_rotary_emb(qkv[:, :, 1], cos_k, sin_k, interleaved,
                             seqlen_offsets)
        return torch.stack([q, k, qkv[:, :, 2]], dim=2)
    if num_heads_q is None:
        raise ValueError("packed GQA qkv needs num_heads_q")
    hk = (qkv.shape[2] - num_heads_q) // 2
    q = apply_rotary_emb(qkv[:, :, :num_heads_q], cos, sin, interleaved,
                         seqlen_offsets)
    k = apply_rotary_emb(qkv[:, :, num_heads_q:num_heads_q + hk], cos_k,
                         sin_k, interleaved, seqlen_offsets)
    return torch.cat([q, k, qkv[:, :, num_heads_q + hk:]], dim=2)


def apply_rotary_emb_kv_(kv, cos, sin, interleaved=False, seqlen_offsets=0):
    """kv: (b, s, 2, hk, d) (`rotary.py:120`): rotates k only."""
    k = apply_rotary_emb(kv[:, :, 0], cos, sin, interleaved, seqlen_offsets)
    return torch.stack([k, kv[:, :, 1]], dim=2)


class RotaryEmbedding:
    """Rotary cos/sin tables with optional xPos scaling (`rotary.py:126`).

    The tables grow on demand to the longest sequence seen and live on
    `device` (None: CUDA, which must be present)."""

    def __init__(self, dim, base=10000.0, interleaved=False, scale_base=None,
                 pos_idx_in_fp32=True, interpolation_factor=1.0,
                 device=None):
        self.device = default_device(device)
        self.dim = dim
        self.base = float(base)
        self.interleaved = interleaved
        self.scale_base = scale_base
        self.pos_idx_in_fp32 = pos_idx_in_fp32
        self.interpolation_factor = float(interpolation_factor)
        self.inv_freq = 1.0 / (
            self.base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
        self.scale = (
            (np.arange(0, dim, 2, dtype=np.float32) + 0.4 * dim) / (1.4 * dim)
            if scale_base is not None else None)
        self._cached_len = 0
        self._cos = self._sin = self._cos_k = self._sin_k = None
        self._by_len = {}

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def _update(self, seqlen):
        if seqlen <= self._cached_len and self._cos is not None:
            return
        self._cached_len = seqlen
        t = np.arange(seqlen, dtype=np.float32)
        if self.interpolation_factor != 1.0:
            t = t / self.interpolation_factor
        freqs = np.outer(t, self.inv_freq)
        if self.scale is None:
            self._cos = self._tensor(np.cos(freqs))
            self._sin = self._tensor(np.sin(freqs))
        else:
            power = (t - seqlen // 2) / self.scale_base
            scale = self.scale[None, :] ** power[:, None]
            self._cos = self._tensor(np.cos(freqs) * scale)
            self._sin = self._tensor(np.sin(freqs) * scale)
            self._cos_k = self._tensor(np.cos(freqs) / scale)
            self._sin_k = self._tensor(np.sin(freqs) / scale)

    def tables(self, seqlen):
        """(cos, sin) of q as the JAX `_update(seqlen)` leaves them on a
        fresh object: at least `seqlen` rows, grown and kept across calls;
        under xPos scaling, whose values depend on the table's length,
        exactly `seqlen` rows, kept by length."""
        if self.scale is None:
            self._update(seqlen)
            return self._cos, self._sin
        if seqlen not in self._by_len:
            fresh = RotaryEmbedding(
                self.dim, self.base, self.interleaved, self.scale_base,
                self.pos_idx_in_fp32, self.interpolation_factor,
                device=self.device)
            fresh._update(seqlen)
            self._by_len[seqlen] = (fresh._cos, fresh._sin)
        return self._by_len[seqlen]

    def factors(self, seqlen, seqlen_offsets=0, table_len=None):
        """`rotary_factors` of positions seqlen_offsets + 0 .. seqlen - 1
        over `tables(table_len or seqlen)`."""
        cos, sin = self.tables(table_len or seqlen)
        return rotary_factors(cos, sin, seqlen, self.interleaved,
                              seqlen_offsets)

    def cos_sin(self, seqlen):
        """The (cos, sin) tables of q for positions 0 .. seqlen - 1 or more,
        in the form `flash_attn_with_kvcache` takes as rotary_cos/sin."""
        self._update(seqlen)
        return self._cos, self._sin

    def __call__(self, qkv, kv=None, seqlen_offset=0, max_seqlen=None,
                 num_heads_q=None):
        """qkv: (b, s, 3, h, d) (+ optional separate kv (b, s, 2, hk, d))."""
        seqlen = qkv.shape[1]
        if max_seqlen is not None:
            self._update(max_seqlen)
        elif isinstance(seqlen_offset, int):
            self._update(seqlen + seqlen_offset)
        if kv is None:
            return apply_rotary_emb_qkv_(
                qkv, self._cos, self._sin, self._cos_k, self._sin_k,
                interleaved=self.interleaved, seqlen_offsets=seqlen_offset,
                num_heads_q=num_heads_q)
        q = apply_rotary_emb(qkv, self._cos, self._sin, self.interleaved,
                             seqlen_offset)
        kv = apply_rotary_emb_kv_(
            kv, self._cos_k if self._cos_k is not None else self._cos,
            self._sin_k if self._sin_k is not None else self._sin,
            interleaved=self.interleaved, seqlen_offsets=seqlen_offset)
        return q, kv
