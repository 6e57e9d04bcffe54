"""Packed-native varlen attention on the flex kernels (counterpart of
`flash_attn_tpu/kernels/varlen_packed.py`: `_segment_aux:38`,
`make_varlen_mask_mod:53`, `varlen_block_mask:73`,
`flash_attn_varlen_packed_func:149`).

Tokens stay in their (total, heads, d) streams.  Each token gets one int32
aux word, (segment << 16) | position counted from its sequence's end, so the
mask is a compare of words: same segment, `k_from_end >= q_from_end - w`
(bottom-right causal, and the right window), `k_from_end <= q_from_end + wl`
(the left window).  The block lists come from interval logic on cu_seqlens
at block granularity: a (q, kv) block pair is listed iff their segment
ranges meet, full iff both lie in one segment with no mask cut and no
padding.  On CUDA the mask reaches the kernels as the flex path's partial-
block bits (`kernels/flex.py`), evaluated over the partial blocks only.

The JAX function pads the streams to a block multiple; here they are passed
unpadded (the flex kernels mask keys past the stream, and padded tokens'
aux words match nothing either way), so no copy is made.
"""

from __future__ import annotations

import math

import torch

from flash_attn_tpu_torch.kernels.block_sizes import round_up
from flash_attn_tpu_torch.kernels.flex import (BlockMask, _pack_indices,
                                               flex_attention)

_POS_BITS = 16
_POS_MASK = (1 << _POS_BITS) - 1
_PAD_SEGMENT = 0x7FFF  # the segment of tokens past the last sequence


def _segment_aux(cu_seqlens, total: int, total_p: int):
    """(total_p,) int32: (segment << 16) | position from the segment's end;
    tokens at or past `total` get segment 0x7FFF (matches nothing real)."""
    cu = cu_seqlens.to(torch.int32)
    idx = torch.arange(total_p, dtype=torch.int32, device=cu.device)
    nseq = cu.shape[0] - 1
    seg = (torch.searchsorted(cu, idx, right=True).to(torch.int32) - 1).clamp(
        0, nseq - 1)
    from_end = (cu[seg.long() + 1] - 1 - idx).clamp(0, _POS_MASK)
    aux = (seg << _POS_BITS) | from_end
    return torch.where(idx < total, aux, _PAD_SEGMENT << _POS_BITS)


def make_varlen_mask_mod(causal: bool, window_size=(-1, -1)):
    """mask_mod over the packed aux words (see the module docstring)."""
    wl, wr = int(window_size[0]), int(window_size[1])

    def mod(b, h, q_idx, kv_idx, qa, ka):
        seg_q, seg_k = qa >> _POS_BITS, ka >> _POS_BITS
        keep = (seg_q == seg_k) & (seg_q < _PAD_SEGMENT)
        pq, pk = qa & _POS_MASK, ka & _POS_MASK  # positions from the END
        if causal or wr >= 0:
            keep = keep & (pk >= pq - (0 if causal else wr))
        if wl >= 0:
            keep = keep & (pk <= pq + wl)
        return keep

    return mod


def varlen_block_mask(cu_seqlens_q, cu_seqlens_k, total_q_p: int,
                      total_k_p: int, *, causal: bool, window_size=(-1, -1),
                      block_q: int, block_k: int, nheads: int) -> BlockMask:
    """Block lists from interval logic on cu_seqlens (`:73`), O(nq * nk), on
    cu_seqlens' device; tables (1, nheads, ...)."""
    cu_q = cu_seqlens_q.to(torch.int32)
    cu_k = cu_seqlens_k.to(torch.int32)
    dev = cu_q.device
    nq, nk = total_q_p // block_q, total_k_p // block_k
    nseq = cu_q.shape[0] - 1

    def seg_of(pos, cu):
        s = torch.searchsorted(cu, pos, right=True).to(torch.int32) - 1
        return s.clamp(0, nseq - 1).long()

    q0 = torch.arange(nq, dtype=torch.int32, device=dev) * block_q
    q1 = q0 + block_q - 1
    k0 = torch.arange(nk, dtype=torch.int32, device=dev) * block_k
    k1 = k0 + block_k - 1
    total_q, total_k = cu_q[-1], cu_k[-1]
    # block ends clamped into the real token range
    q1c, k1c = torch.minimum(q1, total_q - 1), torch.minimum(k1, total_k - 1)
    qs0, qs1 = seg_of(q0, cu_q), seg_of(q1c, cu_q)
    ks0, ks1 = seg_of(k0, cu_k), seg_of(k1c, cu_k)
    inter = ((qs0[:, None] <= ks1[None, :]) & (ks0[None, :] <= qs1[:, None])
             & (q0 < total_q)[:, None] & (k0 < total_k)[None, :])
    # full candidates: both blocks inside one segment, every token real
    one_seg = ((qs0 == qs1)[:, None] & (ks0 == ks1)[None, :]
               & (qs0[:, None] == ks0[None, :]))
    blocks_real = (q1[:, None] < total_q) & (k1[None, :] < total_k)
    full = inter & one_seg & blocks_real
    wl, wr = int(window_size[0]), int(window_size[1])
    q_end, k_end = cu_q[qs0 + 1], cu_k[ks0 + 1]
    if causal or wr >= 0:
        # full iff even the worst pair is kept: the block's smallest k
        # from-end against its largest q from-end
        pk_last = k_end[None, :] - 1 - k1[None, :]
        pq_first = q_end[:, None] - 1 - q0[:, None]
        full = full & (pk_last >= pq_first - (0 if causal else wr))
    if wl >= 0:
        pk_first = k_end[None, :] - 1 - k0[None, :]
        pq_last = q_end[:, None] - 1 - q1[:, None]
        full = full & (pk_first <= pq_last + wl)
    partial = inter & ~full

    def bh(x):  # (1, nheads, ...) as the JAX tables
        return x.expand(1, nheads, *x.shape[2:])

    def lists(m):
        return tuple(bh(t) for t in _pack_indices(m[None, None]))

    kv_num, kv_idx = lists(partial)
    full_kv_num, full_kv_idx = lists(full)
    q_num, q_idx = lists(partial.t())
    full_q_num, full_q_idx = lists(full.t())
    return BlockMask(block_q, block_k, int(total_q_p), int(total_k_p),
                     kv_num, kv_idx, full_kv_num, full_kv_idx, q_num, q_idx,
                     full_q_num, full_q_idx)


def flash_attn_varlen_packed_func(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                  max_seqlen_q=None, max_seqlen_k=None, *,
                                  softmax_scale=None, causal: bool = False,
                                  window_size=(-1, -1), block_q: int = 1024,
                                  block_k: int = 1024):
    """Packed varlen attention on the flex path (`:149`): q (total_q, h, d),
    k, v (total_k, hk, d), cu_seqlens (b + 1,) int32; differentiable in q,
    k, v.  Cross-sequence blocks are skipped through the interval block
    mask.  The JAX checks stay: fewer than 32767 sequences, and each length
    within the aux word's 16 position bits, checked from max_seqlen_q/k when
    given, else from cu_seqlens (a host read).  Runs on the tensors' device
    (the flex kernels on CUDA, with blocks multiples of 64)."""
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(
            f"flash_attn_varlen_packed_func: no kernel for {q.device}")
    total_q, h, d = q.shape
    total_k = k.shape[0]
    nseq = int(cu_seqlens_q.shape[0]) - 1
    if nseq >= _PAD_SEGMENT:
        raise ValueError("packed varlen supports < 32767 sequences per call")
    for name, ms, cu in (("q", max_seqlen_q, cu_seqlens_q),
                         ("k", max_seqlen_k, cu_seqlens_k)):
        if ms is not None:
            longest, what = int(ms), f"max_seqlen_{name}={int(ms)} exceeds it"
        else:
            lens = torch.diff(torch.as_tensor(cu))
            longest = int(lens.max()) if lens.numel() else 0
            what = f"got a length-{longest} sequence"
        if longest > _POS_MASK:
            raise ValueError(
                f"packed varlen supports per-sequence lengths up to "
                f"{_POS_MASK}; {what} (use the padded flash_attn_varlen_func "
                f"path)")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    cu_q = torch.as_tensor(cu_seqlens_q, device=q.device).to(torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=q.device).to(torch.int32)
    tq_p = round_up(max(total_q, block_q), block_q)
    tk_p = round_up(max(total_k, block_k), block_k)
    qa = _segment_aux(cu_q, total_q, tq_p)[None]
    ka = _segment_aux(cu_k, total_k, tk_p)[None]
    bm = varlen_block_mask(cu_q, cu_k, tq_p, tk_p, causal=causal,
                           window_size=window_size, block_q=block_q,
                           block_k=block_k, nheads=1)  # head-invariant: the
    # bits are made once, and the kernels read the tables at head stride 0
    out = flex_attention(q[None], k[None], v[None],
                         mask_mod=make_varlen_mask_mod(causal, window_size),
                         block_mask=bm, q_aux=qa, kv_aux=ka,
                         softmax_scale=float(softmax_scale))
    return out[0]
