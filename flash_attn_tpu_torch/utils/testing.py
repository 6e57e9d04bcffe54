"""Attention oracle and tolerance rule (counterpart of
`flash_attn_tpu/utils/testing.py`: `construct_local_mask:47`,
`attn_bias_from_alibi_slopes:92`, `attention_ref:128`, `check_close:281`).

Everything is computed explicitly from masks so the kernels' plain versions
and `chip_smoke.py` have an independent yardstick.  A kernel is accepted when
its error against the fp32 oracle is at most twice the error of the same
computation done in low precision, plus a small floor.
"""

from __future__ import annotations

import math

import torch

INF = float("inf")


def construct_local_mask(seqlen_q, seqlen_k, window_size=(-1, -1),
                         query_padding_mask=None, key_padding_mask=None,
                         key_leftpad=None, device=None):
    """True where masked OUT.  Bottom-right aligned; a one-sided window is
    normalised to seqlen_k on its open side (as the kernels do)."""
    if window_size[0] >= 0 and window_size[1] < 0:
        window_size = (window_size[0], seqlen_k)
    elif window_size[1] >= 0 and window_size[0] < 0:
        window_size = (seqlen_k, window_size[1])
    row_idx = torch.arange(seqlen_q, dtype=torch.int64, device=device)[:, None]
    col_idx = torch.arange(seqlen_k, dtype=torch.int64, device=device)
    if key_leftpad is not None:
        key_leftpad = key_leftpad.reshape(-1, 1, 1, 1).to(torch.int64)
        col_idx = col_idx.expand(key_leftpad.shape[0], 1, 1, seqlen_k)
        col_idx = torch.where(col_idx >= key_leftpad, col_idx - key_leftpad,
                              2 ** 30)
    sk = (seqlen_k if key_padding_mask is None
          else key_padding_mask.sum(-1).reshape(-1, 1, 1, 1))
    sq = (seqlen_q if query_padding_mask is None
          else query_padding_mask.sum(-1).reshape(-1, 1, 1, 1))
    if window_size[0] < 0:
        return col_idx > row_idx + sk - sq + window_size[1]
    if key_padding_mask is None:
        sk = torch.full_like(col_idx, seqlen_k)
    return torch.logical_or(
        col_idx > torch.minimum(row_idx + sk - sq + window_size[1],
                                torch.as_tensor(sk)),
        col_idx < row_idx + sk - sq - window_size[0],
    )


def attn_bias_from_alibi_slopes(slopes, seqlen_q, seqlen_k,
                                query_padding_mask=None,
                                key_padding_mask=None, causal=False,
                                key_leftpad=None):
    """(batch or 1, nheads) slopes -> additive (batch, nheads, sq, sk) bias."""
    batch, nheads = slopes.shape
    device = slopes.device
    slopes = slopes.reshape(batch, nheads, 1, 1).float()
    if causal:
        return torch.arange(-seqlen_k + 1, 1, dtype=torch.float32,
                            device=device) * slopes
    row_idx = torch.arange(seqlen_q, dtype=torch.int64, device=device)[:, None]
    col_idx = torch.arange(seqlen_k, dtype=torch.int64, device=device)
    if key_leftpad is not None:
        key_leftpad = key_leftpad.reshape(-1, 1, 1, 1).to(torch.int64)
        col_idx = col_idx.expand(key_leftpad.shape[0], 1, 1, seqlen_k)
        col_idx = torch.where(col_idx >= key_leftpad, col_idx - key_leftpad,
                              2 ** 30)
    sk = (seqlen_k if key_padding_mask is None
          else key_padding_mask.sum(-1).reshape(-1, 1, 1, 1))
    sq = (seqlen_q if query_padding_mask is None
          else query_padding_mask.sum(-1).reshape(-1, 1, 1, 1))
    relative_pos = (row_idx + sk - sq - col_idx).abs()
    return -slopes * relative_pos.float()


def attention_ref(q, k, v, query_padding_mask=None, key_padding_mask=None,
                  attn_bias=None, dropout_p=0.0, dropout_mask=None,
                  causal=False, window_size=(-1, -1), softcap=0.0,
                  upcast=True, reorder_ops=False, key_leftpad=None,
                  softmax_scale=None):
    """q: (b, sq, h, d); k/v: (b, sk, hk, d).  Returns (out (b, sq, h, d) in
    q's dtype, attention (b, h, sq, sk))."""
    if causal:
        window_size = (window_size[0], 0)
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    seqlen_q, seqlen_k = q.shape[1], k.shape[1]
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if not reorder_ops:
        scores = torch.einsum("bthd,bshd->bhts", q * scale, k)
    else:
        scores = torch.einsum("bthd,bshd->bhts", q, k * scale)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if key_padding_mask is not None:
        scores = scores.masked_fill(
            ~key_padding_mask.reshape(key_padding_mask.shape[0], 1, 1, -1),
            -INF)
    local_mask = None
    if window_size[0] >= 0 or window_size[1] >= 0:
        local_mask = construct_local_mask(
            seqlen_q, seqlen_k, window_size, query_padding_mask,
            key_padding_mask, key_leftpad=key_leftpad, device=q.device)
        scores = scores.masked_fill(local_mask, -INF)
    if attn_bias is not None:
        scores = scores + attn_bias
    attention = torch.softmax(scores, dim=-1).to(v.dtype)
    # Fully-masked rows produce NaN from softmax(-inf row); zero them.
    if local_mask is not None:
        attention = attention.masked_fill(
            local_mask.all(dim=-1, keepdim=True), 0.0)
    attention = torch.nan_to_num(attention, nan=0.0)
    if query_padding_mask is not None:
        attention = attention.masked_fill(
            ~query_padding_mask.reshape(query_padding_mask.shape[0], 1, -1, 1),
            0.0)
    attention_drop = (attention if dropout_mask is None
                      else attention.masked_fill(~dropout_mask, 0.0))
    output = torch.einsum("bhts,bshd->bthd", attention_drop,
                          v * (1.0 / (1 - dropout_p)))
    if query_padding_mask is not None:
        output = output.masked_fill(
            ~query_padding_mask.reshape(query_padding_mask.shape[0], -1, 1, 1),
            0.0)
    if key_padding_mask is not None:
        output = output.masked_fill(
            ~key_padding_mask.any(dim=1).reshape(-1, 1, 1, 1), 0.0)
    return output.to(dtype_og), attention.to(dtype_og)


def check_close(out, out_ref, out_pt, mult=2.0, atol_floor=1e-5, label="out"):
    """The tolerance rule: |out - ref| <= mult * |pt - ref| + floor.

    Returns (err, err_pt) as floats; raises AssertionError when it fails."""
    err = (out.float() - out_ref.float()).abs().max().item()
    err_pt = (out_pt.float() - out_ref.float()).abs().max().item()
    if not err <= mult * err_pt + atol_floor:
        raise AssertionError(
            f"{label}: err {err:.3e} > {mult} * low-precision err "
            f"{err_pt:.3e} + {atol_floor}")
    return err, err_pt


def dequantise_cache(cache, descale, block_table=None, cache_batch_idx=None):
    """float32 copy of an int8 / fp8 reference-layout KV cache with each
    sequence's rows multiplied by its per-(batch, kv head) descale (b, hk):
    contiguous (bc, smax, hk, d) through cache_batch_idx, or paged (npages,
    page, hk, d) / fused (npages, 2, page, hk, d) through block_table, whose
    sequences own disjoint pages.  The fp32 oracle of a quantised cache."""
    out = cache.float()
    b, hk = descale.shape
    for i in range(b):
        if block_table is not None:
            idx = block_table[i].long()
        else:
            idx = i if cache_batch_idx is None else int(cache_batch_idx[i])
        out[idx] = cache[idx].float() * descale[i].float().view(hk, 1)
    return out
