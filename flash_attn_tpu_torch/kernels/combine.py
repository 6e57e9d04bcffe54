"""LSE-weighted combination of partial attention outputs (counterpart of
`flash_attn_tpu/kernels/combine.py:25,51`).

Given per-split normalised outputs o_i and log-sum-exps lse_i over disjoint
key sets:

    lse = logsumexp_i(lse_i)
    o   = sum_i exp(lse_i - lse) * o_i

Empty splits carry lse = +inf and o = 0 and contribute zero weight.  Like the
JAX package, this small reduction stays in plain tensor code.
"""

from __future__ import annotations

import torch


def combine_attn_partials(o_parts, lse_parts, axis: int = 0):
    """Combine partial attention results along `axis`.

    o_parts: (..., splits, ..., L, d) per-split normalised outputs.
    lse_parts: the same shape without the trailing d; +inf for empty splits.
    Returns (o float32, lse float32) with the split axis reduced.
    """
    o_parts = o_parts.float()
    lse_parts = lse_parts.float()
    # +inf marks "no keys": turn it into -inf so it gets zero weight.
    lse_eff = lse_parts.masked_fill(torch.isposinf(lse_parts), -torch.inf)
    m = lse_eff.amax(dim=axis, keepdim=True)
    m_safe = m.masked_fill(torch.isneginf(m), 0.0)
    w = torch.exp(lse_eff - m_safe)
    sumw = w.sum(dim=axis, keepdim=True)
    lse = torch.where(torch.isneginf(m), torch.inf,
                      m_safe + torch.log(sumw.clamp_min(1e-37)))
    norm = torch.where(sumw == 0.0, 1.0, sumw)
    o = (o_parts * (w / norm)[..., None]).sum(dim=axis)
    return o, lse.squeeze(axis)


def merge_attn_state(o_a, lse_a, o_b, lse_b):
    """Pairwise merge of two attention states."""
    o = torch.stack([o_a.float(), o_b.float()], dim=0)
    lse = torch.stack([lse_a, lse_b], dim=0)
    return combine_attn_partials(o, lse, axis=0)
