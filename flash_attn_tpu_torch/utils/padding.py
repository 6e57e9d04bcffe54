"""Packing and unpacking of padded batches (counterpart of
`flash_attn_tpu/utils/padding.py:19-110`).

`unpad_input` reads the mask on the host to size its outputs (the lengths,
`max_seqlen` as a Python int and the kept indices), as the JAX function does
with `np.asarray(mask)` (`:45`); on a CUDA mask that is one synchronisation.
Indices come back as int64, PyTorch's index type (the JAX ones are int32);
`cu_seqlens` and `seqused` are int32.  Gathers and scatters are
differentiable, and padded rows come back as exact zeros.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def index_first_axis(x, indices):
    """Rows of `x` at `indices` along its first axis."""
    return x.index_select(0, indices)


def index_put_first_axis(values, indices, first_axis_dim):
    """`values` scattered into zeros of leading size `first_axis_dim`."""
    out = torch.zeros((first_axis_dim, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_copy(0, indices, values)


def _cu_seqlens(seqlens):
    return F.pad(torch.cumsum(seqlens, 0, dtype=torch.int32), (1, 0))


def unpad_input(hidden_states, attention_mask, unused_mask=None):
    """Remove padding tokens.

    hidden_states: (batch, seqlen, ...); attention_mask: (batch, seqlen),
    bool or int, 1 = valid token; unused_mask: (batch, seqlen), 1 =
    allocated but unused.  Returns (hidden (total_nnz, ...) with used and
    unused tokens kept, indices (total_nnz,), cu_seqlens (batch + 1,) of the
    kept lengths, max_seqlen, seqused (batch,) of the used lengths)."""
    mask = attention_mask.to(hidden_states.device).bool()
    all_masks = mask if unused_mask is None else (
        mask | unused_mask.to(mask.device).bool())
    seqlens = all_masks.sum(-1, dtype=torch.int32)
    used = mask.sum(-1, dtype=torch.int32)
    indices = torch.nonzero(all_masks.flatten()).flatten()
    max_seqlen = int(seqlens.max()) if seqlens.numel() else 0
    flat = hidden_states.reshape(-1, *hidden_states.shape[2:])
    return (index_first_axis(flat, indices), indices, _cu_seqlens(seqlens),
            max_seqlen, used)


def pad_input(hidden_states, indices, batch, seqlen):
    """Inverse of `unpad_input`: (total_nnz, ...) -> (batch, seqlen, ...)
    with zeros in the padded rows."""
    out = index_put_first_axis(hidden_states, indices, batch * seqlen)
    return out.reshape(batch, seqlen, *hidden_states.shape[1:])


def unpad_input_for_concatenated_sequences(hidden_states,
                                           attention_mask_in_length):
    """Unpad rows that each pack several sequences (`padding.py:81`).

    attention_mask_in_length: (batch, seqlen), row i holding the lengths of
    the sequences packed in it, then zeros.  Returns (hidden (total, ...),
    indices, cu_seqlens over all the sequences, max_seqlen)."""
    length = attention_mask_in_length.to(hidden_states.device)
    seqlen = length.shape[1]
    flat_len = length.flatten()
    seqlens = flat_len[flat_len > 0].to(torch.int32)
    used_per_row = length.sum(-1)
    row_mask = (torch.arange(seqlen, device=length.device)[None, :]
                < used_per_row[:, None])
    indices = torch.nonzero(row_mask.flatten()).flatten()
    max_seqlen = int(seqlens.max()) if seqlens.numel() else 0
    flat = hidden_states.reshape(-1, *hidden_states.shape[2:])
    return (index_first_axis(flat, indices), indices, _cu_seqlens(seqlens),
            max_seqlen)
