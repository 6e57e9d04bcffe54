"""Cross-entropy with label smoothing and z-loss (counterpart of
`flash_attn_tpu/losses/cross_entropy.py`: `cross_entropy_loss:22`,
`CrossEntropyLoss:90`).

Plain PyTorch, differentiated by autograd, as the JAX package leaves it to
XLA.  `axis_name` (vocab-parallel tensor parallelism) raises
`NotImplementedError`; `inplace_backward` is accepted and does nothing.
"""

from __future__ import annotations

import torch


def cross_entropy_loss(logits, labels, label_smoothing: float = 0.0,
                       logit_scale: float = 1.0,
                       lse_square_scale: float = 0.0,
                       ignore_index: int = -100, axis_name=None):
    """Per-token losses.  logits: (n, vocab); labels: (n,).  Returns (losses
    (n,), z_losses (n,)) in float32, both 0 where labels == ignore_index."""
    if axis_name is not None:
        raise NotImplementedError("vocab-parallel cross-entropy is not "
                                  "ported yet")
    logits = logits.float()
    if logit_scale != 1.0:
        logits = logits * logit_scale
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != ignore_index
    idx = torch.where(valid, labels, 0).long()
    x_label = logits.gather(-1, idx[:, None])[:, 0]
    if label_smoothing > 0.0:
        smooth = logits.sum(-1) / logits.shape[-1]
        losses = ((1.0 - label_smoothing) * (lse - x_label)
                  + label_smoothing * (lse - smooth))
    else:
        losses = lse - x_label
    z_losses = lse_square_scale * lse * lse
    losses = losses + z_losses
    zero = torch.zeros((), dtype=losses.dtype, device=losses.device)
    return torch.where(valid, losses, zero), torch.where(valid, z_losses, zero)


class CrossEntropyLoss(torch.nn.Module):
    """Module form of `cross_entropy_loss` (`cross_entropy.py:90`);
    reduction "mean" divides by the number of labels != ignore_index."""

    def __init__(self, ignore_index: int = -100, reduction: str = "mean",
                 label_smoothing: float = 0.0, logit_scale: float = 1.0,
                 lse_square_scale: float = 0.0,
                 inplace_backward: bool = False, axis_name=None,
                 return_z_loss: bool = False):
        super().__init__()
        if reduction not in ("mean", "none", "sum"):
            raise ValueError(f"reduction {reduction!r}")
        if axis_name is not None:
            raise NotImplementedError("vocab-parallel cross-entropy is not "
                                      "ported yet")
        del inplace_backward  # a memory trick of the CUDA reference
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.label_smoothing = label_smoothing
        self.logit_scale = logit_scale
        self.lse_square_scale = lse_square_scale
        self.return_z_loss = return_z_loss

    def forward(self, logits, labels):
        losses, z_losses = cross_entropy_loss(
            logits, labels, label_smoothing=self.label_smoothing,
            logit_scale=self.logit_scale,
            lse_square_scale=self.lse_square_scale,
            ignore_index=self.ignore_index)
        if self.reduction == "mean":
            nvalid = (labels != self.ignore_index).sum().clamp(min=1)
            loss, z_loss = losses.sum() / nvalid, z_losses.sum() / nvalid
        elif self.reduction == "sum":
            loss, z_loss = losses.sum(), z_losses.sum()
        else:
            loss, z_loss = losses, z_losses
        return (loss, z_loss) if self.return_z_loss else loss
