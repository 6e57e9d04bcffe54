"""LM loss with the head folded in (counterpart of
`flash_attn_tpu/training/loss.py`: `lm_head_weight:22`,
`chunked_lm_loss:37`).

The head and the cross-entropy run over `chunk_tokens`-token chunks of the
flattened hidden states; each chunk runs under
`torch.utils.checkpoint.checkpoint` (the role of `jax.checkpoint` at `:79`),
so no (n, vocab) float32 logits tensor stays alive for the backward: each
chunk's logits are recomputed there.  With `chunk_tokens >= n` (GPT-2 small
at batch 8: n = 8192 < 16384) the whole logits tensor is computed at once.
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from flash_attn_tpu_torch.losses.cross_entropy import cross_entropy_loss


def lm_head_weight(model):
    """(vocab, d) output-projection weight and the logit multiplier."""
    cfg = model.config
    if getattr(cfg, "tie_word_embeddings", True):
        w = model.transformer.embeddings.wte.weight
    else:
        w = model.lm_head.weight
    mult = getattr(cfg, "mup_output_multiplier", 1.0) if cfg.use_mup else 1.0
    return w, mult


def chunked_lm_loss(model, batch, chunk_tokens: int = 16384,
                    label_smoothing: float = 0.0,
                    lse_square_scale: float = 0.0, ignore_index: int = -100):
    """Mean next-token loss of `batch` (b, s+1) token ids, over the labels
    that are not `ignore_index`."""
    inputs, targets = batch[:, :-1], batch[:, 1:]
    hidden = model.transformer(inputs)
    b, s, d = hidden.shape
    n = b * s
    h2 = hidden.reshape(n, d)
    t2 = targets.reshape(n)
    w, mult = lm_head_weight(model)

    def chunk_loss(h_c, t_c):
        logits = (h_c @ w.t()).float()
        if mult != 1.0:
            logits = logits * mult
        losses, _ = cross_entropy_loss(
            logits, t_c, label_smoothing=label_smoothing,
            lse_square_scale=lse_square_scale, ignore_index=ignore_index)
        valid = (t_c != ignore_index).float()
        return (losses * valid).sum(), valid.sum()

    if chunk_tokens <= 0 or chunk_tokens >= n:
        loss_sum, n_valid = chunk_loss(h2, t2)
    else:
        loss_sum = n_valid = 0.0
        for i in range(0, n, chunk_tokens):
            ls, nv = checkpoint(chunk_loss, h2[i:i + chunk_tokens],
                                t2[i:i + chunk_tokens], use_reentrant=False)
            loss_sum = loss_sum + ls
            n_valid = n_valid + nv
    return loss_sum / n_valid.clamp(min=1.0)
