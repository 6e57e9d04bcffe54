"""Training metrics (counterpart of `flash_attn_tpu/training/callbacks.py`:
`SpeedMonitor:18`, `model_flops_per_token:40`, `FlopCount:52`,
`global_norm:60`, `NormMonitor:69`, `causality_check:77`,
`Perplexity:92`, `NumTokens:109`).
"""

from __future__ import annotations

import time

import numpy as np
import torch


class SpeedMonitor:
    """steps/s and tokens/s since the first call (host clock)."""

    def __init__(self, tokens_per_step: int):
        self.tokens_per_step = tokens_per_step
        self._t0 = None
        self._steps = 0

    def step(self):
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            self._steps = 0
            return {}
        self._steps += 1
        dt = now - self._t0
        return {
            "steps_per_s": self._steps / dt,
            "tokens_per_s": self._steps * self.tokens_per_step / dt,
        }


def model_flops_per_token(config) -> int:
    """6 N + attention FLOPs per token, forward and backward (causal)."""
    n_embd = config.hidden_size
    n_layer = config.num_hidden_layers
    vocab = config.vocab_size
    seq = getattr(config, "n_positions", 1024) or 1024
    n_params = 12 * n_layer * n_embd * n_embd + vocab * n_embd
    attn = 12 * n_layer * n_embd * seq // 2  # causal
    return 6 * n_params + 2 * attn


class FlopCount:
    def __init__(self, config, tokens_per_step: int):
        self.flops_per_step = model_flops_per_token(config) * tokens_per_step

    def tflops(self, steps_per_s: float) -> float:
        return self.flops_per_step * steps_per_s / 1e12


def global_norm(tensors) -> float:
    """The float32 L2 norm of all `tensors` together."""
    return float(torch.sqrt(sum(t.float().square().sum() for t in tensors)))


class NormMonitor:
    """The global norms of the parameters and of their gradients."""

    def __call__(self, params, grads):
        return {"param_norm": global_norm(params),
                "grad_norm": global_norm(grads)}


@torch.no_grad()
def causality_check(model, input_ids, pos: int, atol=1e-3) -> bool:
    """Perturb the tokens after `pos`: the logits at positions <= pos must
    stay within `atol` (the JAX check takes `apply_fn` and params; this one
    the model)."""
    logits = model(input_ids).logits
    perturbed = input_ids.clone()
    perturbed[:, pos + 1:] = (input_ids[:, pos + 1:] + 1) % logits.shape[-1]
    logits_p = model(perturbed).logits
    diff = (logits[:, : pos + 1].float()
            - logits_p[:, : pos + 1].float()).abs().max()
    return bool(diff <= atol)


class Perplexity:
    """Running perplexity: exp(total nll / total tokens)."""

    def __init__(self):
        self.total_nll = 0.0
        self.total_tokens = 0

    def update(self, loss_sum: float, n_tokens: int):
        self.total_nll += loss_sum
        self.total_tokens += n_tokens

    def compute(self) -> float:
        if self.total_tokens == 0:
            return float("nan")
        return float(np.exp(self.total_nll / self.total_tokens))


class NumTokens:
    """Monotone token counter that survives checkpoint resume."""

    def __init__(self, count: int = 0):
        self.count = count

    def update(self, n: int):
        self.count += n
