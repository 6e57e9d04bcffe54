"""Optimizer, learning-rate schedules and EMA (counterpart of
`flash_attn_tpu/training/optim.py`: `decay_mask:16`, `make_schedule:31`,
`make_optimizer:89`, `ema_update:115`).

The JAX optimizer is the optax chain clip-by-global-norm -> Adam (bias
corrected, eps outside the square root) -> decoupled weight decay where
`decay_mask` holds -> scale by -lr * sched(count), with count the number of
updates already made.  Here `clip_by_global_norm` does the first link and
`torch.optim.AdamW` with two parameter groups (decay and no decay) under a
`LambdaLR` of the same schedule does the rest; the tests hold the two to
each other.  The plateau scheduler is `PlateauLR`: the schedule's warm-up
times a factor that `on_eval` shrinks when the eval loss stops improving
(JAX keeps that factor in `opt_state.hyperparams["lr_mult"]` and the
Trainer's `_on_eval`, `trainer.py:342-356`, shrinks it).
"""

from __future__ import annotations

import math

import torch


def decay_mask(model) -> dict[str, bool]:
    """{name: True where weight decay applies}: matrices only, not the
    embeddings (wte, wpe), biases or norm weights."""
    return {name: p.ndim >= 2 and not any(
                k in name for k in ("embedding", "wte", "wpe"))
            for name, p in model.named_parameters()}


def _linear(init, end, steps):
    """optax.linear_schedule / polynomial_schedule with power 1."""
    return _poly(init, end, 1.0, steps)


def _poly(init, end, power, steps):
    """optax.polynomial_schedule: constant `init` when steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end

    return schedule


def _join(schedules, boundaries):
    """optax.join_schedules: schedule i + 1 from boundary i, on count -
    boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


def make_schedule(cfg):
    """The learning-rate multiplier as a function of the update count."""
    warmup = _linear(0.0, 1.0, cfg.warmup_steps)
    if cfg.name == "constant":
        return lambda count: 1.0
    if cfg.name == "linear":
        return warmup
    if cfg.name == "step":
        # As the JAX code does: step_size 0 gives 1, not decay_steps // 3.
        size = max(cfg.step_size, 1)
        return lambda count: cfg.gamma ** (count // size)
    if cfg.name == "multistep":
        miles = tuple(cfg.milestones
                      or (cfg.decay_steps // 2, 3 * cfg.decay_steps // 4))
        return lambda count: cfg.gamma ** sum(count >= m for m in miles)
    if cfg.name == "invsqrt":
        w = max(cfg.warmup_steps, 1)

        def invsqrt(count):
            s = max(float(count), 1.0)
            return s / w if s < w else (w / s) ** 0.5

        return invsqrt
    if cfg.name == "poly":
        decay = _poly(1.0, cfg.min_lr_ratio, cfg.power,
                      max(cfg.decay_steps - cfg.warmup_steps, 1))
        return _join([warmup, decay], [cfg.warmup_steps])
    if cfg.name == "cosine":
        steps = max(cfg.decay_steps - cfg.warmup_steps, 1)

        def decay(count):
            c = min(count, steps)
            cos = 0.5 * (1.0 + math.cos(math.pi * c / steps))
            return (1.0 - cfg.min_lr_ratio) * cos + cfg.min_lr_ratio

        return _join([warmup, decay], [cfg.warmup_steps])
    if cfg.name == "plateau":
        # the warm-up, then 1; PlateauLR applies the factor
        w = max(cfg.warmup_steps, 1)
        return lambda count: (count / w if count < cfg.warmup_steps
                              else 1.0)
    raise ValueError(f"unknown scheduler {cfg.name!r}")


def make_optimizer(opt_cfg, sched_cfg, model):
    """(torch.optim.AdamW, LambdaLR) for `model`: weight decay only where
    `decay_mask` holds, lr = opt_cfg.lr * sched(count).  Call
    `clip_by_global_norm` before `optimizer.step()` and `scheduler.step()`
    after it."""
    mask = decay_mask(model)
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if mask[n]],
         "weight_decay": opt_cfg.weight_decay},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    optimizer = torch.optim.AdamW(
        [g for g in groups if g["params"]], lr=opt_cfg.lr,
        betas=(opt_cfg.beta1, opt_cfg.beta2), eps=opt_cfg.eps)
    if sched_cfg.name == "plateau":
        scheduler = PlateauLR(optimizer, make_schedule(sched_cfg),
                              gamma=sched_cfg.gamma,
                              patience=sched_cfg.plateau_patience,
                              min_delta=sched_cfg.plateau_min_delta)
    else:
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, make_schedule(sched_cfg))
    return optimizer, scheduler


class PlateauLR(torch.optim.lr_scheduler.LambdaLR):
    """ReduceLROnPlateau over a schedule: lr = base lr * schedule(count) *
    lr_mult, where `on_eval` multiplies lr_mult by `gamma` after `patience`
    evaluations in a row that did not improve on the best loss by more than
    `min_delta`.  Its state (lr_mult, best, bad) is in `state_dict`."""

    def __init__(self, optimizer, schedule, *, gamma: float, patience: int,
                 min_delta: float = 0.0):
        self.lr_mult = 1.0
        self.best = float("inf")
        self.bad = 0
        self.gamma, self.patience, self.min_delta = gamma, patience, min_delta
        super().__init__(optimizer,
                         lambda count: schedule(count) * self.lr_mult)

    def on_eval(self, eval_loss: float):
        if eval_loss < self.best - self.min_delta:
            self.best, self.bad = eval_loss, 0
            return
        self.bad += 1
        if self.bad >= self.patience:
            self.bad = 0
            self.lr_mult *= self.gamma
            # the next update runs at the new factor, as optax's injected
            # hyperparameter does
            self._last_lr = [base * fn(self.last_epoch) for base, fn in
                             zip(self.base_lrs, self.lr_lambdas)]
            for group, lr in zip(self.optimizer.param_groups, self._last_lr):
                group["lr"] = lr


@torch.no_grad()
def ema_update(ema_params, params, decay: float):
    """ema = ema * decay + p * (1 - decay), in place, in the EMA's dtype
    (float32), over lists of tensors."""
    params = [p.to(e.dtype) for e, p in zip(ema_params, params)]
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the `.grad` of `params`: every gradient
    times min(1, max_norm / norm) when max_norm > 0.  Returns the global
    norm before clipping (float32 scalar tensor, no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    if max_norm > 0:
        coef = torch.clamp(max_norm / norm, max=1.0)
        for g in grads:
            g.mul_(coef.to(g.dtype))
    return norm
