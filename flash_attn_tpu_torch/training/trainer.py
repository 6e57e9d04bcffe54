"""Config-driven single-device trainer (counterpart of
`flash_attn_tpu/training/trainer.py::Trainer:39-421` on a mesh of one device).

Mixed precision follows the JAX defaults: float32 parameters (the master
weights) with the forward and the loss under
`torch.autocast(device, dtype=torch.bfloat16)`, which is what flax's `dtype`
against `param_dtype` does.  `param_dtype="bfloat16"` stores the parameters
in bf16 and runs without autocast; `dtype="float32"` runs everything in
float32.  On CUDA every attention call goes through the forward and backward
kernels (`interface.flash_attn_func`).

Checkpoints are `torch.save` files of the model, optimizer, scheduler, step
and loader state (the role of orbax at `:291-339`), so a resumed run
continues the exact token stream and update sequence.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel
from flash_attn_tpu_torch.training.callbacks import (FlopCount, Perplexity,
                                                     SpeedMonitor)
from flash_attn_tpu_torch.training.config import TrainConfig, check_supported
from flash_attn_tpu_torch.training.data import LoaderState, make_loader
from flash_attn_tpu_torch.training.loggers import make_loggers
from flash_attn_tpu_torch.training.loss import chunked_lm_loss
from flash_attn_tpu_torch.training.optim import (clip_by_global_norm,
                                                 make_optimizer)


class Trainer:
    """GPT language-model trainer.  `device=None` means CUDA and raises
    RuntimeError when there is none."""

    def __init__(self, config: TrainConfig, *, device=None):
        self.device = default_device(device)
        check_supported(config)
        self.config = config
        mc, tc = config.model, config.trainer
        self.gpt_config = mc.to_gpt_config()
        param_dtype = getattr(torch, mc.param_dtype)
        self.model = GPTLMHeadModel(self.gpt_config, device=self.device,
                                    dtype=param_dtype)
        self.model.init_weights(torch.Generator().manual_seed(tc.seed))
        self.autocast = mc.dtype == "bfloat16" and param_dtype == torch.float32
        self.loader = make_loader(config.data, mc.vocab_size)
        self.optimizer, self.scheduler = make_optimizer(
            config.optimizer, config.scheduler, self.model)
        self.step = 0
        self.accum = max(1, tc.accumulate_grad_batches)
        tokens_per_step = (config.data.batch_size * config.data.seq_len
                           * self.accum)
        self.flops = FlopCount(self.gpt_config, tokens_per_step)
        self.speed = SpeedMonitor(tokens_per_step)
        self.perplexity = Perplexity()
        self.ckpt_dir = Path(tc.checkpoint_dir).absolute()

    def loss(self, batch) -> torch.Tensor:
        """Mean next-token loss of one (b, s+1) token batch (numpy or
        tensor), with the forward under autocast where mixed precision is
        on."""
        ids = torch.as_tensor(batch, device=self.device).long()
        chunk = self.config.trainer.ce_chunk_tokens
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            return chunked_lm_loss(self.model, ids, chunk_tokens=chunk)

    def train_step(self, batch):
        """One optimizer update.  `batch` is (b, s+1) tokens, or
        (accumulate_grad_batches, b, s+1): the micro-batches' gradients are
        summed in float32 and divided by their number (`trainer.py:237-252`).
        Returns (loss, grad_norm before clipping), float32 scalar tensors on
        the device."""
        params = list(self.model.parameters())
        micros = [batch] if self.accum == 1 else list(batch)
        loss_sum, acc = 0.0, None
        for mb in micros:
            loss = self.loss(mb)
            loss.backward()
            loss_sum = loss_sum + loss.detach().float()
            if self.accum > 1:
                grads = [p.grad.float() for p in params]
                acc = grads if acc is None else [
                    a.add_(g) for a, g in zip(acc, grads)]
                for p in params:
                    p.grad = None
        if self.accum > 1:
            for p, a in zip(params, acc):
                p.grad = (a / self.accum).to(p.dtype)
        gnorm = clip_by_global_norm(params, self.config.optimizer.grad_clip)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return loss_sum / self.accum, gnorm

    def _next_batch(self):
        if self.accum == 1:
            return next(self.loader)
        return np.stack([next(self.loader) for _ in range(self.accum)])

    # ------------------------------------------------------------------
    def save_checkpoint(self):
        path = self.ckpt_dir / f"step_{self.step}"
        path.mkdir(parents=True, exist_ok=True)
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
            "loader": self.loader.state.to_dict(),
        }
        tmp = path / f"state.pt.tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, path / "state.pt")

    def maybe_resume(self) -> bool:
        """Load the newest checkpoint under `checkpoint_dir`, if any."""
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.ckpt_dir.glob("step_*")
                       if (p / "state.pt").exists())
        if not steps:
            return False
        state = torch.load(self.ckpt_dir / f"step_{steps[-1]}" / "state.pt",
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        self.loader.state = LoaderState.from_dict(state["loader"])
        return True

    # ------------------------------------------------------------------
    def train(self, log_fn=None) -> float:
        """The training loop (`trainer.py:357-410`): log every `log_every`
        steps and at the last (loss, grad_norm, ppl, tokens_per_s, TFLOPs),
        evaluate every `eval_every`, checkpoint every `checkpoint_every`.
        Returns the last loss."""
        tc = self.config.trainer
        loggers = make_loggers(tc.loggers, tc.out_dir)
        emit = (lambda step, m: (log_fn({"step": step, **m})
                                 if log_fn else loggers.log(step, m)))
        if tc.resume and self.maybe_resume():
            emit(self.step, {"event": "resumed"})
        loss = torch.tensor(float("nan"))
        while self.step < tc.max_steps:
            batch = self._next_batch()
            loss, gnorm = self.train_step(batch)
            stats = self.speed.step()
            if self.step % tc.log_every == 0 or self.step == tc.max_steps:
                loss_f = float(loss)
                self.perplexity.update(loss_f * batch.size, batch.size)
                msg = {"loss": round(loss_f, 4),
                       "grad_norm": round(float(gnorm), 3),
                       "ppl": round(self.perplexity.compute(), 2)}
                if stats:
                    msg["tokens_per_s"] = int(stats["tokens_per_s"])
                    msg["TFLOPs"] = round(
                        self.flops.tflops(stats["steps_per_s"]), 1)
                emit(self.step, msg)
            if tc.eval_every and self.step % tc.eval_every == 0:
                emit(self.step, {"eval_loss": self.evaluate()})
            if tc.checkpoint_every and self.step % tc.checkpoint_every == 0:
                self.save_checkpoint()
        loggers.close()
        return float(loss)

    @torch.no_grad()
    def evaluate(self) -> float:
        """Mean loss over `eval_steps` batches of the loader."""
        losses = [float(self.loss(next(self.loader)))
                  for _ in range(self.config.trainer.eval_steps)]
        return float(np.mean(losses))


def train(config: TrainConfig, log_fn=print, device=None) -> float:
    """Build a `Trainer` and run its loop."""
    return Trainer(config, device=device).train(log_fn=log_fn)
