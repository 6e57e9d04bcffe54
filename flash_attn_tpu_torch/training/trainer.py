"""Config-driven single-device trainer (counterpart of
`flash_attn_tpu/training/trainer.py::Trainer:39-421` on a mesh of one device).

Two tasks, as in JAX: "lm" trains `GPTLMHeadModel` on a token stream with
the chunked LM loss; "image" trains `VisionTransformer` on (images, labels)
batches with softmax cross-entropy, augmenting on the device keyed by (seed,
step) (`:52-75`, `:176-190`).

Mixed precision follows the JAX defaults: float32 parameters (the master
weights) with the forward and the loss under `torch.autocast(device,
dtype)`, which is what flax's `dtype` against `param_dtype` does; dtype
"bfloat16" or "float16" (no loss scaler, as in JAX).  `param_dtype=
"bfloat16"` stores the parameters in bf16 and runs without autocast;
`dtype="float32"` runs everything in float32.  On CUDA every attention call
goes through the forward and backward kernels (`interface.flash_attn_func`).

With `trainer.ema_decay > 0` a float32 copy of the parameters follows each
update (`optim.ema_update`) and `evaluate(use_ema=True)` runs on it; the
plateau scheduler reacts to each evaluation (`_on_eval`, `:342-356`).

Checkpoints are `torch.save` files of the model, EMA, optimizer, scheduler,
step and loader state (the role of orbax at `:291-339`), so a resumed run
continues the exact data stream and update sequence.
"""

from __future__ import annotations

import contextlib
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
from flash_attn_tpu_torch.training.optim import (PlateauLR,
                                                 clip_by_global_norm,
                                                 ema_update, make_optimizer)


class Trainer:
    """GPT language-model or ViT image-classification trainer.
    `device=None` means CUDA and raises RuntimeError when there is none."""

    def __init__(self, config: TrainConfig, *, device=None):
        self.device = default_device(device)
        check_supported(config)
        self.config = config
        mc, tc, dc = config.model, config.trainer, config.data
        self.task = mc.task
        param_dtype = getattr(torch, mc.param_dtype)
        gen = torch.Generator().manual_seed(tc.seed)
        if self.task == "image":
            from flash_attn_tpu_torch.models.vit import VisionTransformer
            from flash_attn_tpu_torch.training.vision_data import \
                make_image_loader

            size = int(dc.image_size or mc.image_size)
            dc.image_size = size
            self.gpt_config = None
            self.model = VisionTransformer(
                img_size=size, patch_size=mc.patch_size,
                num_classes=mc.num_classes, embed_dim=mc.n_embd,
                depth=mc.n_layer, num_heads=mc.n_head,
                mlp_ratio=mc.mlp_ratio, global_pool=mc.global_pool,
                device=self.device, dtype=param_dtype)
            self.loader = make_image_loader(dc, mc.num_classes)
        else:
            self.gpt_config = mc.to_gpt_config()
            self.model = GPTLMHeadModel(self.gpt_config, device=self.device,
                                        dtype=param_dtype)
            self.loader = make_loader(dc, mc.vocab_size)
        self.model.init_weights(gen)
        compute = getattr(torch, mc.dtype)
        self.autocast = (compute in (torch.bfloat16, torch.float16)
                         and param_dtype == torch.float32)
        self.autocast_dtype = compute
        self.optimizer, self.scheduler = make_optimizer(
            config.optimizer, config.scheduler, self.model)
        self.ema_params = ([p.detach().float().clone()
                            for p in self.model.parameters()]
                           if tc.ema_decay > 0.0 else None)
        self.step = 0
        self.accum = max(1, tc.accumulate_grad_batches)
        if self.task == "image":
            units_per_step = dc.batch_size * self.accum
            self.flops = None
        else:
            units_per_step = dc.batch_size * dc.seq_len * self.accum
            self.flops = FlopCount(self.gpt_config, units_per_step)
        self.speed = SpeedMonitor(units_per_step)
        self.perplexity = Perplexity()
        self.ckpt_dir = Path(tc.checkpoint_dir).absolute()

    # ------------------------------------------------------------------
    def loss(self, batch, step: int = 0, train: bool = True) -> torch.Tensor:
        """Mean loss of one batch (numpy or tensors), with the forward under
        autocast where mixed precision is on: next-token loss of a (b, s+1)
        token batch, or the cross-entropy of an (images, labels) batch,
        augmented with the draws of (seed, step) when `train`."""
        with torch.autocast(self.device.type, dtype=self.autocast_dtype,
                            enabled=self.autocast):
            if self.task == "image":
                return self._image_loss(batch, step, train)[0]
            ids = torch.as_tensor(batch, device=self.device).long()
            return chunked_lm_loss(self.model, ids,
                                   chunk_tokens=self.config.trainer.
                                   ce_chunk_tokens)

    def _image_loss(self, batch, step, train):
        """(loss, accuracy) of an (images, labels) batch (`:176-190`)."""
        from flash_attn_tpu_torch.training.vision_data import (augment_batch,
                                                               augment_draws,
                                                               step_generator)

        images, labels = (torch.as_tensor(x, device=self.device)
                          for x in batch)
        labels = labels.long()
        train = train and self.config.data.augment
        draws = (augment_draws(images.shape[0], step_generator(
            self.config.trainer.seed, step)) if train else None)
        x = augment_batch(images, draws, train=train)
        logits = self.model(x).float()
        loss = torch.nn.functional.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    def train_step(self, batch):
        """One optimizer update, then the EMA.  `batch` is one batch, or
        `accumulate_grad_batches` of them stacked on a leading axis: the
        micro-batches' gradients are summed in float32 and divided by their
        number (`trainer.py:237-252`).  Returns (loss, grad_norm before
        clipping), float32 scalar tensors on the device."""
        params = list(self.model.parameters())
        if self.accum == 1:
            micros = [batch]
        elif isinstance(batch, tuple):
            micros = list(zip(*batch))
        else:
            micros = list(batch)
        loss_sum, acc = 0.0, None
        for i, mb in enumerate(micros):
            loss = self.loss(mb, step=self.step * self.accum + i
                             if self.accum > 1 else self.step)
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
        if self.ema_params is not None:
            ema_update(self.ema_params, params, self.config.trainer.ema_decay)
        self.step += 1
        return loss_sum / self.accum, gnorm

    def _next_batch(self):
        if self.accum == 1:
            return next(self.loader)
        micros = [next(self.loader) for _ in range(self.accum)]
        if isinstance(micros[0], tuple):
            return tuple(np.stack(xs) for xs in zip(*micros))
        return np.stack(micros)

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
        if self.ema_params is not None:
            state["ema"] = self.ema_params
        tmp = path / f"state.pt.tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, path / "state.pt")

    def load_checkpoint(self, path, loader: bool = True):
        """Restore the state saved under `path` (a `step_<n>` directory):
        model, EMA, optimizer, scheduler and step, and with `loader` the
        data position."""
        state = torch.load(Path(path) / "state.pt", map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        if self.ema_params is not None and "ema" in state:
            for e, s in zip(self.ema_params, state["ema"]):
                e.copy_(s)
        if loader:
            self.loader.state = LoaderState.from_dict(state["loader"])

    def maybe_resume(self) -> bool:
        """Load the newest checkpoint under `checkpoint_dir`, if any."""
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.ckpt_dir.glob("step_*")
                       if (p / "state.pt").exists())
        if not steps:
            return False
        self.load_checkpoint(self.ckpt_dir / f"step_{steps[-1]}")
        return True

    # ------------------------------------------------------------------
    def _on_eval(self, eval_loss: float):
        """The plateau scheduler's reaction to an evaluation."""
        if isinstance(self.scheduler, PlateauLR):
            self.scheduler.on_eval(eval_loss)

    def train(self, log_fn=None) -> float:
        """The training loop (`trainer.py:357-410`): log every `log_every`
        steps and at the last (loss, grad_norm, and for the LM ppl and
        TFLOPs; tokens_per_s counts images for the image task), evaluate
        every `eval_every`, checkpoint every `checkpoint_every`.  Returns
        the last loss."""
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
                n = batch[1].size if isinstance(batch, tuple) else batch.size
                self.perplexity.update(loss_f * n, n)
                msg = {"loss": round(loss_f, 4),
                       "grad_norm": round(float(gnorm), 3)}
                if self.task != "image":
                    msg["ppl"] = round(self.perplexity.compute(), 2)
                if stats:
                    msg["tokens_per_s"] = int(stats["tokens_per_s"])
                    if self.flops is not None:
                        msg["TFLOPs"] = round(
                            self.flops.tflops(stats["steps_per_s"]), 1)
                emit(self.step, msg)
            if tc.eval_every and self.step % tc.eval_every == 0:
                ev = self.evaluate()
                self._on_eval(ev)
                emit(self.step, {"eval_loss": ev})
            if tc.checkpoint_every and self.step % tc.checkpoint_every == 0:
                self.save_checkpoint()
        loggers.close()
        return float(loss)

    @contextlib.contextmanager
    def _ema_weights(self):
        """The model's parameters hold the EMA (in their own dtype) inside
        the block, their own values again after it."""
        params = list(self.model.parameters())
        live = [p.data for p in params]
        try:
            for p, e in zip(params, self.ema_params):
                p.data = e.to(p.dtype)
            yield
        finally:
            for p, d in zip(params, live):
                p.data = d

    @torch.no_grad()
    def evaluate(self, use_ema: bool = False) -> float:
        """Mean loss over `eval_steps` batches of the loader, on the EMA
        parameters with `use_ema` (where there is an EMA), without
        augmentation (`trainer.py:412-423`)."""
        ema = use_ema and self.ema_params is not None
        with self._ema_weights() if ema else contextlib.nullcontext():
            losses = [float(self.loss(next(self.loader), train=False))
                      for _ in range(self.config.trainer.eval_steps)]
        return float(np.mean(losses))


def train(config: TrainConfig, log_fn=print, device=None) -> float:
    """Build a `Trainer` and run its loop."""
    return Trainer(config, device=device).train(log_fn=log_fn)
