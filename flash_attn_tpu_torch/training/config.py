"""Typed training configuration (counterpart of
`flash_attn_tpu/training/config.py`: the dataclasses `:16-174`, `_merge:177`,
`load_config:189`).

The dataclasses, their fields and defaults are the JAX package's, so a YAML
file or override dict written for one loads into the other.
`ModelConfig.to_gpt_config` builds the port's `GPTConfig` directly (the JAX
`to_gpt2_config` goes through `transformers`).  Settings this port does not
cover yet raise `NotImplementedError` in `check_supported`, which the
`Trainer` calls: a mesh other than 1x1x1, ZeRO, and hub datasets or
tokenizers (they need the network and `transformers`; only
`tokenizer="bytes"` over local .txt / .jsonl files is ported).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from flash_attn_tpu_torch.models.gpt import GPTConfig


@dataclass
class ModelConfig:
    name: str = "gpt2-small"
    task: str = "lm"  # "lm" (GPT) or "image" (ViT classification)
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_head_kv: Optional[int] = None
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    rms_norm: bool = False
    rotary_emb_fraction: float = 0.0
    activation_function: str = "gelu_new"
    residual_in_fp32: bool = True
    tie_word_embeddings: bool = True
    parallel_block: bool = False
    # compute dtype: "bfloat16" or "float16" runs the forward and the loss
    # under torch.autocast over parameters stored in `param_dtype` (float16
    # with no loss scaler, as in JAX)
    dtype: str = "bfloat16"
    # "float32": fp32 master weights (mixed precision); "bfloat16": the
    # parameters themselves are bf16 and no autocast runs
    param_dtype: str = "float32"
    # per-block activation checkpointing; remat_policy "none" recomputes
    # the whole block, "dots" / "dots_no_batch" keep the matmul outputs
    remat_blocks: bool = False
    remat_policy: str = "none"
    # image-task (ViT) fields
    patch_size: int = 16
    image_size: int = 224
    num_classes: int = 1000
    global_pool: str = "token"
    mlp_ratio: float = 4.0

    def to_gpt_config(self) -> GPTConfig:
        """The port's GPTConfig, with dropout off as in the JAX
        `to_gpt2_config` (`config.py:55-74`)."""
        return GPTConfig(
            n_embd=self.n_embd, n_layer=self.n_layer, n_head=self.n_head,
            n_head_kv=self.n_head_kv, vocab_size=self.vocab_size,
            n_positions=self.max_position_embeddings,
            activation_function=self.activation_function,
            rms_norm=self.rms_norm,
            rotary_emb_fraction=self.rotary_emb_fraction,
            residual_in_fp32=self.residual_in_fp32,
            tie_word_embeddings=self.tie_word_embeddings,
            parallel_block=self.parallel_block,
            remat_blocks=self.remat_blocks, remat_policy=self.remat_policy)


@dataclass
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 6e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    shard_optimizer_state: bool = False  # ZeRO: not ported
    zero_stage: int = 0


@dataclass
class SchedulerConfig:
    # cosine | linear | constant | step | multistep | invsqrt | poly |
    # plateau
    name: str = "cosine"
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    gamma: float = 0.1               # step / multistep / plateau factor
    step_size: int = 0               # step (0 = decay_steps // 3)
    milestones: Optional[list] = None  # multistep
    power: float = 1.0               # poly
    plateau_patience: int = 3
    plateau_min_delta: float = 0.0


@dataclass
class DataConfig:
    # synthetic | <path to token .npy/.bin>; for the image task synthetic
    # | <.npz shard or ImageFolder directory>
    dataset: str = "synthetic"
    seq_len: int = 1024
    batch_size: int = 8
    seed: int = 0
    # local-text datamodule (`hf_data`): text_files with tokenizer "bytes";
    # hub datasets and tokenizers are not ported
    hf_dataset: Optional[str] = None
    hf_config: Optional[str] = None
    text_files: Optional[list] = None
    tokenizer: str = "gpt2"
    detokenizer: Optional[str] = None
    max_examples: int = 0
    cache_dir: str = ".hf_token_cache"
    image_size: Optional[int] = None
    augment: bool = True


@dataclass
class MeshConfig:
    data: int = 1
    model: int = 1
    seq: int = 1
    dcn_data: int = 1


@dataclass
class TrainerConfig:
    max_steps: int = 100
    log_every: int = 10
    eval_every: int = 0
    eval_steps: int = 10
    checkpoint_every: int = 0
    checkpoint_dir: str = "checkpoints"
    resume: bool = True
    seed: int = 0
    ema_decay: float = 0.0
    # loggers: stdout | jsonl | csv | tensorboard | wandb | mlflow
    loggers: Optional[list] = None
    out_dir: str = "runs"
    # chunked LM-head cross-entropy: tokens per chunk (0 = unchunked)
    ce_chunk_tokens: int = 16384
    accumulate_grad_batches: int = 1


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)


def check_supported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for settings this port does not cover."""
    m, d = cfg.mesh, cfg.data
    unsupported = {
        "mesh other than 1x1x1": (m.dcn_data, m.data, m.model, m.seq)
        != (1, 1, 1, 1),
        "ZeRO": cfg.optimizer.zero_stage > 0
        or cfg.optimizer.shard_optimizer_state,
        "hub datasets (only local .txt / .jsonl data.text_files are "
        "ported)": bool(d.hf_dataset),
        f"tokenizer {d.tokenizer!r} (only tokenizer='bytes' is ported)":
            bool(d.text_files) and d.tokenizer not in ("bytes", "byte"),
        f"model.task {cfg.model.task!r}": cfg.model.task not in ("lm",
                                                                  "image"),
        f"model.dtype {cfg.model.dtype!r}":
            cfg.model.dtype not in ("float32", "bfloat16", "float16"),
        f"model.param_dtype {cfg.model.param_dtype!r}":
            cfg.model.param_dtype not in ("float32", "bfloat16"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"training settings not ported yet: {', '.join(bad)}")


def _merge(dc, overrides: dict):
    for k, v in overrides.items():
        if not hasattr(dc, k):
            raise KeyError(f"unknown config key {k!r} for {type(dc).__name__}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge(cur, v)
        else:
            setattr(dc, k, v)
    return dc


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None,
                base: Optional[TrainConfig] = None) -> TrainConfig:
    """Compose a TrainConfig from an optional YAML file and dict overrides."""
    cfg = base or TrainConfig()
    if path is not None:
        import yaml

        with open(path) as f:
            _merge(cfg, yaml.safe_load(f) or {})
    if overrides:
        _merge(cfg, overrides)
    return cfg
