"""The port's `Trainer` on a tiny Llama against the JAX trainer, on the CPU
in float32: the JAX package's llama recipe
(`training/configs/experiment/pile-llama-1b.yaml`) at tiny widths, through
`ModelConfig`'s llama knobs (GQA, RMSNorm, full rotary, SwiGLU, untied
head) on both sides.

The JAX model runs its XLA reference attention (`use_flash_attn=False`), as
in `tests/test_torch_training.py`.  Tolerances as there: trainer losses
atol 2e-4 and grad norms atol 2e-3 (both trainers log them rounded to 4
and 3 decimals), final parameters atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from flash_attn_tpu.training import config as jax_config_mod
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu_torch.models.gpt import state_dict_from_jax_params
from flash_attn_tpu_torch.modules.block import Block
from flash_attn_tpu_torch.modules.mlp import GatedMlp
from flash_attn_tpu_torch.training.config import TrainConfig
from flash_attn_tpu_torch.training.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny torch ops run faster on one thread than with torch's threads
    contending with JAX's; module scope covers the module's fixtures."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def tiny_llama_config(tmp_path, port=True, **over):
    """The llama recipe's model knobs at 2 layers, n_embd 64, 4 heads over
    2 kv heads; seq_len 32, batch 2, float32, warmup 2."""
    cfg = TrainConfig() if port else jax_config_mod.TrainConfig()
    m = cfg.model
    m.name, m.n_embd, m.n_layer, m.n_head, m.n_head_kv = "llama", 64, 2, 4, 2
    m.vocab_size, m.max_position_embeddings = 128, 64
    m.rms_norm, m.rotary_emb_fraction = True, 1.0
    m.activation_function, m.tie_word_embeddings = "swiglu", False
    m.dtype = "float32"
    cfg.data.seq_len, cfg.data.batch_size = 32, 2
    cfg.trainer.log_every = 1
    cfg.trainer.resume = False
    cfg.trainer.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.optimizer.lr = 1e-3
    cfg.scheduler.warmup_steps = 2
    for key, val in over.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, val)
    return cfg


def test_llama_model_config_maps_like_jax(tmp_path):
    """`ModelConfig.to_gpt_config` against JAX's `to_gpt2_config` on the
    fields the model reads: rotary base 10000, rotate-half, positions
    dropped under rotary (no wpe)."""
    ours = tiny_llama_config(tmp_path).model.to_gpt_config()
    theirs = tiny_llama_config(tmp_path, port=False).model.to_gpt2_config()
    for field in ("n_embd", "n_layer", "n_head", "n_head_kv", "vocab_size",
                  "n_positions", "rms_norm", "rotary_emb_fraction",
                  "activation_function", "residual_in_fp32",
                  "tie_word_embeddings", "parallel_block"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.rotary_emb_base == 10000.0
    assert not ours.rotary_emb_interleaved
    t = Trainer(tiny_llama_config(tmp_path), device="cpu")
    tr = t.model.transformer
    assert tr.embeddings.wpe is None and tr.rotary_emb.dim == 16
    assert isinstance(tr.layers[0], Block) and tr.layers[0].norm1.is_rms
    assert isinstance(tr.layers[0].mlp, GatedMlp)
    assert tr.layers[0].mixer.num_heads_kv == 2
    assert t.model.lm_head is not None and t.model.lm_head.bias is None


def test_llama_trainer_matches_jax(tmp_path, monkeypatch):
    """The JAX Trainer and the port's from the same carried parameters, 3
    steps: per-step loss and grad norm, and the parameters at the end."""
    to_gpt2 = jax_config_mod.ModelConfig.to_gpt2_config

    def xla_attention(self):
        c = to_gpt2(self)
        c.use_flash_attn = False
        return c

    monkeypatch.setattr(jax_config_mod.ModelConfig, "to_gpt2_config",
                        xla_attention)
    steps = 3
    jt = JaxTrainer(tiny_llama_config(tmp_path / "j", port=False,
                                      trainer__max_steps=steps))
    tt = Trainer(tiny_llama_config(tmp_path / "t", trainer__max_steps=steps),
                 device="cpu")
    tt.model.load_state_dict(state_dict_from_jax_params(
        to_numpy_tree(jt.params), tt.gpt_config))
    logs_j, logs_t = [], []
    jt.train(log_fn=logs_j.append)
    tt.train(log_fn=logs_t.append)
    assert len(logs_t) == len(logs_j) == steps
    for mt, mj in zip(logs_t, logs_j):
        assert mt["step"] == mj["step"]
        assert abs(mt["loss"] - mj["loss"]) <= 2e-4, (mt, mj)
        assert abs(mt["grad_norm"] - mj["grad_norm"]) <= 2e-3, (mt, mj)
    expected = state_dict_from_jax_params(to_numpy_tree(jt.params),
                                          tt.gpt_config)
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), expected[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
