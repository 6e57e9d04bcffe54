"""GPT-J: config conversion and the HF weight remap (counterpart of
`flash_attn_tpu/models/gptj.py`: `gptj_config_to_gpt2_config:11`,
`remap_state_dict_hf_gptj:44`).  Interleaved partial rotary (`rotary_dim`
of each head's features), parallel blocks under one tied LayerNorm, no
q/k/v or out-projection biases, and an untied head with a bias.  GPT-J-6B's
head dim is 256 (4096 over 16 heads)."""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models.common import (as_tensors,
                                                canonical_to_state_dict)
from flash_attn_tpu_torch.models.gpt import GPTConfig


def gptj_config_to_gpt2_config(gptj_config) -> GPTConfig:
    c = gptj_config
    return GPTConfig(
        vocab_size=c.vocab_size, n_positions=0, n_embd=c.n_embd,
        n_layer=c.n_layer, n_head=c.n_head, n_inner=c.n_inner,
        activation_function=c.activation_function,
        layer_norm_epsilon=c.layer_norm_epsilon,
        rotary_emb_fraction=c.rotary_dim / (c.n_embd // c.n_head),
        rotary_emb_interleaved=True, tie_word_embeddings=False,
        qkv_proj_bias=False, out_proj_bias=False, parallel_block=True,
        parallel_block_tied_norm=True, lm_head_bias=True,
        **{k: getattr(c, k, 0.0) for k in ("resid_pdrop", "embd_pdrop",
                                           "attn_pdrop")})


def remap_state_dict_hf_gptj(state_dict, config: GPTConfig):
    """HF `GPTJForCausalLM` -> the port's state_dict: q, k and v
    projections stacked into `Wqkv`; the causal-mask buffers dropped."""
    sd = as_tensors(state_dict)
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("transformer.wte.weight")}
    for n in ("weight", "bias"):
        cd[f"lm_head.{n}"] = sd.pop(f"lm_head.{n}")
        cd[f"transformer.ln_f.{n}"] = sd.pop(f"transformer.ln_f.{n}")
    for i in range(config.n_layer):
        hf, our = f"transformer.h.{i}.", f"transformer.layers.{i}."
        cd[our + "mixer.Wqkv.weight"] = torch.cat(
            [sd.pop(f"{hf}attn.{w}_proj.weight") for w in "qkv"])
        cd[our + "mixer.out_proj.weight"] = sd.pop(hf + "attn.out_proj.weight")
        for n in ("weight", "bias"):
            cd[f"{our}norm1.{n}"] = sd.pop(f"{hf}ln_1.{n}")
            cd[f"{our}mlp.fc1.{n}"] = sd.pop(f"{hf}mlp.fc_in.{n}")
            cd[f"{our}mlp.fc2.{n}"] = sd.pop(f"{hf}mlp.fc_out.{n}")
        for junk in ("attn.bias", "attn.masked_bias"):
            sd.pop(hf + junk, None)
    return canonical_to_state_dict({**cd, **sd}, config)
