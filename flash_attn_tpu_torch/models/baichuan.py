"""Baichuan: config conversion and the HF weight remap (counterpart of
`flash_attn_tpu/models/baichuan.py`: `baichuan_config_to_gpt2_config:13`,
`remap_state_dict_hf_baichuan:48`).  LLaMA with a fused `W_pack` QKV; the
13B family (hidden >= 5120, or `position_embedding_type="alibi"`) takes
ALiBi in place of rotary."""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models.common import (as_tensors,
                                                canonical_to_state_dict)
from flash_attn_tpu_torch.models.gpt import GPTConfig
from flash_attn_tpu_torch.models.llama import _inv_permute


def baichuan_config_to_gpt2_config(baichuan_config) -> GPTConfig:
    c = baichuan_config
    use_alibi = (getattr(c, "position_embedding_type", "rope") == "alibi"
                 or c.hidden_size >= 5120)
    return GPTConfig(
        vocab_size=c.vocab_size, n_positions=0, n_embd=c.hidden_size,
        n_layer=c.num_hidden_layers, n_head=c.num_attention_heads,
        n_inner=c.intermediate_size, activation_function="swiglu",
        layer_norm_epsilon=c.rms_norm_eps, rms_norm=True,
        use_alibi=use_alibi, rotary_emb_fraction=0.0 if use_alibi else 1.0,
        rotary_emb_interleaved=True, tie_word_embeddings=False,
        qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
        mlp_fc2_bias=False)


def remap_state_dict_hf_baichuan(state_dict, config: GPTConfig):
    """HF Baichuan (`W_pack` = [q ; k ; v]) -> the port's state_dict."""
    sd = as_tensors(state_dict)
    h = config.n_head
    hd = config.n_embd // h
    rotary = config.rotary_emb_fraction > 0
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("model.embed_tokens.weight"),
          "lm_head.weight": sd.pop("lm_head.weight"),
          "transformer.ln_f.weight": sd.pop("model.norm.weight")}
    for i in range(config.n_layer):
        hf, our = f"model.layers.{i}.", f"transformer.layers.{i}."
        cd[our + "norm1.weight"] = sd.pop(hf + "input_layernorm.weight")
        cd[our + "norm2.weight"] = sd.pop(
            hf + "post_attention_layernorm.weight")
        wq, wk, wv = sd.pop(hf + "self_attn.W_pack.weight").chunk(3)
        if rotary:
            wq, wk = _inv_permute(wq, h, hd), _inv_permute(wk, h, hd)
        cd[our + "mixer.Wqkv.weight"] = torch.cat([wq, wk, wv])
        cd[our + "mixer.out_proj.weight"] = sd.pop(
            hf + "self_attn.o_proj.weight")
        cd[our + "mlp.fc1.weight"] = torch.cat(
            [sd.pop(hf + "mlp.gate_proj.weight"),
             sd.pop(hf + "mlp.up_proj.weight")])
        cd[our + "mlp.fc2.weight"] = sd.pop(hf + "mlp.down_proj.weight")
    return canonical_to_state_dict({**cd, **sd}, config)
