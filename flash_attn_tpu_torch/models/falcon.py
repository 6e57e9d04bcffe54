"""Falcon: config conversion and the HF weight remap (counterpart of
`flash_attn_tpu/models/falcon.py`: `falcon_config_to_gpt2_config:11`,
`remap_state_dict_hf_falcon:54`).  Multi-query (7B) or `num_kv_heads`
groups (the new decoder architecture), rotate-half rotary, parallel blocks:
one tied norm (`input_layernorm`) in the old architecture, `ln_attn` and
`ln_mlp` in the new one."""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models.common import (as_tensors,
                                                canonical_to_state_dict)
from flash_attn_tpu_torch.models.gpt import GPTConfig


def falcon_config_to_gpt2_config(falcon_config) -> GPTConfig:
    c = falcon_config
    new_arch = getattr(c, "new_decoder_architecture", False)
    # HF FalconConfig.num_kv_heads ignores multi_query for the old decoder
    # architecture, so multi_query is read first.
    if new_arch:
        n_head_kv = c.num_kv_heads
    elif getattr(c, "multi_query", False):
        n_head_kv = 1
    else:
        n_head_kv = c.num_attention_heads
    bias = getattr(c, "bias", False)
    return GPTConfig(
        vocab_size=c.vocab_size, n_positions=0, n_embd=c.hidden_size,
        n_layer=c.num_hidden_layers, n_head=c.num_attention_heads,
        n_head_kv=n_head_kv, n_inner=4 * c.hidden_size,
        activation_function="gelu", layer_norm_epsilon=c.layer_norm_epsilon,
        rotary_emb_fraction=1.0, rotary_emb_interleaved=False,
        tie_word_embeddings=True, qkv_proj_bias=bias, out_proj_bias=bias,
        mlp_fc1_bias=bias, mlp_fc2_bias=bias, parallel_block=c.parallel_attn,
        parallel_block_tied_norm=not new_arch,
        resid_pdrop=getattr(c, "hidden_dropout", 0.0),
        attn_pdrop=getattr(c, "attention_dropout", 0.0))


def remap_state_dict_hf_falcon(state_dict, config: GPTConfig):
    """HF `FalconForCausalLM` -> the port's state_dict.  The fused
    `query_key_value` is grouped by kv head, (hk, g + 2, d, in): g query
    heads, then the group's k and v."""
    sd = as_tensors(state_dict)
    h = config.n_head
    hk = config.n_head_kv or h
    hd = config.n_embd // h
    g = h // hk
    sd.pop("lm_head.weight", None)  # tied
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("transformer.word_embeddings.weight")}
    for n in ("weight", "bias"):
        cd[f"transformer.ln_f.{n}"] = sd.pop(f"transformer.ln_f.{n}")
    norms = ((("input_layernorm", "norm1"),)
             if config.parallel_block_tied_norm
             else (("ln_attn", "norm1"), ("ln_mlp", "norm2")))
    for i in range(config.n_layer):
        hf, our = f"transformer.h.{i}.", f"transformer.layers.{i}."
        for src, dst in norms:
            for n in ("weight", "bias"):
                cd[f"{our}{dst}.{n}"] = sd.pop(f"{hf}{src}.{n}")
        w = sd.pop(hf + "self_attention.query_key_value.weight").reshape(
            hk, g + 2, hd, -1)
        cd[our + "mixer.Wqkv.weight"] = torch.cat(
            [w[:, :g].reshape(h * hd, -1), w[:, g].reshape(hk * hd, -1),
             w[:, g + 1].reshape(hk * hd, -1)])
        cd[our + "mixer.out_proj.weight"] = sd.pop(
            hf + "self_attention.dense.weight")
        cd[our + "mlp.fc1.weight"] = sd.pop(hf + "mlp.dense_h_to_4h.weight")
        cd[our + "mlp.fc2.weight"] = sd.pop(hf + "mlp.dense_4h_to_h.weight")
    return canonical_to_state_dict({**cd, **sd}, config)
