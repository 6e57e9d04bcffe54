"""GPT-NeoX (Pythia): config conversion and the HF weight remap
(counterpart of `flash_attn_tpu/models/gpt_neox.py`:
`gpt_neox_config_to_gpt2_config:13`, `remap_state_dict_hf_gpt_neox:42`).
Partial rotate-half rotary (`rotary_pct`) and, with
`use_parallel_residual`, untied parallel blocks."""

from __future__ import annotations

from flash_attn_tpu_torch.models.common import (as_tensors,
                                                canonical_to_state_dict)
from flash_attn_tpu_torch.models.gpt import GPTConfig


def gpt_neox_config_to_gpt2_config(neox_config) -> GPTConfig:
    c = neox_config
    return GPTConfig(
        vocab_size=c.vocab_size, n_positions=0, n_embd=c.hidden_size,
        n_layer=c.num_hidden_layers, n_head=c.num_attention_heads,
        n_inner=c.intermediate_size, activation_function=c.hidden_act,
        layer_norm_epsilon=c.layer_norm_eps,
        rotary_emb_fraction=c.rotary_pct,
        rotary_emb_base=c.rotary_emb_base, rotary_emb_interleaved=False,
        tie_word_embeddings=c.tie_word_embeddings,
        parallel_block=c.use_parallel_residual,
        parallel_block_tied_norm=False)


def remap_state_dict_hf_gpt_neox(state_dict, config: GPTConfig):
    """HF `GPTNeoXForCausalLM` -> the port's state_dict.  The fused
    `query_key_value` is laid out per head, (h, 3, d, in), and becomes
    [q ; k ; v]."""
    sd = as_tensors(state_dict)
    h = config.n_head
    hd = config.n_embd // h
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("gpt_neox.embed_in.weight")}
    if "embed_out.weight" in sd:
        cd["lm_head.weight"] = sd.pop("embed_out.weight")
    for n in ("weight", "bias"):
        cd[f"transformer.ln_f.{n}"] = sd.pop(f"gpt_neox.final_layer_norm.{n}")
    for i in range(config.n_layer):
        hf, our = f"gpt_neox.layers.{i}.", f"transformer.layers.{i}."
        w = sd.pop(hf + "attention.query_key_value.weight")
        b = sd.pop(hf + "attention.query_key_value.bias")
        cd[our + "mixer.Wqkv.weight"] = (
            w.reshape(h, 3, hd, -1).transpose(0, 1).reshape(3 * h * hd, -1))
        cd[our + "mixer.Wqkv.bias"] = (
            b.reshape(h, 3, hd).transpose(0, 1).reshape(-1))
        for n in ("weight", "bias"):
            cd[f"{our}norm1.{n}"] = sd.pop(f"{hf}input_layernorm.{n}")
            cd[f"{our}norm2.{n}"] = sd.pop(
                f"{hf}post_attention_layernorm.{n}")
            cd[f"{our}mixer.out_proj.{n}"] = sd.pop(
                f"{hf}attention.dense.{n}")
            cd[f"{our}mlp.fc1.{n}"] = sd.pop(f"{hf}mlp.dense_h_to_4h.{n}")
            cd[f"{our}mlp.fc2.{n}"] = sd.pop(f"{hf}mlp.dense_4h_to_h.{n}")
        for junk in ("attention.bias", "attention.masked_bias",
                     "attention.rotary_emb.inv_freq"):
            sd.pop(hf + junk, None)
    return canonical_to_state_dict({**cd, **sd}, config)
