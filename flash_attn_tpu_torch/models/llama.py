"""LLaMA family: config conversion and the HF / Meta weight remaps
(counterpart of `flash_attn_tpu/models/llama.py`:
`llama_config_to_gpt2_config:15`, `_inv_permute:50`,
`remap_state_dict_hf_llama:60`, `remap_state_dict_meta_llama:91`).

The converters read any object with the Hugging Face attribute names (a
`LlamaConfig`, or a `types.SimpleNamespace` holding the fields of a
checkpoint's config.json) and return the port's `GPTConfig`; the remaps
take a state dict of tensors or numpy arrays and return the port's
state_dict.  As in JAX, the model rotates interleaved pairs: HF's q / k
weights (permuted for rotate-half) are permuted back, Meta's are already
in that order.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models.common import (as_tensors,
                                                canonical_to_state_dict)
from flash_attn_tpu_torch.models.gpt import GPTConfig


def llama_config_to_gpt2_config(llama_config) -> GPTConfig:
    c = llama_config
    return GPTConfig(
        vocab_size=c.vocab_size, n_positions=0, n_embd=c.hidden_size,
        n_layer=c.num_hidden_layers, n_head=c.num_attention_heads,
        n_head_kv=getattr(c, "num_key_value_heads", None)
        or c.num_attention_heads,
        n_inner=c.intermediate_size, activation_function="swiglu",
        layer_norm_epsilon=c.rms_norm_eps, rms_norm=True,
        rotary_emb_fraction=1.0, rotary_emb_interleaved=True,
        rotary_emb_base=getattr(c, "rope_theta", 10000.0),
        tie_word_embeddings=False, qkv_proj_bias=False, out_proj_bias=False,
        mlp_fc1_bias=False, mlp_fc2_bias=False)


def _inv_permute(w, nheads, headdim):
    """HF's rotate-half weight permutation back to interleaved rotary order
    (the inverse of HF's convert_llama_weights_to_hf permute)."""
    return (torch.as_tensor(w).reshape(nheads, 2, headdim // 2, -1)
            .transpose(1, 2).reshape(nheads * headdim, -1))


def remap_state_dict_hf_llama(state_dict, config: GPTConfig):
    """HF `LlamaForCausalLM` -> the port's state_dict."""
    sd = as_tensors(state_dict)
    h = config.n_head
    hk = config.n_head_kv or h
    hd = config.n_embd // h
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("model.embed_tokens.weight"),
          "lm_head.weight": sd.pop("lm_head.weight"),
          "transformer.ln_f.weight": sd.pop("model.norm.weight")}
    for i in range(config.n_layer):
        hf, our = f"model.layers.{i}.", f"transformer.layers.{i}."
        cd[our + "norm1.weight"] = sd.pop(hf + "input_layernorm.weight")
        cd[our + "norm2.weight"] = sd.pop(
            hf + "post_attention_layernorm.weight")
        wq = _inv_permute(sd.pop(hf + "self_attn.q_proj.weight"), h, hd)
        wk = _inv_permute(sd.pop(hf + "self_attn.k_proj.weight"), hk, hd)
        wv = sd.pop(hf + "self_attn.v_proj.weight")
        cd[our + "mixer.Wqkv.weight"] = torch.cat([wq, wk, wv])
        cd[our + "mixer.out_proj.weight"] = sd.pop(
            hf + "self_attn.o_proj.weight")
        cd[our + "mlp.fc1.weight"] = torch.cat(
            [sd.pop(hf + "mlp.gate_proj.weight"),
             sd.pop(hf + "mlp.up_proj.weight")])
        cd[our + "mlp.fc2.weight"] = sd.pop(hf + "mlp.down_proj.weight")
    return canonical_to_state_dict({**cd, **sd}, config)


def remap_state_dict_meta_llama(state_dict, config: GPTConfig):
    """A Meta (original) llama checkpoint -> the port's state_dict."""
    sd = as_tensors(state_dict)
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("tok_embeddings.weight"),
          "lm_head.weight": sd.pop("output.weight"),
          "transformer.ln_f.weight": sd.pop("norm.weight")}
    for i in range(config.n_layer):
        m, our = f"layers.{i}.", f"transformer.layers.{i}."
        cd[our + "norm1.weight"] = sd.pop(m + "attention_norm.weight")
        cd[our + "norm2.weight"] = sd.pop(m + "ffn_norm.weight")
        cd[our + "mixer.Wqkv.weight"] = torch.cat(
            [sd.pop(m + f"attention.{w}.weight") for w in ("wq", "wk", "wv")])
        cd[our + "mixer.out_proj.weight"] = sd.pop(m + "attention.wo.weight")
        cd[our + "mlp.fc1.weight"] = torch.cat(
            [sd.pop(m + "feed_forward.w1.weight"),
             sd.pop(m + "feed_forward.w3.weight")])
        cd[our + "mlp.fc2.weight"] = sd.pop(m + "feed_forward.w2.weight")
        sd.pop(m + "attention.inner_attention.rope.freqs", None)
    sd.pop("rope.freqs", None)
    return canonical_to_state_dict({**cd, **sd}, config)
