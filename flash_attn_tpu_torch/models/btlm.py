"""BTLM (Cerebras btlm-3b-8k): config conversion and the HF weight remap
(counterpart of `flash_attn_tpu/models/btlm.py`:
`btlm_config_to_gpt2_config:12`, `remap_state_dict_hf_btlm:43`).  GPT-2
shaped, with SwiGLU, ALiBi and the muP multipliers: the softmax scale is
head_dim ** -0.5 times `mup_attn_multiplier` (head_dim ** -0.5 again when
`mup_scale_qk_dot_by_d`, so 1 / head_dim), the logits are multiplied by
`mup_output_alpha * mup_width_scale`, and `mup_embeddings_scale` is kept as
`mup_embeddings_multiplier` and applied nowhere, as in JAX."""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models.common import (as_tensors,
                                                canonical_to_state_dict)
from flash_attn_tpu_torch.models.gpt import GPTConfig


def btlm_config_to_gpt2_config(btlm_config) -> GPTConfig:
    """The port's `GPTConfig` of any object with BTLM's config fields (HF
    `BTLMConfig`'s names; no `transformers` import)."""
    c = btlm_config
    alibi = c.position_embedding_type == "alibi"
    emb = getattr(c, "mup_embeddings_scale", 1.0)
    qk_by_d = getattr(c, "mup_scale_qk_dot_by_d", False)
    return GPTConfig(
        vocab_size=c.vocab_size, n_positions=0 if alibi else c.n_positions,
        n_embd=c.n_embd, n_layer=c.n_layer, n_head=c.n_head,
        n_inner=c.n_inner, activation_function=c.activation_function,
        resid_pdrop=c.resid_pdrop, embd_pdrop=c.embd_pdrop,
        attn_pdrop=c.attn_pdrop, layer_norm_epsilon=c.layer_norm_epsilon,
        use_alibi=alibi, tie_word_embeddings=True, use_mup=emb != 1.0,
        mup_embeddings_multiplier=emb,
        mup_output_multiplier=(getattr(c, "mup_output_alpha", 1.0)
                               * getattr(c, "mup_width_scale", 1.0)),
        mup_attn_multiplier=((c.n_embd // c.n_head) ** -0.5 if qk_by_d
                             else 1.0))


def remap_state_dict_hf_btlm(state_dict, config: GPTConfig):
    """HF `BTLMLMHeadModel` -> the port's state_dict.  GPT-2's `Conv1D`
    weights (in, out) are transposed to `nn.Linear`'s (out, in); the SwiGLU
    projections `c_fc` (gate) and `c_fc2` (up) are packed [gate ; up] into
    fc1; the tied head and the attention-mask buffers are dropped."""
    sd = as_tensors(state_dict)
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("transformer.wte.weight")}
    if "transformer.wpe.weight" in sd:
        cd["transformer.embeddings.position_embeddings.weight"] = sd.pop(
            "transformer.wpe.weight")
    sd.pop("lm_head.weight", None)
    for n in ("weight", "bias"):
        cd[f"transformer.ln_f.{n}"] = sd.pop(f"transformer.ln_f.{n}")
    for i in range(config.n_layer):
        hf, our = f"transformer.h.{i}.", f"transformer.layers.{i}."
        for n in ("weight", "bias"):
            cd[f"{our}norm1.{n}"] = sd.pop(f"{hf}ln_1.{n}")
            cd[f"{our}norm2.{n}"] = sd.pop(f"{hf}ln_2.{n}")
        cd[our + "mixer.Wqkv.weight"] = sd.pop(hf + "attn.c_attn.weight").t()
        cd[our + "mixer.Wqkv.bias"] = sd.pop(hf + "attn.c_attn.bias")
        cd[our + "mixer.out_proj.weight"] = sd.pop(
            hf + "attn.c_proj.weight").t()
        cd[our + "mixer.out_proj.bias"] = sd.pop(hf + "attn.c_proj.bias")
        cd[our + "mlp.fc1.weight"] = torch.cat(
            [sd.pop(hf + "mlp.c_fc.weight").t(),
             sd.pop(hf + "mlp.c_fc2.weight").t()])
        cd[our + "mlp.fc1.bias"] = torch.cat([sd.pop(hf + "mlp.c_fc.bias"),
                                              sd.pop(hf + "mlp.c_fc2.bias")])
        cd[our + "mlp.fc2.weight"] = sd.pop(hf + "mlp.c_proj.weight").t()
        cd[our + "mlp.fc2.bias"] = sd.pop(hf + "mlp.c_proj.bias")
        sd.pop(hf + "attn.bias", None)
    return canonical_to_state_dict({**cd, **sd}, config)
