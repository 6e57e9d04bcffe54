"""GPT-BigCode (StarCoder): config conversion and the HF weight remap
(counterpart of `flash_attn_tpu/models/bigcode.py`:
`bigcode_config_to_gpt2_config:11`, `remap_state_dict_hf_bigcode:36`).
Multi-query attention with GPT-2's learned positions and tied head."""

from __future__ import annotations

from flash_attn_tpu_torch.models.common import (as_tensors,
                                                canonical_to_state_dict)
from flash_attn_tpu_torch.models.gpt import GPTConfig


def bigcode_config_to_gpt2_config(bigcode_config) -> GPTConfig:
    c = bigcode_config
    return GPTConfig(
        vocab_size=c.vocab_size, n_positions=c.n_positions, n_embd=c.n_embd,
        n_layer=c.n_layer, n_head=c.n_head,
        n_head_kv=1 if c.multi_query else c.n_head, n_inner=c.n_inner,
        activation_function=c.activation_function,
        layer_norm_epsilon=c.layer_norm_epsilon,
        tie_word_embeddings=True,
        **{k: getattr(c, k, 0.0) for k in ("resid_pdrop", "embd_pdrop",
                                           "attn_pdrop")})


def remap_state_dict_hf_bigcode(state_dict, config: GPTConfig):
    """HF `GPTBigCodeForCausalLM` -> the port's state_dict.  `c_attn` is an
    `nn.Linear` already packed [q ; kv] (one kv head under multi-query)."""
    sd = as_tensors(state_dict)
    sd.pop("lm_head.weight", None)  # tied
    cd = {"transformer.embeddings.word_embeddings.weight":
          sd.pop("transformer.wte.weight"),
          "transformer.embeddings.position_embeddings.weight":
          sd.pop("transformer.wpe.weight")}
    for n in ("weight", "bias"):
        cd[f"transformer.ln_f.{n}"] = sd.pop(f"transformer.ln_f.{n}")
    for i in range(config.n_layer):
        hf, our = f"transformer.h.{i}.", f"transformer.layers.{i}."
        for src, dst in (("ln_1", "norm1"), ("ln_2", "norm2"),
                         ("attn.c_attn", "mixer.Wqkv"),
                         ("attn.c_proj", "mixer.out_proj"),
                         ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
            for n in ("weight", "bias"):
                cd[f"{our}{dst}.{n}"] = sd.pop(f"{hf}{src}.{n}")
    return canonical_to_state_dict({**cd, **sd}, config)
