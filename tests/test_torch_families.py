"""The port's GPT-family remaps (`flash_attn_tpu_torch.models.{gpt, llama,
baichuan, gpt_neox, falcon, bigcode}`) against the JAX package's and against
Hugging Face, on the CPU in float32.

Each family is a tiny Hugging Face model (2 layers, width 128, 4 heads)
whose weights are drawn from a seed with numpy (norm weights near 1, so
they matter).  One state dict goes through the JAX remap into the JAX model
and through the port's remap into the port's model; the JAX model runs
under `jax.jit` (its XLA reference attention, XLA's optimisations off).

Tolerances: the port's logits within 1e-4 of JAX's (float32 summed in
different orders through two layers: `tests/test_torch_gpt.py`'s bound)
and within 2e-3 of HF's (the JAX family tests' bound: NeoX, Falcon and
BigCode use the exact GELU where both packages take the tanh form); the
remapped weights equal JAX's exactly.
"""

import os
import types

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from flash_attn_tpu.models import baichuan as jbaichuan  # noqa: E402
from flash_attn_tpu.models import bigcode as jbigcode  # noqa: E402
from flash_attn_tpu.models import falcon as jfalcon  # noqa: E402
from flash_attn_tpu.models import gpt as jgpt  # noqa: E402
from flash_attn_tpu.models import gpt_neox as jneox  # noqa: E402
from flash_attn_tpu.models import llama as jllama  # noqa: E402
from flash_attn_tpu_torch.models import (baichuan, bigcode,  # noqa: E402
                                         falcon, gpt, gpt_neox, llama)
from flash_attn_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig, GPTLMHeadModel, state_dict_from_jax_params)

LOGIT_ATOL, HF_ATOL = 1e-4, 2e-3


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references here are tiny programs whose time is compiling,
    not running: compile them with XLA's optimizations off."""
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


def seeded_weights(model, seed):
    """Every parameter of `model` drawn from numpy: norm weights 1 + N(0,
    0.1), other vectors N(0, 0.02), matrices N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = rng.standard_normal(p.shape).astype(np.float32)
            norm = p.ndim == 1 and any(
                s in name for s in ("norm", "ln", "layernorm"))
            x = 1 + 0.1 * x if norm else x * (0.02 if p.ndim == 1 else 0.05)
            p.copy_(torch.from_numpy(x))
    return model.eval()


def llama_hf(seed):
    from transformers import LlamaConfig, LlamaForCausalLM

    c = LlamaConfig(vocab_size=503, hidden_size=128, intermediate_size=344,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    rope_theta=500000.0)
    return c, seeded_weights(LlamaForCausalLM(c), seed)


def case_llama_hf():
    c, hf = llama_hf(0)
    return (hf, hf.state_dict(), jllama.llama_config_to_gpt2_config(c),
            llama.llama_config_to_gpt2_config(c),
            jllama.remap_state_dict_hf_llama, llama.remap_state_dict_hf_llama)


def inv_permute(w, h, hd):
    return w.reshape(h, 2, hd // 2, -1).transpose(1, 2).reshape(h * hd, -1)


def case_llama_meta():
    """Meta's layout of the HF model: q / k in interleaved order."""
    c, hf = llama_hf(1)
    sd = hf.state_dict()
    h, hk, hd = 4, 2, 32
    meta = {"tok_embeddings.weight": sd["model.embed_tokens.weight"],
            "output.weight": sd["lm_head.weight"],
            "norm.weight": sd["model.norm.weight"],
            "rope.freqs": torch.ones(hd // 2)}
    for i in range(c.num_hidden_layers):
        p, m = f"model.layers.{i}.", f"layers.{i}."
        meta[m + "attention_norm.weight"] = sd[p + "input_layernorm.weight"]
        meta[m + "ffn_norm.weight"] = sd[p + "post_attention_layernorm.weight"]
        meta[m + "attention.wq.weight"] = inv_permute(
            sd[p + "self_attn.q_proj.weight"], h, hd)
        meta[m + "attention.wk.weight"] = inv_permute(
            sd[p + "self_attn.k_proj.weight"], hk, hd)
        meta[m + "attention.wv.weight"] = sd[p + "self_attn.v_proj.weight"]
        meta[m + "attention.wo.weight"] = sd[p + "self_attn.o_proj.weight"]
        for w, hfw in (("w1", "gate_proj"), ("w2", "down_proj"),
                       ("w3", "up_proj")):
            meta[m + f"feed_forward.{w}.weight"] = sd[p + f"mlp.{hfw}.weight"]
    return (hf, meta, jllama.llama_config_to_gpt2_config(c),
            llama.llama_config_to_gpt2_config(c),
            jllama.remap_state_dict_meta_llama,
            llama.remap_state_dict_meta_llama)


def case_baichuan():
    """Baichuan-7B is LLaMA with a fused W_pack: a Llama twin re-keyed
    (as `tests/models/test_model_families.py` does); the config is a
    namespace with Baichuan's attribute names."""
    from transformers import LlamaConfig, LlamaForCausalLM

    c = LlamaConfig(vocab_size=521, hidden_size=128, intermediate_size=344,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=4, max_position_embeddings=128)
    hf = seeded_weights(LlamaForCausalLM(c), 2)
    sd = hf.state_dict()
    bsd = {k: v for k, v in sd.items()
           if not any(s in k for s in ("q_proj", "k_proj", "v_proj"))}
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}.self_attn."
        bsd[p + "W_pack.weight"] = torch.cat(
            [sd[p + f"{w}_proj.weight"] for w in "qkv"])
    bc = types.SimpleNamespace(
        vocab_size=521, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=344,
        rms_norm_eps=c.rms_norm_eps, initializer_range=0.02, bos_token_id=1,
        eos_token_id=2, position_embedding_type="rope")
    return (hf, bsd, jbaichuan.baichuan_config_to_gpt2_config(bc),
            baichuan.baichuan_config_to_gpt2_config(bc),
            jbaichuan.remap_state_dict_hf_baichuan,
            baichuan.remap_state_dict_hf_baichuan)


def case_gpt_neox():
    from transformers import GPTNeoXConfig, GPTNeoXForCausalLM

    c = GPTNeoXConfig(vocab_size=511, hidden_size=128, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      rotary_pct=0.25, max_position_embeddings=128,
                      use_parallel_residual=True, hidden_dropout=0.0,
                      attention_dropout=0.0)
    hf = seeded_weights(GPTNeoXForCausalLM(c), 3)
    return (hf, hf.state_dict(), jneox.gpt_neox_config_to_gpt2_config(c),
            gpt_neox.gpt_neox_config_to_gpt2_config(c),
            jneox.remap_state_dict_hf_gpt_neox,
            gpt_neox.remap_state_dict_hf_gpt_neox)


def falcon_case(new_arch, seed):
    from transformers import FalconConfig, FalconForCausalLM

    c = FalconConfig(vocab_size=513, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_kv_heads=2,
                     parallel_attn=True, bias=False, multi_query=True,
                     new_decoder_architecture=new_arch, hidden_dropout=0.0,
                     attention_dropout=0.0, alibi=False)
    hf = seeded_weights(FalconForCausalLM(c), seed)
    return (hf, hf.state_dict(), jfalcon.falcon_config_to_gpt2_config(c),
            falcon.falcon_config_to_gpt2_config(c),
            jfalcon.remap_state_dict_hf_falcon,
            falcon.remap_state_dict_hf_falcon)


def case_bigcode():
    from transformers import GPTBigCodeConfig, GPTBigCodeForCausalLM

    c = GPTBigCodeConfig(vocab_size=517, n_embd=128, n_layer=2, n_head=4,
                         n_positions=128, multi_query=True, resid_pdrop=0.0,
                         embd_pdrop=0.0, attn_pdrop=0.0,
                         activation_function="gelu")
    hf = seeded_weights(GPTBigCodeForCausalLM(c), 6)
    return (hf, hf.state_dict(), jbigcode.bigcode_config_to_gpt2_config(c),
            bigcode.bigcode_config_to_gpt2_config(c),
            jbigcode.remap_state_dict_hf_bigcode,
            bigcode.remap_state_dict_hf_bigcode)


def case_gpt2():
    from transformers import GPT2Config, GPT2LMHeadModel

    kw = dict(vocab_size=509, n_embd=128, n_layer=2, n_head=4,
              n_positions=128)
    c = GPT2Config(**kw, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    hf = seeded_weights(GPT2LMHeadModel(c), 7)
    return (hf, hf.state_dict(), c, GPTConfig(**kw),
            jgpt.remap_state_dict_hf_gpt2, gpt.remap_state_dict_hf_gpt2)


CASES = {
    "llama_hf": case_llama_hf,
    "llama_meta": case_llama_meta,
    "baichuan": case_baichuan,
    "gpt_neox": case_gpt_neox,
    "falcon_tied": lambda: falcon_case(False, 4),
    "falcon_new_arch": lambda: falcon_case(True, 5),
    "bigcode": case_bigcode,
    "gpt2": case_gpt2,
}


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
    """One family: the HF model, its state dict, both configs and remaps,
    the JAX model's logits and the port's model, built once."""
    hf, sd, jcfg, cfg, jremap, remap = CASES[request.param]()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48))
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(ids)).logits.numpy()
    jcfg.use_flash_attn = False
    jtree = to_numpy_tree(jremap(dict(sd), jcfg))
    jm = jgpt.GPTLMHeadModel(jcfg, dtype=jnp.float32)
    jlogits = np.asarray(jax.jit(lambda p, x: jm.apply(p, x).logits)(
        {"params": jtree}, jnp.asarray(ids, jnp.int32)))
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(remap(dict(sd), cfg))
    return dict(name=request.param, sd=sd, cfg=cfg, remap=remap, ids=ids,
                hf_logits=hf_logits, jlogits=jlogits, jtree=jtree,
                port=port.eval())


def test_family_logits_match_jax_and_hf(family):
    with torch.no_grad():
        out = family["port"](torch.from_numpy(family["ids"])).logits.numpy()
    np.testing.assert_allclose(out, family["jlogits"], atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out, family["hf_logits"], atol=HF_ATOL,
                               rtol=0)


def test_family_remap_matches_jax_and_uses_every_key(family):
    """The port's remap gives JAX's weights exactly, under the port's
    parameter names and nothing else; a key it does not know raises."""
    cfg, remap = family["cfg"], family["remap"]
    sd = remap(dict(family["sd"]), cfg)
    assert set(sd) == set(family["port"].state_dict())
    expected = state_dict_from_jax_params(family["jtree"], cfg)
    assert set(sd) == set(expected)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), expected[k].numpy(),
                                      err_msg=k)
    extra = dict(family["sd"], **{"extra.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="unmapped"):
        remap(extra, cfg)
