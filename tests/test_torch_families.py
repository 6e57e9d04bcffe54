"""The port's GPT-family remaps (`flash_attn_tpu_torch.models.{gpt, llama,
baichuan, gpt_neox, falcon, bigcode}`) and the ViT (`models.vit`, its
remap, the image data and task) against the JAX package's and against
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

from flash_attn_tpu.layers.patch_embed import (  # noqa: E402
    PatchEmbed as JaxPatchEmbed)
from flash_attn_tpu.models import baichuan as jbaichuan  # noqa: E402
from flash_attn_tpu.models import bigcode as jbigcode  # noqa: E402
from flash_attn_tpu.models import falcon as jfalcon  # noqa: E402
from flash_attn_tpu.models import gpt as jgpt  # noqa: E402
from flash_attn_tpu.models import gpt_neox as jneox  # noqa: E402
from flash_attn_tpu.models import llama as jllama  # noqa: E402
from flash_attn_tpu.models import vit as jvit  # noqa: E402
from flash_attn_tpu.models.vit import VisionTransformer as JaxViT  # noqa
from flash_attn_tpu.training import vision_data as jax_vd  # noqa: E402
from flash_attn_tpu_torch.layers.patch_embed import PatchEmbed  # noqa: E402
from flash_attn_tpu_torch.models import (baichuan, bigcode,  # noqa: E402
                                         falcon, gpt, gpt_neox, llama, vit)
from flash_attn_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig, GPTLMHeadModel, state_dict_from_jax_params)
from flash_attn_tpu_torch.training import vision_data as vd  # noqa: E402
from flash_attn_tpu_torch.training.config import load_config  # noqa: E402
from flash_attn_tpu_torch.training.data import LoaderState  # noqa: E402
from flash_attn_tpu_torch.training.trainer import Trainer  # noqa: E402

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


def test_vit_remap_matches_jax_and_hf():
    """A tiny `ViTForImageClassification` (the JAX test's widths, its norm
    eps at the port's 1e-5): the port's remap gives the JAX remap's weights
    exactly (JAX's takes no classifier) and its logits are within 2e-3 of
    HF's."""
    from transformers import ViTConfig, ViTForImageClassification

    hf_cfg = ViTConfig(hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=256,
                       image_size=32, patch_size=8, num_labels=10,
                       layer_norm_eps=1e-5, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    hf = seeded_weights(ViTForImageClassification(hf_cfg), 0)
    sd = hf.state_dict()
    ours = vit.remap_state_dict_hf_vit(dict(sd), 2)
    body = {k: v for k, v in sd.items() if not k.startswith("classifier")}
    expected = vit.state_dict_from_jax_params(
        jvit.remap_state_dict_hf_vit(body, 2), 2)
    assert set(ours) == set(expected) | {"head.weight", "head.bias"}
    for k, v in expected.items():
        np.testing.assert_array_equal(ours[k].numpy(), v.numpy(), err_msg=k)
    model = vit.VisionTransformer(img_size=32, patch_size=8, embed_dim=64,
                                  depth=2, num_heads=4, num_classes=10,
                                  device="cpu")
    model.load_state_dict(ours)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(x).permute(0, 3, 1, 2)).logits.numpy()
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=HF_ATOL, rtol=0)
    with pytest.raises(ValueError, match="unmapped"):
        vit.remap_state_dict_hf_vit(dict(sd, **{"extra.w": torch.zeros(1)}),
                                    2)

# --------------------------------------------------------------------- ViT
# The image task (`models.vit`, `layers.patch_embed`,
# `training.vision_data`, the trainer's `task="image"`) against the JAX
# package's, from numpy-drawn weights in the JAX tree.  Tolerances: logits
# and the patch embedding 1e-5; the augmentation at given draws and the
# normalisation 1e-6 (elementwise); the trainer's first-step loss 1e-4.

VIT = dict(img_size=32, patch_size=4, embed_dim=64, depth=2, num_heads=4,
            num_classes=10)


def vit_images(b=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def jax_params(model, x, seed=0):
    """Parameters in the JAX model's tree, drawn with numpy on
    `jax.eval_shape(model.init)`'s shapes (class token and biases too, which
    would hide a misplaced one at their initial zeros)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if hasattr(v, "items") else
                (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    return fill(shapes)


def pool_variant(params, kw):
    """TINY's parameters for a pooling variant: the final norm under its
    other name, the position table without the class row, no head."""
    p = {k: v for k, v in params["params"].items()}
    if kw.get("global_pool") == "avg" and kw.get("fc_norm") is not False:
        p["fc_norm_layer"] = p.pop("norm")
    if kw.get("no_embed_class"):
        p["pos_embed"] = p["pos_embed"][:, 1:]
    if kw.get("num_classes") == 0:
        del p["head"]
    return {"params": p}


@pytest.fixture(scope="module")
def tiny_params():
    return jax_params(JaxViT(**VIT, use_flash_attn=False), vit_images())


@pytest.mark.parametrize("kw", [
    dict(global_pool="token"), dict(global_pool="avg"),
    dict(global_pool="token", no_embed_class=True),
    dict(global_pool="avg", fc_norm=False, num_classes=0)],
    ids=["token", "avg_fc_norm", "no_embed_class", "avg_features"])
def test_vit_matches_jax(tiny_params, kw):
    """Logits (features for num_classes=0) of the JAX model (its XLA
    attention) and the port's on the carried weights."""
    cfg = {**VIT, **kw}
    x = vit_images()
    params = pool_variant(tiny_params, kw)
    jm = JaxViT(**cfg, use_flash_attn=False, dtype=jnp.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, x))
    model = vit.VisionTransformer(**cfg, device="cpu")
    model.load_state_dict(vit.state_dict_from_jax_params(params,
                                                         cfg["depth"]))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_patch_embed_matches_jax():
    x = vit_images(b=3, size=16)
    jm = JaxPatchEmbed(img_size=16, patch_size=4, embed_dim=24)
    params = jax_params(jm, x)
    ref = np.asarray(jm.apply(params, x))
    pe = PatchEmbed(16, 4, 24, device="cpu")
    proj = params["params"]["proj"]
    pe.load_state_dict({
        "proj.weight": torch.from_numpy(np.ascontiguousarray(
            proj["kernel"].transpose(3, 2, 0, 1))),
        "proj.bias": torch.from_numpy(proj["bias"])})
    with torch.no_grad():
        out = pe(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 16, 24)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_vit_factories_and_dropout_raise():
    m = vit.vit_small_patch16_224(device="meta")
    assert len(m.blocks) == 12 and m.embed_dim == 384
    assert m.pos_embed.shape == (1, 197, 384)
    assert vit.vit_base_patch16_224(device="meta").blocks[0].mixer.\
        num_heads == 12
    assert len(vit.vit_large_patch16_224(device="meta").blocks) == 24
    # the attention dropout is ported (`tests/test_torch_dropout.py`); the
    # position / residual dropout and stochastic depth are not
    for rate in ("drop_rate", "drop_path_rate"):
        with pytest.raises(NotImplementedError):
            vit.VisionTransformer(**VIT, **{rate: 0.1}, device="cpu")
    m = vit.VisionTransformer(**VIT, attn_drop_rate=0.1, device="cpu")
    assert m.blocks[0].mixer.dropout == 0.1


@pytest.fixture(scope="module")
def uint8_batch():
    return np.random.default_rng(3).integers(0, 256, (4, 12, 12, 3),
                                             dtype=np.uint8)


def test_augment_batch_matches_jax_at_given_draws(uint8_batch):
    """JAX's transform keyed by a PRNG key against the port's at the
    offsets and flips that key draws (`vision_data.py:169-176`)."""
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    ref = np.asarray(jax_vd.augment_batch(jnp.asarray(uint8_batch), key,
                                          train=True))
    kc, kf = jax.random.split(key)
    b, pad = uint8_batch.shape[0], 4
    oy = jax.random.randint(kc, (b,), 0, 2 * pad + 1)
    ox = jax.random.randint(jax.random.fold_in(kc, 1), (b,), 0, 2 * pad + 1)
    flip = jax.random.bernoulli(kf, 0.5, (b,))
    draws = tuple(torch.from_numpy(np.array(a)) for a in (oy, ox, flip))
    out = vd.augment_batch(torch.from_numpy(uint8_batch), draws, train=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    norm = vd.augment_batch(torch.from_numpy(uint8_batch), train=False)
    np.testing.assert_allclose(
        norm.numpy(), np.asarray(jax_vd.augment_batch(
            jnp.asarray(uint8_batch), key, train=False)), atol=1e-6, rtol=0)


def test_augment_draws_are_a_function_of_seed_and_step():
    a = vd.augment_draws(16, vd.step_generator(0, 7))
    b = vd.augment_draws(16, vd.step_generator(0, 7))
    c = vd.augment_draws(16, vd.step_generator(0, 8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    oy, ox, flip = a
    assert 0 <= int(oy.min()) and int(ox.max()) <= 8 and flip.dtype == \
        torch.bool


def test_vision_loader_resume_exact():
    """As JAX's `test_vision_loader_resume_exact`: the stream after a state
    round trip, across an epoch boundary, and equal to JAX's loader."""
    imgs, labels = vd.synthetic_images(40, 8, 3, seed=1)
    jimgs, jlabels = jax_vd.synthetic_images(40, 8, 3, seed=1)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    ld = vd.VisionLoader(vd.ImageDataset(imgs, labels), batch_size=4, seed=7)
    jl = jax_vd.VisionLoader(jax_vd.ImageDataset(jimgs, jlabels),
                             batch_size=4, seed=7)
    for _ in range(13):
        for x, y in zip(next(ld), next(jl)):
            np.testing.assert_array_equal(x, y)
    state = ld.state.to_dict()
    expected = [next(ld) for _ in range(5)]
    ld2 = vd.VisionLoader(vd.ImageDataset(imgs, labels), batch_size=4,
                          state=LoaderState.from_dict(dict(state)))
    for exp in expected:
        for x, y in zip(next(ld2), exp):
            np.testing.assert_array_equal(x, y)


def test_image_sources(tmp_path):
    imgs, labels = vd.synthetic_images(6, 8, 3, seed=2)
    np.savez(tmp_path / "shard.npz", images=imgs, labels=labels)
    (tmp_path / "arr").mkdir()
    np.save(tmp_path / "arr" / "images.npy", imgs)
    np.save(tmp_path / "arr" / "labels.npy", labels)
    cfg = load_config(overrides={"data": {"batch_size": 2, "image_size": 8,
                                          "max_examples": 4}})
    for src in ("shard.npz", "arr"):
        cfg.data.dataset = str(tmp_path / src)
        ld = vd.make_image_loader(cfg.data, 3)
        assert len(ld.dataset) == 4
        np.testing.assert_array_equal(ld.dataset.images, imgs[:4])
    Image = pytest.importorskip("PIL.Image")
    for c in ("a", "b"):
        (tmp_path / "folder" / c).mkdir(parents=True)
        Image.fromarray(imgs[0]).save(tmp_path / "folder" / c / "0.png")
    cfg.data.dataset = str(tmp_path / "folder")
    ld = vd.make_image_loader(cfg.data, 2)
    assert ld.dataset.images.shape == (2, 8, 8, 3)
    assert list(ld.dataset.labels) == [0, 1]


def image_config():
    """TINY as a training recipe: synthetic 32 px images of 10 classes."""
    return load_config(overrides={
        "model": {"task": "image", "n_embd": 64, "n_layer": 2, "n_head": 4,
                  "num_classes": 10, "image_size": 32, "patch_size": 4,
                  "dtype": "float32"},
        "data": {"batch_size": 4, "max_examples": 16},
        "trainer": {"resume": False, "eval_steps": 2}})


def test_image_trainer_matches_jax(tiny_params):
    """The trainer's first-step loss against JAX's loss function
    (`trainer.py:176-190`: JAX's augmentation at the port's draws, the
    model, softmax cross-entropy) on the same weights and batch; the
    batches equal JAX's image loader's."""
    t = Trainer(image_config(), device="cpu")
    t.model.load_state_dict(vit.state_dict_from_jax_params(tiny_params, 2))
    assert t.flops is None and t.gpt_config is None
    assert t.config.data.image_size == 32
    jl = jax_vd.make_image_loader(t.config.data, 10)
    batch = next(t.loader)
    for x, y in zip(batch, next(jl)):
        np.testing.assert_array_equal(x, y)
    draws = vd.augment_draws(4, vd.step_generator(0, 0))
    x = vd.augment_batch(torch.from_numpy(batch[0]), draws, train=True)
    jm = JaxViT(**VIT, use_flash_attn=False, dtype=jnp.float32)
    logits = jax.jit(jm.apply)(tiny_params, jnp.asarray(x.numpy()))
    ref = float(jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, jnp.asarray(batch[1])[:, None], -1)[:, 0]))
    loss, _ = t.train_step(batch)
    assert abs(float(loss) - ref) <= 1e-4
    assert t.step == 1
    logs = []
    t.config.trainer.max_steps = 2
    t.train(log_fn=logs.append)
    assert set(logs[-1]) == {"step", "loss", "grad_norm"}
    assert np.isfinite(t.evaluate())
