"""Head dims other than 64 and 128: the port's head-dim rule
(`kernels.flash_fwd.kernel_head_dim`, `pad_head_dim`), its plain attention
versions at d 80 and 256 against the JAX kernels, GPT-J (`models.gptj`,
head dim 256 at its published widths) and the repo's GPT-3 2.7B recipe
(head dim 80), on the CPU in float32; and three helpers of `chip_smoke.py`'s
checks at the wide head dims (the plain version a few heads at a time,
ptxas's wgmma serialization notes, the instantiations a profile names).

The CUDA kernels run a call of head dim d in a tile of d rounded up to a
multiple of 64, the columns past d zero, and copy inputs whose d is not a
multiple of 8 into zero-padded ones; the padding tests hold the plain
versions on such zero-padded inputs (the true d's softmax scale) to the
plain versions at the true d.  The JAX kernels run as the JAX package's
own tests run them on the CPU (Pallas interpret mode) under `jax.jit`
with XLA's optimisations off; the JAX models take XLA's reference
attention.

Tolerances: padded against true d 1e-6 (float32, the same products with
zero terms added); attention against JAX o 2e-5, lse 1e-5 and gradients
2e-5 (`tests/test_torch_attention.py`, `test_torch_backward.py`); model
logits 1e-4 to JAX and 2e-3 to HF (`tests/test_torch_families.py`); the
recipe's loss rtol 1e-6 and gradients 1e-5 (`tests/test_torch_training.py`).
"""

import dataclasses
import functools
import os
import sys
from pathlib import Path

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from flash_attn_tpu.kernels.flash_bwd import \
    flash_attn_bwd_bhsd as jax_bwd  # noqa: E402
from flash_attn_tpu.kernels.flash_decode import \
    decode_attn_bhsd as jax_decode  # noqa: E402
from flash_attn_tpu.kernels.flash_fwd import \
    flash_attn_fwd_bhsd as jax_fwd  # noqa: E402
from flash_attn_tpu.models import gpt as jgpt  # noqa: E402
from flash_attn_tpu.models import gptj as jgptj  # noqa: E402
from flash_attn_tpu.training import config as jax_config_mod  # noqa: E402
from flash_attn_tpu.training.loss import \
    chunked_lm_loss as jax_lm_loss  # noqa: E402
from flash_attn_tpu_torch.kernels import (flash_bwd, flash_decode,  # noqa
                                          flash_fwd)
from flash_attn_tpu_torch.models import gptj  # noqa: E402
from flash_attn_tpu_torch.models.gpt import (  # noqa: E402
    GPTLMHeadModel, state_dict_from_jax_params)
from flash_attn_tpu_torch.modules.mha import InferenceParams  # noqa: E402
from flash_attn_tpu_torch.training.config import load_config  # noqa: E402
from flash_attn_tpu_torch.training.loss import chunked_lm_loss  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RECIPE = (ROOT / "flash_attn_tpu" / "training" / "configs" / "experiment"
          / "pile-gpt3-2p7b-flash-8k.yaml")
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PAD_ATOL = 1e-6
O_ATOL, LSE_ATOL, GRAD_ATOL = 2e-5, 1e-5, 2e-5
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


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


# ------------------------------------------------------------ the rule

def test_kernel_head_dim_rule():
    """d rounded up to 64 (the backward's too, since it takes D 192 and
    256), refused beyond 256; the pad helper copies (and counts) only where
    d is not a multiple of 8 (16 for 8-bit caches), zero-filling the new
    columns, fp8 too."""
    ds = (1, 32, 64, 65, 80, 96, 100, 128, 129, 160, 192, 224, 256)
    assert [flash_fwd.kernel_head_dim(d) for d in ds] == [
        64, 64, 64, 128, 128, 128, 128, 128, 192, 192, 192, 256, 256]
    for d in (0, 257, 288):
        with pytest.raises(NotImplementedError, match="head dim"):
            flash_fwd.kernel_head_dim(d)
    assert flash_fwd.kernel_head_dim(100, flash_fwd.MAX_BWD_HEAD_DIM) == 128
    assert flash_fwd.kernel_head_dim(160, flash_fwd.MAX_BWD_HEAD_DIM) == 192
    with pytest.raises(NotImplementedError, match="head dim"):
        flash_fwd.kernel_head_dim(288, flash_fwd.MAX_BWD_HEAD_DIM)
    assert [flash_fwd.fwd_rows(flash_fwd.kernel_head_dim(d))
            for d in (32, 80, 192, 256)] == [64, 128, 128, 128]
    assert [flash_fwd.padded_head_dim(d) for d in (80, 100, 256)] == [
        80, 104, 256]
    assert flash_fwd.padded_head_dim(100, 16) == 112

    x = torch.randn(2, 3, 100)
    before = flash_fwd.pad_copies
    y, none = flash_fwd.pad_head_dim(x, None)
    assert none is None and y.shape == (2, 3, 104)
    assert torch.equal(y[..., :100], x) and not y[..., 100:].any()
    assert flash_fwd.pad_copies == before + 1
    assert flash_fwd.pad_head_dim(y)[0] is y
    assert flash_fwd.pad_copies == before + 1
    (z,) = flash_fwd.unpad_head_dim(100, y)
    assert z.is_contiguous() and torch.equal(z, x)

    cache = torch.randn(4, 8, 2, 100).to(torch.float8_e4m3fn)
    assert flash_decode.cache_multiple(cache) == 16
    (c16,) = flash_fwd.pad_head_dim(cache, multiple=16)
    assert c16.dtype == cache.dtype and c16.shape[-1] == 112
    assert torch.equal(c16[..., :100].float(), cache.float())
    assert not c16[..., 100:].float().any()


# ------------------------------------------------------------ padding

@pytest.mark.parametrize("d", [32, 80, 100, 160])
def test_padded_inputs_give_the_true_d_results(d):
    """The plain forward, backward and decode on q, k, v (and dO, O)
    zero-padded from d to `kernel_head_dim(d)` with d's own scale: o and
    the gradients equal the true d's in their first d columns and are zero
    past them; lse equal."""
    dp = flash_fwd.kernel_head_dim(d)
    rng = np.random.default_rng(d)
    b, h, hk, sq, sk = 2, 4, 2, 24, 40

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def pad(x):
        return torch.nn.functional.pad(x, (0, dp - d))

    q, k, v = draw(b, h, sq, d), draw(b, hk, sk, d), draw(b, hk, sk, d)
    used = ([24, 19], [40, 23])
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    o, lse = flash_fwd.flash_attn_fwd_bhsd(q, k, v, *used, **kw)
    op, lsep = flash_fwd.flash_attn_fwd_bhsd(pad(q), pad(k), pad(v), *used,
                                             **kw)
    torch.testing.assert_close(op[..., :d], o, atol=PAD_ATOL, rtol=0)
    torch.testing.assert_close(lsep, lse, atol=PAD_ATOL, rtol=0)
    assert not op[..., d:].any()

    do = draw(b, h, sq, d)
    grads = flash_bwd.flash_attn_bwd_bhsd(do, q, k, v, o, lse, *used, **kw)
    padded = flash_bwd.flash_attn_bwd_bhsd(pad(do), pad(q), pad(k), pad(v),
                                           op, lsep, *used, **kw)
    for g, gp in zip(grads, padded):
        torch.testing.assert_close(gp[..., :d], g, atol=PAD_ATOL, rtol=0)
        assert not gp[..., d:].any()

    lens = torch.tensor([40, 13], dtype=torch.int32)
    od, lsed = flash_decode.decode_attn_bhsd(q[:, :, :1], k, v, lens, **kw)
    odp, lsedp = flash_decode.decode_attn_bhsd(pad(q[:, :, :1]), pad(k),
                                               pad(v), lens, **kw)
    torch.testing.assert_close(odp[..., :d], od, atol=PAD_ATOL, rtol=0)
    torch.testing.assert_close(lsedp, lsed, atol=PAD_ATOL, rtol=0)
    assert not odp[..., d:].any()


# ------------------------------------------------------------ against JAX

def attention_inputs(d, seed):
    rng = np.random.default_rng(seed)
    b, h, hk, sq, sk = 2, 2, 1, 24, 48
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    squ = np.asarray([24, 21], np.int32)
    sku = np.asarray([48, 30], np.int32)
    return q, k, v, do, squ, sku


@pytest.mark.parametrize("kind", ["fwd", "bwd", "decode"])
@pytest.mark.parametrize("d", [80, 256])
def test_plain_attention_matches_jax_kernels(kind, d):
    """The plain forward, backward and decode at GPT-3 2.7B's and GPT-J's
    head dims against the JAX kernels (interpret mode): causal GQA over
    ragged lengths; rows past seqused_q are not compared (the JAX kernel
    leaves them unmasked)."""
    q, k, v, do, squ, sku = attention_inputs(d, seed=d)
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    t = torch.from_numpy
    valid = np.arange(q.shape[2])[None, None, :] < squ[:, None, None]
    if kind == "decode":
        lens = np.asarray([48, 17], np.int32)
        o_j, lse_j = jax.jit(functools.partial(jax_decode, **kw))(
            q[:, :, :1], k, v, lens)
        o_t, lse_t = flash_decode.decode_attn_bhsd(t(q[:, :, :1]), t(k), t(v),
                                                   t(lens), **kw)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=O_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                                   atol=LSE_ATOL, rtol=0)
        return
    o_t, lse_t = flash_fwd.flash_attn_fwd_bhsd(t(q), t(k), t(v), t(squ),
                                               t(sku), **kw)
    if kind == "fwd":
        o_j, lse_j = jax.jit(functools.partial(jax_fwd, **kw))(q, k, v, squ,
                                                               sku)
        rows = np.broadcast_to(valid[..., None], q.shape)
        np.testing.assert_allclose(o_t.numpy()[rows], np.asarray(o_j)[rows],
                                   atol=O_ATOL, rtol=0)
        lv = np.broadcast_to(valid, lse_t.shape)
        np.testing.assert_allclose(lse_t.numpy()[lv], np.asarray(lse_j)[lv],
                                   atol=LSE_ATOL, rtol=0)
        return
    do = do * valid[..., None]  # callers pass dO = 0 past seqused_q
    o, lse = o_t.numpy(), lse_t.numpy()
    ref = jax.jit(functools.partial(jax_bwd, **kw))(do, q, k, v, o, lse, squ,
                                                    sku)
    out = flash_bwd.flash_attn_bwd_bhsd(t(do), t(q), t(k), t(v), t(o),
                                        t(lse), t(squ), t(sku), **kw)
    rows = np.broadcast_to(valid[..., None], q.shape)
    np.testing.assert_allclose(out[0].numpy()[rows], np.asarray(ref[0])[rows],
                               atol=GRAD_ATOL, rtol=0)
    for x, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=0)


# ------------------------------------------------------------ GPT-J

def seeded_weights(model, seed):
    """Every parameter drawn from numpy: norm weights 1 + N(0, 0.1), other
    vectors N(0, 0.02), matrices N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = rng.standard_normal(p.shape).astype(np.float32)
            norm = p.ndim == 1 and ("ln" in name or "norm" in name)
            x = 1 + 0.1 * x if norm else x * (0.02 if p.ndim == 1 else 0.05)
            p.copy_(torch.from_numpy(x))
    return model.eval()


@pytest.fixture(scope="module")
def gptj_models():
    """A tiny HF GPT-J (2 layers, width 128 over 4 heads: head dim 32, 16
    of it rotated), its state dict through the JAX remap into the JAX
    model and through the port's remap into the port's model; a 12-token
    prompt and 4 greedy tokens through the port's cache (the logits of
    each step), and JAX's and HF's logits of the whole sequence."""
    from transformers import GPTJConfig, GPTJForCausalLM

    c = GPTJConfig(vocab_size=509, n_embd=128, n_layer=2, n_head=4,
                   rotary_dim=16, n_positions=128, n_inner=None,
                   resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    hf = seeded_weights(GPTJForCausalLM(c), 8)
    sd = hf.state_dict()
    jcfg = jgptj.gptj_config_to_gpt2_config(c)
    jcfg.use_flash_attn = False
    jtree = to_numpy_tree(jgptj.remap_state_dict_hf_gptj(dict(sd), jcfg))
    cfg = gptj.gptj_config_to_gpt2_config(c)
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(gptj.remap_state_dict_hf_gptj(dict(sd), cfg))
    port.eval()

    b, n0, steps = 2, 12, 4
    seq = np.random.default_rng(1).integers(0, 509, (b, n0))
    ip = InferenceParams(max_seqlen=32, max_batch_size=b,
                         lengths_per_sample=torch.zeros(b, dtype=torch.int32))
    x, step_logits = seq, []
    for _ in range(steps + 1):
        with torch.no_grad():
            logits = port(torch.from_numpy(x).long(),
                          inference_params=ip).logits[:, -1]
        step_logits.append(logits.numpy())
        x = logits.argmax(-1).numpy()[:, None]
        seq = np.concatenate([seq, x], axis=1)
    ids = seq[:, :-1]  # the last pick is not fed back
    jm = jgpt.GPTLMHeadModel(jcfg, dtype=jnp.float32)
    jlogits = np.asarray(jax.jit(lambda p, x: jm.apply(p, x).logits)(
        {"params": jtree}, jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(ids)).logits.numpy()
    return dict(sd=sd, cfg=cfg, jtree=jtree, port=port, ids=ids, n0=n0,
                step_logits=np.stack(step_logits, 1), picked=seq[:, n0:],
                jlogits=jlogits, hf_logits=hf_logits)


def test_gptj_remap_and_logits_match_jax_and_hf(gptj_models):
    """The port's remap gives JAX's weights exactly (and refuses a key it
    does not know); the logits match JAX's and HF's."""
    m = gptj_models
    cfg = m["cfg"]
    assert (cfg.rotary_dim(), cfg.rotary_emb_interleaved, cfg.parallel_block,
            cfg.parallel_block_tied_norm, cfg.lm_head_bias) == (
                16, True, True, True, True)
    sd = gptj.remap_state_dict_hf_gptj(dict(m["sd"]), cfg)
    expected = state_dict_from_jax_params(m["jtree"], cfg)
    assert set(sd) == set(expected) == set(m["port"].state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), expected[k].numpy(),
                                      err_msg=k)
    with pytest.raises(ValueError, match="unmapped"):
        gptj.remap_state_dict_hf_gptj(
            dict(m["sd"], **{"extra.weight": torch.zeros(2)}), cfg)
    with torch.no_grad():
        out = m["port"](torch.from_numpy(m["ids"])).logits.numpy()
    np.testing.assert_allclose(out, m["jlogits"], atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(out, m["hf_logits"], atol=HF_ATOL, rtol=0)


def test_gptj_cached_greedy_steps_match_jax_and_hf(gptj_models):
    """The 12-token prefill and 4 greedy one-token steps through the
    port's cache: each step's logits equal JAX's and HF's logits of the
    whole sequence at that position, and the picked tokens are HF's
    greedy ones."""
    m = gptj_models
    rows = slice(m["n0"] - 1, None)
    np.testing.assert_allclose(m["step_logits"], m["jlogits"][:, rows],
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(m["step_logits"], m["hf_logits"][:, rows],
                               atol=HF_ATOL, rtol=0)
    assert np.array_equal(m["picked"], m["hf_logits"][:, rows].argmax(-1))


# ------------------------------------------------------------ GPT-3 2.7B

def test_gpt3_recipe_loads_like_jax():
    """The recipe through the port's `load_config` gives JAX's model
    fields (head dim 2560 / 32 = 80), and `chip_smoke.py` builds the same
    model, optimizer and scheduler in code (the card machine has no YAML
    parser), but for the optimizer-state sharding one card drops."""
    ours, theirs = load_config(str(RECIPE)), jax_config_mod.load_config(
        str(RECIPE))
    mo, mt = dataclasses.asdict(ours.model), dataclasses.asdict(theirs.model)
    assert {k: mo[k] for k in mt if k in mo} == {k: mt[k] for k in mt
                                                 if k in mo}
    og, tg = ours.model.to_gpt_config(), theirs.model.to_gpt2_config()
    for field in ("n_embd", "n_layer", "n_head", "vocab_size", "n_positions",
                  "rotary_emb_fraction", "activation_function",
                  "tie_word_embeddings", "residual_in_fp32"):
        assert getattr(og, field) == getattr(tg, field), field
    assert og.n_embd // og.n_head == 80 and og.rotary_dim() == 80
    assert (ours.data.seq_len, ours.data.batch_size) == (8192, 4)
    smoke = chip_smoke.gpt3_train_config()
    ours.optimizer.shard_optimizer_state = False  # one card
    for sec in ("model", "optimizer", "scheduler"):
        assert dataclasses.asdict(getattr(smoke, sec)) == dataclasses.asdict(
            getattr(ours, sec)), sec
    assert (smoke.data.seq_len, smoke.data.batch_size) == (8192, 4)


def test_gpt3_recipe_step_matches_jax():
    """The recipe's model at 2 layers, n_embd 160 over 2 heads (head dim
    80), float32: one batch's LM loss and every gradient against the JAX
    model's (the same seeded weights)."""
    cfg = load_config(str(RECIPE), overrides={"model": dict(
        n_layer=2, n_embd=160, n_head=2, dtype="float32")})
    gcfg = cfg.model.to_gpt_config()
    assert gcfg.n_embd // gcfg.n_head == 80
    # the port's GPTConfig as the JAX model's config (no transformers
    # import): it carries the GPT2Config attribute names the model reads
    jcfg = dataclasses.replace(gcfg)
    jcfg.head_dim, jcfg.use_flash_attn = 80, False
    jm = jgpt.GPTLMHeadModel(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(3)
    params = to_numpy_tree(jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.05).astype(np.float32),
        shapes))
    batch = rng.integers(0, gcfg.vocab_size, (2, 17)).astype(np.int32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jax_lm_loss(
        jm, p, jnp.asarray(batch), chunk_tokens=0)))(params)
    port = GPTLMHeadModel(gcfg, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params, gcfg))
    loss_t = chunked_lm_loss(port, torch.from_numpy(batch).long(),
                             chunk_tokens=0)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    expected = state_dict_from_jax_params(to_numpy_tree(grads_j), gcfg)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


# ------------------------------------------------- the smoke's own checks

@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_smoke_plain_by_heads_equals_one_call(which):
    """`chip_smoke.plain_by_heads`, which holds BTLM's 8192-token attention
    to its plain version a few heads at a time on the card, gives the
    plain version's own result over all heads (causal GQA under ALiBi,
    two q heads of each kv head a part); it refuses dropout (the keep mask
    hashes the head index) and a part that splits a group."""
    g = torch.Generator().manual_seed(80)
    b, h, hk, s, d = 2, 8, 4, 24, 80
    q, o, do = (torch.randn(b, h, s, d, generator=g) for _ in range(3))
    k, v = (torch.randn(b, hk, s, d, generator=g) for _ in range(2))
    lens = torch.tensor([24, 17], dtype=torch.int32)
    kw = dict(softmax_scale=1 / d, causal=True,
              alibi_slopes=torch.rand(b, h, generator=g))
    if which == "fwd":
        fn, args = flash_fwd.flash_attn_fwd_bhsd_ref, (q, k, v, lens, lens)
        kinds = ("q", "kv", "kv", None, None)
    else:
        lse = flash_fwd.flash_attn_fwd_bhsd_ref(q, k, v, lens, lens, **kw)[1]
        fn, args = flash_bwd.flash_attn_bwd_bhsd_ref, (do, q, k, v, o, lse,
                                                       lens, lens)
        kinds = ("q", "q", "kv", "kv", "q", "q", None, None)
    whole = fn(*args, **kw)
    parts = chip_smoke.plain_by_heads(fn, args, kinds, kw, heads=2)
    assert len(parts) == len(whole)
    for x, y in zip(parts, whole):
        torch.testing.assert_close(x, y, atol=PAD_ATOL, rtol=0)
    with pytest.raises(ValueError, match="split a group"):
        chip_smoke.plain_by_heads(fn, args, kinds, kw, heads=3)
    with pytest.raises(ValueError, match="dropout"):
        chip_smoke.plain_by_heads(fn, args, kinds,
                                  dict(kw, dropout_p=0.1), heads=2)


def test_smoke_ptxas_summary_files_serialized_wgmma(monkeypatch):
    """`chip_smoke.ptxas_summary` keeps ptxas's wgmma serialization notes
    (an info line, not a warning) under the instantiation they name, which
    the smoke's build check then fails on, beside spills."""
    from flash_attn_tpu_torch.kernels import _build

    fn = ("_ZN45_GLOBAL__N__a304c3cb_12_flash_bwd_cu_fb72e9ae20flash_bwd_dq_"
          "kernelI13__nv_bfloat16Li256ELb0ELb0ELb0EEEvNS_9BwdParamsENS_7Bwd"
          "MapsE")
    other = fn.replace("dq_kernelI13__nv_bfloat16Li256",
                       "dq_kernelI13__nv_bfloat16Li192")
    lines = [f"ptxas info    : Compiling entry function '{other}' for "
             "'sm_90a'",
             "ptxas info    : Used 228 registers",
             "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
             f"ptxas info    : (C7520) Potential Performance Loss: "
             "wgmma.mma_async instructions are serialized due to the "
             f"presence of a wgmma in a branch in the function '{fn}'",
             f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
             "ptxas info    : Used 220 registers"]
    monkeypatch.setitem(_build.build_info, "probe", {"ptxas": lines})
    out = chip_smoke.ptxas_summary("probe")
    wide = "flash_bwd_dq_kernel<13__nv_bfloat16Li256ELb0ELb0ELb0EE>"
    narrow = wide.replace("Li256", "Li192")
    assert out[wide]["registers"] == 220
    assert out[wide]["serialized"] == [lines[3]]
    assert "serialized" not in out[narrow]
    assert out[narrow]["spill_stores"] == 0 and out[narrow]["registers"] == 228


def test_smoke_profiled_kernel_dims_reads_instantiations():
    """`chip_smoke.profiled_kernel_dims` reads the template arguments after
    the dtype (D, kVarlen, kMods, kDropout) from the profiler's demangled
    device kernel names, each instantiation once, host events skipped: what
    `lm_train_phase` holds to the path's D and mods."""
    import types

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    names = ["void (anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16,"
             " 128, false, true, false>(BwdParams, BwdMaps)"] * 2 + [
        "void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 256, "
        "false, false, false>(FwdParams, FwdMaps)",
        "void at::native::vectorized_elementwise_kernel<4>(int)"]
    events = [types.SimpleNamespace(device_type=cuda, name=n) for n in names]
    events.append(types.SimpleNamespace(device_type=cpu, name=names[0].replace(
        "128", "64")))
    prof = types.SimpleNamespace(events=lambda: events)
    assert chip_smoke.profiled_kernel_dims(
        prof, ("flash_fwd_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkv_kernel")) == {
        "flash_bwd_dkv_kernel": ["128, false, true, false"],
        "flash_fwd_kernel": ["256, false, false, false"]}
