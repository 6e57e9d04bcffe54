"""The port's BERT (`flash_attn_tpu_torch.models.bert`) and padding utilities
(`utils.padding`) against the JAX package, at a tiny size (2 layers, hidden
128, 4 heads, vocab 523, as `tests/models/test_bert.py`; the gradient case
at 1 layer, since JAX's gradient through the interpret-mode varlen kernel is
what costs), in float32 on the CPU, with the JAX weights carried over by
`bert_state_dict_from_jax_params`.

* The padded `BertModel` (mask -> per-batch seqused of the dense kernels)
  and the unpadded one (`unpad_varlen=True`: the packed varlen kernels),
  hidden states and pooled output, with padded rows exactly 0 in the
  unpadded output; `BertForPreTraining`'s MLM and NSP logits.
* `jax.grad` of a seeded random projection of the unpadded encoder output,
  taken through the JAX packed backward kernel (interpret mode), against
  the port's autograd, every parameter.
* `unpad_input`, `pad_input`, `unpad_input_for_concatenated_sequences`.
* `deterministic=False` with a dropout probability above 0 raises
  NotImplementedError (the port has no dropout yet; JAX applies it).

`remap_state_dict_hf_bert` is tested in `test_torch_bert_hf.py`, apart,
because importing `transformers` takes seconds.

The JAX model runs under `jax.jit`, with its random weights made from numpy
on the shapes of `jax.eval_shape(model.init)` (no interpret-mode init).
Tolerances: 1e-4 on hidden states, logits and pooled outputs (at most a
dozen float32 matrix products and norms deep; both sides differ only in
summation order),
and 1e-4 of each parameter gradient's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import bert as jax_bert
from flash_attn_tpu.utils import padding as jax_padding
from flash_attn_tpu_torch.kernels import flash_fwd, varlen
from flash_attn_tpu_torch.models import bert
from flash_attn_tpu_torch.utils import padding

CFG = bert.BertConfig(vocab_size=523, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=512,
                      max_position_embeddings=128, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
CFG1 = dataclasses.replace(CFG, num_hidden_layers=1)
LENGTHS = [64, 17, 40]
B, S = 3, 64
ATOL = 1e-4
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    types = rng.integers(0, CFG.type_vocab_size, (B, S)).astype(np.int32)
    mask = np.arange(S)[None, :] < np.asarray(LENGTHS)[:, None]
    return ids, types, mask


def random_params(module, seed, *args):
    """The module's flax parameters at random: matrices and embeddings
    N(0, 0.05), biases N(0, 0.02), norm weights 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if leaf.ndim >= 2:
            x = rng.normal(0.0, 0.05, leaf.shape)
        elif "weight" in name:
            x = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        else:
            x = rng.normal(0.0, 0.02, leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port(cls, params, cfg=CFG):
    model = cls(cfg, device="cpu")
    model.load_state_dict(bert.bert_state_dict_from_jax_params(params, cfg))
    return model


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def encoder():
    """The JAX BertModel's outputs on one batch, padded and unpadded."""
    ids, types, mask = batch()
    model = jax_bert.BertModel(CFG)
    params = random_params(model, 2, ids, mask, types)
    padded = jax.jit(lambda p: model.apply(p, ids, mask, types))(params)
    unpadded = jax.jit(lambda p: model.apply(p, ids, mask, types,
                                             unpad_varlen=True))(params)
    return dict(params=params, padded=padded, unpadded=unpadded)


@pytest.mark.parametrize("unpad", [False, True])
def test_bert_model_matches_jax(encoder, unpad):
    ids, types, mask = batch()
    model = port(bert.BertModel, encoder["params"])
    ref_h, ref_pooled = encoder["unpadded" if unpad else "padded"]
    before = varlen.launches_fwd, flash_fwd.launches
    with torch.no_grad():
        h, pooled = model(t(ids), t(mask), t(types), unpad_varlen=unpad)
    assert (varlen.launches_fwd, flash_fwd.launches) == before  # plain
    valid = mask[..., None].repeat(CFG.hidden_size, -1)
    np.testing.assert_allclose(h.numpy()[valid], np.asarray(ref_h)[valid],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled),
                               atol=ATOL, rtol=0)
    if unpad:
        assert not h.numpy()[~valid].any()


def test_bert_unpadded_grad_matches_jax():
    """The gradient of sum(hidden * R) over the 1-layer encoder's
    parameters, unpadded."""
    ids, types, mask = batch()
    jmodel = jax_bert.BertModel(CFG1)
    params = random_params(jmodel, 2, ids, mask, types)
    proj = np.random.default_rng(3).standard_normal(
        (B, S, CFG1.hidden_size)).astype(np.float32)

    def loss(p):
        h, _ = jmodel.apply(p, ids, mask, types, unpad_varlen=True)
        return jnp.sum(h * proj)

    grads = jax.jit(jax.grad(loss))(params)
    model = port(bert.BertModel, params, CFG1)
    h, _ = model(t(ids), t(mask), t(types), unpad_varlen=True)
    (h * t(proj)).sum().backward()
    ref = bert.bert_state_dict_from_jax_params(grads, CFG1)
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        # the pooler is not on the loss's path: no gradient, JAX's zeros
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_RTOL * np.abs(r).max(),
                                   err_msg=name)


def test_bert_pretraining_matches_jax():
    ids, types, mask = batch(4)
    model = jax_bert.BertForPreTraining(CFG)
    params = random_params(model, 5, ids, mask, types)
    logits_j, nsp_j = jax.jit(lambda p: model.apply(p, ids, mask, types))(
        params)
    ours = port(bert.BertForPreTraining, params)
    with torch.no_grad():
        logits, nsp = ours(t(ids), t(mask), t(types))
    valid = mask[..., None].repeat(CFG.vocab_size, -1)
    np.testing.assert_allclose(logits.numpy()[valid],
                               np.asarray(logits_j)[valid], atol=ATOL, rtol=0)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(nsp_j), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("cls", ["BertModel", "BertForPreTraining"])
def test_bert_dropout_raises_until_ported(cls):
    """JAX applies the configured dropout when deterministic=False; the port
    has the attention dropout but raises on the hidden dropout instead of
    running without it.  deterministic=False with the hidden dropout at 0
    is the deterministic path on the padded branch, with or without an
    attention dropout (JAX's `key_padding_mask` branch passes none, quirk
    10); the unpadded path's attention dropout is held to JAX's in
    `tests/test_torch_dropout.py`."""
    ids, types, mask = batch()
    torch.manual_seed(0)
    cfg = dataclasses.replace(CFG, hidden_dropout_prob=0.1)
    model = getattr(bert, cls)(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1.3"):
        model(t(ids), t(mask), t(types), deterministic=False)
    for cfg in (CFG, dataclasses.replace(CFG,
                                         attention_probs_dropout_prob=0.1)):
        model = getattr(bert, cls)(cfg, device="cpu")
        with torch.no_grad():
            a = model(t(ids), t(mask), t(types), deterministic=False)
            b = model(t(ids), t(mask), t(types))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_padding_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 7, 2, 5)).astype(np.float32)
    mask = np.array([[1] * 7, [1] * 3 + [0] * 4, [0] * 7], bool)
    unused = np.zeros_like(mask)
    unused[1, 3:5] = True
    for um in (None, unused):
        got = padding.unpad_input(t(x), t(mask),
                                  None if um is None else t(um))
        ref = jax_padding.unpad_input(jnp.asarray(x), jnp.asarray(mask),
                                      None if um is None else jnp.asarray(um))
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
        assert isinstance(got[3], int)
        back = padding.pad_input(got[0], got[1], 3, 7)
        ref_back = jax_padding.pad_input(ref[0], ref[1], 3, 7)
        np.testing.assert_array_equal(back.numpy(), np.asarray(ref_back))
    assert not back[2].any()  # padded rows are exact zeros
    lens = np.array([[2, 3, 0, 0, 0, 0, 0], [7, 0, 0, 0, 0, 0, 0],
                     [1, 1, 1, 0, 0, 0, 0]])
    got = padding.unpad_input_for_concatenated_sequences(t(x), t(lens))
    ref = jax_padding.unpad_input_for_concatenated_sequences(
        jnp.asarray(x), jnp.asarray(lens))
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
