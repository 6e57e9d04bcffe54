"""The port's continuous-batching engine (`flash_attn_tpu_torch.serving`) on
the CPU, with weights carried over from the JAX model, against the JAX
model's no-cache forward (`use_flash_attn=False`) teacher-forced on the
engine's own tokens.

A greedy token passes when it is JAX's argmax, or when JAX's top-2 gap at
that position is below 1e-4 and it is the runner-up (float32 summation
order may flip a near-tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPT
from flash_attn_tpu_torch.models.gpt import (GPTConfig, GPTLMHeadModel,
                                             state_dict_from_jax_params)
from flash_attn_tpu_torch.serving import ServingEngine, _filter_topk_rows
from flash_attn_tpu_torch.utils.generation import (
    decode, modify_logits_for_min_p_filtering,
    modify_logits_for_top_k_filtering, modify_logits_for_top_p_filtering)

TINY = dict(n_embd=128, n_head=4, n_layer=2, vocab_size=311, n_positions=256)
NEAR_TIE = 1e-4
PROMPT_LENS = (7, 19, 33, 12, 25)
MAX_NEW = (6, 11, 9, 14, 8)


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX references here are tiny programs whose time is compiling,
    not running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny torch ops run faster on one thread than with torch's threads
    contending with JAX's (and other test processes') in one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    # the port's GPTConfig as the JAX model's config (no transformers
    # import): it carries the GPT2Config attribute names the model reads
    jcfg = GPTConfig(**TINY)
    jcfg.head_dim = jcfg.n_embd // jcfg.n_head
    jcfg.use_flash_attn = False
    jmodel = JaxGPT(jcfg, dtype=jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = GPTConfig(**TINY)
    port = GPTLMHeadModel(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(tree, cfg))
    port.eval()
    jlogits = jax.jit(lambda p, x: jmodel.apply(p, x).logits)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 311, (n,)) for n in PROMPT_LENS]
    return port, lambda ids: np.asarray(jlogits(params, jnp.asarray(ids)[None]))[0], prompts


def engine(port, **kw):
    return ServingEngine(port, max_batch=2, max_seqlen=128, chunk_steps=4,
                         prefill_buckets=(16, 32, 64), **kw)


def reference_logits(jax_logits, prompt, tokens):
    """JAX logits predicting each of `tokens` after `prompt`."""
    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int32)
    return jax_logits(seq)[len(prompt) - 1:]


def assert_greedy(logits, tokens):
    for row, t in zip(logits, tokens):
        order = np.argsort(-row)
        ok = t == order[0] or (t == order[1]
                               and row[order[0]] - row[order[1]] < NEAR_TIE)
        assert ok, (t, order[:2], row[order[:2]])


def test_engine_greedy_matches_jax(setup):
    port, jax_logits, prompts = setup
    eng = engine(port)
    uids = [eng.submit(p, max_new_tokens=mn) for p, mn in zip(prompts, MAX_NEW)]
    results = eng.run()
    assert eng.stats.finished == len(prompts)
    assert eng.stats.prefill_tokens == sum(PROMPT_LENS)
    for uid, p, mn in zip(uids, prompts, MAX_NEW):
        toks = results[uid]
        assert len(toks) == mn
        assert_greedy(reference_logits(jax_logits, p, toks), toks)


def test_engine_matches_port_decode(setup):
    port, _, prompts = setup
    eng = engine(port)
    uids = [eng.submit(p, max_new_tokens=mn) for p, mn in zip(prompts, MAX_NEW)]
    results = eng.run()
    for uid, p, mn in zip(uids, prompts, MAX_NEW):
        out = decode(torch.as_tensor(p)[None], port, len(p) + mn)
        assert out.sequences[0, len(p):].tolist() == results[uid]


def test_engine_eos_stops_early(setup):
    port, _, prompts = setup
    eng = engine(port)
    uid = eng.submit(prompts[0], max_new_tokens=8)
    cont = eng.run()[uid]
    eos = cont[2]
    eng = engine(port)
    uid = eng.submit(prompts[0], max_new_tokens=8, eos_token_id=int(eos))
    out = eng.run()[uid]
    assert out == cont[:cont.index(eos) + 1]
    assert out[-1] == eos


def test_engine_topk_sampling_stays_in_topk(setup):
    port, jax_logits, prompts = setup
    k = 5
    eng = engine(port, generator=torch.Generator().manual_seed(0))
    uids = [eng.submit(p, max_new_tokens=mn, top_k=k, temperature=0.8)
            for p, mn in zip(prompts[:3], MAX_NEW[:3])]
    results = eng.run()
    for uid, p in zip(uids, prompts[:3]):
        toks = results[uid]
        for row, t in zip(reference_logits(jax_logits, p, toks), toks):
            kth = np.sort(row)[-k]
            assert row[t] >= kth - NEAR_TIE


def test_filters_match_jax():
    from flash_attn_tpu.serving import _filter_topk_rows as jax_rows
    from flash_attn_tpu.utils import generation as jgen

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 50)).astype(np.float32) * 2
    t, j = torch.from_numpy(logits), jnp.asarray(logits)
    top_k = np.asarray([1, 3, 50, 7])
    pairs = [
        (_filter_topk_rows(t, torch.from_numpy(top_k)),
         jax_rows(j, jnp.asarray(top_k))),
        (modify_logits_for_top_k_filtering(t, 5),
         jgen.modify_logits_for_top_k_filtering(j, 5)),
        (modify_logits_for_top_p_filtering(t, 0.7),
         jgen.modify_logits_for_top_p_filtering(j, 0.7)),
        (modify_logits_for_min_p_filtering(t, 0.2),
         jgen.modify_logits_for_min_p_filtering(j, 0.2)),
    ]
    for ours, ref in pairs:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_mesh_and_speculative_raise(setup):
    port, _, _ = setup
    with pytest.raises(NotImplementedError):
        engine(port, mesh=object())
    with pytest.raises(NotImplementedError):
        engine(port, model_draft=port)
