"""The rest of the port's training harness against the JAX package's, on
the CPU in float32: block rematerialisation and float16 compute, EMA, the
plateau scheduler, `evaluate(use_ema=)` and checkpoints with the EMA, the
eval CLI, the callbacks and loggers, the `.bin`, text-file and native data
loaders, and the recipes' configs.

Remat: a tiny Llama (2 layers, width 64, 4 heads over 2, RMSNorm, rotary,
SwiGLU); under each policy the loss and gradients equal the port's own
without remat bit for bit (the same operations run, some of them twice),
and JAX's `remat_blocks=True` gradients within 1e-5 relative (XLA's
reference attention; summation orders differ).

The JAX Trainer takes the port's `GPTConfig` as its model config (it has
the attribute names the JAX model reads), so no `transformers` import is
needed, and runs XLA's reference attention.

Other tolerances: EMA 1e-6 (one float32 expression a step); plateau multipliers
exact (powers of 1/2) and learning rates rtol 1e-6 (as the schedules in
`test_torch_training.py`); evaluation against JAX 1e-5; every loader's
batches and the text token arrays exact.
"""

import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch.utils._python_dispatch import TorchDispatchMode

from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPT
from flash_attn_tpu.training import callbacks as jax_callbacks
from flash_attn_tpu.training import config as jax_config_mod
from flash_attn_tpu.training import data as jax_data
from flash_attn_tpu.training import hf_data as jax_hf
from flash_attn_tpu.training import native_loader as jax_native
from flash_attn_tpu.training import optim as jax_optim
from flash_attn_tpu.training.loss import chunked_lm_loss as jax_lm_loss
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu_torch.models.gpt import (GPTConfig, GPTLMHeadModel,
                                             state_dict_from_jax_params)
from flash_attn_tpu_torch.training import (callbacks, data, eval as
                                           eval_cli, hf_data, loggers,
                                           native_loader, optim)
from flash_attn_tpu_torch.training.config import (TrainConfig,
                                                  check_supported,
                                                  load_config)
from flash_attn_tpu_torch.training.loss import chunked_lm_loss
from flash_attn_tpu_torch.training.run import parse_overrides
from flash_attn_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
RECIPES = ROOT / "flash_attn_tpu" / "training" / "configs" / "experiment"
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = {"model": {"n_embd": 64, "n_layer": 2, "n_head": 2,
                  "vocab_size": 128, "max_position_embeddings": 64,
                  "dtype": "float32"},
        "data": {"seq_len": 32, "batch_size": 2},
        "optimizer": {"lr": 1e-3},
        "scheduler": {"warmup_steps": 2},
        "trainer": {"log_every": 1, "resume": False, "eval_steps": 2}}


def tiny(tmp_path, port=True, **over):
    """The tiny GPT run of `test_torch_training.py` for either package,
    with `section__field` overrides."""
    load = load_config if port else jax_config_mod.load_config
    cfg = load(overrides=json.loads(json.dumps(TINY)))
    cfg.trainer.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.trainer.out_dir = str(tmp_path / "runs")
    for key, val in over.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, val)
    return cfg


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


# -------------------------------------------------------------- remat

POLICIES = ("none", "dots", "dots_no_batch")
LLAMA = dict(n_embd=64, n_layer=2, n_head=4, n_head_kv=2, vocab_size=128,
            n_positions=64, rms_norm=True, rotary_emb_fraction=1.0,
            activation_function="swiglu", tie_word_embeddings=False,
            residual_in_fp32=True)


def jax_model(**over):
    cfg = dataclasses.replace(GPTConfig(**LLAMA), **over)
    cfg.use_flash_attn = False
    cfg.head_dim = cfg.n_embd // cfg.n_head
    return JaxGPT(cfg, dtype=jnp.float32)


@pytest.fixture(scope="module")
def setup():
    """Seeded weights in the JAX tree, a (2, 33) token batch, and the
    port's loss and gradients without remat."""
    batch = np.random.default_rng(0).integers(0, 128, (2, 33)).astype(
        np.int32)
    shapes = jax.eval_shape(jax_model().init, jax.random.PRNGKey(0),
                            jnp.asarray(batch[:, :-1]))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)
    sd = state_dict_from_jax_params(params, GPTConfig(**LLAMA))
    loss, grads = port_grads(sd, batch, remat=None)
    # JAX's remat_blocks=True gradients (its policies differ only in what
    # the backward keeps, not in the values)
    jm = jax_model(remat_blocks=True)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jm, p, jnp.asarray(batch), chunk_tokens=0)))(
        params)
    return dict(batch=batch, params=params, sd=sd, loss=loss, grads=grads,
                jax_loss=float(jloss), jax_grads=state_dict_from_jax_params(
                    jax.tree_util.tree_map(np.asarray, jgrads),
                    GPTConfig(**LLAMA)))


def port_grads(sd, batch, remat):
    over = dict(remat_blocks=remat is not None, remat_policy=remat or "none")
    model = GPTLMHeadModel(GPTConfig(**LLAMA, **over), device="cpu")
    model.load_state_dict(sd)
    loss = chunked_lm_loss(model, torch.from_numpy(batch).long(),
                           chunk_tokens=0)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_plain_and_jax(setup, policy):
    loss, grads = port_grads(setup["sd"], setup["batch"], policy)
    assert torch.equal(loss, setup["loss"])
    for name, g in grads.items():
        assert torch.equal(g, setup["grads"][name]), name

    np.testing.assert_allclose(float(loss), setup["jax_loss"], rtol=1e-5)
    for name, g in grads.items():
        ref = setup["jax_grads"][name].numpy()
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, (name, err)


class CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.counts["mm"] += 1
        elif name == "bmm":
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_keep_the_products(setup):
    """Products run in the backward: "none" runs the blocks' forward
    products again; "dots" keeps every product's output, so its backward
    runs the plain backward's; "dots_no_batch" keeps the 2-D products and
    recomputes the batched ones (the plain attention's)."""
    ids = torch.from_numpy(setup["batch"]).long()
    seen = {}
    for policy in (None,) + POLICIES:
        over = dict(remat_blocks=policy is not None,
                    remat_policy=policy or "none")
        model = GPTLMHeadModel(GPTConfig(**LLAMA, **over), device="cpu")
        model.load_state_dict(setup["sd"])
        loss = chunked_lm_loss(model, ids, chunk_tokens=0)
        with CountProducts() as c:
            loss.backward()
        seen[policy] = c.counts
    plain = seen[None]
    assert seen["none"]["mm"] > plain["mm"]
    assert seen["none"]["bmm"] > plain["bmm"]
    assert seen["dots"] == plain
    assert seen["dots_no_batch"]["mm"] == plain["mm"]
    assert seen["dots_no_batch"]["bmm"] > plain["bmm"]


def test_remat_is_training_only(setup):
    """No checkpointing under no_grad or with a cache (decode paths)."""
    model = GPTLMHeadModel(GPTConfig(**LLAMA, remat_blocks=True), device="cpu")
    model.load_state_dict(setup["sd"])
    ids = torch.from_numpy(setup["batch"][:, :8]).long()
    with torch.no_grad(), CountProducts() as c:
        model(ids)
    assert c.counts["mm"] == 2 * 4 + 1  # Wqkv, out_proj, fc1, fc2; head
    with pytest.raises(ValueError, match="remat_policy"):
        GPTLMHeadModel(GPTConfig(**LLAMA, remat_policy="all"), device="cpu")


def tiny_llama(**over):
    cfg = TrainConfig()
    m = cfg.model
    m.n_embd, m.n_layer, m.n_head, m.n_head_kv = 64, 2, 4, 2
    m.vocab_size, m.max_position_embeddings = 128, 64
    m.rms_norm, m.rotary_emb_fraction = True, 1.0
    m.activation_function, m.tie_word_embeddings = "swiglu", False
    cfg.data.seq_len, cfg.data.batch_size = 32, 2
    cfg.trainer.resume = False
    for key, val in over.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, val)
    return cfg


def test_trainer_float16_and_remat_against_float32():
    """The Trainer under float16 autocast (no loss scaler) with remat, one
    batch: loss within 0.02 and gradient cosine >= 0.999 against float32
    without remat, on the same weights."""
    f16 = Trainer(tiny_llama(model__dtype="float16",
                              model__remat_blocks=True), device="cpu")
    f32 = Trainer(tiny_llama(model__dtype="float32"), device="cpu")
    assert f16.autocast and f16.autocast_dtype == torch.float16
    assert f16.gpt_config.remat_blocks and not f32.gpt_config.remat_blocks
    batch = next(f32.loader)
    out = []
    for t in (f16, f32):
        loss = t.loss(batch)
        loss.backward()
        out.append((float(loss.detach()), torch.cat(
            [p.grad.flatten() for p in t.model.parameters()]).double()))
    (l16, g16), (l32, g32) = out
    assert abs(l16 - l32) <= 0.02
    assert float(g16 @ g32 / (g16.norm() * g32.norm())) >= 0.999


# ---------------------------------------------------------------- EMA

def test_ema_matches_jax_ema_update(tmp_path):
    """After k steps the EMA equals JAX's `ema_update` applied to the same
    sequence of parameters, from the same start."""
    t = Trainer(tiny(tmp_path, trainer__ema_decay=0.9), device="cpu")
    names = [n for n, _ in t.model.named_parameters()]
    snap = lambda: {n: p.detach().numpy().copy()  # noqa: E731
                    for n, p in t.model.named_parameters()}
    ema = snap()  # numpy leaves: JAX's tree_map of float32 expressions
    for _ in range(4):
        t.train_step(next(t.loader))
        ema = jax_optim.ema_update(ema, snap(), 0.9)
    assert all(e.dtype == torch.float32 for e in t.ema_params)
    for n, e in zip(names, t.ema_params):
        np.testing.assert_allclose(e.numpy(), np.asarray(ema[n]), atol=1e-6,
                                   rtol=0, err_msg=n)


def test_evaluate_use_ema_and_resume_carry_the_ema(tmp_path):
    """`evaluate(use_ema=True)` runs on the EMA and leaves the live weights
    in place; a checkpoint and resume carry the EMA exactly, and the
    resumed run equals a straight one, EMA included."""
    over = dict(trainer__ema_decay=0.5, trainer__max_steps=3,
                trainer__checkpoint_every=3)
    t = Trainer(tiny(tmp_path / "a", **over), device="cpu")
    t.train(log_fn=lambda m: None)
    live = [p.detach().clone() for p in t.model.parameters()]
    ref = Trainer(tiny(tmp_path / "r"), device="cpu")
    with torch.no_grad():
        for p, e in zip(ref.model.parameters(), t.ema_params):
            p.copy_(e)
    for tr in (t, ref):
        tr.loader.state = data.LoaderState(seed=0)
    assert t.evaluate(use_ema=True) == ref.evaluate()
    assert all(torch.equal(p, q) for p, q in zip(t.model.parameters(), live))
    t.loader.state = data.LoaderState(seed=0)
    ref.loader.state = data.LoaderState(seed=0)
    assert t.evaluate() != ref.evaluate()

    resumed = Trainer(tiny(tmp_path / "a", **dict(
        over, trainer__max_steps=5, trainer__resume=True)), device="cpu")
    assert resumed.maybe_resume() and resumed.step == 3
    for a, b in zip(resumed.ema_params, t.ema_params):
        assert torch.equal(a, b)
    resumed.train(log_fn=lambda m: None)
    straight = Trainer(tiny(tmp_path / "b", trainer__ema_decay=0.5,
                            trainer__max_steps=5), device="cpu")
    straight.train(log_fn=lambda m: None)
    for a, b in zip(resumed.ema_params, straight.ema_params):
        assert torch.equal(a, b)


# ------------------------------------------------------------ plateau

def test_plateau_matches_jax():
    """The learning rate of each update for a sequence of eval losses: the
    port's `PlateauLR` against the JAX schedule times the multiplier that
    JAX's `Trainer._on_eval` keeps in the optax state."""
    sc = jax_config_mod.SchedulerConfig(
        name="plateau", warmup_steps=3, gamma=0.5, plateau_patience=2,
        plateau_min_delta=0.01)
    oc = jax_config_mod.OptimizerConfig(lr=1e-3)
    params = {"w": jnp.ones((2, 2))}
    jax_state = jax_optim.make_optimizer(oc, sc, params).init(params)
    jt = types.SimpleNamespace(
        _plateau=True, _best_eval=float("inf"), _plateau_bad=0,
        opt_state=jax_state, config=types.SimpleNamespace(scheduler=sc))
    sched = jax_optim.make_schedule(sc)
    model = torch.nn.Linear(2, 2)
    opt, port = optim.make_optimizer(oc, sc, model)
    assert isinstance(port, optim.PlateauLR)
    losses = [3.0, 2.9, 2.895, 2.95, 2.8, 2.85, 2.9, 2.95, 2.79, 2.7]
    for count, loss in enumerate(losses):
        mult = float(jt.opt_state.hyperparams["lr_mult"])
        assert port.lr_mult == mult
        want = oc.lr * mult * float(sched(count))
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want,
                                   rtol=1e-6, atol=0)
        opt.step()
        port.step()
        JaxTrainer._on_eval(jt, loss)
        port.on_eval(loss)
    assert port.lr_mult == float(jt.opt_state.hyperparams["lr_mult"]) \
        == 0.125
    state = port.state_dict()
    _, again = optim.make_optimizer(oc, sc, torch.nn.Linear(2, 2))
    again.load_state_dict(state)
    assert (again.lr_mult, again.best, again.bad) == (0.125, 2.7, 0)


def test_trainer_plateau_reacts_to_evals(tmp_path):
    t = Trainer(tiny(tmp_path, scheduler__name="plateau",
                     scheduler__warmup_steps=0, scheduler__plateau_patience=1,
                     trainer__max_steps=3, trainer__eval_every=1),
                device="cpu")
    seen = []
    t._on_eval = lambda loss, f=t._on_eval: (seen.append(loss), f(loss))
    t.train(log_fn=lambda m: None)
    assert len(seen) == 3
    best, mult = float("inf"), 1.0
    for loss in seen:
        if loss < best:
            best = loss
        else:
            mult *= 0.1
    assert t.scheduler.lr_mult == mult


# ----------------------------------------------------- eval CLI, JAX

@pytest.mark.parametrize("ema", [False, True])
def test_eval_cli_matches_trainer_evaluate(tmp_path, capsys, ema):
    """The CLI on a saved run prints the JSON of `Trainer.evaluate` on the
    same checkpoint: from the loader's start with --checkpoint, from the
    saved loader state without."""
    over = dict(trainer__ema_decay=0.9, trainer__max_steps=3,
                trainer__checkpoint_every=3)
    Trainer(tiny(tmp_path, **over), device="cpu").train(log_fn=lambda m: None)
    cfg_path = tmp_path / "cfg.yaml"
    doc = json.loads(json.dumps(TINY))
    doc["trainer"].update(checkpoint_dir=str(tmp_path / "ckpt"),
                          ema_decay=0.9)
    cfg_path.write_text(yaml.safe_dump(doc))
    flags = ["--ema"] if ema else []
    for explicit in (True, False):
        ck = ["--checkpoint", str(tmp_path / "ckpt" / "step_3")]
        capsys.readouterr()
        res = eval_cli.main(["--config", str(cfg_path), "--steps", "2",
                             *(ck if explicit else []), *flags,
                             "data.seed=0"], device="cpu")
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == res
        t = Trainer(tiny(tmp_path, trainer__ema_decay=0.9), device="cpu")
        t.load_checkpoint(tmp_path / "ckpt" / "step_3", loader=not explicit)
        loss = t.evaluate(use_ema=ema)
        assert res == {"step": 3, "eval_loss": round(loss, 6),
                       "perplexity": round(float(np.exp(loss)), 4),
                       "ema": ema}


def test_evaluate_matches_jax(tmp_path, monkeypatch):
    """`Trainer.evaluate` against JAX's on the same carried weights and the
    same batches."""
    def port_config(self):
        cfg = load_config(overrides={"model": dataclasses.asdict(self)}
                          ).model.to_gpt_config()
        cfg.use_flash_attn = False
        cfg.head_dim = cfg.n_embd // cfg.n_head
        return cfg

    monkeypatch.setattr(jax_config_mod.ModelConfig, "to_gpt2_config",
                        port_config)
    jt = JaxTrainer(tiny(tmp_path / "j", port=False))
    t = Trainer(tiny(tmp_path / "t"), device="cpu")
    t.model.load_state_dict(state_dict_from_jax_params(
        to_numpy_tree(jt.params), t.gpt_config))
    np.testing.assert_allclose(t.evaluate(), jt.evaluate(), rtol=1e-5)
    assert t.loader.state.to_dict() == jt.loader.state.to_dict()


# ---------------------------------------------------- callbacks, loggers

def test_callbacks_match_jax():
    rng = np.random.default_rng(0)
    params = [rng.standard_normal((3, 4)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)]
    grads = [2 * p for p in params]
    ours = callbacks.NormMonitor()([torch.from_numpy(p) for p in params],
                                   [torch.from_numpy(g) for g in grads])
    theirs = jax_callbacks.NormMonitor()([jnp.asarray(p) for p in params],
                                         [jnp.asarray(g) for g in grads])
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6)
    nt, jn = callbacks.NumTokens(5), jax_callbacks.NumTokens(5)
    for n in (7, 11, 0):
        nt.update(n)
        jn.update(n)
    assert nt.count == jn.count == 23


def test_causality_check(tmp_path):
    t = Trainer(tiny(tmp_path), device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 16)))
    assert callbacks.causality_check(t.model, ids, pos=7)
    for layer in t.model.transformer.layers:
        layer.mixer.causal = False  # a broken mask sees the future
    assert not callbacks.causality_check(t.model, ids, pos=7)


def test_tensorboard_logger_and_fallbacks(tmp_path, monkeypatch):
    """TensorBoard writes an event file where `tensorboardX` is present and
    is dropped where it is absent; wandb and mlflow fall back to JSONL."""
    pytest.importorskip("tensorboardX")
    lc = loggers.make_loggers(["tensorboard"], tmp_path / "tb_on")
    assert isinstance(lc.loggers[0], loggers.TensorBoardLogger)
    lc.log(1, {"loss": 2.5, "note": "text"})
    lc.close()
    assert list((tmp_path / "tb_on" / "tb").glob("events.out.tfevents.*"))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    assert loggers.make_loggers(["tb"], tmp_path / "tb_off").loggers == []
    for name in ("wandb", "mlflow"):
        monkeypatch.setitem(sys.modules, name, None)
    lc = loggers.make_loggers(["wandb", "mlflow"], tmp_path / "ext")
    assert [type(lg) for lg in lc.loggers] == [loggers.JSONLLogger] * 2
    lc.log(0, {"loss": 1.0})
    lc.close()
    assert len((tmp_path / "ext" / "metrics.jsonl").read_text()
               .splitlines()) == 2


# --------------------------------------------------------------- data

def test_lm_dataset_from_bin_matches_jax(tmp_path):
    tokens = np.random.default_rng(5).integers(0, 60000, 1001).astype(
        np.uint16)
    tokens.tofile(tmp_path / "t.bin")
    ours = data.lm_dataset_from_bin(tmp_path / "t.bin", 24)
    theirs = jax_data.lm_dataset_from_bin(tmp_path / "t.bin", 24)
    assert len(ours) == len(theirs) == 41
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i], theirs[i])


@pytest.fixture(scope="module")
def text_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("text")
    lines = [f" = Title {i} = \n" if i % 7 == 0 else
             f"the state @-@ of @-@ art , line {i} isn 't it ? \n"
             for i in range(60)]
    (d / "a.txt").write_text("".join(lines[:30]) + "\n\n")
    (d / "b.jsonl").write_text("".join(
        json.dumps({"text": ln, "id": i}) + "\n"
        for i, ln in enumerate(lines[30:])))
    return [str(d / "a.txt"), str(d / "b.jsonl")]


@pytest.mark.parametrize("detok,files,cap", [
    (None, slice(0, 1), 0), ("wikitext", slice(1, 2), 0),
    ("wikitext", slice(0, 2), 40)], ids=["txt", "jsonl", "both_capped"])
def test_text_files_match_jax(tmp_path, text_files, detok, files, cap):
    """Token arrays, their cache and the loader's batches equal JAX's."""
    kw = dict(text_files=text_files[files], tokenizer="bytes",
              detokenizer=detok, max_examples=cap)
    ours = hf_data.tokenize_to_array(hf_data.HFDataConfig(
        cache_dir=str(tmp_path / "p"), **kw))
    theirs = jax_hf.tokenize_to_array(jax_hf.HFDataConfig(
        cache_dir=str(tmp_path / "j"), **kw))
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.int32 and list((tmp_path / "p").glob("*.npy"))
    cached = hf_data.tokenize_to_array(hf_data.HFDataConfig(
        cache_dir=str(tmp_path / "p"), **kw))
    np.testing.assert_array_equal(cached, ours)
    lt = hf_data.make_hf_loader(hf_data.HFDataConfig(
        cache_dir=str(tmp_path / "p"), **kw), 16, 3, seed=2)
    lj = jax_hf.make_hf_loader(jax_hf.HFDataConfig(
        cache_dir=str(tmp_path / "j"), **kw), 16, 3, seed=2)
    for _ in range(5):
        np.testing.assert_array_equal(next(lt), next(lj))


def test_wikitext_detokenize_and_hub_names_raise(tmp_path):
    for s in ("the state @-@ of @-@ the @-@ art , he said .",
              "( a ) `` b '' c n't d 's 1 @.@ 5 @,@ 000 ; e : f !"):
        assert hf_data.wikitext_detokenize(s) == jax_hf.wikitext_detokenize(s)
    with pytest.raises(NotImplementedError, match="bytes"):
        hf_data.make_tokenizer("gpt2")
    with pytest.raises(NotImplementedError, match="bytes"):
        hf_data.tokenize_to_array(hf_data.HFDataConfig(
            dataset_name="wikitext", tokenizer="bytes",
            cache_dir=str(tmp_path)))


@pytest.fixture(scope="module")
def jax_native_private_build(tmp_path_factory):
    """JAX's `NativeLMLoader` on its own build of the same C++ source in a
    private directory (its `build_standalone` runs `make` in `standalone/`,
    which another test process may be running at the same time)."""
    d = tmp_path_factory.mktemp("standalone")
    (d / "build").mkdir()
    import subprocess

    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    str(native_loader.SOURCE), "-o",
                    str(d / "build" / "libfa_data_loader.so"), "-lpthread"],
                   check=True)
    return str(d)


def native_batches(mod, paths, start=0, epoch=0):
    ld = mod.NativeLMLoader(paths, seq_len=63, batch_size=4, seed=7,
                            epoch=epoch, start_batch=start)
    got = dict(iter(ld))
    ld.close()
    return got


def test_native_loader_matches_jax(tmp_path, monkeypatch,
                                   jax_native_private_build):
    """Same shards, seed, epoch and start batch: the same batches by index
    as JAX's loader; each row is a row of the memmap `LMDataset` over the
    same tokens; the resume is exact."""
    monkeypatch.setattr(jax_native, "STANDALONE_DIR",
                        jax_native_private_build)
    monkeypatch.setattr(jax_native, "build_standalone", lambda: None)
    toks = np.random.default_rng(0).integers(0, 1000, 4096, dtype=np.uint16)
    paths = [tmp_path / "a.bin", tmp_path / "b.bin"]
    toks[:2048].tofile(paths[0])
    toks[2048:].tofile(paths[1])
    toks.tofile(tmp_path / "all.bin")
    ds = data.lm_dataset_from_bin(tmp_path / "all.bin", 63)
    rows = {bytes(np.asarray(ds[i], np.int32)) for i in range(len(ds))}
    for epoch, start in ((0, 0), (1, 10)):
        ours = native_batches(native_loader, paths, start, epoch)
        theirs = native_batches(jax_native, paths, start, epoch)
        assert set(ours) == set(theirs) == set(range(start, 16))
        for i in ours:
            np.testing.assert_array_equal(ours[i], theirs[i])
            assert all(bytes(r) in rows for r in ours[i])
    full = native_batches(native_loader, paths)
    for i, b in native_batches(native_loader, paths, start=10).items():
        np.testing.assert_array_equal(b, full[i])


def test_native_loader_pinned_order(tmp_path):
    """The example order `chip_smoke.py` holds the card machine's build
    to: a shard of the tokens 0, 1, ..., so a row's first token over
    seq_len is its example."""
    case = chip_smoke.NATIVE_CASE
    path = tmp_path / "arange.bin"
    np.arange(case["n_tokens"], dtype=np.uint16).tofile(path)
    assert chip_smoke.native_order(native_loader, path) == \
        chip_smoke.NATIVE_ORDER


# ------------------------------------------------------------- configs

def test_recipes_build_a_trainer(tmp_path):
    """`wikitext-byte-smoke.yaml` over a local text file trains; the ViT
    recipe, shrunk by overrides, builds; both as written load."""
    txt = tmp_path / "corpus.txt"
    txt.write_text("".join(f"line {i} of a corpus\n" for i in range(300)))
    cfg = load_config(str(RECIPES / "wikitext-byte-smoke.yaml"), {
        "data": {"text_files": [str(txt)],
                 "cache_dir": str(tmp_path / "cache")},
        "trainer": {"checkpoint_dir": str(tmp_path / "ck"), "max_steps": 2,
                    "resume": False}})
    t = Trainer(cfg, device="cpu")
    assert t.loader.dataset.tokens.max() <= 256
    assert np.isfinite(t.train(log_fn=lambda m: None))
    vit_cfg = load_config(str(RECIPES / "imagenet-vit-b.yaml"), {
        "model": {"n_embd": 32, "n_layer": 1, "n_head": 2, "image_size": 32,
                  "num_classes": 10},
        "data": {"batch_size": 2, "max_examples": 4}})
    t = Trainer(vit_cfg, device="cpu")
    assert t.task == "image" and len(t.model.blocks) == 1
    assert t.autocast and t.autocast_dtype == torch.bfloat16
    check_supported(load_config(str(RECIPES / "imagenet-vit-b.yaml")))


def test_smoke_recipes_equal_the_yaml():
    """`chip_smoke.py` builds the ViT and llama recipes in code (the card
    machine has no YAML parser): the same model, optimizer, scheduler and
    data settings as the YAML files, but for what one card changes."""
    import dataclasses as dc

    vit, vit_yaml = chip_smoke.vit_train_config(), load_config(
        str(RECIPES / "imagenet-vit-b.yaml"))
    for sec in ("model", "optimizer", "scheduler", "data"):
        assert dc.asdict(getattr(vit, sec)) == dc.asdict(
            getattr(vit_yaml, sec)), sec
    llama, llama_yaml = chip_smoke.llama_train_config(), load_config(
        str(RECIPES / "pile-llama-1b.yaml"))
    llama_yaml.optimizer.shard_optimizer_state = False  # one card
    for sec in ("model", "optimizer", "scheduler"):
        assert dc.asdict(getattr(llama, sec)) == dc.asdict(
            getattr(llama_yaml, sec)), sec
    assert (llama.data.seq_len, llama.data.batch_size) == (2048, 8)
    cfg = chip_smoke.vit_train_config(trainer__ema_decay=0.5)
    back = load_config(overrides=parse_overrides(
        chip_smoke.config_overrides(cfg)))
    assert back == cfg


@pytest.mark.parametrize("over", [
    {"mesh": {"data": 4, "model": 2}}, {"optimizer": {"zero_stage": 2}},
    {"data": {"hf_dataset": "the_pile"}},
    {"data": {"text_files": ["a.txt"], "tokenizer": "gpt2"}}],
    ids=["mesh", "zero", "hub_dataset", "hub_tokenizer"])
def test_check_supported_still_refuses(over):
    with pytest.raises(NotImplementedError):
        check_supported(load_config(overrides=over))
    with pytest.raises(NotImplementedError):
        check_supported(load_config(str(RECIPES / "pile-llama-1b.yaml")))
