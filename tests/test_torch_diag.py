"""The port's diagnostic probes (`flash_attn_tpu_torch.diag`) and timing
utilities (`utils.benchmark`, `utils.profiler`) against the JAX package.

Each probe's plain twin is held against the JAX probe's own kernel body on
the same seeded numpy inputs: the Pallas kernels of `benchmarks/diag_*.py`
(imported, never edited) are built here at a small size and run in
interpret mode, with the bisect's size globals set by `monkeypatch`.

Tolerances:
* Attention-like outputs (bisect K3..K10 o and lse, ladder `full`):
  `check_close`'s 2x rule against a float64 oracle computed here from the
  probe's definition (the twin's error at most twice the JAX kernel's, plus
  1e-5).
* Sums (ladder qk, cast, soft, pquant; the stream's tile sums): 1e-5 of
  their magnitude.  For `soft` the bound adds one float32 rounding of every
  score (p * |s| * 2^-23, summed): XLA contracts the probe's `st * 0.0883883
  - m` into one FMA, so JAX skips that rounding, and the int8 probe's
  scores reach ~2e4, where one rounding moves p by ~1e-3.
* Only outputs that JAX defines are compared: not the ladder's `dma` stage
  (JAX writes no output there) and not the bisect's K0..K2 or its rows that
  no tick finalizes.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flash_attn_tpu.utils import benchmark as jax_benchmark
from flash_attn_tpu_torch import diag
from flash_attn_tpu_torch.diag import dma_stream, int8_decode
from flash_attn_tpu_torch.diag import varlen_overhead_bisect as bisect
from flash_attn_tpu_torch.utils import benchmark, profiler
from flash_attn_tpu_torch.utils.testing import check_close

ROOT = Path(__file__).resolve().parent.parent
SUM_RTOL = 1e-5


def jax_probe(name):
    """`benchmarks/<name>.py` as a module (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """The JAX probes here run at small sizes, where their time is
    compiling, not running: compile them with XLA's optimizations off."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_sum_close(got, ref, extra=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    tol = SUM_RTOL * np.abs(ref).max() + extra
    err = np.abs(got - ref).max()
    assert err <= tol, f"sum err {err:.3e} > {tol:.3e}"


def bf16(a):
    """numpy -> bf16 as JAX rounds it, and the same values as torch bf16."""
    a = np.asarray(a).astype(ml_dtypes.bfloat16)
    return a, torch.from_numpy(a.astype(np.float32)).bfloat16()


# ---------------------------------------------------------------------------
# row 17: the decode ladder

B, HK, ROWS, DH, SMAX, BK = 2, 2, 8, 128, 256, 128


def ladder_inputs(int8):
    rng = np.random.default_rng(0)
    if int8:
        arrs = [rng.integers(-127, 127, s).astype(np.int8)
                for s in ((B, HK, ROWS, DH), (B, SMAX, HK * DH),
                          (B, SMAX, HK * DH))]
        return arrs, [torch.from_numpy(a) for a in arrs]
    pairs = [bf16(rng.standard_normal(s))
             for s in ((B, HK, ROWS, DH), (B, SMAX, HK * DH),
                       (B, SMAX, HK * DH))]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def jax_ladder(stage, int8, q, kc, vc, bk=BK):
    """The JAX probe's `pallas_call` of `run_stage`, in interpret mode."""
    mod = jax_probe("diag_int8_decode")
    fn = pl.pallas_call(
        mod.make_kernel(stage, int8, HK, bk, ROWS, DH),
        grid=(B, SMAX // bk),
        in_specs=[
            pl.BlockSpec((1, HK, ROWS, DH), lambda b_, k_: (b_, 0, 0, 0)),
            pl.BlockSpec((1, bk, HK * DH), lambda b_, k_: (b_, k_, 0)),
            pl.BlockSpec((1, bk, HK * DH), lambda b_, k_: (b_, k_, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, HK, ROWS, DH),
                               lambda b_, k_: (b_, 0, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, 1, HK, ROWS, DH), jnp.float32),
        scratch_shapes=[pltpu.VMEM((HK, ROWS, DH), jnp.float32),
                        pltpu.VMEM((HK, ROWS, 128), jnp.float32),
                        pltpu.VMEM((HK, ROWS, 128), jnp.float32)],
        interpret=True)
    return np.array(jax.jit(fn)(q, kc, vc))


def ladder_scores(int8, q, kc):
    """float64 scaled scores (b, hk, rows, smax) of the probe."""
    qf = np.asarray(q, np.float64)
    b, smax = kc.shape[:2]
    kf = np.asarray(kc, np.float64).reshape(b, smax, HK, DH)
    s = np.einsum("bhrd,bkhd->bhrk", qf, kf)
    if int8:
        s = s.astype(np.float32).astype(np.float64)  # exact int32 scores
    return s * np.float64(np.float32(int8_decode.SCALE))


def ladder_oracle(int8, q, kc, vc):
    """float64 `full`: sum_j exp(s_j - max s) v_j (x 0.0883883 for int8,
    whose P V is scaled by 0.0883883 / 127 of round(127 p))."""
    s = ladder_scores(int8, q, kc)
    p = np.exp(s - s.max(-1, keepdims=True))
    vf = np.asarray(vc, np.float64).reshape(*vc.shape[:2], HK, DH)
    oracle = np.einsum("bhrk,bkhd->bhrd", p, vf)[:, None]
    return oracle * int8_decode.SCALE if int8 else oracle


def check_ladder(stage, int8, got, ref, q, kc, vc):
    """A twin's result `got` against the JAX ladder's `ref`."""
    assert got.shape == ref.shape == (B, 1, HK, ROWS, DH)
    if stage != "full":
        assert not got[..., 1:].any() and not ref[..., 1:].any()
        extra = 0.0
        if stage == "soft":
            s = ladder_scores(int8, q, kc)
            extra = np.abs(got[..., 0]).max() * np.abs(s).max() * 2.0 ** -23
        assert_sum_close(got, ref, extra)
        return
    check_close(torch.from_numpy(got),
                torch.from_numpy(ladder_oracle(int8, q, kc, vc)),
                torch.from_numpy(ref))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("stage", ["qk", "cast", "soft", "pquant", "full"])
def test_ladder_twin_matches_jax(stage, int8):
    (q, kc, vc), (tq, tk, tv) = ladder_inputs(int8)
    ref = jax_ladder(stage, int8, q, kc, vc)
    got = int8_decode.decode_ladder_ref(stage, tq, tk, tv, bk=BK).numpy()
    check_ladder(stage, int8, got, ref, q, kc, vc)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("stage", ["soft", "pquant", "full"])
def test_ladder_tile_twin_matches_jax_at_64(stage, int8):
    """The kernel's function (the running max moved once per 64-key tile,
    `max_every=64`) is JAX's ladder at bk = 64."""
    (q, kc, vc), (tq, tk, tv) = ladder_inputs(int8)
    ref = jax_ladder(stage, int8, q, kc, vc, bk=64)
    got = int8_decode.decode_ladder_ref(stage, tq, tk, tv, bk=64,
                                        max_every=64).numpy()
    check_ladder(stage, int8, got, ref, q, kc, vc)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("stage", ["soft", "pquant", "full"])
def test_ladder_tile_twin_at_bk_1024(stage, int8):
    """At JAX's bk = 1024 the 64-key twin (the kernel's function) against
    the bk twin (JAX's): soft equal up to rounding; pquant within one step
    of round(127 p) a row (int8) or one bf16 rounding of the sum (bf16);
    full within the 2x rule of the float64 oracle, the bk twin the
    yardstick.  Two blocks of 1024 keys, twins only."""
    rng = np.random.default_rng(1)
    shapes = ((B, HK, ROWS, DH), (B, 2048, HK * DH), (B, 2048, HK * DH))
    if int8:
        arrs = [rng.integers(-127, 127, s).astype(np.int8) for s in shapes]
        q, kc, vc = (torch.from_numpy(a) for a in arrs)
    else:
        arrs, (q, kc, vc) = zip(*(bf16(rng.standard_normal(s))
                                  for s in shapes))
    tile = int8_decode.decode_ladder_ref(stage, q, kc, vc, bk=1024,
                                         max_every=64)
    block = int8_decode.decode_ladder_ref(stage, q, kc, vc, bk=1024)
    if stage == "full":
        check_close(tile, torch.from_numpy(ladder_oracle(int8, *arrs)),
                    block)
        return
    assert not tile[..., 1:].any()
    extra = 0.0
    if stage == "pquant":
        extra = 1.0 if int8 else 2.0 ** -8 * block.abs().max().item()
    assert_sum_close(tile.numpy(), block.numpy(), extra)


@pytest.mark.parametrize("stage", ["dma", "soft", "full"])
def test_ladder_twin_splits(stage):
    """A key split restarts the running max (soft: the sum of each half's
    own sums) and merges full by exp2((m_j - M) log2 e) weights (full at 2
    splits against the oracle, with the 1-split error as the yardstick);
    dma sums whole blocks either way."""
    (q, kc, vc), (tq, tk, tv) = ladder_inputs(False)
    one = int8_decode.decode_ladder_ref(stage, tq, tk, tv, bk=64)
    two = int8_decode.decode_ladder_ref(stage, tq, tk, tv, bk=64, splits=2)
    if stage == "soft":
        halves = [int8_decode.decode_ladder_ref(
            stage, tq, tk[:, i * 128:(i + 1) * 128].contiguous(),
            tv[:, i * 128:(i + 1) * 128].contiguous(), bk=64)
            for i in range(2)]
        torch.testing.assert_close(two, halves[0] + halves[1])
    elif stage == "dma":
        assert_sum_close(two.numpy(), one.numpy())
    else:
        check_close(two, torch.from_numpy(ladder_oracle(False, q, kc, vc)),
                    one)


# ---------------------------------------------------------------------------
# row 18: the DMA stream


def jax_stream(mod, arr, table, bundle, fused):
    """The JAX probe's `pallas_call` of `run` (scalar-prefetched table)."""
    R = arr.shape[-2]
    blk = (1, 2, R, mod.LANES) if fused else (1, R, mod.LANES)
    zero_idx = (0, 0, 0) if fused else (0, 0)
    steps = table.shape[0] // bundle

    def make_spec(j):
        return pl.BlockSpec(
            blk, lambda i, t: (t[i * bundle + j],) + zero_idx)

    with pltpu.force_tpu_interpret_mode():
        fn = pl.pallas_call(
            lambda *args: mod.stream_kernel(bundle, *args),
            grid_spec=pltpu.PrefetchScalarGridSpec(
                num_scalar_prefetch=1, grid=(steps,),
                in_specs=[make_spec(j) for j in range(bundle)],
                out_specs=pl.BlockSpec((8, 128), lambda i, t: (0, 0))),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32))
        return np.array(fn(jnp.asarray(table),
                           *([jnp.asarray(arr)] * bundle)))


@pytest.mark.parametrize("bundle,fused,shuffled", [
    (1, False, False), (4, False, True), (2, True, True)])
def test_stream_twin_matches_jax(bundle, fused, shuffled):
    mod = jax_probe("diag_dma_stream")
    n, R = 8, 16
    rng = np.random.default_rng(0)
    shape = (n, 2, R, mod.LANES) if fused else (n, R, mod.LANES)
    arr, tarr = bf16(rng.standard_normal(shape))
    order = np.arange(n, dtype=np.int32)
    if shuffled:
        order = rng.permutation(order).astype(np.int32)
    table = order[: n - 1]  # a ragged tail: steps = (n - 1) // bundle
    ref = jax_stream(mod, arr, table, bundle, fused)
    got = dma_stream.dma_stream_ref(tarr, torch.from_numpy(table),
                                    bundle=bundle, fused=fused)
    assert got.shape == (8, 128)
    assert_sum_close(got.numpy(), ref)
    steps = (n - 1) // bundle
    assert dma_stream.stream_bytes(R, bundle, fused, steps) == (
        steps * bundle * (2 if fused else 1) * R * mod.LANES * 2)


# ---------------------------------------------------------------------------
# row 16: the varlen bisect

SIZES = dict(H=4, D=128, BQ=128, BK=128, BH=2, TOTAL_P=256)


@pytest.fixture
def small(monkeypatch):
    """Both bisect modules at H=4, D=128, BQ=BK=128, BH=2, TOTAL_P=256 (T
    is set to each test's table length)."""
    jmod = jax_probe("diag_varlen_overhead_bisect")
    for mod in (jmod, bisect):
        for name, value in SIZES.items():
            monkeypatch.setattr(mod, name, value)
    return jmod


def bisect_inputs(kind, n_bodies=4):
    rng = np.random.default_rng(0)
    shape = (SIZES["H"], SIZES["TOTAL_P"], SIZES["D"])
    pairs = [bf16(rng.standard_normal(shape)) for _ in range(3)]
    qa, ka = bisect.make_aux(SIZES["TOTAL_P"], SIZES["BK"], doc=100)
    # the second q block: rows 128..255, documents 1 and 2
    tables = (np.asarray(x, np.int32) for x in bisect.live_tables(
        kind, n_bodies=n_bodies, q_blocks=1, k_ticks=2, first_q_block=1))
    return pairs, qa.numpy(), ka.numpy(), tuple(tables)


def bisect_oracle(variant, tables, q, k, v, qa, ka, bh, n_bodies=4):
    """float64 o and lse of the rows a LAST tick finalizes: a base-2 softmax
    over the keys visited since the state was last reset (init or a fresh
    body), boundary ticks masking seg_q != seg_k or pos_k < pos_q."""
    qi, ki, fl, code = tables
    bq, bk = SIZES["BQ"], SIZES["BK"]
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    heads = q.shape[0]
    o = np.zeros(q.shape)
    lse = np.zeros(q.shape[:2])
    visits = []
    for t, f in enumerate(fl):
        first, empty = bool(f & diag._FIRST), bool(f & diag._EMPTY)
        live, bound = not empty, bool(f & diag._BOUND)
        if variant in ("K9", "K10"):
            if first:
                visits = []
        elif first and empty:
            visits = []
        runs = []
        if variant == "K3" and live:
            runs = [(False, False)]
        elif variant in ("K4", "K7") and live:
            runs = [(bound, False)]
        elif variant in ("K6", "K8") and live:
            runs = [(bound, first)]
        elif variant == "K9" and 0 <= code[t] < 4:
            runs = [[(False, False), (True, False), (False, True),
                     (True, True)][code[t]]]
        elif variant == "K10" and (f >> 4) < n_bodies:
            runs = [(False, False)]
        for mask, fresh in runs:
            if fresh:
                visits = []
            visits.append((ki[t], mask))
        if f & diag._LAST:
            rows = slice(qi[t] * bq, (qi[t] + 1) * bq)
            aq = qa[rows, 0]
            for h in range(heads):
                s_all, v_all = [], []
                for kb, mask in visits:
                    keys = slice(kb * bk, (kb + 1) * bk)
                    s = q[h, rows] @ k[h, keys].T
                    if mask:
                        ak = ka[kb, 0]
                        bad = (((aq[:, None] >> 16) != (ak[None] >> 16))
                               | ((ak[None] & 0xFFFF) < (aq[:, None] & 0xFFFF)))
                        s = np.where(bad, -np.inf, s)
                    s_all.append(s)
                    v_all.append(v[h, keys])
                s = np.concatenate(s_all, 1)
                m = s.max(1, keepdims=True)
                dead = ~np.isfinite(m)
                m = np.where(dead, bisect.M_INIT, m)
                p = np.exp2(s - m)
                l = p.sum(1, keepdims=True)
                l_safe = np.where(l == 0, 1.0, l)
                o[h, rows] = p @ np.concatenate(v_all, 0) / l_safe
                lse[h, rows] = (m + np.log(l_safe))[:, 0]
    return o, lse


def run_jax_bisect(jmod, variant, tables, arrs, qa, ka, n_bodies, bh):
    qi, ki, fl, code = (jnp.asarray(x) for x in tables)
    q, k, v = (jnp.asarray(a) for a in arrs)
    qa, ka = jnp.asarray(qa), jnp.asarray(ka)
    def launch(qi, ki, fl, code, q, k, v, qa, ka):
        if variant in ("K3", "K4"):
            return jmod.launch(int(variant[1]), qi, ki, fl, q, k, v, qa,
                               ka), None
        if variant in ("K6", "K7", "K8"):
            res = jmod.launch2(qi, ki, fl, q, k, v, qa, ka,
                               lse_lanes=variant != "K6",
                               four_variants=variant != "K7")
            return res[0], (res[1] if len(res) > 1 else None)
        if variant == "K9":
            return jmod.launch3(qi, ki, fl, code, q, k, v, qa, ka), None
        return jmod.launch4(n_bodies, bh, qi, ki, fl, q, k, v), None

    with pltpu.force_tpu_interpret_mode():
        return jax.jit(launch)(qi, ki, fl, code, q, k, v, qa, ka)


def run_port_bisect(variant, tables, arrs, qa, ka, n_bodies, bh):
    qi, ki, fl, code = (torch.from_numpy(x) for x in tables)
    q, k, v = arrs
    qa, ka = torch.from_numpy(qa), torch.from_numpy(ka)
    if variant in ("K3", "K4"):
        return bisect.launch_ref(int(variant[1]), qi, ki, fl, q, k, v, qa,
                                 ka), None
    if variant in ("K6", "K7", "K8"):
        res = bisect.launch2_ref(qi, ki, fl, q, k, v, qa, ka,
                                 lse_lanes=variant != "K6",
                                 four_variants=variant != "K7")
        return res[0], (res[1] if len(res) > 1 else None)
    if variant == "K9":
        return bisect.launch3_ref(qi, ki, fl, code, q, k, v, qa, ka), None
    return bisect.launch4_ref(n_bodies, bh, qi, ki, fl, q, k, v), None


@pytest.mark.parametrize("variant,n_bodies,bh", [
    ("K3", 4, 2), ("K4", 4, 2), ("K6", 4, 2), ("K8", 4, 2), ("K9", 4, 2),
    ("K10", 2, 2), ("K10", 3, 4)])
def test_bisect_twin_matches_jax(small, monkeypatch, variant, n_bodies, bh):
    kind = {"K9": "code", "K10": "k10"}.get(variant, "init")
    pairs, qa, ka, tables = bisect_inputs(kind, n_bodies)
    for mod in (small, bisect):
        monkeypatch.setattr(mod, "T", len(tables[0]))
    arrs = [p[0] for p in pairs]
    o_j, lse_j = run_jax_bisect(small, variant, tables, arrs, qa, ka,
                                n_bodies, bh)
    o_p, lse_p = run_port_bisect(variant, tables, [p[1] for p in pairs], qa,
                                 ka, n_bodies, bh)
    o_r, lse_r = bisect_oracle(variant, tables, *arrs, qa, ka, bh, n_bodies)
    rows = bisect.finalized_rows(torch.from_numpy(tables[0]),
                                 torch.from_numpy(tables[2])).numpy()
    assert rows.sum() == SIZES["BQ"]
    assert (np.abs(o_r[:, rows]).max(-1) > 0).all()  # every row sees keys
    o_j = np.asarray(o_j.astype(jnp.float32))[:, rows]
    check_close(o_p.float()[:, rows], torch.from_numpy(o_r[:, rows]),
                torch.from_numpy(o_j))
    if variant == "K8":  # lse once per row, JAX's lane 0
        check_close(lse_p[:, rows], torch.from_numpy(lse_r[:, rows]),
                    torch.from_numpy(np.asarray(lse_j)[:, rows, 0]))


def test_bisect_tables_and_aux():
    """The port's copy of the varlen_sched constants and aux packing."""
    from flash_attn_tpu.kernels import varlen_sched as vs

    assert (diag._FIRST, diag._LAST, diag._BOUND, diag._EMPTY, diag.STAT,
            diag.LANES) == (vs._FIRST, vs._LAST, vs._BOUND, vs._EMPTY,
                            vs.STAT, vs.LANES)
    seg = torch.tensor([0, 1, 0x7FFF, 0xFFFF], dtype=torch.int32)
    pos = torch.tensor([5, 0xFFFF, 7, 3], dtype=torch.int32)
    aux = diag.pack_aux(seg, pos)
    ref = jax.lax.shift_right_logical(jnp.asarray(aux.numpy()), 16)
    assert diag.aux_segment(aux).tolist() == np.asarray(ref).tolist()
    assert diag.aux_segment(aux).tolist() == seg.tolist()
    assert diag.aux_position(aux).tolist() == pos.tolist()
    for kind in ("init", "code", "k10"):
        qi, ki, fl, code = bisect.live_tables(kind, n_bodies=3)
        assert len({len(qi), len(ki), len(fl), len(code)}) == 1
        assert sum(f & diag._LAST != 0 for f in fl) == 2


# ---------------------------------------------------------------------------
# utilities


def toy_step(c, w):
    for _ in range(4):
        c = torch.tanh(c @ w)
    return c


@pytest.mark.parametrize("agg", ["median", "min"])
@pytest.mark.parametrize("donate", [False, True])
def test_benchmark_chained_cpu(agg, donate):
    gen = torch.Generator().manual_seed(0)
    c = torch.randn(192, 192, generator=gen)
    w = torch.randn(192, 192, generator=gen) / 14
    c0 = c.clone()
    dt = benchmark.benchmark_chained(toy_step, c, w, iters=8, reps=3,
                                     donate=donate, agg=agg)
    assert isinstance(dt, float) and dt > 0
    assert torch.equal(c, c0)  # the step writes no carry in place


def test_benchmark_nested_carry_and_attention_helpers():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 64, 32, generator=gen) for _ in range(3))

    def attn(q, k, v):
        return torch.softmax(q @ k.transpose(-1, -2) / 8, -1) @ v

    assert benchmark.benchmark_attention_fwd(attn, q, k, v, iters=4) > 0
    assert benchmark.benchmark_attention_fwd_bwd(attn, q, k, v, iters=2) > 0
    dt = benchmark.benchmark_chained(
        lambda c: {"a": c["a"] @ c["b"], "b": c["b"]},
        {"a": q[0, 0], "b": k[0, 0].T @ k[0, 0] / 64}, iters=4, agg="min")
    assert isinstance(dt, float)


@pytest.mark.parametrize("shape", [
    (2, 512, 512, 12, 64, False, "fwd"), (1, 1, 8192, 32, 128, False, "fwd"),
    (8, 1024, 1024, 12, 64, True, "bwd"), (3, 77, 129, 5, 96, True, "fwd_bwd")])
def test_attention_flops_match_jax(shape):
    *dims, causal, mode = shape
    assert benchmark.attention_flops(*dims, causal=causal, mode=mode) == \
        jax_benchmark.attention_flops(*dims, causal=causal, mode=mode)


def test_profile_and_summarize_trace(tmp_path):
    x = torch.randn(64, 64)

    def fn(x):
        with profiler.annotate("diag_region"):
            return torch.relu(x @ x)

    out, trace_dir = profiler.profile_trace(fn, x, trace_dir=str(tmp_path),
                                            iters=2)
    torch.testing.assert_close(out, torch.relu(x @ x))
    assert trace_dir == str(tmp_path)
    top = profiler.summarize_trace(trace_dir, top=50)
    names = [n for n, _ in top]
    assert "diag_region" in names and any("mm" in n for n in names)
    assert all(ms >= 0 for _, ms in top)
    assert profiler.summarize_trace(str(tmp_path / "none")) == []
