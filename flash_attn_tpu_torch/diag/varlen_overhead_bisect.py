"""Bisect the fixed cost of a tick of the scheduled-varlen forward
(counterpart of `benchmarks/diag_varlen_overhead_bisect.py`).

Times stripped-down kernel variants (`csrc/diag_varlen_bisect.cu`) over the
same tick tables to find the piece a tick pays for:
  K0  empty body
  K1  + scalar/table reads + qa/ka prologue
  K2  + predicated _init region (scratch zeroing, off)
  K3  + one predicated interior body (off)
  K4  full kernel (reference point)
  K5  K4 + a cost estimate (none on CUDA: K4's kernel runs)
  K6  K4 with four predicated bodies (first / boundary)
  K7  K4 + an lse output (written once per row)
  K8  K6 + K7
  K9  four bodies chosen by `code == i` from a fourth table
  K10 n identical bodies at block_h = bh, the code in fl >> 4

    python -m flash_attn_tpu_torch.diag.varlen_overhead_bisect k04 k58 k9 k10

The tables are all empty (fl = EMPTY), so o is never written and only the
time means anything: ms and the script's us/tick = dt / T / (H // BH).  A
tick on the card is one step of a CTA's walk of the staged tables, for
each of the BQ / 64 CTAs (64-row slices of the q block) of a head group;
a tick with nothing to do and no aux to fetch costs a lane of a 32-tick
warp step, so the empty levels time the walk's set-up (staging the tables,
the first aux copy) more than its ticks; `k04` also prints us per empty
CTA, K0 launched with one CTA per (tick, head group, row slice).

`launch`, `launch2`, `launch3`, `launch4` and `launch_empty_ctas` launch the
kernel (CUDA tensors only); `launch_ref` .. `launch4_ref` are their plain
twins.  The size globals below are read at call time, as the JAX script's.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from flash_attn_tpu_torch.diag import (_BOUND, _EMPTY, _FIRST, _LAST, STAT,
                                       aux_position, aux_segment,
                                       device_line, pack_aux, require_cuda)
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.utils.benchmark import benchmark_chained

KERNEL = "diag_varlen_bisect"

H, D = 16, 128
BQ = BK = 1024
BH = 4
T = 256
TOTAL_P = 16384

MASK_BIAS = -3e38  # the boundary mask's additive bias
M_INIT = -1e30     # the running max's initial value

# variant codes of the C entry point
_K = {f"K{i}": i for i in range(11)}

# Number of times the CUDA kernel was launched (the twins do not count).
launches = 0


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.diag_varlen_bisect.argtypes = [I] * 3 + [P] * 11 + [I] * 7 + [P]
        lib.diag_varlen_bisect.restype = I
        _build.declare_error_string(lib)
        lib._typed = True
    return lib


def _launch(variant, qi, ki, fl, qT, kT, vT, qa_rep=None, ka_rows=None,
            code=None, *, bh, n_bodies=0, lse=False, empty_ctas=False):
    global launches
    name = f"varlen_overhead_bisect {variant}"
    require_cuda(name, qi, ki, fl, qT, kT, vT, qa_rep, ka_rows, code)
    heads, total, d = qT.shape
    if kT.shape != qT.shape or vT.shape != qT.shape or d != 128:
        raise ValueError("q, k, v must be (H, TOTAL_P, 128)")
    if qT.dtype != torch.bfloat16 or kT.dtype != qT.dtype \
            or vT.dtype != qT.dtype:
        raise ValueError("q, k, v must be bf16")
    if BQ % 64 or BK % 64 or total % BQ or total % BK or heads % bh \
            or not 1 <= bh <= 4:
        raise ValueError(f"BQ, BK must be multiples of 64 dividing "
                         f"TOTAL_P, 1 <= bh <= 4 dividing H (BQ={BQ}, "
                         f"BK={BK}, bh={bh}, H={heads}, TOTAL_P={total})")
    tables = [t for t in (qi, ki, fl, code) if t is not None]
    if any(t.dtype != torch.int32 or t.shape != fl.shape for t in tables):
        raise ValueError("the tick tables must be int32 of one length")
    for t in (qT, kT, vT, qa_rep, ka_rows, *tables):
        if t is not None and not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    for t in (qa_rep, ka_rows, *tables):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the tick tables and aux must be 16-byte aligned "
                             "(the kernel bulk-copies them)")
    o = torch.empty_like(qT)
    lse_t = (torch.empty(heads, total, dtype=torch.float32, device=qT.device)
             if lse else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    err = lib.diag_varlen_bisect(
        _K[variant], n_bodies, int(empty_ctas), ptr(qi), ptr(ki), ptr(fl),
        ptr(code), ptr(qT), ptr(kT), ptr(vT), ptr(qa_rep), ptr(ka_rows),
        ptr(o), ptr(lse_t), heads, total, d, BQ, BK, bh, fl.shape[0],
        torch.cuda.current_stream(qT.device).cuda_stream)
    _build.check(lib, err, KERNEL)
    launches += 1
    return o, lse_t


def launch(level, qi, ki, fl, qT, kT, vT, qa_rep, ka_rows):
    """Levels K0..K4 (`make_kernel`).  Returns o (H, TOTAL_P, D); its rows
    are written only by finalized ticks (K3, K4)."""
    return _launch(f"K{level}", qi, ki, fl, qT, kT, vT, qa_rep, ka_rows,
                   bh=BH)[0]


def _variant2(cost, lse_lanes, four_variants):
    if four_variants:
        return "K8" if lse_lanes else "K6"
    if lse_lanes:
        return "K7"
    return "K5" if cost else "K4"


def launch2(qi, ki, fl, qT, kT, vT, qa_rep, ka_rows, *, cost=False,
            lse_lanes=False, four_variants=False):
    """K4 plus the deltas of K5..K8.  Returns [o] or [o, lse (H, TOTAL_P)].
    `cost` has no CUDA counterpart (K5 runs K4's kernel)."""
    o, lse = _launch(_variant2(cost, lse_lanes, four_variants), qi, ki, fl,
                     qT, kT, vT, qa_rep, ka_rows, bh=BH, lse=lse_lanes)
    return [o] if lse is None else [o, lse]


def launch3(qi, ki, fl, code, qT, kT, vT, qa_rep, ka_rows):
    """K9: four bodies chosen by code == i: (mask, fresh) = (no, no),
    (yes, no), (no, yes), (yes, yes)."""
    return _launch("K9", qi, ki, fl, qT, kT, vT, qa_rep, ka_rows, code,
                   bh=BH)[0]


def launch4(n_bodies, bh, qi, ki, fl, qT, kT, vT):
    """K10: n_bodies identical interior bodies at block_h = bh; the body
    index is fl >> 4."""
    if not 1 <= n_bodies <= 4:
        raise ValueError("n_bodies must be 1..4")
    return _launch("K10", qi, ki, fl, qT, kT, vT, bh=bh,
                   n_bodies=n_bodies)[0]


def launch_empty_ctas(qi, ki, fl, qT, kT, vT):
    """K0 with one CTA per (tick, head group, 64-row slice): what an idle
    CTA costs.  Writes nothing."""
    return _launch("K0", qi, ki, fl, qT, kT, vT, bh=BH, empty_ctas=True)[0]


# ---------------------------------------------------------------------------
# plain twins


def _bodies(variant, f, code, n_bodies):
    """The (mask, fresh) bodies that tick flags `f` run, in order, and
    whether the tick initialises the state."""
    first, empty = bool(f & _FIRST), bool(f & _EMPTY)
    bound, live = bool(f & _BOUND), not f & _EMPTY
    if variant in ("K9", "K10"):
        init = first
    else:
        init = first and empty
    if variant == "K3":
        runs = [(False, False)] if live else []
    elif variant in ("K4", "K5", "K7"):
        runs = [(bound, False)] if live else []
    elif variant in ("K6", "K8"):
        runs = [(bound, first)] if live else []
    elif variant == "K9":
        runs = ([[(False, False), (True, False), (False, True),
                  (True, True)][code]] if 0 <= code < 4 else [])
    elif variant == "K10":
        c = (f & 0xFFFFFFFF) >> 4
        runs = [(False, False)] if c < n_bodies else []
    else:
        runs = []
    return init, runs


def _ref(variant, qi, ki, fl, qT, kT, vT, qa_rep=None, ka_rows=None,
         code=None, *, bh, n_bodies=0, lse=False):
    """The tick walk of the JAX level `variant`, head group by head group,
    with the JAX kernel's per-tick math on whole (BQ, BK) blocks: in
    float32, or in float64 for float64 inputs (no rounding of P then)."""
    heads, total, d = qT.shape
    mm = torch.float64 if qT.dtype == torch.float64 else torch.float32
    o = torch.zeros_like(qT)
    lse_t = (torch.zeros(heads, total, dtype=mm, device=qT.device)
             if lse else None)
    if variant in ("K0", "K1", "K2"):
        return o, lse_t  # these levels write no output
    qi_l, ki_l, fl_l = qi.tolist(), ki.tolist(), fl.tolist()
    code_l = code.tolist() if code is not None else [0] * len(fl_l)
    dev = qT.device
    for hb in range(heads // bh):
        acc = torch.zeros(bh, BQ, d, dtype=mm, device=dev)
        m = torch.full((bh, BQ, 1), M_INIT, dtype=mm, device=dev)
        l = torch.zeros(bh, BQ, 1, dtype=mm, device=dev)
        for t, f in enumerate(fl_l):
            rows = slice(qi_l[t] * BQ, (qi_l[t] + 1) * BQ)
            keys = slice(ki_l[t] * BK, (ki_l[t] + 1) * BK)
            init, runs = _bodies(variant, f, code_l[t], n_bodies)
            if init:
                acc.zero_()
                m.fill_(M_INIT)
                l.zero_()
            for mask, fresh in runs:
                bias = None
                if mask:
                    qa = qa_rep[rows, 0].view(BQ, 1)
                    ka = ka_rows[ki_l[t], 0].view(1, BK)
                    keep = ((aux_segment(qa) == aux_segment(ka))
                            & (aux_position(ka) >= aux_position(qa)))
                    bias = torch.where(keep, 0.0, MASK_BIAS)
                for hh in range(bh):
                    h = hb * bh + hh
                    s = qT[h, rows].to(mm) @ kT[h, keys].to(mm).T
                    if bias is not None:
                        s = s + bias
                    m_prev = (torch.full_like(m[hh], M_INIT) if fresh
                              else m[hh])
                    m_curr = torch.maximum(m_prev, s.amax(1, keepdim=True))
                    p = torch.exp2(s - m_curr)
                    psum = p.sum(1, keepdim=True)
                    pv = p.to(vT.dtype).to(mm) @ vT[h, keys].to(mm)
                    if fresh:
                        l[hh], acc[hh] = psum, pv
                    else:
                        alpha = torch.exp2(m_prev - m_curr)
                        l[hh] = l[hh] * alpha + psum
                        acc[hh] = acc[hh] * alpha + pv
                    m[hh] = m_curr
            if f & _LAST:
                l_safe = torch.where(l == 0.0, 1.0, l)
                o[hb * bh:(hb + 1) * bh, rows] = (acc / l_safe).to(o.dtype)
                if lse_t is not None:
                    lse_t[hb * bh:(hb + 1) * bh, rows] = (
                        m + torch.log(l_safe))[..., 0]
    return o, lse_t


def launch_ref(level, qi, ki, fl, qT, kT, vT, qa_rep, ka_rows):
    """Plain twin of `launch` (rows no tick finalizes are 0)."""
    return _ref(f"K{level}", qi, ki, fl, qT, kT, vT, qa_rep, ka_rows,
                bh=BH)[0]


def launch2_ref(qi, ki, fl, qT, kT, vT, qa_rep, ka_rows, *, cost=False,
                lse_lanes=False, four_variants=False):
    """Plain twin of `launch2`."""
    o, lse = _ref(_variant2(cost, lse_lanes, four_variants), qi, ki, fl, qT,
                  kT, vT, qa_rep, ka_rows, bh=BH, lse=lse_lanes)
    return [o] if lse is None else [o, lse]


def launch3_ref(qi, ki, fl, code, qT, kT, vT, qa_rep, ka_rows):
    """Plain twin of `launch3`."""
    return _ref("K9", qi, ki, fl, qT, kT, vT, qa_rep, ka_rows, code,
                bh=BH)[0]


def launch4_ref(n_bodies, bh, qi, ki, fl, qT, kT, vT):
    """Plain twin of `launch4`."""
    return _ref("K10", qi, ki, fl, qT, kT, vT, bh=bh, n_bodies=n_bodies)[0]


def finalized_rows(qi, fl):
    """(TOTAL_P,) bool: the rows of the q blocks that a LAST tick
    finalizes, the only rows of o that a launch defines."""
    rows = torch.zeros(TOTAL_P, dtype=torch.bool)
    for q, f in zip(qi.tolist(), fl.tolist()):
        if f & _LAST:
            rows[q * BQ:(q + 1) * BQ] = True
    return rows


def live_tables(kind, n_bodies=4, q_blocks=2, k_ticks=4, first_q_block=0):
    """A short live tick walk, as int32 (qi, ki, fl, code) lists, over q
    blocks first_q_block.. (q_blocks of them).  A q block's first tick and
    every masked one read its own keys (ki = qi, with BQ = BK), where the
    boundary mask keeps part of each row's keys; the others read the next
    key blocks.  "init" (K3..K8): an initialising FIRST|EMPTY tick, then
    k_ticks live ticks, the first FIRST, the even ones BOUND, the last
    LAST.  "code" (K9): each body once, the fresh ones first (a fresh body
    drops what came before it), and one dead code 7.  "k10" (K10): k_ticks
    ticks with codes 0..n_bodies-1 in fl >> 4, and one dead code 15."""
    nk = TOTAL_P // BK
    qi, ki, fl, code = [], [], [], []
    for qb in range(first_q_block,
                    min(first_q_block + q_blocks, TOTAL_P // BQ)):
        if kind == "code":
            ticks = [(qb + 1, _FIRST, 2), (qb, 0, 3), (qb, 0, 7),
                     (qb + 1, 0, 0), (qb, 0, 1)]
        else:
            ticks = [(qb, _FIRST | _EMPTY, 7)] if kind == "init" else []
            for j in range(k_ticks):
                f = (_BOUND if j % 2 == 0 else 0) | (_FIRST if j == 0 else 0)
                if kind == "k10":
                    f |= (j % n_bodies) << 4
                ticks.append((qb + j if j % 2 else qb, f, 7))
            if kind == "k10":
                ticks.insert(2, (qb, 15 << 4, 7))
        kb, f, c = ticks[-1]
        ticks[-1] = (kb, f | _LAST, c)
        for kb, f, c in ticks:
            qi.append(qb)
            ki.append(kb % nk)
            fl.append(f)
            code.append(c)
    return qi, ki, fl, code


def make_aux(total, bk, doc=300):
    """qa_rep (total, STAT) and ka_rows (total / bk, STAT, bk) int32 aux of
    documents of `doc` tokens: segment = token // doc, position =
    token % doc."""
    tok = torch.arange(total, dtype=torch.int32)
    aux = pack_aux(tok // doc, tok % doc)
    qa = aux.view(total, 1).expand(total, STAT).contiguous()
    ka = aux.view(total // bk, 1, bk).expand(total // bk, STAT, bk)
    return qa, ka.contiguous()


# ---------------------------------------------------------------------------
# the script


def _inputs(seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw():
        return torch.randn((H, TOTAL_P, D), generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    qT, kT, vT = draw(), draw(), draw()
    qa_rep = torch.zeros((TOTAL_P, STAT), dtype=torch.int32, device="cuda")
    ka_rows = torch.zeros((TOTAL_P // BK, STAT, BK), dtype=torch.int32,
                          device="cuda")
    # constant tables, all empty: zero transitions, zero compute
    qi = torch.zeros((T,), dtype=torch.int32, device="cuda")
    ki = torch.zeros((T,), dtype=torch.int32, device="cuda")
    fl = torch.full((T,), _EMPTY, dtype=torch.int32, device="cuda")
    return qT, kT, vT, qa_rep, ka_rows, qi, ki, fl


def _time(name, call, groups, args, iters, reps):
    """Time `call(qT, kT, vT)` chained; print the script's line."""
    def step(qc, kT, vT):
        call(qc, kT, vT)
        return qc

    dt = benchmark_chained(step, *args, iters=iters, reps=reps, agg="min")
    print(f"{name}: {dt*1e3:9.4f} ms  {dt/T/groups*1e6:8.4f} us/tick",
          flush=True)
    return dict(ms=dt * 1e3, us_per_tick=dt / T / groups * 1e6)


def main(argv=None, iters=8, reps=3):
    """Runs the sections named in argv (k04, k58, k9, k10); returns
    {label: {"ms", "us_per_tick"}} (and "K0 per CTA": "us_per_cta")."""
    argv = sys.argv[1:] if argv is None else argv
    qT, kT, vT, qa_rep, ka_rows, qi, ki, fl = _inputs()
    args = (qT, kT, vT)
    res = {}
    if "k04" in argv:
        print(device_line(), flush=True)
        for level in range(5):
            res[f"K{level}"] = _time(
                f"K{level}", lambda qc, k, v, level=level: launch(
                    level, qi, ki, fl, qc, k, v, qa_rep, ka_rows),
                H // BH, args, iters, reps)
        ctas = T * (H // BH) * (BQ // 64)
        r = _time("K0 one CTA per (tick, head group, row slice)",
                  lambda qc, k, v: launch_empty_ctas(qi, ki, fl, qc, k, v),
                  H // BH, args, iters, reps)
        r["ctas"] = ctas
        r["us_per_cta"] = r["ms"] * 1e3 / ctas
        print(f"K0 per CTA: {r['us_per_cta']:8.5f} us/CTA ({ctas} CTAs)",
              flush=True)
        res["K0 per CTA"] = r
    if "k58" in argv:
        for name, kw in [
            ("K5 cost_estimate (none on CUDA: K4)", dict(cost=True)),
            ("K6 four variants", dict(four_variants=True)),
            ("K7 lse out", dict(lse_lanes=True)),
            ("K8 all three", dict(cost=True, four_variants=True,
                                  lse_lanes=True)),
        ]:
            res[name.split()[0]] = _time(
                name, lambda qc, k, v, kw=kw: launch2(
                    qi, ki, fl, qc, k, v, qa_rep, ka_rows, **kw),
                H // BH, args, iters, reps)
    if "k9" in argv:
        code = torch.full((T,), 7, dtype=torch.int32, device="cuda")
        res["K9"] = _time(
            "K9 code-dispatch 4 bodies",
            lambda qc, k, v: launch3(qi, ki, fl, code, qc, k, v, qa_rep,
                                     ka_rows),
            H // BH, args, iters, reps)
    if "k10" in argv:
        fl10 = torch.full((T,), _EMPTY | (15 << 4), dtype=torch.int32,
                          device="cuda")  # code 15: dead
        for n_bodies, bh in [(2, 4), (3, 4), (4, 4), (4, 2)]:
            res[f"K10 n={n_bodies} bh={bh}"] = _time(
                f"K10 n={n_bodies} bh={bh}",
                lambda qc, k, v, n=n_bodies, bh=bh: launch4(
                    n, bh, qi, ki, fl10, qc, k, v),
                H // bh, args, iters, reps)
    return res


if __name__ == "__main__":
    main()
