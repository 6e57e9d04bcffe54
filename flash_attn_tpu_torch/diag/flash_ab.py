"""Times the dense and varlen attention kernels of source trees in turns on
one card (no JAX counterpart: a tool for redesigning `csrc/flash_fwd.cu`'s
`flash_fwd_kernel` and `csrc/flash_bwd.cu`'s `flash_bwd_dq_kernel` and
`flash_bwd_dkv_kernel`).

    python -m flash_attn_tpu_torch.diag.flash_ab [--path train]
        [--rounds N] [--cases a,b,...,f1,f2,f10,...]
        [--variants base,rows64,rows128] TREE [TREE ...]

Each TREE is the root of a checkout of this repository, such as the parent
commit unpacked with `git archive` into a git-ignored directory.  Every
tree runs in a process of its own from its root, so it builds and imports
that tree's kernels.  Each case times the tree's own wrapper: the whole
call with `chip_smoke.time_ms` (device time of back-to-back calls, inputs
cycled through 4x the L2), `<case>_ms`, and each of its kernels apart from
`torch.profiler`'s device activity (`chip_smoke.kernel_device_ms`, 10
calls): `<case>_dq_ms` and `<case>_dkv_ms` for the backward, `<case>_
kernel_ms` for the forward (whose whole call also counts the wrapper's
allocations: in varlen mode a zeroed o and an lse filled with +inf).
Cases, as `chip_smoke.py` builds them (bf16):

* a-d: `flash_attn_bwd_bhsd` on the forward's output and a seeded dO at
  `kernel_bwd`'s cases: a, GPT-2 small's training shape (b 8, h 12, s
  1024, d 64, causal); b, GQA (b 2, h 32, hk 8, s 2048, d 128, causal); c,
  window (256, 0) + softcap 30 + ALiBi, causal (b 2, h 12, s 1024, d 64);
  d, ragged seqused_q / seqused_k, one batch with no key (b 3, h 12, s
  1024, d 64, causal);
* va-vd: `varlen_attn_bwd` at `kernel_varlen_bwd`'s cases: va, the BERT
  batch (64 sequences of 16-512 tokens, h 12, d 64); vb, packed causal GQA
  (8 documents of 128-4096 tokens, h 32, hk 8, d 128); vc, cross lengths
  with an empty q and an empty k sequence (16 sequences, h 16, hk 4, d
  128, causal); vd, window (256, 0) + softcap 30 + ALiBi (16 sequences of
  64-2048 tokens, h 12, d 64);
* the forward, `flash_attn_fwd_bhsd` at `kernel_fwd`'s cases: f1 (a), the
  serving prefill (b 8, h 12, sq 512 of a 1024-row cache, d 64, causal;
  `PERF.md` row 1); f2 (f), the training shape (row 2); fb (b),
  full-length causal d = 128 (b 2, h 16, s 2048); fc (c), GQA with ragged
  seqused_k (b 2, h 32, hk 8, s 1024, d 128, causal; seqused_k from a
  seeded CPU generator); fd (d), window (256, 0) + softcap 30 + ALiBi
  (the mod kernels); and `varlen_attn_fwd` at `kernel_varlen`'s cases: f10
  (a), the BERT batch (row 10); fvb (b), packed causal GQA; fvd (d),
  window + softcap + ALiBi; and on (d)'s lengths fvw, the window alone,
  and fvm, softcap + ALiBi under a causal mask (which of the two the
  varlen row tile follows).

`--variants` runs each tree once per variant: `base` is the tree as it
is; `rows64` and `rows128` are copies of its port and `chip_smoke.py` (in
the git-ignored build directory) whose `csrc/flash_fwd.cu` takes 64 or
128 q rows a block at every head dim in place of `FwdTiles`' rule (64 at
d = 64, 128 at d = 128; `kernels.flash_fwd.fwd_rows`), the measurement
that chose it; a tree whose kernel has no such rule runs `base` only.  With
`--path train` it runs a few steps of the smoke's `train` phase instead
(GPT-2 small at the JAX defaults, `chip_smoke.train_config`): two warm-up
steps, then `TRAIN_STEPS` steps timed on the host clock, ended by a
synchronize; it reports step ms and tokens/s.  The rounds alternate the
order of the runs (A B, then B A).  All trees are built first, in
parallel.  Prints one JSON line per run, then the medians by run.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

CASES = ("a", "b", "c", "d", "va", "vb", "vc", "vd", "f1", "f2", "fb", "fc",
         "fd", "f10", "fvb", "fvd", "fvw", "fvm")
DEFAULT_CASES = "a,b,c,d,va,vb,vc,vd"
TRAIN_STEPS = 8
KERNEL_SOURCE = Path("flash_attn_tpu_torch/csrc/flash_fwd.cu")
# the forward's row-tile rule, and what each variant puts in its place
TILE_RULE = "static constexpr int kRows = D == 64 ? 64 : 128;"
VARIANTS = {"rows64": "static constexpr int kRows = 64;",
            "rows128": "static constexpr int kRows = 128;"}

WORKER = r'''
import json, sys, time
import torch
import chip_smoke as cs
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels import flash_bwd as fb
from flash_attn_tpu_torch.kernels import flash_fwd as ff
from flash_attn_tpu_torch.kernels import varlen as vl

_build.build(("flash_fwd", "flash_bwd"))
torch.backends.cuda.matmul.allow_tf32 = False
dev = cs.DEV

if sys.argv[2] == "train":
    from flash_attn_tpu_torch.training.trainer import Trainer
    t = Trainer(cs.train_config())
    for _ in range(2):
        t.train_step(next(t.loader))
    steps = int(sys.argv[3])
    batches = [next(t.loader) for _ in range(steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        t.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    print(json.dumps(dict(step_ms=step_s * 1e3,
                          tokens_per_s=t.speed.tokens_per_step / step_s)))
    sys.exit(0)

gen = torch.Generator(device=dev).manual_seed(7)
BWD = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
FWD = ("flash_fwd_kernel",)


def dense(b, h, hk, s, d, squ, sku, window=(-1, -1), softcap=0.0,
          alibi=False):
    q, k, v = (torch.randn(b, n, s, d, generator=gen, device=dev).bfloat16()
               for n in (h, hk, hk))
    squ = torch.tensor(squ, dtype=torch.int32, device=dev)
    sku = torch.tensor(sku, dtype=torch.int32, device=dev)
    slopes = (torch.rand(b, h, generator=gen, device=dev) * 0.3
              if alibi else None)
    kw = dict(softmax_scale=d ** -0.5, causal=True, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    rows = (torch.arange(s, device=dev)[None, None, :]
            < squ[:, None, None])[..., None]
    do = (torch.randn(b, h, s, d, generator=gen, device=dev)
          * rows).bfloat16()
    o, lse = ff.flash_attn_fwd_bhsd(q, k, v, squ, sku, **kw)
    return (lambda *a: fb.flash_attn_bwd_bhsd(*a, **kw),
            (do, q, k, v, o, lse, squ, sku), BWD)


def packed(lens_q, lens_k, h, hk, d, causal=False, window=(-1, -1),
           softcap=0.0, alibi=False):
    q, k, v, cu_q, cu_k = cs.varlen_inputs(lens_q, lens_k, h, hk, d, gen,
                                           torch.bfloat16)
    slopes = (torch.rand(h, generator=gen, device=dev) * 0.3
              if alibi else None)
    kw = dict(softmax_scale=d ** -0.5, causal=causal, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    args = (cu_q, cu_k, max(lens_q), max(lens_k))
    o, lse = vl.varlen_attn_fwd(q, k, v, *args, **kw)
    do = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    return (lambda *a: vl.varlen_attn_bwd(*a, *args, **kw),
            (do, q, k, v, o, lse), BWD)


def forward(b, h, hk, sq, sk, d, squ, sku, window=(-1, -1), softcap=0.0,
            alibi=False):
    q = torch.randn(b, h, sq, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    squ = torch.tensor(squ, dtype=torch.int32, device=dev)
    sku = torch.tensor(sku, dtype=torch.int32, device=dev)
    slopes = (torch.rand(b, h, generator=gen, device=dev) * 0.3
              if alibi else None)
    kw = dict(softmax_scale=d ** -0.5, causal=True, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    return (lambda *a: ff.flash_attn_fwd_bhsd(*a, **kw),
            (q, k, v, squ, sku), FWD)


def packed_fwd(lens, h, hk, d, causal=False, window=(-1, -1), softcap=0.0,
               alibi=False):
    q, k, v, cu_q, cu_k = cs.varlen_inputs(lens, lens, h, hk, d, gen,
                                           torch.bfloat16)
    slopes = (torch.rand(h, generator=gen, device=dev) * 0.3
              if alibi else None)
    args = (cu_q, cu_k, max(lens), max(lens))
    kw = dict(softmax_scale=d ** -0.5, causal=causal, window_size=window,
              softcap=softcap, alibi_slopes=slopes)
    return (lambda *a: vl.varlen_attn_fwd(*a, *args, **kw), (q, k, v), FWD)


lens = torch.Generator().manual_seed(4)  # kernel_varlen_phases' order
docs = cs.varlen_lengths(lens, 8, 128, 4096)
cross_q = cs.varlen_lengths(lens, 16, 1, 1024)
cross_k = cs.varlen_lengths(lens, 16, 1, 2048)
cross_q[3], cross_k[7] = 0, 0
win = cs.varlen_lengths(lens, 16, 64, 2048)
bert = cs.bert_batch_lengths()
ragged_k = torch.randint(1, 1025, (2,),
                         generator=torch.Generator().manual_seed(3)).tolist()
wsa = dict(window=(256, 0), softcap=30.0, alibi=True)
make = {
    "a": lambda: dense(8, 12, 12, 1024, 64, [1024] * 8, [1024] * 8),
    "b": lambda: dense(2, 32, 8, 2048, 128, [2048] * 2, [2048] * 2),
    "c": lambda: dense(2, 12, 12, 1024, 64, [1024] * 2, [1024] * 2, **wsa),
    "d": lambda: dense(3, 12, 12, 1024, 64, [1024, 700, 1024],
                       [1024, 500, 0]),
    "va": lambda: packed(bert, bert, 12, 12, 64),
    "vb": lambda: packed(docs, docs, 32, 8, 128, causal=True),
    "vc": lambda: packed(cross_q, cross_k, 16, 4, 128, causal=True),
    "vd": lambda: packed(win, win, 12, 12, 64, **wsa),
    "f1": lambda: forward(8, 12, 12, 512, 1024, 64, [512] * 8, [512] * 8),
    "f2": lambda: forward(8, 12, 12, 1024, 1024, 64, [1024] * 8,
                          [1024] * 8),
    "fb": lambda: forward(2, 16, 16, 2048, 2048, 128, [2048] * 2,
                          [2048] * 2),
    "fc": lambda: forward(2, 32, 8, 1024, 1024, 128, [1024] * 2, ragged_k),
    "fd": lambda: forward(2, 12, 12, 1024, 1024, 64, [1024] * 2,
                          [1024] * 2, **wsa),
    "f10": lambda: packed_fwd(bert, 12, 12, 64),
    "fvb": lambda: packed_fwd(docs, 32, 8, 128, causal=True),
    "fvd": lambda: packed_fwd(win, 12, 12, 64, **wsa),
    "fvw": lambda: packed_fwd(win, 12, 12, 64, window=(256, 0)),
    "fvm": lambda: packed_fwd(win, 12, 12, 64, causal=True, softcap=30.0,
                              alibi=True),
}
res = {}
for key in sys.argv[1].split(","):
    fn, args, names = make[key]()
    copies = cs.input_copies(*args)
    res[f"{key}_ms"] = cs.time_ms(fn, copies)
    ms = cs.kernel_device_ms(fn, copies, names, iters=10)
    for name in names:
        part = "kernel" if name in FWD else name.split("_")[2]
        res[f"{key}_{part}_ms"] = ms[name]
    del fn, args, copies
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


def build_all(roots):
    """Build the forward and backward kernels of every tree in `roots`, one
    process each, all started together."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from flash_attn_tpu_torch.kernels import "
         "_build; _build.build(('flash_fwd', 'flash_bwd'))"], cwd=root,
        stderr=subprocess.PIPE, text=True) for root in roots]
    for root, proc in zip(roots, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: build failed\n{err}")


def variant_tree(tree: Path, variant: str, work: Path) -> Path | None:
    """`tree` itself for `base`, else a copy of its port and `chip_smoke.py`
    under `work` with `variant`'s row tile in `csrc/flash_fwd.cu`; None
    where the tree's kernel has no tile rule to replace."""
    if variant == "base":
        return tree
    src = (tree / KERNEL_SOURCE).read_text()
    if TILE_RULE not in src:
        return None
    dst = work / f"{tree.name or 'tree'}-{variant}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "flash_attn_tpu_torch", dst / "flash_attn_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(tree / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / KERNEL_SOURCE).write_text(src.replace(TILE_RULE,
                                                 VARIANTS[variant]))
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--path", choices=("train",), default=None,
                    help="run a few steps of the smoke's train phase")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=DEFAULT_CASES)
    ap.add_argument("--variants", default="base",
                    help="base and / or the forward's row tiles "
                    f"{sorted(VARIANTS)}")
    args = ap.parse_args(argv)
    unknown = set(args.cases.split(",")) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; known: {CASES}")
    variants = args.variants.split(",")
    if set(variants) - {"base", *VARIANTS}:
        ap.error(f"unknown variants; known: base, {sorted(VARIANTS)}")
    work = Path(__file__).resolve().parents[1] / "_build" / "flash_ab"
    arms = {}
    for tree in args.trees:
        for variant in variants:
            root = variant_tree(tree.resolve(), variant, work)
            if root is not None:
                arms[f"{tree.resolve()} {variant}"] = root
    build_all(list(dict.fromkeys(arms.values())))
    mode = ["train", str(TRAIN_STEPS)] if args.path else ["kernels"]
    runs = {}
    for r in range(args.rounds):
        names = list(arms) if r % 2 == 0 else list(arms)[::-1]
        for name in names:
            out = subprocess.run(
                [sys.executable, "-c", WORKER, args.cases, *mode],
                cwd=arms[name], capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"{name}:\n{out.stderr}")
            res = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(round=r, tree=name, **res)), flush=True)
            runs.setdefault(name, []).append(res)
    for name, rs in runs.items():
        med = {k: statistics.median(x[k] for x in rs) for k in rs[0]}
        print(json.dumps(dict(tree=name, runs=len(rs), median=med)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
