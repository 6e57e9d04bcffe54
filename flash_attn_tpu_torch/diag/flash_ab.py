"""Times the dense and varlen backward kernels of source trees in turns on
one card (no JAX counterpart: a tool for redesigning `csrc/flash_bwd.cu`'s
`flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`).

    python -m flash_attn_tpu_torch.diag.flash_ab [--path train]
        [--rounds N] [--cases a,b,c,d,va,vb,vc,vd,f1,f2,f10] TREE [TREE ...]

Each TREE is the root of a checkout of this repository, such as the parent
commit unpacked with `git archive` into a git-ignored directory.  Every
tree runs in a process of its own from its root, so it builds and imports
that tree's kernels.  For each case the worker times the tree's own
wrapper on the case's forward output and a seeded dO: the whole call with
`chip_smoke.time_ms` (device time of back-to-back calls, inputs cycled
through 4x the L2), `<case>_ms`, and each of its two kernels apart from
`torch.profiler`'s device activity (`chip_smoke.kernel_device_ms`, 10
calls), `<case>_dq_ms` and `<case>_dkv_ms`.  Cases, as `chip_smoke.py`
builds them (bf16):

* a-d: `flash_attn_bwd_bhsd` at `kernel_bwd`'s cases: a, GPT-2 small's
  training shape (b 8, h 12, s 1024, d 64, causal); b, GQA (b 2, h 32, hk
  8, s 2048, d 128, causal); c, window (256, 0) + softcap 30 + ALiBi,
  causal (b 2, h 12, s 1024, d 64); d, ragged seqused_q / seqused_k, one
  batch with no key (b 3, h 12, s 1024, d 64, causal);
* va-vd: `varlen_attn_bwd` at `kernel_varlen_bwd`'s cases: va, the BERT
  batch (64 sequences of 16-512 tokens, h 12, d 64); vb, packed causal GQA
  (8 documents of 128-4096 tokens, h 32, hk 8, d 128); vc, cross lengths
  with an empty q and an empty k sequence (16 sequences, h 16, hk 4, d
  128, causal); vd, window (256, 0) + softcap 30 + ALiBi (16 sequences of
  64-2048 tokens, h 12, d 64);
* f1, f2, f10: the forward kernels of `PERF.md` rows 1, 2 and 10, whole
  call only (`flash_attn_fwd_bhsd` at the serving prefill, b 8, h 12, sq
  512 of 1024, d 64, and at the training shape; `varlen_attn_fwd` at the
  BERT batch), to hold what the backward's redesign leaves unchanged.

With `--path train` it runs a few steps of the smoke's `train` phase
instead (GPT-2 small at the JAX defaults, `chip_smoke.train_config`): two
warm-up steps, then `TRAIN_STEPS` steps timed on the host clock, ended by a
synchronize; it reports step ms and tokens/s.  The rounds alternate the
order of the trees (A B, then B A).  All trees are built first, in
parallel.  Prints one JSON line per run, then the medians by tree.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CASES = ("a", "b", "c", "d", "va", "vb", "vc", "vd", "f1", "f2", "f10")
DEFAULT_CASES = "a,b,c,d,va,vb,vc,vd"
TRAIN_STEPS = 8
KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")

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
names = sys.argv[3].split(",")


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
            (do, q, k, v, o, lse, squ, sku))


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
            (do, q, k, v, o, lse))


def forward(b, h, s, sq, d):
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16()
               for n in (sq, s, s))
    used = torch.full((b,), sq, dtype=torch.int32, device=dev)
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    return (lambda *a: ff.flash_attn_fwd_bhsd(*a, **kw),
            (q, k, v, used, used))


def packed_fwd(lens, h, d):
    q, k, v, cu_q, cu_k = cs.varlen_inputs(lens, lens, h, h, d, gen,
                                           torch.bfloat16)
    args = (cu_q, cu_k, max(lens), max(lens))
    kw = dict(softmax_scale=d ** -0.5)
    return (lambda *a: vl.varlen_attn_fwd(*a, *args, **kw), (q, k, v))


lens = torch.Generator().manual_seed(4)  # kernel_varlen_phases' order
docs = cs.varlen_lengths(lens, 8, 128, 4096)
cross_q = cs.varlen_lengths(lens, 16, 1, 1024)
cross_k = cs.varlen_lengths(lens, 16, 1, 2048)
cross_q[3], cross_k[7] = 0, 0
win = cs.varlen_lengths(lens, 16, 64, 2048)
bert = cs.bert_batch_lengths()
make = {
    "a": lambda: dense(8, 12, 12, 1024, 64, [1024] * 8, [1024] * 8),
    "b": lambda: dense(2, 32, 8, 2048, 128, [2048] * 2, [2048] * 2),
    "c": lambda: dense(2, 12, 12, 1024, 64, [1024] * 2, [1024] * 2,
                       window=(256, 0), softcap=30.0, alibi=True),
    "d": lambda: dense(3, 12, 12, 1024, 64, [1024, 700, 1024],
                       [1024, 500, 0]),
    "va": lambda: packed(bert, bert, 12, 12, 64),
    "vb": lambda: packed(docs, docs, 32, 8, 128, causal=True),
    "vc": lambda: packed(cross_q, cross_k, 16, 4, 128, causal=True),
    "vd": lambda: packed(win, win, 12, 12, 64, window=(256, 0),
                         softcap=30.0, alibi=True),
    "f1": lambda: forward(8, 12, 1024, 512, 64),
    "f2": lambda: forward(8, 12, 1024, 1024, 64),
    "f10": lambda: packed_fwd(bert, 12, 64),
}
res = {}
for key in sys.argv[1].split(","):
    fn, args = make[key]()
    copies = cs.input_copies(*args)
    res[f"{key}_ms"] = cs.time_ms(fn, copies)
    if not key.startswith("f"):
        ms = cs.kernel_device_ms(fn, copies, names, iters=10)
        for name in names:
            res[f"{key}_{name.split('_')[2]}_ms"] = ms[name]
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--path", choices=("train",), default=None,
                    help="run a few steps of the smoke's train phase")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=DEFAULT_CASES)
    args = ap.parse_args(argv)
    unknown = set(args.cases.split(",")) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; known: {CASES}")
    mode = (["train", str(TRAIN_STEPS)] if args.path else
            ["bwd", ",".join(KERNELS)])
    roots = [tree.resolve() for tree in args.trees]
    build_all(list(dict.fromkeys(roots)))
    runs = {}
    for r in range(args.rounds):
        order = roots if r % 2 == 0 else roots[::-1]
        for root in order:
            out = subprocess.run(
                [sys.executable, "-c", WORKER, args.cases, *mode], cwd=root,
                capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"{root}:\n{out.stderr}")
            res = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(round=r, tree=str(root), **res)),
                  flush=True)
            runs.setdefault(str(root), []).append(res)
    for tree, rs in runs.items():
        med = {k: statistics.median(x[k] for x in rs) for k in rs[0]}
        print(json.dumps(dict(tree=tree, runs=len(rs), median=med)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
