"""Times the decode ladder and the varlen bisect of source trees in turns on
one card (no JAX counterpart: a tool for redesigning `csrc/diag_int8_decode.cu`
and `csrc/diag_varlen_bisect.cu`).

    python -m flash_attn_tpu_torch.diag.probe_ab [--rounds N]
        [--splits 1,4] TREE [TREE ...]

Each TREE is the root of a checkout of this repository, such as the parent
commit unpacked with `git archive` into a git-ignored directory.  Each tree
runs in a process of its own from its root, so it builds and imports that
tree's kernels, and times through the tree's own wrappers:

* every ladder rung, bf16 and int8, at the probe's shape (b 8, hk 8, 8
  rows, smax 8192, d 128, bk 1024) at each key split of `--splits`, and the
  production decode kernel (`flash_decode_ref`, 4 rows of the same m16
  tile) on the same cache at the same split: `chip_smoke.time_ms` (device
  time of back-to-back calls, input sets cycled through 4x the L2);
* the bisect's levels K0..K10 on the probe's all-empty table of 256 ticks
  (H 16, BQ = BK 1024, BH 4), through its `main` (`benchmark_chained`, the
  least of each leg).

The rounds alternate the order of the trees (A B, then B A).  Prints one
JSON line per run, then the medians by tree.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

WORKER = r'''
import contextlib, io, json, sys
import torch
import chip_smoke as cs
from flash_attn_tpu_torch.kernels import _build, flash_decode as fd
from flash_attn_tpu_torch.diag import int8_decode as ld
from flash_attn_tpu_torch.diag import varlen_overhead_bisect as vb

splits_list = [int(x) for x in sys.argv[1].split(",")]
_build.build(("diag_int8_decode", "diag_varlen_bisect", "flash_decode_ref"))
res = {}
for int8 in (False, True):
    name = "int8" if int8 else "bf16"
    q, kc, vc = ld.make_inputs(int8)
    b, hk, _, d = q.shape
    smax = kc.shape[1]
    lens = torch.full((b,), smax, dtype=torch.int32, device="cuda")
    qs = torch.ones(b, hk, device="cuda") if int8 else None
    inputs = cs.input_copies(q, kc, vc)
    for n in splits_list:
        for st in ld.STAGES:
            res[f"{name} {st} [{n}]"] = cs.time_ms(
                lambda *a, st=st, n=n: ld.decode_ladder(st, *a, bk=1024,
                                                        splits=n), inputs)

        # int8_decode.production_decode's launch, written out: a parent
        # tree's module may not have it
        def production(q_, k_, v_, n=n):
            fd._launch(q_[:, :, :4].contiguous(), k_.view(b, smax, hk, d),
                       v_.view(b, smax, hk, d), lens, h=4 * hk, sq=1,
                       q_code=0, cache_code=2 if int8 else 0,
                       softmax_scale=ld.SCALE, causal=False,
                       window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
                       splits=n, split_keys=smax // n, smax=smax, q_scale=qs)

        res[f"{name} production [{n}]"] = cs.time_ms(production, inputs)
    del q, kc, vc, inputs
    torch.cuda.empty_cache()
with contextlib.redirect_stdout(io.StringIO()):
    bis = vb.main(["k04", "k58", "k9", "k10"])
for k, v in bis.items():
    res[f"bisect {k} ms"] = v["ms"]
print(json.dumps(res))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--splits", default="1,4")
    args = ap.parse_args(argv)
    runs = {}
    for r in range(args.rounds):
        trees = args.trees if r % 2 == 0 else args.trees[::-1]
        for tree in trees:
            out = subprocess.run(
                [sys.executable, "-c", WORKER, args.splits],
                cwd=tree.resolve(), capture_output=True, text=True,
                timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"{tree}:\n{out.stderr}")
            res = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(round=r, tree=str(tree), **res)),
                  flush=True)
            runs.setdefault(str(tree), []).append(res)
    for tree, rs in runs.items():
        med = {k: statistics.median(x[k] for x in rs) for k in rs[0]}
        print(json.dumps(dict(tree=tree, runs=len(rs), median=med)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
