"""Times the decode kernel of source trees in turns on one card (no JAX
counterpart: a tool for redesigning `csrc/flash_decode_ref.cu`).

    python -m flash_attn_tpu_torch.diag.decode_ab [--rounds N]
        [--splits 0,4,6,8,16] [--variants base,noload,nocomp] TREE [TREE ...]

Each TREE is the root of a checkout of this repository, such as the parent
commit unpacked with `git archive` into a git-ignored directory.  Every
(tree, variant) runs in a process of its own from that tree's root, so it
builds and imports that tree's kernels, and times, through the tree's own
wrappers and `chip_smoke.time_ms` (device time of back-to-back calls,
inputs cycled through 4x the L2):

* a: `decode_attn_ref_layout` on a paged bf16 cache at the bench shape
  (Llama-3-8B's widths, batch 8, 64 pages of 256 rows a sequence);
* b: the same cache quantised to int8;
* serve: `decode_attn_bhsd` at the serving decode's shape (GPT-2 small,
  batch 8, a 1024-row heads-first cache);
* g: the chunked prefill through `interface.flash_attn_varlen_func(
  block_table=)` at `chip_smoke.py`'s case (g) shapes.

a, b and serve run at every count of `--splits` (0: the tree's default),
serve with 256-key split units.  The rounds alternate the order of the
trees (A B, then B A).  A variant other than `base` runs a copy of the
tree's kernel source with one edit, to split the kernel's time: `noload`
issues no copy (compute on whatever the ring holds), `nocomp` skips all
but the loads.  Their outputs are meaningless; only their times are read.
Prints one JSON line per run, then the medians by (tree, variant).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

KERNEL_SOURCE = Path("flash_attn_tpu_torch/csrc/flash_decode_ref.cu")
VARIANTS = {
    "noload": ("  auto issue = [&](int col0, int slot) {\n",
               "  auto issue = [&](int col0, int slot) {\n"
               "    if (col0 >= 0) return;\n"),
    "nocomp": ("    const unsigned char* sV = sK + kSlotBytes;\n",
               "    const unsigned char* sV = sK + kSlotBytes;\n"
               "    if (n > 0) { col0 += n; continue; }\n"),
}

WORKER = r'''
import json, sys
import torch
import chip_smoke as cs
from flash_attn_tpu_torch import interface
from flash_attn_tpu_torch.kernels import _build, flash_decode as fd

splits = [int(x) for x in sys.argv[1].split(",")]
_build.build(("flash_decode_ref",))
dev = "cuda"
gen = torch.Generator(device=dev).manual_seed(0)
h, hk, d, b, page, npages = 32, 8, 128, 8, 256, 512
table = torch.randperm(npages, generator=gen, device=dev).view(b, 64).int()
kc = torch.randn(npages, page, hk, d, generator=gen, device=dev).bfloat16()
vc = torch.randn(npages, page, hk, d, generator=gen, device=dev).bfloat16()
q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
lens = torch.full((b,), 64 * page, dtype=torch.int32, device=dev)
kq, kds = cs.quantise_paged_int8(kc, table)
vq, vds = cs.quantise_paged_int8(vc, table)
res = {}
for n in splits:
    kw = dict(softmax_scale=d ** -0.5, causal=True, block_table=table)
    if n:
        kw["num_splits"] = n
    res[f"a_ms[{n}]"] = cs.time_ms(
        lambda *a: fd.decode_attn_ref_layout(*a, **kw),
        cs.input_copies(q, kc, vc, lens))
    kw8 = dict(kw, k_descale=kds, v_descale=vds)
    res[f"b_ms[{n}]"] = cs.time_ms(
        lambda *a: fd.decode_attn_ref_layout(*a, **kw8),
        cs.input_copies(q, kq, vq, lens))
del kc, vc, kq, vq
torch.cuda.empty_cache()
qs = torch.randn(8, 12, 1, 64, generator=gen, device=dev).bfloat16()
ks = torch.randn(8, 12, 1024, 64, generator=gen, device=dev).bfloat16()
vs = torch.randn(8, 12, 1024, 64, generator=gen, device=dev).bfloat16()
ls = torch.randint(17, 1025, (8,), generator=gen, device=dev,
                   dtype=torch.int32)
for n in splits:
    kws = dict(softmax_scale=0.125, causal=True)
    if n:
        kws.update(num_splits=n, block_k=256)
    res[f"serve_ms[{n}]"] = cs.time_ms(
        lambda *a: fd.decode_attn_bhsd(*a, **kws),
        cs.input_copies(qs, ks, vs, ls))
b4, pps = 4, 16
np4 = b4 * pps + 8
t4 = torch.randperm(np4, generator=gen, device=dev)[:b4 * pps].view(
    b4, pps).int()
kc4 = torch.randn(np4, page, hk, d, generator=gen, device=dev).bfloat16()
vc4 = torch.randn(np4, page, hk, d, generator=gen, device=dev).bfloat16()
lk = torch.randint(2048, 4097, (b4,), generator=gen, device=dev,
                   dtype=torch.int32)
lq = torch.randint(64, 513, (b4,), generator=gen, device=dev,
                   dtype=torch.int32)
cu_q = torch.nn.functional.pad(lq.cumsum(0), (1, 0)).int()
cu_k = torch.nn.functional.pad(lk.cumsum(0), (1, 0)).int()
q4 = torch.randn(int(lq.sum()), h, d, generator=gen, device=dev).bfloat16()
mq, mk = int(lq.max()), int(lk.max())
res["g_ms"] = cs.time_ms(
    lambda a, k_, v_: interface.flash_attn_varlen_func(
        a, k_, v_, cu_q, cu_k, mq, mk, causal=True, block_table=t4),
    cs.input_copies(q4, kc4, vc4))
print(json.dumps(res))
'''


def variant_tree(tree: Path, variant: str, work: Path) -> Path | None:
    """`tree` itself for `base`, else a copy of its port and `chip_smoke.py`
    under `work` (in the git-ignored build directory) with the variant's
    edit of the kernel source; None where the tree's source has no place
    for the edit."""
    if variant == "base":
        return tree
    anchor, edit = VARIANTS[variant]
    src = (tree / KERNEL_SOURCE).read_text()
    if anchor not in src:
        return None
    dst = work / f"{tree.name or 'tree'}-{variant}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "flash_attn_tpu_torch", dst / "flash_attn_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(tree / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / KERNEL_SOURCE).write_text(src.replace(anchor, edit, 1))
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--splits", default="0")
    ap.add_argument("--variants", default="base")
    args = ap.parse_args(argv)
    work = Path(__file__).resolve().parents[1] / "_build" / "decode_ab"
    runs = {}
    for r in range(args.rounds):
        trees = args.trees if r % 2 == 0 else args.trees[::-1]
        for tree in trees:
            for variant in args.variants.split(","):
                root = variant_tree(tree.resolve(), variant, work)
                if root is None:
                    print(json.dumps(dict(tree=str(tree), variant=variant,
                                          skipped="no place for the edit")))
                    continue
                out = subprocess.run(
                    [sys.executable, "-c", WORKER, args.splits], cwd=root,
                    capture_output=True, text=True, timeout=900)
                if out.returncode != 0:
                    raise RuntimeError(f"{tree} {variant}:\n{out.stderr}")
                res = json.loads(out.stdout.strip().splitlines()[-1])
                print(json.dumps(dict(round=r, tree=str(tree),
                                      variant=variant, **res)), flush=True)
                runs.setdefault((str(tree), variant), []).append(res)
    for (tree, variant), rs in runs.items():
        med = {k: statistics.median(x[k] for x in rs) for k in rs[0]}
        print(json.dumps(dict(tree=tree, variant=variant, runs=len(rs),
                              median=med)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
