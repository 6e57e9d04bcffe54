"""Times the flex kernels of source trees in turns on one card (no JAX
counterpart: a tool for redesigning `csrc/flex.cu`'s `flex_fwd_kernel`,
`flex_bwd_dq_kernel` and `flex_bwd_dkv_kernel`).

    python -m flash_attn_tpu_torch.diag.flex_ab [--bwd | --path]
        [--rounds N] [--cases c,a,i,layer]
        [--variants base,noload,nocomp,nobits] TREE [TREE ...]

Each TREE is the root of a checkout of this repository, such as the parent
commit unpacked with `git archive` into a git-ignored directory.  Every
(tree, variant) runs in a process of its own from that tree's root, so it
builds and imports that tree's kernels.  Without `--bwd` it times
`kernels.flex.flex_attn_fwd` through the tree's own wrapper with
`chip_smoke.time_ms` (device time of back-to-back calls, inputs cycled
through 4x the L2).  With `--bwd` it times `kernels.flex.flex_attn_bwd` on
the case's forward output and a seeded dO, each of its two kernels apart,
from `torch.profiler`'s device activity (`chip_smoke.kernel_device_ms`,
10 calls, inputs cycled the same way): `<case>_dq_ms` and `<case>_dkv_ms`.
With `--path` it runs the `flex` path instead (`chip_smoke.flex_phase`:
32 layers forward and backward; the cases are not used) and reports its
forward and backward ms a layer, attention tokens/s, mask preparation
ms, and device busy ms, idle share and kernels a layer.
Cases, as `chip_smoke.py`'s `kernel_flex` phase builds them (bf16,
128-blocks unless said):

* a: GPT-2 small, causal (b 8, h 12, s 1024, d 64);
* b: sliding window 256 + causal (b 4, h 16, s 2048, d 128);
* c: document mask through aux at Llama-3-8B's widths (b 1, h 32, hk 8,
  s 8192, d 128);
* d: softcap 30 + causal; e: relative position, GQA, causal; f: a (1, h,
  sq, sk) bias + causal (d 64); g: ragged sq 1000, sk 1500, empty rows;
* h: `flash_blocksparse_attn_func`'s seeded 8x8 layout of 512-blocks;
* i: the packed varlen BERT batch (64 sequences, h 12, d 64);
* layer: one layer of the `flex` path (Llama-3-8B's widths, 8192 tokens,
  causal document mask, head-invariant).

The rounds alternate the order of the trees (A B, then B A).  A variant
other than `base` runs a copy of the tree's kernel source with one edit
inside the kernel it names, to split that kernel's time; an anchor found
only outside that kernel's text is not used.  Forward variants: `noload`
issues no K/V copy (each stage is handed over as it stands), `nocomp`
skips all but the loads, `nobits` treats every listed block as full (no
bit test).  Backward variants (`--bwd`): `noload_dq` issues no K/V copy,
`noload_dkv` no Q/dO, lse, delta or bits copy; `nocomp_dq` / `nocomp_dkv`
skip all but the loads (the outputs of these are meaningless; only their
times are read); `noorder_dq` / `noorder_dkv` run the blocks in the
grid's own order instead of heaviest first (same results).  A tree whose
kernel has no place for an edit (the first versions have no producer for
`noload` and `nocomp`) skips that variant.  All trees and variants are
built first, in parallel.  Prints one JSON line per run, then the medians
by (tree, variant).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

KERNEL_SOURCE = Path("flash_attn_tpu_torch/csrc/flex.cu")
# a producer's copy of one ring stage and a consumer's wait for one, at the
# indentation of the forward's and the dQ kernel's loops (the dK/dV
# kernel's are deeper)
_EXPECT = "        mbar_expect_tx(&bar_full[stage], 2 * Cfg::kTileBytes);\n"
_FULL = "      mbar_wait(&bar_full[stage], (it / kStages) & 1);\n"
_MASKED = "      if (kMods || partial || col0 + kKeys > p.sk) {\n"
# the first version's bit test
_BITS = ("          if (partial) keep = keep && "
         "bit_set(bits + brow[i] * p.words, c);\n")
_NOLOAD = (_EXPECT, "        if (col0 >= 0) {\n"
                    "          mbar_arrive(&bar_full[stage]);\n"
                    "          continue;\n"
                    "        }\n" + _EXPECT)
_NOCOMP = (_FULL, _FULL + "      if (col0 >= 0) {\n"
                          "        if (lane == 0) "
                          "mbar_arrive(&bar_empty[stage]);\n"
                          "        continue;\n"
                          "      }\n")
_DKV_EMPTY = ("          mbar_wait(&bar_empty[stage], ((it / kStages) & 1)"
              " ^ 1);\n")
_ORDER = "  const dim3 blk = bwd_block(p);\n"
_DKV_FULL = "  " + _FULL
FWD, DQ, DKV = "flex_fwd_kernel", "flex_bwd_dq_kernel", "flex_bwd_dkv_kernel"
# variant: (kernel, [(anchor, edit), ...]): the first pair whose anchor the
# kernel's text holds
VARIANTS = {
    "noload": (FWD, [_NOLOAD]),
    "nocomp": (FWD, [_NOCOMP]),
    "nobits": (FWD, [(_MASKED, "      if (kMods || col0 + kKeys > p.sk) {\n"),
                     (_BITS, "")]),
    "noload_dq": (DQ, [_NOLOAD]),
    "nocomp_dq": (DQ, [_NOCOMP]),
    # the stage handed over with no copy: tiles, lse, delta, bits
    "noload_dkv": (DKV, [(_DKV_EMPTY, _DKV_EMPTY
                          + "          if (row0 >= 0) {\n"
                            "            mbar_arrive(&bar_full[stage]);\n"
                            "            continue;\n"
                            "          }\n")]),
    "nocomp_dkv": (DKV, [(_DKV_FULL,
                          _DKV_FULL + "        if (row0 >= 0) {\n"
                                      "          if (lane == 0) "
                                      "mbar_arrive(&bar_empty[stage]);\n"
                                      "          continue;\n"
                                      "        }\n")]),
    # the grid's own block order in place of the wrapper's heaviest-first
    "noorder_dq": (DQ, [(_ORDER, "  const dim3 blk = blockIdx;\n")]),
    "noorder_dkv": (DKV, [(_ORDER, "  const dim3 blk = blockIdx;\n")]),
}
BWD_VARIANTS = tuple(v for v, (kernel, _) in VARIANTS.items()
                     if kernel != FWD)
CASES = ("a", "b", "c", "d", "e", "f", "g", "h", "i", "layer")
BWD_KERNELS = (DQ, DKV)


def kernel_span(src: str, kernel: str) -> tuple[int, int]:
    """[start, end) of `kernel`'s definition in `src`: from its name to the
    closing brace at the start of a line."""
    start = re.search(rf"\n\s+{kernel}\(const FlexParams", src).start()
    return start, src.index("\n}\n", start) + 3


def edit_source(src: str, variant: str) -> str | None:
    """`src` with `variant`'s edit made inside the kernel it names, or None
    where that kernel's text holds none of its anchors."""
    kernel, pairs = VARIANTS[variant]
    start, end = kernel_span(src, kernel)
    body = src[start:end]
    for anchor, edit in pairs:
        if anchor in body:
            assert body.count(anchor) == 1, (variant, anchor)
            return src[:start] + body.replace(anchor, edit, 1) + src[end:]
    return None

WORKER = r'''
import json, sys
import torch
import chip_smoke as cs
from flash_attn_tpu_torch import blocksparse
from flash_attn_tpu_torch.kernels import _build, flex
from flash_attn_tpu_torch.kernels import varlen_packed as vp

cases = sys.argv[1].split(",")
_build.build(("flex",))
dev = cs.DEV
gen = torch.Generator(device=dev).manual_seed(7)


def make(key):
    if key == "a":
        return cs.flex_inputs("a", 8, 12, 12, 1024, 1024, 64, gen,
                              cs.causal_mod)
    if key == "b":
        return cs.flex_inputs("b", 4, 16, 16, 2048, 2048, 128, gen,
                              cs.window_causal_mod)
    if key == "c":
        docs = cs.doc_ids(cs.doc_lengths(torch.Generator().manual_seed(7),
                                         cs.FLEX_SEQ, 128, 4096))
        return cs.flex_inputs("c", 1, 32, 8, cs.FLEX_SEQ, cs.FLEX_SEQ, 128,
                              gen, cs.doc_mod, aux=docs)
    if key == "d":
        return cs.flex_inputs("d", 4, 16, 16, 2048, 2048, 128, gen,
                              cs.causal_mod, score_mod=flex.softcap(30.0))
    if key == "e":
        return cs.flex_inputs(
            "e", 2, 32, 8, 2048, 2048, 128, gen, cs.causal_mod,
            score_mod=flex.relative_position(
                2.0 ** (-8.0 * torch.arange(1, 33) / 32)))
    if key == "f":
        bias = torch.randn(1, 16, 2048, 2048, generator=gen, device=dev) * 0.5
        return cs.flex_inputs("f", 2, 16, 16, 2048, 2048, 64, gen,
                              cs.causal_mod, bias=bias)
    if key == "g":
        return cs.flex_inputs("g", 2, 16, 16, 1000, 1500, 64, gen,
                              cs.late_rows_mod)
    if key == "h":
        layout = torch.rand(8, 8, generator=torch.Generator().manual_seed(8)) \
            < 0.4
        layout |= torch.eye(8, dtype=torch.bool)
        return cs.flex_inputs(
            "h", 2, 16, 16, 4096, 4096, 64, gen, None,
            block_mask=blocksparse.convert_blockmask(
                layout, 2, 16, 4096, 4096, block_q=512, block_k=512,
                device=dev))
    if key == "i":
        lens = cs.bert_batch_lengths()
        q, k, v, cu, _ = cs.varlen_inputs(lens, lens, 12, 12, 64, gen,
                                          torch.bfloat16)
        total, blk = q.shape[0], 128
        tp = -(-total // blk) * blk
        aux = vp._segment_aux(cu, total, tp)[None]
        bm = vp.varlen_block_mask(cu, cu, tp, tp, causal=False, block_q=blk,
                                  block_k=blk, nheads=1)
        c = cs.flex_inputs("i", 1, 12, 12, total, total, 64, gen,
                           vp.make_varlen_mask_mod(False), aux=aux,
                           block_mask=bm)
        c["q"], c["k"], c["v"] = q[None], k[None], v[None]
        return c
    docs = cs.doc_ids(cs.doc_lengths(torch.Generator().manual_seed(5),
                                     cs.FLEX_SEQ, 128, 4096))
    return cs.flex_inputs("layer", 1, 32, 8, cs.FLEX_SEQ, cs.FLEX_SEQ, 128,
                          gen, cs.doc_causal_mod, aux=docs,
                          block=cs.FLEX_BLOCK)


if sys.argv[2] == "path":
    r = cs.flex_phase()
    prof = r["profile"]
    print(json.dumps(dict(
        fwd_ms=r["forward_ms_per_layer"], bwd_ms=r["backward_ms_per_layer"],
        tokens_per_s=r["attention_tokens_per_s"],
        mask_prep_ms=r["mask_prep_ms"],
        busy_ms=prof["device_busy_ms_per_layer"],
        idle_share=prof["device_idle_share"],
        kernels=prof["device_kernels_per_layer"])))
    sys.exit(0)
res = {}
for key in cases:
    c = make(key)
    kw = c["kw"]
    if sys.argv[2] == "fwd":
        res[f"{key}_ms"] = cs.time_ms(
            lambda *a: flex.flex_attn_fwd(*a, *kw),
            cs.input_copies(c["q"], c["k"], c["v"]))
    else:
        o, lse = flex.flex_attn_fwd(c["q"], c["k"], c["v"], *kw)
        do = torch.randn(c["q"].shape, generator=gen, device=dev).bfloat16()
        names = sys.argv[3].split(",")
        ms = cs.kernel_device_ms(
            lambda *a: flex.flex_attn_bwd(*a, *kw),
            cs.input_copies(do, c["q"], c["k"], c["v"], o, lse), names,
            iters=10)
        for name in names:
            res[f"{key}_{name.split('_')[2]}_ms"] = ms[name]
        del o, lse, do
    del c
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


def variant_tree(tree: Path, variant: str, work: Path) -> Path | None:
    """`tree` itself for `base`, else a copy of its port and `chip_smoke.py`
    under `work` (in the git-ignored build directory) with the variant's
    edit of the kernel source; None where the tree's kernel has no place
    for the edit."""
    if variant == "base":
        return tree
    src = edit_source((tree / KERNEL_SOURCE).read_text(), variant)
    if src is None:
        return None
    dst = work / f"{tree.name or 'tree'}-{variant}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "flash_attn_tpu_torch", dst / "flash_attn_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(tree / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / KERNEL_SOURCE).write_text(src)
    return dst


def build_all(roots):
    """Build the flex kernel of every tree in `roots`, one process each, all
    started together (each `nvcc` of `csrc/flex.cu` takes about a minute)."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from flash_attn_tpu_torch.kernels import "
         "_build; _build.build(('flex',))"], cwd=root, stderr=subprocess.PIPE,
        text=True) for root in dict.fromkeys(roots)]
    for root, proc in zip(dict.fromkeys(roots), procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: build failed\n{err}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward's two kernels")
    ap.add_argument("--path", action="store_true",
                    help="run chip_smoke.flex_phase, the flex path")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=None,
                    help="default c,a,i,layer; with --bwd a,c,d,f,g,layer")
    ap.add_argument("--variants", default="base")
    args = ap.parse_args(argv)
    cases = args.cases or ("a,c,d,f,g,layer" if args.bwd else "c,a,i,layer")
    unknown = set(cases.split(",")) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; known: {CASES}")
    variants = args.variants.split(",")
    known = ("base",) + (BWD_VARIANTS if args.bwd else tuple(
        v for v in VARIANTS if v not in BWD_VARIANTS))
    if set(variants) - set(known):
        ap.error(f"unknown variants {sorted(set(variants) - set(known))}; "
                 f"known{' with --bwd' if args.bwd else ''}: {known}")
    mode = (["path"] if args.path else
            ["bwd", ",".join(BWD_KERNELS)] if args.bwd else ["fwd"])
    work = Path(__file__).resolve().parents[1] / "_build" / "flex_ab"
    roots = {(tree, variant): variant_tree(tree.resolve(), variant, work)
             for tree in args.trees for variant in variants}
    build_all([r for r in roots.values() if r is not None])
    runs = {}
    for r in range(args.rounds):
        trees = args.trees if r % 2 == 0 else args.trees[::-1]
        for tree in trees:
            for variant in variants:
                root = roots[tree, variant]
                if root is None:
                    print(json.dumps(dict(tree=str(tree), variant=variant,
                                          skipped="no place for the edit")))
                    continue
                out = subprocess.run(
                    [sys.executable, "-c", WORKER, cases, *mode], cwd=root,
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
