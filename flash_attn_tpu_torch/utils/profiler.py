"""Profiler trace capture helpers (counterpart of
`flash_attn_tpu/utils/profiler.py`).

Wrap a callable, capture a `torch.profiler` trace (a Chrome trace, viewable
in Perfetto or chrome://tracing), and return the trace directory.  Used to
see kernel-level time that the chained-timing harness cannot split: the
device time of each kernel, and the gaps between them.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_trace(fn, *args, trace_dir: str | None = None, iters: int = 3,
                  warmup: int = 1):
    """Run `fn(*args)` `warmup` times, then `iters` times under
    `torch.profiler` (CPU activity, and CUDA activity where a card is
    present), and write the Chrome trace `<trace_dir>/trace.json`.

    Returns (result of the last call, trace_dir).  `trace_dir` defaults to a
    new temporary directory."""
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="torch-trace-")
    os.makedirs(trace_dir, exist_ok=True)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            out = fn(*args)
        _sync()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out, trace_dir


def annotate(name: str):
    """Named region in the trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


def summarize_trace(trace_dir: str, top: int = 15):
    """Parse the newest Chrome trace (`*.json` or `*.json.gz`) under
    `trace_dir` and return the `top` (name, total ms) pairs of its complete
    events, by total duration."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    if not paths:
        return []
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    totals = {}
    for ev in events:
        if ev.get("ph") == "X" and "dur" in ev:
            name = ev.get("name", "?")
            totals[name] = totals.get(name, 0.0) + float(ev["dur"])
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [(name, dur_us / 1e3) for name, dur_us in ranked]  # ms
