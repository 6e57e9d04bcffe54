"""Micro-benchmark harness (counterpart of `flash_attn_tpu/utils/benchmark.py`).

The card's timing rule: PyTorch returns from a call before the card has run
it, so a host clock measures the enqueue unless the stream is synchronised.
Here the op under test is chained n times and then 2n times, back to back
on the current stream, and each leg is timed with CUDA events recorded on
that stream; the time per call is the difference of the two legs over n,
which cancels the fixed cost of a leg.  A spin kernel
(`torch.cuda._sleep`) holds the stream while the host queues a leg, so the
host's own time per call (Python, argument checks, launch) is not counted;
the spin is lengthened until the host has queued the whole leg before it
ends.  A step that the host cannot queue ahead of the card (one that
synchronises, or launches more kernels than the launch queue holds while the
spin blocks it) is timed without the spin, so its time includes the
host's.  On the CPU each leg is timed with `time.perf_counter` as the
least of three runs: on cores shared with other work a leg of a small op
takes whatever time slices the process loses, which can make the n-call
leg outlast the 2n-call one.

Eager PyTorch runs every call in stream order, so a step needs no data
dependency on its carry to be timed (the JAX harness needs one, or XLA
hoists the call out of its loop).

FLOPs accounting matches the JAX module (and its reference,
`benchmarks/benchmark_flash_attention.py:27-33`): fwd = 4*b*s^2*h*d
(halved if causal), bwd = 2.5x fwd, fwd+bwd = 3.5x fwd.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Timing(float):
    """Seconds per call; `host_bound` is True when a CUDA timing ran without
    the spin, so the host's time per call is included."""

    host_bound = False


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return []


def _on_cuda(carry, consts):
    return any(t.is_cuda for t in _leaves((carry, consts)))


def _chain(step_fn, carry, consts, n):
    for _ in range(n):
        carry = step_fn(carry, *consts)
    return carry


def _cuda_legs(step_fn, carry, consts, n, donate):
    """Device seconds of an n-call and a 2n-call leg, each run while a spin
    kernel holds the stream until the host has queued it, the last carry,
    and whether the spin was dropped: a step the host cannot queue ahead of
    the card (it synchronises, or its kernels overrun the launch queue
    while the spin holds it) is timed without it, host time included."""
    for cycles in (10_000_000, 40_000_000, 160_000_000, 640_000_000, 0):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        if cycles:
            torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        c = _chain(step_fn, carry, consts, n)
        ev[2].record()
        c = _chain(step_fn, c if donate else carry, consts, 2 * n)
        ev[3].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if not cycles or host_ms < ev[0].elapsed_time(ev[1]):
            break
    return (ev[1].elapsed_time(ev[2]) / 1e3, ev[2].elapsed_time(ev[3]) / 1e3,
            c, not cycles)


def _cpu_leg(step_fn, carry, consts, n, donate):
    """Wall seconds of an n-call leg on the CPU, the least of three runs
    (a process that shares its cores loses whole time slices, which only
    lengthen a run), and the last carry."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = _chain(step_fn, carry, consts, n)
        best = min(best, time.perf_counter() - t0)
        if donate:
            carry = out
    return best, out


def benchmark_chained(step_fn, carry, *consts, iters: int = 32, reps: int = 3,
                      donate: bool = False, agg: str = "median"):
    """Per-iteration seconds of `carry -> step_fn(carry, *consts)`.

    `carry` is a tensor or a (nested) tuple, list or dict of tensors; the
    CUDA path is taken when any tensor of `carry` or `consts` lies on a
    CUDA device, else the CPU path.

    `donate=False`: every leg starts from `carry`, so `step_fn` must not
    write into it.  `donate=True`: each leg continues from the state the
    previous one returned, and `step_fn` may update the carry in place (a
    cache append, a train state): the caller's `carry` is overwritten.

    `agg`: "median" takes the median of the per-rep (t2N - tN) / N;
    "min" takes (min(t2N) - min(tN)) / N across reps (host jitter is
    additive, so the least of each leg is its cleanest estimate).  Returns
    a `Timing` (a float of seconds)."""
    cuda = _on_cuda(carry, consts)
    c = carry
    t1s, t2s = [], []
    held = False
    for rep in range(reps + 1):  # rep 0 warms up
        if cuda:
            t1, t2, out, dropped = _cuda_legs(step_fn, c, consts, iters,
                                              donate)
            held |= dropped and rep > 0
        else:
            t1, out = _cpu_leg(step_fn, c, consts, iters, donate)
            t2, out = _cpu_leg(step_fn, out if donate else c, consts,
                               2 * iters, donate)
        if donate:
            c = out
        if rep:
            t1s.append(t1)
            t2s.append(t2)
    out = Timing(_aggregate(t1s, t2s, iters, agg))
    out.host_bound = held
    return out


def _aggregate(t1s, t2s, iters, agg):
    if agg == "min":
        return float((min(t2s) - min(t1s)) / iters)
    return float(np.median([(b - a) / iters for a, b in zip(t1s, t2s)]))


def attention_flops(b, sq, sk, h, d, causal=False, mode="fwd"):
    """Reference FLOPs model (`benchmarks/benchmark_flash_attention.py:27`)."""
    f = 4 * b * sq * sk * h * d // (2 if causal else 1)
    return {"fwd": f, "bwd": int(2.5 * f), "fwd_bwd": int(3.5 * f)}[mode]


def benchmark_attention_fwd(flash_fn, q, k, v, iters: int = 32, reps: int = 3,
                            agg: str = "median", **kw):
    """Time `flash_fn(q, k, v, **kw)` chained through q (same shape as out)."""

    def step(q, k, v):
        o = flash_fn(q, k, v, **kw)
        return o.to(q.dtype)

    return benchmark_chained(step, q, k, v, iters=iters, reps=reps, agg=agg)


def benchmark_attention_fwd_bwd(flash_fn, q, k, v, iters=16, reps=3,
                                agg: str = "median", **kw):
    """Time forward + backward (autograd) chained through the (q, k, v)
    gradients."""

    def step(carry):
        q, k, v = (t.detach().requires_grad_() for t in carry)
        loss = flash_fn(q, k, v, **kw).float().sum()
        dq, dk, dv = torch.autograd.grad(loss, (q, k, v))
        return (dq.to(q.dtype) * 1e-3 + q.detach(),
                dk.to(k.dtype) * 1e-3 + k.detach(),
                dv.to(v.dtype) * 1e-3 + v.detach())

    return benchmark_chained(step, (q, k, v), iters=iters, reps=reps,
                             agg=agg)
