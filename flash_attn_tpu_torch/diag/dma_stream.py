"""Pure-stream microbench: what sets paged-read bandwidth on the card?
(counterpart of `benchmarks/diag_dma_stream.py`).

Streams a (N, R, 1024) bf16 array page by page through a page table
(`csrc/diag_dma_stream.cu`: every byte of every page into shared memory,
one (8, 128) tile of each folded into the output), varying:
  R (page rows)      256 / 512 / 1024
  table order        sequential / shuffled
  bundle             1 / 2 / 4  (separate page loads in flight per step)
  fused shape        (N, 2, R, 1024): two-page contiguous blocks
Total bytes constant (512 MiB).  Reports GB/s.

    python -m flash_attn_tpu_torch.diag.dma_stream

`dma_stream` launches the kernel (CUDA tensors only) and `dma_stream_ref`
is its plain twin.  Bytes as the JAX script counts them:
steps * bundle * (2 if fused) * R * 1024 * 2.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from flash_attn_tpu_torch.diag import device_line, require_cuda
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.utils.benchmark import benchmark_chained

KERNEL = "diag_dma_stream"
LANES = 1024
TOTAL = 512 * 1024 * 1024  # bytes

# Number of times the CUDA kernel was launched (the twin does not count).
launches = 0

_ctas: dict[int, int] = {}


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.diag_dma_stream.argtypes = [P] * 4 + [I] * 5 + [P]
        lib.diag_dma_stream.restype = I
        lib.diag_dma_stream_ctas.argtypes = [I, P]
        lib.diag_dma_stream_ctas.restype = I
        _build.declare_error_string(lib)
        lib._typed = True
    return lib


def _layout(arr, fused):
    """(pages, rows) of a plain (n, R, 1024) or fused (n, 2, R, 1024)
    array; raises on any other shape."""
    want = 4 if fused else 3
    if arr.ndim != want or arr.shape[-1] != LANES or (
            fused and arr.shape[1] != 2):
        raise ValueError(
            f"arr must be ({'n, 2, ' if fused else 'n, '}R, {LANES}), "
            f"got {tuple(arr.shape)}")
    return arr.shape[0], arr.shape[-2]


def stream_bytes(rows, bundle, fused, steps):
    """The bytes one call streams, as the JAX script counts them."""
    return steps * bundle * (2 if fused else 1) * rows * LANES * 2


def dma_stream_ref(arr, table, *, bundle: int, fused: bool):
    """Plain twin of `dma_stream`: the (8, 128) fp32 sum over the streamed
    pages table[:steps * bundle] of each page's [:8, :128] tile (its first
    half's, fused)."""
    _layout(arr, fused)
    steps = table.shape[0] // bundle
    tiles = arr[:, 0] if fused else arr
    pages = table[: steps * bundle].long()
    return tiles[:, :8, :128][pages].float().sum(0)


def dma_stream(arr, table, *, bundle: int, fused: bool):
    """Stream table[:steps * bundle] (steps = len(table) // bundle) pages of
    `arr`, bundle pages a step, through `csrc/diag_dma_stream.cu`; returns
    the (8, 128) fp32 tile sum (see `dma_stream_ref`).  Table entries must
    lie in [0, n).  CUDA tensors only."""
    global launches
    require_cuda("dma_stream", arr, table)
    _, rows = _layout(arr, fused)
    loads = bundle * (2 if fused else 1)
    if loads not in (1, 2, 4):
        raise ValueError(f"bundle * (2 if fused) must be 1, 2 or 4, got {loads}")
    if arr.dtype != torch.bfloat16 or not arr.is_contiguous():
        raise ValueError("arr must be contiguous bf16")
    if rows % 8 or arr.data_ptr() % 16:
        raise ValueError("pages must hold a multiple of 8 rows, 16 B aligned")
    if table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError("table must be contiguous int32")
    steps = table.shape[0] // bundle
    lib = _lib()
    if loads not in _ctas:
        n = ctypes.c_int(0)
        _build.check(lib, lib.diag_dma_stream_ctas(loads, ctypes.byref(n)),
                     KERNEL)
        _ctas[loads] = n.value
    ctas = _ctas[loads]
    partial = torch.empty(ctas, 8, 128, dtype=torch.float32, device=arr.device)
    out = torch.empty(8, 128, dtype=torch.float32, device=arr.device)
    err = lib.diag_dma_stream(
        arr.data_ptr(), table.data_ptr(), partial.data_ptr(), out.data_ptr(),
        rows, bundle, int(fused), steps, ctas,
        torch.cuda.current_stream(arr.device).cuda_stream)
    _build.check(lib, err, KERNEL)
    launches += 1
    return out


_BIG = None


def big():
    """The 512 MiB bf16 array, made on the card from seed 0."""
    global _BIG
    if _BIG is None:
        gen = torch.Generator(device="cuda").manual_seed(0)
        _BIG = torch.randn((TOTAL // (LANES * 2), LANES), generator=gen,
                           device="cuda", dtype=torch.bfloat16)
    return _BIG


def make_case(R, bundle, shuffled, fused):
    """(arr, table, steps) of one variant, as the JAX script builds them."""
    n = TOTAL // (R * LANES * 2) // (2 if fused else 1)
    rng = np.random.default_rng(0)
    if fused:
        arr = big()[: n * 2 * R].view(n, 2, R, LANES)
    else:
        arr = big()[: n * R].view(n, R, LANES)
    order = np.arange(n, dtype=np.int32)
    if shuffled:
        order = rng.permutation(order).astype(np.int32)
    table = torch.as_tensor(order, device="cuda")
    return arr, table, n // bundle


def run(R, bundle, shuffled, fused, reps=3, iters=8):
    arr, table, steps = make_case(R, bundle, shuffled, fused)

    def step(table, arr):
        dma_stream(arr, table, bundle=bundle, fused=fused)
        return table

    dt = benchmark_chained(step, table, arr, iters=iters, reps=reps,
                           agg="min")
    bts = stream_bytes(R, bundle, fused, steps)
    tag = ("fused4d" if fused else "plain ")
    print(f"{tag} R={R:5d} bundle={bundle} shuf={int(shuffled)}: "
          f"{bts/dt/1e9:7.1f} GB/s  ({steps} steps)", flush=True)
    return dict(R=R, bundle=bundle, shuffled=shuffled, fused=fused,
                steps=steps, bytes=bts, ms=dt * 1e3, gbps=bts / dt / 1e9)


VARIANTS = [(R, bundle, shuffled, fused)
            for fused in (False, True)
            for R in (256, 512, 1024)
            for bundle in ((1, 2, 4) if not fused else (1, 2))
            for shuffled in (False, True)]


def main(argv=None, reps=3, iters=8):
    del argv  # the JAX script takes no arguments
    print(device_line(), flush=True)
    return [run(R, bundle, shuffled, fused, reps=reps, iters=iters)
            for R, bundle, shuffled, fused in VARIANTS]


if __name__ == "__main__":
    main(sys.argv[1:])
