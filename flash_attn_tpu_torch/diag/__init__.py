"""Diagnostic probes on the card (counterparts of the JAX benchmark probes).

* `dma_stream` (`benchmarks/diag_dma_stream.py`): paged-read bandwidth
  through a page table.
* `int8_decode` (`benchmarks/diag_int8_decode.py`): the decode body stripped
  one stage at a time, int8 and bf16.
* `varlen_overhead_bisect` (`benchmarks/diag_varlen_overhead_bisect.py`):
  the fixed cost of a tick of the scheduled varlen forward, level by level.

Each module has a wrapper per kernel variant that launches its hand-written
CUDA kernel (`csrc/diag_*.cu`) on CUDA tensors and raises on any other
device, a plain PyTorch twin of the same signature (the tests' and the
smoke's yardstick), and `main(argv)`, run as
`python -m flash_attn_tpu_torch.diag.<name>`.

This module holds the port's own copy of what the bisect reads from
`flash_attn_tpu/kernels/varlen_sched.py`: the tick flags, the aux lane
counts and the aux word packing.
"""

from __future__ import annotations

import torch

# tick flags of the scheduled varlen tables (`varlen_sched.py:61`)
_FIRST, _LAST, _BOUND, _EMPTY = 1, 2, 4, 8
STAT = 8  # q-aux lane replication (`varlen_sched.py:62`)
LANES = 128  # lanes of the m / l scratch rows

_POS_BITS = 16
_POS_MASK = (1 << _POS_BITS) - 1


def pack_aux(segment, position):
    """Aux words `segment << 16 | position` (int32)."""
    seg = torch.as_tensor(segment, dtype=torch.int32)
    pos = torch.as_tensor(position, dtype=torch.int32)
    return (seg << _POS_BITS) | (pos & _POS_MASK)


def aux_segment(aux):
    """The segment of aux words, by a logical right shift of the int32."""
    return (aux >> _POS_BITS) & _POS_MASK


def aux_position(aux):
    return aux & _POS_MASK


def require_cuda(name, *tensors):
    """The probes' kernels take CUDA tensors only: nothing runs a twin in
    their place."""
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise RuntimeError(
                f"{name}: the kernel takes CUDA tensors, got {t.device} "
                "(the plain twin `*_ref` runs on the CPU)")


def device_line():
    """The card's name, the device count and the power limit, for the
    probes' output."""
    import subprocess

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi: not available"
    return (f"device: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()} ({smi})")
