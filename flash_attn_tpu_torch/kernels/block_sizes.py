"""Tile-size heuristic of the JAX package's forward kernels (counterpart of
`flash_attn_tpu/kernels/block_sizes.py:15-66`).

The port keeps its own copy because `interface.get_scheduler_metadata`
returns these values, and they stay the JAX heuristic's so that the two
packages return the same dictionary.  The CUDA kernels choose their own
tiles and do not read them.
"""

from __future__ import annotations

import dataclasses


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class FwdBlockSizes:
    block_q: int
    block_k: int
    # Compute subtile of block_k (0 = whole tile).
    block_k_sub: int = 0


def fwd_block_sizes(seqlen_q: int, seqlen_k: int, head_dim: int,
                    boundary_heavy: bool = False) -> FwdBlockSizes:
    """(block_q, block_k, block_k_sub) as `block_sizes.py:42` picks them."""
    bks = 0
    if head_dim <= 128:
        if boundary_heavy:
            bq, bk, bks = 1024, 4096, 1024
        else:
            bq, bk = 1024, 2048
    elif head_dim <= 192:
        bq, bk = 1024, 1024
    else:
        bq, bk = 512, 1024
    bq = min(bq, max(128, round_up(seqlen_q, 128)))
    bk = min(bk, max(128, round_up(seqlen_k, 128)))
    if bks:
        bks = min(bks, bk)
        if bk % bks:
            bks = 0
    return FwdBlockSizes(bq, bk, bks)
