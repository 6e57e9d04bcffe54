"""Programmable attention: mask mods, score mods, block sparsity (counterpart
of `flash_attn_tpu/kernels/flex.py`: `BlockMask:64`, `_pack_indices:107`,
`create_block_mask:124`, `_dense_block_mask:202`, the Pallas kernels
`_flex_fwd_sched_kernel:430` (launched at `:868`), `_flex_fwd_hb_kernel:521`
(`:741`), `_flex_bwd_dq_kernel:912` (`:1204`), `_flex_bwd_dkv_kernel:1010`
(`:1290`), and `flex_attention:1334`).

A `BlockMask` lists, for each (batch, head, q block), the kv blocks to visit:
*full* ones (computed without the mask) and *partial* ones (masked); and, for
each kv block, the q blocks, for the backward's dK/dV pass.  The lists are
followed as given: an unlisted block pair is skipped even where `mask_mod`
would keep some of it, and a full one is computed unmasked.

Mods are torch callables with the JAX signatures, `mask_mod(b, h, q_idx,
kv_idx[, q_aux, kv_aux]) -> bool` and `score_mod(score, b, h, q_idx, kv_idx[,
q_aux, kv_aux]) -> score`.  Their index arguments are int32 tensors that
broadcast against each other (not the JAX scalars and (block_q, block_k)
grids), so a mod is written with tensor ops: `q_idx >= kv_idx`,
`slopes[h] * (q_idx - kv_idx).abs()`, `doc[b, q_idx] == doc[b, kv_idx]`.

A CUDA kernel cannot call Python, so the two kinds of mod reach the kernels
differently:
* `mask_mod`: any callable.  `partial_block_bits` evaluates it once per call,
  in PyTorch on the tensors' device, over the partial blocks only (with the
  padding test `kv_idx < kv_len`), and packs the result into one bit per
  (row, key) of each block.  The forward and both backward kernels read the
  same bits; the plain versions read them too.
* `score_mod`: on CUDA one of the compiled-in descriptors `softcap(cap)` and
  `relative_position(slopes)`; anything else raises `NotImplementedError`
  there (an additive score term of any form is exact through `attn_bias`).
  The plain versions take any callable and differentiate it with torch
  autograd, the counterpart of the JAX kernels' in-kernel `jax.vjp`.
The score is `s * scale`, then `+ attn_bias`, then the score mod, then the
mask, as JAX's `_mod_score` (`:903`).

`flex_attn_fwd` / `flex_attn_bwd` launch the hand-written Hopper kernels of
`csrc/flex.cu` on CUDA tensors and run their plain versions on CPU tensors.
A CUDA block reads the `BlockMask`'s per-q-block (or per-kv-block) lists
directly, so the TPU's tile tables (`_flex_schedule:360`, a flattened
(b, h, T) walk for a sequential grid) and the head-blocked grid of
`_flex_fwd_hb_kernel` (HB heads pipelined against one K/V tile for the MXU;
one kernel here serves rows 12 and 13, reading head-invariant tables with
head stride 0) have no counterpart; `block_h` is accepted and ignored.

Numerics: scores are float32 throughout.  The JAX forward with neither a
score mod nor a bias ("folded", `:859-862`) pre-scales q by scale * log2(e)
and rounds it back to q's dtype; the port does not, so in bf16 it is held to
the fp32 oracle with `check_close`, and to JAX only at that tolerance.  Keys
at or past kv_len are never attended (JAX zero-pads them and masks them in
partial blocks; a valid `BlockMask` lists no padded block as full).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from flash_attn_tpu_torch.env import default_device
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.block_sizes import cdiv, round_up
from flash_attn_tpu_torch.kernels.flash_fwd import _DTYPE_CODE

KERNEL = "flex"
TILE = 64  # the CUDA kernels' smallest tile: block_q, block_k multiples
# The head dims `csrc/flex.cu` is instantiated at: the dense kernels'
# padding to the next multiple of 64 (`flash_fwd.kernel_head_dim`) is not
# carried over to the flex kernels yet.
HEAD_DIMS = (64, 128)
_LOG2E = math.log2(math.e)
_MASK_CHUNK = 1 << 24  # elements of one mask evaluation (bounds its memory)
TABLES = ("kv_num", "kv_idx", "full_kv_num", "full_kv_idx", "q_num", "q_idx",
          "full_q_num", "full_q_idx")

MaskMod = Callable  # (b, h, q_idx, kv_idx[, q_aux, kv_aux]) -> bool
ScoreMod = Callable  # (score, b, h, q_idx, kv_idx[, q_aux, kv_aux]) -> score

# Launches of each CUDA kernel (plain CPU runs do not count).
launches_fwd = 0
launches_dq = 0
launches_dkv = 0


@dataclasses.dataclass
class BlockMask:
    """Block-sparse iteration structure (`flex.py:64`).

    Index tables are (B, H, n_major, n_minor) int32 with counts (B, H,
    n_major); H is 1 for a head-invariant mask.  `kv_*` drive the forward and
    dQ (per q block), `q_*` the dK/dV pass (per kv block)."""

    block_q: int
    block_k: int
    q_len: int
    kv_len: int
    kv_num: torch.Tensor       # partial kv blocks per q block
    kv_idx: torch.Tensor
    full_kv_num: torch.Tensor  # full kv blocks per q block
    full_kv_idx: torch.Tensor
    q_num: torch.Tensor        # partial q blocks per kv block
    q_idx: torch.Tensor
    full_q_num: torch.Tensor
    full_q_idx: torch.Tensor

    @property
    def sparsity(self) -> float:
        """Fraction of block pairs computed (1.0 = dense)."""
        total = int((self.kv_num + self.full_kv_num).sum())
        b_, h_, nq, nk = self.kv_idx.shape
        return total / float(b_ * h_ * nq * nk)

    @property
    def device(self) -> torch.device:
        return self.kv_num.device

    @classmethod
    def from_numpy(cls, block_q, block_k, q_len, kv_len, *, device=None,
                   **tables):
        """A `BlockMask` from the eight index arrays of a JAX `BlockMask`
        (numpy arrays, or anything `torch.as_tensor` takes), by name."""
        dev = default_device(device)
        return cls(int(block_q), int(block_k), int(q_len), int(kv_len),
                   **{n: torch.tensor(tables[n], dtype=torch.int32,
                                      device=dev) for n in TABLES})


def _pack_indices(blockmap):
    """(..., n_major, n_minor) bool -> (counts, indices: listed first, each
    part ascending) as `flex.py:107`'s stable argsort of ~blockmap."""
    counts = blockmap.sum(-1, dtype=torch.int32)
    order = torch.argsort((~blockmap).to(torch.uint8), dim=-1, stable=True)
    return counts, order.to(torch.int32)


def _default_flex_block(seq_len: int) -> int:
    """The JAX default tile edge (`flex.py:115`): 1024, clamped for short
    sequences to a multiple of 128."""
    return min(1024, round_up(max(seq_len, 1), 128))


def _call_mod(mod, args, aux):
    return mod(*args, *aux) if aux is not None else mod(*args)


def create_block_mask(mask_mod: MaskMod, B: int, H: int, q_len: int,
                      kv_len: int, *, block_q: int | None = None,
                      block_k: int | None = None, q_aux=None, kv_aux=None,
                      head_invariant: bool = False, device=None) -> BlockMask:
    """Evaluate `mask_mod` and build the block lists (`flex.py:124`): a block
    is *full* if every element is kept (padding included), *partial* if some
    are, skipped if none.  The mod sees (rows, 1) q and (1, cols) kv index
    tensors and, with aux, the aux values there (clamped to the aux's last
    entry, as the JAX function reads them); it is evaluated one (b, h) and a
    bounded run of q blocks at a time.  `head_invariant=True` evaluates h = 0
    only and keeps a head dimension of 1 in the tables.  Runs on `device`
    (None means CUDA, which must be present)."""
    dev = default_device(device)
    block_q = block_q or _default_flex_block(q_len)
    block_k = block_k or _default_flex_block(kv_len)
    q_len_p, kv_len_p = round_up(q_len, block_q), round_up(kv_len, block_k)
    nq, nk = q_len_p // block_q, kv_len_p // block_k
    hn = 1 if head_invariant else H
    has_aux = q_aux is not None or kv_aux is not None
    any_ = torch.empty(B, hn, nq, nk, dtype=torch.bool, device=dev)
    all_ = torch.empty_like(any_)
    ki = torch.arange(kv_len_p, dtype=torch.int32, device=dev)[None, :]
    step = max(1, _MASK_CHUNK // (block_q * kv_len_p)) * block_q

    def aux_at(aux, b, idx):
        if aux is None:
            return torch.zeros_like(idx)
        return aux[b, idx.clamp(max=aux.shape[1] - 1)]

    for b in range(B):
        bt = torch.tensor(b, dtype=torch.int32, device=dev)
        for h in range(hn):
            ht = torch.tensor(h, dtype=torch.int32, device=dev)
            for r0 in range(0, q_len_p, step):
                r1 = min(q_len_p, r0 + step)
                qi = torch.arange(r0, r1, dtype=torch.int32,
                                  device=dev)[:, None]
                aux = ((aux_at(q_aux, b, qi), aux_at(kv_aux, b, ki))
                       if has_aux else None)
                m = torch.as_tensor(_call_mod(mask_mod, (bt, ht, qi, ki), aux),
                                    device=dev).to(torch.bool)
                m = m.broadcast_to((r1 - r0, kv_len_p))
                m = m & (qi < q_len) & (ki < kv_len)
                blocks = m.view((r1 - r0) // block_q, block_q, nk, block_k)
                any_[b, h, r0 // block_q:r1 // block_q] = blocks.any(3).any(1)
                all_[b, h, r0 // block_q:r1 // block_q] = blocks.all(3).all(1)
    partial = any_ & ~all_
    kv_num, kv_idx = _pack_indices(partial)
    full_kv_num, full_kv_idx = _pack_indices(all_)
    q_num, q_idx = _pack_indices(partial.transpose(-1, -2))
    full_q_num, full_q_idx = _pack_indices(all_.transpose(-1, -2))
    return BlockMask(block_q, block_k, q_len, kv_len, kv_num, kv_idx,
                     full_kv_num, full_kv_idx, q_num, q_idx, full_q_num,
                     full_q_idx)


def _dense_block_mask(B, H, q_len, kv_len, block_q, block_k, has_mask,
                      head_invariant=False, device=None) -> BlockMask:
    """Every block listed; all partial iff there is a mask or padding
    (`flex.py:202`)."""
    dev = default_device(device)
    nq, nk = cdiv(max(q_len, 1), block_q), cdiv(max(kv_len, 1), block_k)
    H = 1 if head_invariant else H
    idx = torch.arange(nk, dtype=torch.int32, device=dev).expand(B, H, nq, nk)
    qidx = torch.arange(nq, dtype=torch.int32, device=dev).expand(B, H, nk, nq)
    zeros_k = torch.zeros(B, H, nq, dtype=torch.int32, device=dev)
    zeros_q = torch.zeros(B, H, nk, dtype=torch.int32, device=dev)
    masked = has_mask or q_len % block_q or kv_len % block_k
    full_k, part_k = (zeros_k, zeros_k + nk) if masked else (zeros_k + nk,
                                                             zeros_k)
    full_q, part_q = (zeros_q, zeros_q + nq) if masked else (zeros_q + nq,
                                                             zeros_q)
    return BlockMask(block_q, block_k, q_len, kv_len, part_k, idx, full_k, idx,
                     part_q, qidx, full_q, qidx)


# ---------------------------------------------------------------------------
# Score-mod descriptors
# ---------------------------------------------------------------------------

_MOD_NONE, _MOD_SOFTCAP, _MOD_RELPOS = 0, 1, 2


class ScoreModDescriptor:
    """A score mod that the CUDA kernels compute in place (`code` selects the
    formula).  Called, it is an ordinary torch score mod with the JAX
    signature, which the plain versions use."""

    def __init__(self, code: int, cap: float = 0.0, slopes=None):
        self.code, self.cap, self.slopes = code, float(cap), slopes
        self._on_device = {}

    def slopes_on(self, device) -> torch.Tensor:
        """The slopes as float32 on `device`, copied there once (a copy from
        host memory each call would wait for the stream)."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = self.slopes.to(
                device, torch.float32).contiguous()
        return self._on_device[key]

    def __call__(self, s, b, h, q_idx, kv_idx, *aux):
        if self.code == _MOD_SOFTCAP:
            return torch.tanh(s / self.cap) * self.cap
        slopes = self.slopes_on(s.device)
        return s - slopes[h] * (q_idx - kv_idx).abs().to(torch.float32)

    def __repr__(self):
        if self.code == _MOD_SOFTCAP:
            return f"softcap({self.cap})"
        return f"relative_position({self.slopes.tolist()})"


def softcap(cap: float) -> ScoreModDescriptor:
    """`tanh(s / cap) * cap`; its derivative is `1 - tanh(s / cap)^2`."""
    if not cap > 0:
        raise ValueError(f"softcap: cap must be positive, got {cap}")
    return ScoreModDescriptor(_MOD_SOFTCAP, cap=cap)


def relative_position(slopes) -> ScoreModDescriptor:
    """`s - slopes[h] * |q_idx - kv_idx|` with one slope per query head (an
    ALiBi-like bias); its derivative is 1."""
    slopes = torch.as_tensor(slopes, dtype=torch.float32).reshape(-1)
    return ScoreModDescriptor(_MOD_RELPOS, slopes=slopes)


# ---------------------------------------------------------------------------
# Partial-block bits
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MaskBits:
    """`mask_mod` on the partial blocks of a `BlockMask`.

    `slot` (B, H_t, nq, nk) int32 numbers the block pairs listed as partial
    in either direction (-1 elsewhere); `words` (P, block_q, cdiv(block_k,
    32)) int32 holds, for slot p, bit c % 32 of word c // 32 of row r set iff
    (q block row r, kv block key c) is kept."""

    slot: torch.Tensor
    words: torch.Tensor


def _padded_aux(aux, n):
    """A (b, s) aux read up to n positions, 0 past its end (the JAX kernels'
    padding, `_prep_aux:633`)."""
    return F.pad(aux, (0, n - aux.shape[1])) if aux.shape[1] < n else aux


def _aux_args(q_aux, kv_aux, b, rows, cols):
    """The aux values at (b, rows) and (b, cols), or None without aux."""
    if q_aux is None and kv_aux is None:
        return None

    def at(aux, idx):
        if aux is None:
            return torch.zeros_like(idx)
        return _padded_aux(aux, int(idx.max()) + 1)[b, idx]

    return at(q_aux, rows), at(kv_aux, cols)


def _pack_bits(keep):
    """(n, bq, bk) bool -> (n, bq, cdiv(bk, 32)) int32 words."""
    n, bq, bk = keep.shape
    w = cdiv(bk, 32)
    keep = F.pad(keep, (0, w * 32 - bk)).view(n, bq, w, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=keep.device)
    x = (keep << shifts).sum(-1)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _unpack_bits(words, bk):
    """(..., w) int32 words -> (..., bk) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.flatten(-2)[..., :bk].to(torch.bool)


def partial_block_bits(block_mask: BlockMask, mask_mod: Optional[MaskMod],
                       q_aux=None, kv_aux=None,
                       kv_len: Optional[int] = None) -> MaskBits:
    """Evaluate `mask_mod` (and `kv_idx < kv_len`) over every block pair the
    `BlockMask` lists as partial, in PyTorch on the mask's device, a bounded
    number of blocks at a time, and pack it (`MaskBits`).  The aux values
    past the aux's end are 0, as the JAX kernels pad them; head-invariant
    tables are evaluated at h = 0.  `kv_len` defaults to the mask's."""
    bm = block_mask
    bq, bk = bm.block_q, bm.block_k
    kv_len = bm.kv_len if kv_len is None else kv_len
    b, ht, nq, _ = bm.kv_idx.shape
    nk = bm.q_idx.shape[2]
    dev = bm.device

    def listed(num, idx, n_minor):
        valid = torch.arange(idx.shape[-1], device=dev) < num[..., None]
        cnt = torch.zeros(*num.shape, n_minor, dtype=torch.int32, device=dev)
        return cnt.scatter_add_(-1, idx.long(), valid.to(torch.int32)) > 0

    pair = listed(bm.kv_num, bm.kv_idx, nk) | listed(
        bm.q_num, bm.q_idx, nq).transpose(-1, -2)
    slot = (pair.flatten().cumsum(0, dtype=torch.int64) - 1).view(pair.shape)
    slot = torch.where(pair, slot, -1).to(torch.int32)
    where = pair.nonzero()  # (P, 4): b, h, q block, kv block, in slot order
    n = where.shape[0]
    words = torch.empty(n, bq, cdiv(bk, 32), dtype=torch.int32, device=dev)
    ar_q = torch.arange(bq, dtype=torch.int32, device=dev).view(1, bq, 1)
    ar_k = torch.arange(bk, dtype=torch.int32, device=dev).view(1, 1, bk)
    step = max(1, _MASK_CHUNK // (bq * bk))
    for p0 in range(0, n, step):
        bb, hh, qi, kb = where[p0:p0 + step].to(torch.int32).unbind(1)
        bb, hh = bb.view(-1, 1, 1), hh.view(-1, 1, 1)
        rows = qi.view(-1, 1, 1) * bq + ar_q
        cols = kb.view(-1, 1, 1) * bk + ar_k
        keep = cols < kv_len
        if mask_mod is not None:
            aux = _aux_args(q_aux, kv_aux, bb.long(), rows.long(), cols.long())
            m = torch.as_tensor(_call_mod(mask_mod, (bb, hh, rows, cols), aux),
                                device=dev).to(torch.bool)
            keep = keep & m
        words[p0:p0 + step] = _pack_bits(keep.broadcast_to(
            (bb.shape[0], bq, bk)))
    return MaskBits(slot, words)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _geometry(q, k, v, block_mask, bias=None):
    """Shapes of a call, checked against the `BlockMask`'s tables and the
    bias."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    bm = block_mask
    bq, bk = bm.block_q, bm.block_k
    nq, nk = cdiv(max(sq, 1), bq), cdiv(max(sk, 1), bk)
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    tb, th = bm.kv_num.shape[:2]
    if (tb != b or th not in (1, h) or tuple(bm.kv_num.shape) != (tb, th, nq)
            or tuple(bm.q_num.shape) != (tb, th, nk)):
        raise ValueError(
            f"block mask tables {tuple(bm.kv_num.shape)} / "
            f"{tuple(bm.q_num.shape)} do not fit b={b}, h={h}, {nq} q blocks "
            f"of {bq}, {nk} kv blocks of {bk}")
    if bm.device != q.device:
        raise ValueError(f"block mask on {bm.device}, q on {q.device}")
    if bias is not None and (bias.shape[0] not in (1, b)
                             or bias.shape[1] not in (1, h)
                             or tuple(bias.shape[2:]) != (sq, sk)):
        raise ValueError(f"attn_bias {tuple(bias.shape)} for b={b}, h={h}, "
                         f"sq={sq}, sk={sk}")
    return b, sq, h, d, sk, hk, bq, bk, nq, nk


class _Walk:
    """What the plain versions share: q, k, v, do as (b, h, blocks, rows, d)
    (zero-padded, kv heads repeated per query head), the tables expanded to
    every head, the bias as (b|1, h|1, nq, nk, bq, bk) blocks, and the
    score of a gathered set of block pairs."""

    def __init__(self, q, k, v, block_mask, bits, score_mod, scale, q_aux,
                 kv_aux, bias):
        (self.b, self.sq, self.h, self.d, self.sk, hk, self.bq, self.bk,
         self.nq, self.nk) = _geometry(q, k, v, block_mask, bias)
        b, h = self.b, self.h
        dev = q.device
        self.bits = bits
        self.score_mod, self.scale = score_mod, scale
        self.q_aux, self.kv_aux = q_aux, kv_aux
        kv_head = torch.arange(h, device=dev) // (h // hk)
        self.qb = self.blocks(q, self.bq)
        self.kb = self.blocks(k, self.bk)[:, kv_head]
        self.vb = self.blocks(v, self.bk)[:, kv_head]
        self.bi = torch.arange(b, device=dev).view(b, 1, 1)
        self.hi = torch.arange(h, device=dev).view(1, h, 1)
        self.slot = bits.slot.expand(b, h, self.nq, self.nk)
        self.bias = None
        if bias is not None:
            bias = bias.float()
            bb, bh = bias.shape[:2]
            bias = F.pad(bias, (0, self.nk * self.bk - self.sk,
                                0, self.nq * self.bq - self.sq))
            self.bias = bias.view(bb, bh, self.nq, self.bq, self.nk,
                                  self.bk).permute(0, 1, 2, 4, 3, 5)
            self.bias_bi = self.bi if bb > 1 else torch.zeros_like(self.bi)
            self.bias_hi = self.hi if bh > 1 else torch.zeros_like(self.hi)

    def blocks(self, x, blk):
        """(b, s, heads, d) -> (b, heads, n, blk, d), zero-padded."""
        b, s, heads, d = x.shape
        n = cdiv(max(s, 1), blk)
        x = F.pad(x, (0, 0, 0, 0, 0, n * blk - s))
        return x.permute(0, 2, 1, 3).reshape(b, heads, n, blk, d)

    def lists(self, num, idx):
        e = (self.b, self.h, *num.shape[2:])
        return num.expand(e), idx.expand(*e, idx.shape[-1]).long()

    def score(self, s, qblk, kblk, partial, valid):
        """(modded score in natural units, the score before the mod, keep)
        of the block pairs (qblk, kblk) ((b, h, n) each) whose raw q.k
        products are `s` (b, h, n, bq, bk), float32."""
        bq, bk, dev = self.bq, self.bk, s.device
        x = s * self.scale
        if self.bias is not None:
            x = x + self.bias[self.bias_bi, self.bias_hi, qblk, kblk]
        rows = (qblk * bq).to(torch.int32)[..., None, None] + torch.arange(
            bq, dtype=torch.int32, device=dev).view(bq, 1)
        cols = (kblk * bk).to(torch.int32)[..., None, None] + torch.arange(
            bk, dtype=torch.int32, device=dev).view(1, bk)
        x_in = x
        if self.score_mod is not None:
            bt = self.bi.to(torch.int32)[..., None, None]
            htt = self.hi.to(torch.int32)[..., None, None]
            aux = _aux_args(self.q_aux, self.kv_aux, self.bi[..., None, None],
                            rows.long(), cols.long())
            x_in = x.detach().requires_grad_(torch.is_grad_enabled())
            x = _call_mod(self.score_mod, (x_in, bt, htt, rows, cols), aux)
        keep = valid[..., None, None] & (cols < self.sk)
        if partial:
            slot = self.slot[self.bi, self.hi, qblk, kblk].clamp(min=0).long()
            keep = keep & _unpack_bits(self.bits.words[slot], bk)
        return x, x_in, keep


def flex_attn_fwd_ref(q, k, v, block_mask: BlockMask, bits: MaskBits,
                      score_mod: Optional[ScoreMod], scale: float,
                      q_aux=None, kv_aux=None, bias=None):
    """Plain PyTorch version of `flex_attn_fwd` (same signature): an online
    softmax over each q block's listed kv blocks, full ones first, then
    partial ones through the bits, for all (b, h, q block) at once.  The two
    products run in the inputs' dtype, the softmax in float32."""
    w = _Walk(q, k, v, block_mask, bits, score_mod, scale, q_aux, kv_aux,
              bias)
    b, h, nq, bq, d = w.b, w.h, w.nq, w.bq, w.d
    dev = q.device
    m = torch.full((b, h, nq, bq), -math.inf, device=dev)
    l = torch.zeros(b, h, nq, bq, device=dev)
    acc = torch.zeros(b, h, nq, bq, d, device=dev)
    qblk = torch.arange(nq, device=dev).view(1, 1, nq).expand(b, h, nq)
    bm = block_mask
    for partial, (num, idx) in ((False, w.lists(bm.full_kv_num,
                                                bm.full_kv_idx)),
                                (True, w.lists(bm.kv_num, bm.kv_idx))):
        for j in range(int(num.max()) if num.numel() else 0):
            valid = j < num
            kblk = idx[..., j]
            kj, vj = w.kb[w.bi, w.hi, kblk], w.vb[w.bi, w.hi, kblk]
            s = torch.matmul(w.qb, kj.transpose(-1, -2)).float()
            with torch.no_grad():
                x, _, keep = w.score(s, qblk, kblk, partial, valid)
            x = x.masked_fill(~keep, -math.inf)
            m_new = torch.maximum(m, x.amax(-1))
            m_use = m_new.masked_fill(torch.isneginf(m_new), 0.0)
            alpha = torch.exp(m - m_use)
            p = torch.exp(x - m_use[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(v.dtype), vj).float()
            m = m_new
    o = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    lse = torch.where(l == 0.0, math.inf, m + torch.log(l))
    o = o.reshape(b, h, nq * bq, d)[:, :, :w.sq].transpose(1, 2)
    return o.to(q.dtype), lse.reshape(b, h, nq * bq)[:, :, :w.sq].contiguous()


def _p_and_ds(w, s, dp, lse, delta, qblk, kblk, partial, valid):
    """p = exp(score - lse) and the score gradient through the score mod
    (autograd) of one gathered set of block pairs; (p, ds) float32."""
    with torch.enable_grad():
        x, x_in, keep = w.score(s, qblk, kblk, partial, valid)
    p = torch.exp(x.detach().masked_fill(~keep, -math.inf) - lse[..., None])
    ds = p * (dp - delta[..., None])
    if w.score_mod is not None:
        (ds,) = torch.autograd.grad(x, x_in, ds)
    return p, ds


def flex_attn_bwd_ref(do, q, k, v, o, lse, block_mask: BlockMask,
                      bits: MaskBits, score_mod: Optional[ScoreMod],
                      scale: float, q_aux=None, kv_aux=None, bias=None):
    """Plain PyTorch version of `flex_attn_bwd` (same signature): dQ (and
    dbias) over each q block's kv lists, dK and dV over each kv block's q
    lists summed over the query heads of a GQA group, full blocks first,
    for all blocks at once; the score mod's derivative from autograd."""
    w = _Walk(q, k, v, block_mask, bits, score_mod, scale, q_aux, kv_aux,
              bias)
    b, h, nq, nk, bq, bk, d = w.b, w.h, w.nq, w.nk, w.bq, w.bk, w.d
    hk = k.shape[2]
    dev = q.device
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    lse_b = F.pad(lse.float(), (0, nq * bq - w.sq), value=math.inf).view(
        b, h, nq, bq)
    delta_b = F.pad(delta, (0, nq * bq - w.sq)).view(b, h, nq, bq)
    dob = w.blocks(do, bq)
    bm = block_mask

    dq = torch.zeros(b, h, nq, bq, d, device=dev)
    dbias = (torch.zeros(b, h, nq, nk, bq, bk, device=dev)
             if bias is not None else None)
    qblk = torch.arange(nq, device=dev).view(1, 1, nq).expand(b, h, nq)
    for partial, (num, idx) in ((False, w.lists(bm.full_kv_num,
                                                bm.full_kv_idx)),
                                (True, w.lists(bm.kv_num, bm.kv_idx))):
        for j in range(int(num.max()) if num.numel() else 0):
            valid = j < num
            kblk = idx[..., j]
            kj, vj = w.kb[w.bi, w.hi, kblk], w.vb[w.bi, w.hi, kblk]
            s = torch.matmul(w.qb, kj.transpose(-1, -2)).float()
            dp = torch.matmul(dob, vj.transpose(-1, -2)).float()
            _, ds = _p_and_ds(w, s, dp, lse_b, delta_b, qblk, kblk, partial,
                              valid)
            dq += torch.matmul(ds.to(k.dtype), kj).float()
            if dbias is not None:
                sel = valid.nonzero(as_tuple=True)
                dbias[(*sel, kblk[sel])] = ds[sel]

    dk = torch.zeros(b, h, nk, bk, d, device=dev)
    dv = torch.zeros(b, h, nk, bk, d, device=dev)
    kblk = torch.arange(nk, device=dev).view(1, 1, nk).expand(b, h, nk)
    for partial, (num, idx) in ((False, w.lists(bm.full_q_num,
                                                bm.full_q_idx)),
                                (True, w.lists(bm.q_num, bm.q_idx))):
        for j in range(int(num.max()) if num.numel() else 0):
            valid = j < num
            qblk = idx[..., j]
            qj, doj = w.qb[w.bi, w.hi, qblk], dob[w.bi, w.hi, qblk]
            s = torch.matmul(qj, w.kb.transpose(-1, -2)).float()
            dp = torch.matmul(doj, w.vb.transpose(-1, -2)).float()
            p, ds = _p_and_ds(w, s, dp, lse_b[w.bi, w.hi, qblk],
                              delta_b[w.bi, w.hi, qblk], qblk, kblk, partial,
                              valid)
            dv += torch.matmul(p.transpose(-1, -2).to(do.dtype), doj).float()
            dk += torch.matmul(ds.transpose(-1, -2).to(q.dtype), qj).float()

    dq = (dq * scale).reshape(b, h, nq * bq, d)[:, :, :w.sq].transpose(1, 2)
    g = h // hk

    def kv_grad(x):
        x = x.view(b, hk, g, nk * bk, d).sum(2)[:, :, :w.sk]
        return x.transpose(1, 2)

    dk, dv = kv_grad(dk * scale), kv_grad(dv)
    if dbias is not None:
        dbias = _reduce_dbias(dbias.permute(0, 1, 2, 4, 3, 5).reshape(
            b, h, nq * bq, nk * bk)[:, :, :w.sq, :w.sk], bias)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias)


def _reduce_dbias(dbias, bias):
    """Sum (b, h, sq, sk) back over the bias's broadcast dimensions."""
    if bias.shape[0] == 1:
        dbias = dbias.sum(0, keepdim=True)
    if bias.shape[1] == 1:
        dbias = dbias.sum(1, keepdim=True)
    return dbias


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_PTRS = ("q", "k", "v", "o", "lse", "dout", "delta", "dq", "dk", "dv",
         "dbias", "bias", "slopes", *TABLES, "slot", "bits")
_STRIDES = ("q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh", "v_sb", "v_ss",
            "v_sh", "do_sb", "do_ss", "do_sh", "bias_sb", "bias_sh",
            "bias_ss")
_INTS = ("b", "h", "hk", "sq", "sk", "bq", "bk", "nq", "nk", "th",
         "l_kv_part", "l_kv_full", "l_q_part", "l_q_full", "words", "mod")


class _Params(ctypes.Structure):
    """`csrc/flex.cu`'s FlexParams, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_longlong) for n in _STRIDES]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("scale", ctypes.c_float), ("softcap", ctypes.c_float)])


def _check_cuda(q, k, v, block_q, block_k, score_mod):
    """Raise on what the CUDA kernels do not take."""
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"flex kernel: dtype {q.dtype} (bf16 and fp16 are ported)")
    if q.shape[-1] not in HEAD_DIMS:
        raise NotImplementedError(f"flex kernel: head dim {q.shape[-1]} "
                                  f"(ported: {HEAD_DIMS})")
    if block_q % TILE or block_k % TILE:
        raise NotImplementedError(
            f"flex kernel: block_q={block_q}, block_k={block_k}; both must "
            f"be multiples of {TILE} on CUDA")
    if score_mod is not None and not isinstance(score_mod,
                                                ScoreModDescriptor):
        raise NotImplementedError(
            "flex kernel: score_mod must be a compiled-in descriptor, "
            "flex.softcap(cap) or flex.relative_position(slopes); pass any "
            "additive score term as attn_bias, which is exact")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}")


def _kernel_ready(x):
    """x itself if the kernels can read it in place (unit last stride, rows
    16-byte aligned, no broadcast dimension: the forward's TMA descriptors
    take strides that are nonzero multiples of 16 bytes), else a contiguous
    copy."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % 8 == 0 and (st > 0 or n == 1)
                  for st, n in zip(x.stride()[:-1], x.shape[:-1])))
    return x if ok else x.contiguous()


def fwd_tile(block_q: int, block_k: int) -> tuple[int, int]:
    """(q rows, keys) of the CUDA forward's tile for these blocks, the rule
    of `csrc/flex.cu::launch_fwd`: 128 rows (two consumer warpgroups) when
    block_q is a multiple of 128, else 64; keys 128 when block_k is a
    multiple of 128, else 64."""
    return (128 if block_q % 128 == 0 else 64,
            128 if block_k % 128 == 0 else 64)


def bwd_tile(block_q: int, block_k: int) -> tuple[int, int]:
    """(dQ q rows, dK/dV keys) of the CUDA backward's blocks, the rule of
    `csrc/flex.cu::launch_dq` / `launch_dkv`, which is the forward's: 128
    q rows when block_q is a multiple of 128, else 64; 128 keys when
    block_k is a multiple of 128, else 64."""
    return fwd_tile(block_q, block_k)


def _bits_by_key_block(words, keys: int):
    """`MaskBits.words` (P, block_q, block_k / 32) as (P, block_k / keys,
    block_q, keys / 32): the dK/dV kernel's layout, in which the bits of
    one block of `keys` keys and 64 q rows are contiguous (a view where
    keys == block_k)."""
    n, bq, w = words.shape
    return (words.view(n, bq, w * 32 // keys, keys // 32).transpose(1, 2)
            .contiguous())


def _bwd_orders(bm: BlockMask, b: int, h: int, hk: int):
    """int32 block orders of the dK/dV and dQ grids (`csrc/flex.cu::
    bwd_block`: linear block index, x fastest), heaviest blocks first, so
    that the grid's tail is short under masks of very unequal work.  A
    dK/dV block's work is the length of its kv block's q lists summed over
    its GQA group, a dQ block's that of its q block's kv list; ties keep
    the grid's order.  Built on the device, with no host sync."""
    rows, keys = bwd_tile(bm.block_q, bm.block_k)
    n = bm.full_q_num + bm.q_num  # (b, th, nk)
    w_dkv = (n.expand(b, hk, -1) if n.shape[1] == 1
             else n.view(b, hk, h // hk, -1).sum(2))
    w_dq = (bm.full_kv_num + bm.kv_num).expand(b, h, -1)
    # each block's work for its blk // tile sub-blocks (an expand, not
    # repeat_interleave, which may read the repeats back to the host)
    return tuple(
        torch.argsort(w.unsqueeze(-1).expand(-1, -1, -1, blk // tile)
                      .reshape(-1), descending=True, stable=True).int()
        for w, blk, tile in ((w_dkv, bm.block_k, keys),
                             (w_dq, bm.block_q, rows)))


def _params(q, k, v, block_mask, bits, score_mod, scale, bias):
    b, sq, h, d, sk, hk, bq, bk, nq, nk = _geometry(q, k, v, block_mask,
                                                     bias)
    _check_cuda(q, k, v, bq, bk, score_mod)
    p = _Params()
    keep = []  # tensors whose pointers the launch reads: alive until then

    def ptr(name, t):
        keep.append(t)
        setattr(p, name, t.data_ptr())

    for name, t in (("q", q), ("k", k), ("v", v)):
        t = _kernel_ready(t)
        ptr(name, t)
        p_sb, p_ss, p_sh, _ = t.stride()
        setattr(p, f"{name}_sb", p_sb)
        setattr(p, f"{name}_ss", p_ss)
        setattr(p, f"{name}_sh", p_sh)
    bm = block_mask
    for name in TABLES:
        ptr(name, getattr(bm, name).to(torch.int32).contiguous())
    ptr("slot", bits.slot.contiguous())
    ptr("bits", bits.words.contiguous())
    if bias is not None:
        bias = bias.to(q.device, torch.float32).contiguous()
        ptr("bias", bias)
        p.bias_sb = bias.stride(0) if bias.shape[0] > 1 else 0
        p.bias_sh = bias.stride(1) if bias.shape[1] > 1 else 0
        p.bias_ss = bias.stride(2)
    p.mod = _MOD_NONE if score_mod is None else score_mod.code
    if p.mod == _MOD_SOFTCAP:
        p.softcap = score_mod.cap
    elif p.mod == _MOD_RELPOS:
        slopes = score_mod.slopes_on(q.device)
        if slopes.numel() != h:
            raise ValueError(f"relative_position: {slopes.numel()} slopes "
                             f"for {h} heads")
        ptr("slopes", slopes)
    p.b, p.h, p.hk, p.sq, p.sk, p.bq, p.bk = b, h, hk, sq, sk, bq, bk
    p.nq, p.nk, p.th = nq, nk, bm.kv_num.shape[1]
    p.l_kv_part, p.l_kv_full = bm.kv_idx.shape[-1], bm.full_kv_idx.shape[-1]
    p.l_q_part, p.l_q_full = bm.q_idx.shape[-1], bm.full_q_idx.shape[-1]
    p.words = bits.words.shape[-1]
    p.scale = float(scale)
    return p, keep


def flex_attn_fwd(q, k, v, block_mask: BlockMask, bits: MaskBits,
                  score_mod: Optional[ScoreMod], scale: float, q_aux=None,
                  kv_aux=None, bias=None):
    """Block-sparse forward with mods.  q: (b, sq, h, d); k, v: (b, sk, hk,
    d); `bits` from `partial_block_bits`; bias (b|1, h|1, sq, sk) or None.
    Returns o (b, sq, h, d) in q's dtype and lse (b, h, sq) float32, natural
    log; a row with no kept key gives o = 0 and lse = +inf.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flex.cu`'s `flex_fwd_kernel` (bf16 or fp16, d in {64, 128},
    blocks multiples of 64, a descriptor score mod) or raise.  q, k and v
    are read in place through their strides."""
    global launches_fwd
    if q.device.type == "cpu":
        return flex_attn_fwd_ref(q, k, v, block_mask, bits, score_mod, scale,
                                 q_aux, kv_aux, bias)
    if q.device.type != "cuda":
        raise RuntimeError(f"flex_attn_fwd: no kernel for {q.device}")
    p, keep = _params(q, k, v, block_mask, bits, score_mod, scale, bias)
    o = torch.empty(p.b, p.sq, p.h, q.shape[-1], dtype=q.dtype,
                    device=q.device)
    lse = torch.empty(p.b, p.h, p.sq, dtype=torch.float32, device=q.device)
    p.o, p.lse = o.data_ptr(), lse.data_ptr()
    lib = _lib()
    err = lib.flex_fwd(ctypes.byref(p), q.shape[-1], _DTYPE_CODE[q.dtype],
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, KERNEL)
    launches_fwd += 1
    return o, lse


def flex_attn_bwd(do, q, k, v, o, lse, block_mask: BlockMask,
                  bits: MaskBits, score_mod: Optional[ScoreMod], scale: float,
                  q_aux=None, kv_aux=None, bias=None):
    """Block-sparse backward with mods.  do, o as q; lse (b, h, sq) float32;
    the rest as `flex_attn_fwd`.  Returns (dq, dk, dv, dbias) in the inputs'
    dtypes, dk and dv summed over each GQA group, dbias float32 in the
    bias's own shape (None without a bias).

    delta = rowsum(dO * O) is plain PyTorch.  dbias starts at 0 and the dQ
    kernel writes the blocks it visits, which gives JAX's result for the
    blocks it never visits (`:1223-1239`); broadcast dimensions are then
    summed back.  CPU tensors run the plain version; CUDA tensors launch
    `flex_bwd_dkv_kernel` then `flex_bwd_dq_kernel` (deterministic bit for
    bit: no atomics; their blocks start heaviest first, `_bwd_orders`) or
    raise."""
    global launches_dq, launches_dkv
    if q.device.type == "cpu":
        return flex_attn_bwd_ref(do, q, k, v, o, lse, block_mask, bits,
                                 score_mod, scale, q_aux, kv_aux, bias)
    if q.device.type != "cuda":
        raise RuntimeError(f"flex_attn_bwd: no kernel for {q.device}")
    p, keep = _params(q, k, v, block_mask, bits, score_mod, scale, bias)
    if do.shape != q.shape or o.shape != q.shape or \
            tuple(lse.shape) != (p.b, p.h, p.sq):
        raise ValueError(f"shapes do {tuple(do.shape)} o {tuple(o.shape)} "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    do = _kernel_ready(do.to(q.dtype))
    p.dout = do.data_ptr()
    p.do_sb, p.do_ss, p.do_sh, _ = do.stride()
    # lse in log2 units and delta, (b, h, sq) padded to a multiple of 64 rows
    # (+inf and 0), so that the dK/dV kernel copies a tile's rows in bulk
    pad = (0, round_up(p.sq, TILE) - p.sq)
    lse = F.pad(lse.float() * _LOG2E, pad, value=math.inf).contiguous()
    delta = F.pad((do.float() * o.float()).sum(-1).transpose(1, 2),
                  pad).contiguous()
    dq = torch.empty(p.b, p.sq, p.h, q.shape[-1], dtype=q.dtype,
                     device=q.device)
    dk = torch.empty(p.b, p.sk, p.hk, k.shape[-1], dtype=k.dtype,
                     device=q.device)
    dv = torch.empty_like(dk)
    dbias = None
    if bias is not None:
        dbias = torch.zeros(p.b, p.h, p.sq, p.sk, dtype=torch.float32,
                            device=q.device)
        p.dbias = dbias.data_ptr()
    p.lse, p.delta = lse.data_ptr(), delta.data_ptr()
    p.dq, p.dk, p.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    order_dkv, order_dq = _bwd_orders(block_mask, p.b, p.h, p.hk)
    words_dkv = _bits_by_key_block(bits.words, bwd_tile(p.bq, p.bk)[1])
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (ctypes.byref(p), q.shape[-1], _DTYPE_CODE[q.dtype], stream)
    p.o, p.bits = order_dkv.data_ptr(), words_dkv.data_ptr()
    _build.check(lib, lib.flex_bwd_dkv(*args), KERNEL)
    launches_dkv += 1
    p.o, p.bits = order_dq.data_ptr(), bits.words.data_ptr()
    _build.check(lib, lib.flex_bwd_dq(*args), KERNEL)
    launches_dq += 1
    if dbias is not None:
        dbias = _reduce_dbias(dbias, bias)
    return dq, dk, dv, dbias


class FlexAttnFunc(torch.autograd.Function):
    """Flex attention with the flex backward as its gradient (the
    `custom_vjp` `core` of `flex.py:1408-1441`).  Returns (o, lse); lse is
    not differentiable (JAX drops its cotangent too).  The bias, when given,
    gets its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, block_mask, bits, score_mod, scale,
                q_aux, kv_aux):
        o, lse = flex_attn_fwd(q, k, v, block_mask, bits, score_mod, scale,
                               q_aux, kv_aux, bias)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.rest = (block_mask, bits, score_mod, scale, q_aux, kv_aux)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, bias = ctx.saved_tensors
        dq, dk, dv, dbias = flex_attn_bwd(do, q, k, v, o, lse, *ctx.rest,
                                          bias=bias)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return (dq, dk, dv, dbias) + (None,) * 6


def flex_attention(q, k, v, *, score_mod: Optional[ScoreMod] = None,
                   mask_mod: Optional[MaskMod] = None,
                   block_mask: Optional[BlockMask] = None,
                   softmax_scale: Optional[float] = None, q_aux=None,
                   kv_aux=None, attn_bias=None, block_q: int | None = None,
                   block_k: int | None = None, block_h: Optional[int] = None,
                   head_invariant: bool = False, return_lse: bool = False):
    """Programmable flash attention, (b, s, h, d) layout (`flex.py:1334`).

    `score_mod(score, b, h, q_idx, kv_idx)` rewrites the scaled scores;
    `mask_mod(b, h, q_idx, kv_idx) -> bool` keeps (True) or masks (False)
    positions.  With a `block_mask` (from `create_block_mask`) only its
    listed blocks are visited; without one every block is, as partial when
    there is a mask (`block_q`/`block_k` then size the blocks, with JAX's
    defaults).  `q_aux`/`kv_aux` (b, s) are handed to both mods as two more
    arguments, their values at the q and kv positions.  `attn_bias` (b|1,
    h|1, sq, sk) is added after scaling, before the mods, and gets a
    gradient.  `head_invariant` decides whether a block mask built here
    carries one head; `block_h` is ignored (the CUDA kernel has no head
    blocks).  Differentiable in q, k, v and attn_bias.  Returns o, or (o,
    lse) with `return_lse` (lse (b, h, sq) float32).

    Runs on the tensors' device: the CUDA kernels (bf16 or fp16, head dim
    64 or 128, blocks multiples of 64, a descriptor score mod, else raise)
    or, on the CPU, the plain versions, which take any score mod."""
    del block_h
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flex_attention: no kernel for {q.device}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = float(1.0 / math.sqrt(d) if softmax_scale is None
                  else softmax_scale)
    if block_mask is None:
        block_mask = _dense_block_mask(
            b, h, sq, sk, block_q or _default_flex_block(sq),
            block_k or _default_flex_block(sk), mask_mod is not None,
            head_invariant=head_invariant or mask_mod is None,
            device=q.device)
    bits = partial_block_bits(block_mask, mask_mod, q_aux, kv_aux, sk)
    o, lse = FlexAttnFunc.apply(q, k, v, attn_bias, block_mask, bits,
                                score_mod, scale, q_aux, kv_aux)
    return (o, lse) if return_lse else o


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.flex_fwd, lib.flex_bwd_dq, lib.flex_bwd_dkv):
            fn.argtypes = [P, I, I, P]
            fn.restype = I
        lib.flex_params_size.restype = I
        size = lib.flex_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(f"flex: FlexParams is {size} bytes in "
                               f"csrc/flex.cu, {ctypes.sizeof(_Params)} here")
        _build.declare_error_string(lib)
        lib._typed = True
    return lib
