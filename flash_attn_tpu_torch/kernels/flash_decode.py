"""Split-KV decode attention and the KV-cache API (counterpart of
`flash_attn_tpu/kernels/flash_decode.py`).

Two wrappers of one CUDA kernel, `csrc/flash_decode_ref.cu`, each with a
plain PyTorch version of the same signature that runs for CPU tensors (CUDA
tensors launch the kernel or raise):

* `decode_attn_bhsd` (`decode_attn_bhsd:227`, Pallas `_decode_kernel:117`)
  over heads-first (bc, hk, smax, d) caches: the serving path's decode.
* `decode_attn_ref_layout` (`:747`, Pallas `_decode_ref_kernel:407` and
  `_decode_paged_pipe_kernel:1083`) over the reference layouts: contiguous
  (bc, smax, hk, d), paged (npages, page, hk, d) with a block table, fused
  pages (npages, 2, page, hk, d); bf16/fp16, int8 and fp8 caches with
  per-(batch, kv head) descales.

`flash_attn_with_kvcache` (`:1259`) is the public decode API on top of the
second: rotary at the cache positions, append (quantise-on-append for int8
and fp8 caches), `qv`, sinks.  The JAX function is pure and returns the
updated caches; here the appended rows are written into `k_cache` /
`v_cache` in place, and `return_updated_cache=True` also returns them.

As in the JAX kernels, the q heads of one kv head are packed into rows
(packed row r is query position r % sq of head group r // sq,
`flash_decode.py:281,836`); each (batch, kv head, split) writes float32
partial O and LSE, merged as `combine_attn_partials` merges them (the plain
versions call it; the kernel merges in its last block of each group).

`num_splits = 0` means "auto", as in FA's own API: on CUDA the wrappers
take `decode_num_splits` at the card's SM count, so that a grid of b * hk
row-tile blocks that leaves SMs idle is cut along the keys.  On the CPU (and
in the plain versions) 0 means 1, as the JAX wrapper maps it
(`flash_attn_tpu/kernels/flash_decode.py:22`: the TPU has no occupancy
cliff).  An explicit count is honoured everywhere.
"""

from __future__ import annotations

import ctypes
import math

import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.block_sizes import cdiv, round_up
from flash_attn_tpu_torch.kernels.combine import combine_attn_partials
from flash_attn_tpu_torch.kernels.flash_fwd import (
    _DTYPE_CODE, kernel_head_dim, mask_params, masked_softmax_pv,
    pad_head_dim)

KERNEL = "flash_decode_ref"
# the library of head dims above 128 (`_build.DERIVED`: the same source)
KERNEL_WIDE = "flash_decode_ref_wide"

# Number of times the CUDA kernel was launched, by either wrapper (plain CPU
# runs do not count), and the key splits of the last launch.
launches = 0
last_num_splits = 0

LOG2E = math.log2(math.e)
MASK_VALUE = -1e30  # the JAX kernels' masked score (`flash_fwd.py:51`)
BUNDLE_ROWS = 1024  # cache rows per grid step of the JAX paged kernel
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
# cache dtype -> kernel code (q's own bf16/fp16 code for unquantised caches)
_CACHE_CODE = {torch.int8: 2, torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}


def _unsupported(block_table, cache_leftpad, attention_chunk):
    if block_table is not None:
        raise NotImplementedError("paged KV decode is not ported yet")
    if cache_leftpad is not None:
        raise NotImplementedError("cache_leftpad is not ported yet")
    if attention_chunk:
        raise NotImplementedError("attention_chunk is not ported yet")


# Packed query rows of one block of the kernel: a decode step's rows (up to
# 16) take one 16-row tile, more rows take 64-row tiles.
DECODE_ROWS, ROW_TILE = 16, 64
# Blocks an SM that an automatic split aims at: with two, one block can
# stream while the other waits on its tile (the kernel's ring lets two or
# three share an SM).
SPLIT_BLOCKS_PER_SM = 2
# Keys per split unit of `decode_attn_bhsd`'s automatic split when block_k
# is not given (four of the kernel's 64-key tiles): heads-first caches are
# bf16 / fp16 only, so the split moves no result beyond float32 rounding.
AUTO_BLOCK_K = 256


def row_tiles(rows: int) -> int:
    """Row tiles of the kernel's grid for `rows` packed query rows."""
    return 1 if rows <= DECODE_ROWS else cdiv(rows, ROW_TILE)


def decode_num_splits(b: int, hk: int, row_tiles: int, keys: int,
                      split_unit: int, sm_count: int) -> int:
    """Key splits of an automatic (`num_splits = 0`) launch on a card with
    `sm_count` SMs: 1 where the b * hk * row_tiles blocks already fill the
    card (one an SM); else the smallest count whose splits give at least
    SPLIT_BLOCKS_PER_SM blocks an SM, each split at least one `split_unit`
    of keys, so never more splits than units.  The count is one that
    `split_layout` / `ref_layout_tiles` cut into non-empty splits of whole
    units (cdiv(units, cdiv(units, n)) == n)."""
    base = b * hk * row_tiles
    if base == 0 or base >= sm_count:
        return 1
    units = max(1, cdiv(keys, split_unit))
    target = SPLIT_BLOCKS_PER_SM * sm_count
    for n in range(1, units + 1):
        nonempty = cdiv(units, cdiv(units, n))
        if base * nonempty >= target:
            return nonempty
    return units


_SM_COUNT: dict = {}


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (cached)."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def split_layout(smax: int, num_splits: int, block_k: int | None):
    """(num_splits, keys per split) as the JAX wrapper computes them: the
    cache is cut into block_k-key blocks and the blocks are shared out."""
    block_k = min(block_k or 1024, -(-smax // 8) * 8)
    nk = -(-smax // block_k)
    num_splits = max(1, min(int(num_splits), nk))
    bps = -(-nk // num_splits)
    return num_splits, bps * block_k


def decode_attn_bhsd_ref(q, k_cache, v_cache, cache_seqlens, *,
                         softmax_scale: float, causal: bool = True,
                         window_size=(-1, -1), softcap: float = 0.0,
                         alibi_slopes=None, block_table=None,
                         cache_batch_idx=None, cache_leftpad=None,
                         num_splits: int = 0, block_k: int | None = None,
                         attention_chunk: int = 0):
    """Plain PyTorch version of `decode_attn_bhsd` (same signature).

    `num_splits` and `block_k` only change how the kernel cuts the work, not
    the result, so this version ignores them.  The matrix products run in
    the inputs' dtype; masking and softmax run in float32."""
    _unsupported(block_table, cache_leftpad, attention_chunk)
    b, h, sq, d = q.shape
    _, hk, smax, _ = k_cache.shape
    g = h // hk
    dev = q.device
    if cache_batch_idx is not None:
        idx = torch.as_tensor(cache_batch_idx, device=dev).long()
        kc, vc = k_cache[idx], v_cache[idx]
    else:
        kc, vc = k_cache[:b], v_cache[:b]
    if g > 1:
        kc = kc.repeat_interleave(g, dim=1)
        vc = vc.repeat_interleave(g, dim=1)
    has_upper, wr, has_lower, wl = mask_params(
        causal, int(window_size[0]), int(window_size[1]))
    s = torch.matmul(q, kc.transpose(-1, -2)).float() * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    lens = torch.as_tensor(cache_seqlens, device=dev).long().clamp(max=smax)
    lens = lens.view(b, 1, 1, 1)
    offset = lens - sq
    pos = torch.arange(sq, device=dev).view(1, 1, sq, 1)
    cols = torch.arange(smax, device=dev).view(1, 1, 1, smax)
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=dev).float()
        slopes = slopes.reshape(-1, h).expand(b, h).reshape(b, h, 1, 1)
        s = s - slopes * (pos + offset - cols).abs().float()
    mask = cols >= lens
    if has_upper:
        mask = mask | (cols > pos + offset + wr)
    if has_lower:
        mask = mask | (cols < pos + offset - wl)
    o, lse = masked_softmax_pv(s, mask, vc)
    return o.to(q.dtype), lse


def decode_attn_bhsd(q, k_cache, v_cache, cache_seqlens, *,
                     softmax_scale: float, causal: bool = True,
                     window_size=(-1, -1), softcap: float = 0.0,
                     alibi_slopes=None, block_table=None,
                     cache_batch_idx=None, cache_leftpad=None,
                     num_splits: int = 0, block_k: int | None = None,
                     attention_chunk: int = 0):
    """Decode attention.  q: (b, h, sq, d); caches: (bc, hk, smax, d);
    cache_seqlens: (b,) keys in use, the new tokens included.  Returns
    o (b, h, sq, d) in q's dtype and lse (b, h, sq) float32.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flash_decode_ref.cu` in its heads-first layout (bf16 or fp16, d
    up to 256; a d that is not a multiple of 8 through zero-padded copies
    of q and the caches) or raise.  On CUDA, num_splits = 0 takes
    `decode_num_splits` on units of block_k (AUTO_BLOCK_K if not given)."""
    if q.device.type == "cpu":
        return decode_attn_bhsd_ref(
            q, k_cache, v_cache, cache_seqlens, softmax_scale=softmax_scale,
            causal=causal, window_size=window_size, softcap=softcap,
            alibi_slopes=alibi_slopes, block_table=block_table,
            cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad,
            num_splits=num_splits, block_k=block_k,
            attention_chunk=attention_chunk)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attn_bhsd: no kernel for {q.device}")
    _unsupported(block_table, cache_leftpad, attention_chunk)
    b, h, sq, d = q.shape
    bc, hk, smax, _ = k_cache.shape
    q_code, cache_code = _kernel_codes(q.dtype, d, d, k_cache.dtype)
    if h % hk or v_cache.shape != k_cache.shape or k_cache.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k_cache "
                         f"{tuple(k_cache.shape)} v_cache "
                         f"{tuple(v_cache.shape)}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lens = _ints(cache_seqlens, b, q.device)
    cbi = _ints(cache_batch_idx, b, q.device)
    if cbi is None and b > bc:
        raise ValueError(f"batch {b} > cache batch {bc}")
    rows = h // hk * sq
    if not num_splits:
        block_k = block_k or AUTO_BLOCK_K
        unit = min(block_k, round_up(smax, 8))
        num_splits = decode_num_splits(b, hk, row_tiles(rows), smax, unit,
                                       sm_count(q.device))
    num_splits, split_keys = split_layout(smax, num_splits, block_k)
    # (b, h, sq, d) is already packed: heads kh*g .. kh*g+g-1 are rows
    # (head - kh*g) * sq + pos of kv head kh
    qp, k_cache, v_cache = pad_head_dim(q.reshape(b, hk, rows, d), k_cache,
                                        v_cache)
    o, lse = _launch(
        qp, k_cache, v_cache, lens, h=h,
        sq=sq, q_code=q_code, cache_code=cache_code, cbi=cbi,
        alibi_slopes=alibi_slopes, heads_first=True, smax=smax,
        splits=num_splits, split_keys=split_keys, softmax_scale=softmax_scale,
        causal=causal, window_size=window_size, softcap=softcap)
    return (o[..., :d].reshape(b, h, sq, d).to(q.dtype),
            lse.reshape(b, h, sq))


def _kernel_codes(q_dtype, d, dv, cache_dtype):
    """(q code, cache code) of a `csrc/flash_decode_ref.cu` call; raises
    NotImplementedError on what the kernel does not take: q other than
    bf16/fp16, d above 256 (`kernel_head_dim`), dv != d (qv), or a cache
    that is neither q's dtype, int8 nor fp8."""
    if q_dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"{KERNEL} kernel: q dtype {q_dtype}")
    kernel_head_dim(d)
    if dv != d:
        raise NotImplementedError(f"{KERNEL} kernel: dv {dv} != d {d} (qv)")
    cache_code = (_DTYPE_CODE[q_dtype] if cache_dtype == q_dtype
                  else _CACHE_CODE.get(cache_dtype))
    if cache_code is None:
        raise NotImplementedError(
            f"{KERNEL} kernel: {cache_dtype} cache with {q_dtype} q")
    return _DTYPE_CODE[q_dtype], cache_code


def cache_multiple(cache) -> int:
    """The head dims the kernel reads a cache at: multiples of 8 for 16-bit
    caches and of 16 for 8-bit ones (whole 16-byte cp.async chunks a row)."""
    return 16 if cache.element_size() == 1 else 8


def _ints(x, b, dev):
    """A contiguous int32 per-sequence tensor (first dim b), or None."""
    if x is None:
        return None
    t = torch.as_tensor(x, dtype=torch.int32, device=dev).contiguous()
    if t.ndim == 0 or t.shape[0] != b:
        raise ValueError(f"per-sequence tensor of shape {tuple(t.shape)} "
                         f"for batch {b}")
    return t


def _launch(qp, k_cache, v_cache, lens, *, h, sq, q_code, cache_code,
            softmax_scale, causal, window_size, softcap, alibi_slopes, splits,
            split_keys, smax=0, heads_first=False, cbi=None, leftpad=None,
            table=None, page=0, nk_max=0, q_scale=None, kd=None, vd=None,
            attention_chunk=0):
    """One launch of `csrc/flash_decode_ref.cu` on the packed query qp (b,
    hk, rows, d), d a multiple of 8 (16 for 8-bit caches: `cache_multiple`);
    returns the split-merged o (b, hk, rows, d) and lse (b, hk, rows),
    float32 (the kernel merges the splits into split 0)."""
    global launches, last_num_splits
    b, hk, rows, d = qp.shape
    dev = qp.device
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=dev).float()
        slopes = slopes.reshape(-1, h).expand(b, h).contiguous()
    has_upper, wr, has_lower, wl = mask_params(
        causal, int(window_size[0]), int(window_size[1]))
    o_parts = torch.empty((b, hk, splits, rows, d), dtype=torch.float32,
                          device=dev)
    lse_parts = torch.empty((b, hk, splits, rows), dtype=torch.float32,
                            device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    sems = (_semaphores(dev, b * hk * row_tiles(rows)) if splits > 1
            else None)
    name = KERNEL_WIDE if kernel_head_dim(d) > 128 else KERNEL
    lib = _lib(name)
    err = lib.flash_decode_ref(
        qp.data_ptr(), k_cache.data_ptr(), ptr(v_cache), o_parts.data_ptr(),
        lse_parts.data_ptr(), ptr(sems), lens.data_ptr(), ptr(leftpad),
        ptr(cbi),
        ptr(table), ptr(slopes), ptr(q_scale), ptr(kd), ptr(vd),
        b, h, hk, sq, d, q_code, cache_code, int(table is not None),
        int(v_cache is None), page, nk_max, smax, int(heads_first), splits,
        split_keys, float(softmax_scale), int(has_upper), wr, int(has_lower),
        wl, int(attention_chunk), float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, name)
    launches += 1
    last_num_splits = splits
    return o_parts[:, :, 0], lse_parts[:, :, 0]


_SEMS: dict = {}


def _semaphores(dev, n):
    """n zeroed int32 counters for the kernel's split merge, one buffer per
    (device, stream) and reused: the kernel sets every counter it takes
    back to 0, and launches on one stream run in order."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _SEMS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _SEMS[key] = t
    return t


def _lib(name=KERNEL):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode_ref.argtypes = ([P] * 14 + [I] * 15
                                         + [F, I, I, I, I, I, F, P])
        lib.flash_decode_ref.restype = I
        _build.declare_error_string(lib)
        lib._typed = True
    return lib


# --------------------------------------------------------------------------
# Reference-layout caches: `decode_attn_ref_layout` and the KV-cache API.
# --------------------------------------------------------------------------


def ref_layout_tiles(k_cache, v_cache, block_table, num_splits: int,
                     block_k: int | None):
    """(block_k, nk_max, bundle, num_splits, blocks_per_split) as the JAX
    wrapper computes them (`flash_decode.py:789-844`): the cache is cut in
    block_k-key tiles (a page for paged caches), `bundle` tiles a grid step,
    and the steps are shared out among the splits.  A split covers
    blocks_per_split * bundle * block_k keys."""
    widen = max(1, 2 // k_cache.element_size())  # int8 / fp8: 2x rows
    if block_table is not None:
        fused = v_cache is None
        block_k = k_cache.shape[2] if fused else k_cache.shape[1]
        nk_max = block_table.shape[1]
        bundle = max(1, BUNDLE_ROWS * widen // ((2 if fused else 1) * block_k))
    else:
        smax = k_cache.shape[1]
        block_k = min(block_k or 1024 * widen, round_up(smax, 8))
        nk_max = cdiv(smax, block_k)
        bundle = 1
    nk_bund = cdiv(nk_max, bundle)
    num_splits = max(1, min(int(num_splits), nk_bund))
    return block_k, nk_max, bundle, num_splits, cdiv(nk_bund, num_splits)


def _per_kv_head(x, b, hk, device, default=None):
    """A (b, hk) float32 tensor from a scalar, (hk,), (1, hk) or (b, hk)."""
    if x is None:
        return default
    return torch.as_tensor(x, device=device).float().reshape(-1, hk).expand(
        b, hk).contiguous()


def quantise_q_int8(qp):
    """Per-(batch, kv head) symmetric int8 quantisation of the packed query
    (b, hk, rows, d) (`flash_decode.py:957-963`): returns (integer values as
    float32, q_scale (b, hk))."""
    qf = qp.float()
    q_scale = qf.abs().amax(dim=(2, 3)).clamp_min(1e-9) / 127.0
    qi = torch.round(qf / q_scale[:, :, None, None]).clamp(-127, 127)
    return qi, q_scale


def _cache_shape(q, k_cache, v_cache, block_table):
    """(paged, fused, hk, dv) of a reference-layout call; raises on a layout
    the JAX wrapper refuses."""
    paged, fused = block_table is not None, v_cache is None
    if fused and not paged:
        raise ValueError(
            "fused KV cache requires a paged layout (npages, 2, page, hk, d)")
    if fused and (k_cache.ndim != 5 or k_cache.shape[1] != 2):
        raise ValueError("fused KV cache must be (npages, 2, page, hk, d)")
    hk = k_cache.shape[-2]
    dv = k_cache.shape[-1] if fused else v_cache.shape[-1]
    if q.shape[2] % hk:
        raise ValueError(f"{q.shape[2]} q heads over {hk} kv heads")
    return paged, fused, hk, dv


def _finish(o, lse, b, sq, h, dv, sinks, dtype):
    """Packed (b, hk, rows, dv) / (b, hk, rows) -> o (b, sq, h, dv) in
    `dtype` and lse (b, h, sq), with the sink post-correction
    (`flash_decode.py:1064-1076`): o' = o sigmoid(lse - sink), lse' =
    logaddexp(lse, sink), and lse' = sink on empty rows."""
    o = o.reshape(b, h, sq, dv)
    lse = lse.reshape(b, h, sq)
    if sinks is not None:
        sk = torch.as_tensor(sinks, device=o.device).float().reshape(h)
        sk = sk[None, :, None].expand(b, h, sq)
        empty = torch.isposinf(lse)
        o = o * torch.sigmoid(lse - sk)[..., None]
        lse = torch.where(empty, sk, torch.logaddexp(lse, sk))
    return o.transpose(1, 2).to(dtype), lse


def decode_attn_ref_layout_ref(q, k_cache, v_cache, cache_seqlens, *,
                               softmax_scale: float, causal: bool = True,
                               window_size=(-1, -1), softcap: float = 0.0,
                               alibi_slopes=None, block_table=None,
                               cache_batch_idx=None, cache_leftpad=None,
                               num_splits: int = 0,
                               block_k: int | None = None,
                               attention_chunk: int = 0, k_descale=None,
                               v_descale=None, sinks=None):
    """Plain PyTorch version of `decode_attn_ref_layout` (same signature).

    It walks the cache in the JAX kernel's own tiles and splits
    (`ref_layout_tiles`) with the same online softmax, because the int8
    path depends on them: P is quantised as round(127 p) against the
    running maximum of the tiles seen so far (`flash_decode.py:552-553`).
    The int8 products are exact (integer values in float64).  Otherwise the
    matrix products run in q's dtype (fp8 caches widened to bf16, as
    `:594-597` casts them, and P rounded to bf16 before it meets V), and
    masking and softmax in float32."""
    b, sq, h, d = q.shape
    paged, fused, hk, dv = _cache_shape(q, k_cache, v_cache, block_table)
    g, dev = h // hk, q.device
    rows = g * sq
    bk, nk_max, bundle, ns, bps = ref_layout_tiles(
        k_cache, v_cache, block_table, num_splits, block_k)
    int8 = k_cache.dtype == torch.int8
    fp8 = k_cache.dtype in FP8_DTYPES
    lens = torch.as_tensor(cache_seqlens, device=dev).long().reshape(b)
    lp = (torch.zeros_like(lens) if cache_leftpad is None
          else torch.as_tensor(cache_leftpad, device=dev).long().reshape(b))
    len_eff = (lens - lp).view(b, 1, 1, 1)
    offset = len_eff - sq
    lp4 = lp.view(b, 1, 1, 1)
    pos = (torch.arange(rows, device=dev) % sq).view(1, 1, rows, 1)
    has_upper, wr, has_lower, wl = mask_params(
        causal, int(window_size[0]), int(window_size[1]))

    qp = q.transpose(1, 2).reshape(b, hk, rows, d)
    ones = torch.ones(b, hk, device=dev)
    kd = _per_kv_head(k_descale, b, hk, dev, ones)
    vd = _per_kv_head(v_descale, b, hk, dev, ones)
    if int8:
        qp, q_scale = quantise_q_int8(qp)
        qp = qp.double()
        kfac = ((softmax_scale * q_scale) * kd)[..., None, None]
        vfac = (vd * (1.0 / 127.0))[..., None, None]
    elif fp8:
        kfac = (softmax_scale * kd)[..., None, None]
        vfac = vd[..., None, None]
    else:
        kfac, vfac = softmax_scale, None
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=dev).float()
        slopes = slopes.reshape(-1, h).expand(b, h).reshape(b, hk, g, 1)
        slopes = slopes.repeat_interleave(sq, dim=2)  # (b, hk, rows, 1)
    if not paged:
        idx = (torch.arange(b, device=dev) if cache_batch_idx is None else
               torch.as_tensor(cache_batch_idx, device=dev).long())
        pad = nk_max * bk - k_cache.shape[1]
        kc = torch.nn.functional.pad(k_cache[idx], (0, 0, 0, 0, 0, pad))
        vc = torch.nn.functional.pad(v_cache[idx], (0, 0, 0, 0, 0, pad))
    else:
        table = torch.as_tensor(block_table, device=dev).long()

    def tile(kg):
        """K, V tiles (b, hk, bk, d) of keys kg*bk .. kg*bk + bk - 1."""
        if paged:
            pid = table[:, kg]
            kt, vt = ((k_cache[pid, 0], k_cache[pid, 1]) if fused
                      else (k_cache[pid], v_cache[pid]))
        else:
            kt, vt = kc[:, kg * bk:(kg + 1) * bk], vc[:, kg * bk:(kg + 1) * bk]
        kt, vt = kt.transpose(1, 2), vt.transpose(1, 2)
        if int8:
            return kt.double(), vt.double()
        if fp8:
            kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
        return kt.to(q.dtype), vt.to(q.dtype)

    o_parts, lse_parts = [], []
    for s in range(ns):
        m = torch.full((b, hk, rows, 1), -torch.inf, device=dev)
        l = torch.zeros((b, hk, rows, 1), device=dev)
        acc = torch.zeros((b, hk, rows, dv), device=dev)
        for kg in range(s * bps * bundle, min((s + 1) * bps * bundle, nk_max)):
            kt, vt = tile(kg)
            st = torch.matmul(qp, kt.transpose(-1, -2)).float() * kfac
            if softcap > 0.0:
                st = torch.tanh(st / softcap) * softcap
            cols = (kg * bk + torch.arange(bk, device=dev)).view(1, 1, 1, bk)
            cols = cols - lp4
            if slopes is not None:
                st = st - slopes * (pos + offset - cols).abs().float()
            mask = (cols < 0) | (cols >= len_eff)
            if has_upper:
                mask = mask | (cols > pos + offset + wr)
            if has_lower:
                mask = mask | (cols < pos + offset - wl)
            if attention_chunk > 0:
                cc = int(attention_chunk)
                mask = mask | (cols // cc != (pos + offset) // cc)
            st = st.masked_fill(mask, MASK_VALUE)
            m_cur = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            alpha = torch.exp2((m - m_cur) * LOG2E)
            pm = torch.exp2((st - m_cur) * LOG2E).masked_fill(mask, 0.0)
            l = l * alpha + pm.sum(dim=-1, keepdim=True)
            if int8:
                pv = torch.matmul(torch.round(pm * 127.0).double(), vt)
                pv = pv.float() * vfac
            elif fp8:  # P meets the bf16-widened V in bf16 (`:650-674`)
                pv = torch.matmul(pm.to(torch.bfloat16).to(vt.dtype), vt)
                pv = pv.float() * vfac
            else:
                pv = torch.matmul(pm.to(vt.dtype), vt).float()
            acc = acc * alpha + pv
            m = m_cur
        empty = l == 0.0
        l_safe = torch.where(empty, 1.0, l)
        o_parts.append(acc / l_safe)
        lse_parts.append(torch.where(empty, torch.inf,
                                     m + torch.log(l_safe))[..., 0])
    if ns > 1:
        o, lse = combine_attn_partials(torch.stack(o_parts),
                                       torch.stack(lse_parts), axis=0)
    else:
        o, lse = o_parts[0], lse_parts[0]
    return _finish(o, lse, b, sq, h, dv, sinks, q.dtype)


def decode_attn_ref_layout(q, k_cache, v_cache, cache_seqlens, *,
                           softmax_scale: float, causal: bool = True,
                           window_size=(-1, -1), softcap: float = 0.0,
                           alibi_slopes=None, block_table=None,
                           cache_batch_idx=None, cache_leftpad=None,
                           num_splits: int = 0, block_k: int | None = None,
                           attention_chunk: int = 0, k_descale=None,
                           v_descale=None, sinks=None):
    """Split-KV decode on reference-layout caches.  q: (b, sq, h, d);
    caches: contiguous (bc, smax, hk, d), paged (npages, page, hk, d) with
    block_table (b, pages), or fused (npages, 2, page, hk, d) with
    v_cache=None; cache_seqlens (b,) keys in use, new tokens included.
    Returns o (b, sq, h, dv) in q's dtype and lse (b, h, sq) float32.

    CPU tensors run the plain version; CUDA tensors launch
    `csrc/flash_decode_ref.cu` (q bf16/fp16, cache of q's dtype, int8 or
    fp8, d = dv up to 256; a d whose cache rows are not whole 16-byte units
    through zero-padded copies of q and the caches, `cache_multiple`) or
    raise.  On CUDA, num_splits = 0 takes
    `decode_num_splits` on the units of `ref_layout_tiles` (bundle * block_k
    keys), so the plain version run at `last_num_splits` cuts at the same
    keys."""
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap,
              alibi_slopes=alibi_slopes, block_table=block_table,
              cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad,
              num_splits=num_splits, block_k=block_k,
              attention_chunk=attention_chunk, k_descale=k_descale,
              v_descale=v_descale, sinks=sinks)
    if q.device.type == "cpu":
        return decode_attn_ref_layout_ref(q, k_cache, v_cache, cache_seqlens,
                                          **kw)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attn_ref_layout: no kernel for {q.device}")
    b, sq, h, d = q.shape
    paged, fused, hk, dv = _cache_shape(q, k_cache, v_cache, block_table)
    q_code, cache_code = _kernel_codes(q.dtype, d, dv, k_cache.dtype)
    if k_cache.shape[-1] != d:
        raise ValueError(f"q head dim {d}, k_cache {tuple(k_cache.shape)}")
    caches = (("k_cache", k_cache),) if fused else (
        ("k_cache", k_cache), ("v_cache", v_cache))
    for name, t in caches:
        if t.dtype != k_cache.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not fused and v_cache.shape != k_cache.shape:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} and v_cache "
                         f"{tuple(v_cache.shape)} differ")
    dev = q.device
    q, k_cache, v_cache = pad_head_dim(q, k_cache, v_cache,
                                       multiple=cache_multiple(k_cache))
    lens = _ints(cache_seqlens, b, dev).reshape(b)
    table = _ints(block_table, b, dev) if paged else None
    cbi = None if paged else _ints(cache_batch_idx, b, dev)
    if not paged and cbi is None and b > k_cache.shape[0]:
        raise ValueError(f"batch {b} > cache batch {k_cache.shape[0]}")
    qp = q.transpose(1, 2).reshape(b, hk, h // hk * sq, q.shape[-1])
    q_scale = kd = vd = None
    if cache_code == 2:
        qi, q_scale = quantise_q_int8(qp)
        qp = qi.to(torch.int8)
    if cache_code >= 2:
        kd = _per_kv_head(k_descale, b, hk, dev)
        vd = _per_kv_head(v_descale, b, hk, dev)
    if not num_splits:
        bk, nk_max, bundle, _, _ = ref_layout_tiles(k_cache, v_cache,
                                                    block_table, 1, block_k)
        num_splits = decode_num_splits(
            b, hk, row_tiles(qp.shape[2]), nk_max * bk, bundle * bk,
            sm_count(dev))
    bk, nk_max, bundle, ns, bps = ref_layout_tiles(
        k_cache, v_cache, block_table, num_splits, block_k)
    o, lse = _launch(
        qp.contiguous(), k_cache, v_cache, lens, h=h, sq=sq, q_code=q_code,
        cache_code=cache_code, cbi=cbi, leftpad=_ints(cache_leftpad, b, dev),
        table=table, page=bk if paged else 0, nk_max=nk_max,
        smax=0 if paged else k_cache.shape[1], q_scale=q_scale, kd=kd, vd=vd,
        alibi_slopes=alibi_slopes, splits=ns, split_keys=bps * bundle * bk,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, attention_chunk=attention_chunk)
    return _finish(o[..., :d], lse, b, sq, h, d, sinks, q.dtype)


def _apply_rotary(x, cos, sin, positions, interleaved):
    """Rotary embedding at per-token positions (`flash_decode.py:1213`).
    x: (b, s, h, d); cos/sin: (max_pos, rotary_dim // 2); positions: (b, s).
    The first rotary_dim features rotate in float32 (rotate-half, or pairs
    when interleaved); the rest pass through."""
    rd2 = cos.shape[-1]
    rd = 2 * rd2
    c = cos[positions].float()[:, :, None, :]
    s_ = sin[positions].float()[:, :, None, :]
    x_rot = x[..., :rd].float()
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        out = torch.stack([x1 * c - x2 * s_, x1 * s_ + x2 * c],
                          dim=-1).reshape(x_rot.shape)
    else:
        x1, x2 = x_rot[..., :rd2], x_rot[..., rd2:]
        out = torch.cat([x1 * c - x2 * s_, x1 * s_ + x2 * c], dim=-1)
    return torch.cat([out.to(x.dtype), x[..., rd:]], dim=-1)


def quantise_append(x, descale, cache_dtype):
    """Quantise-on-append (`flash_decode.py:1351-1361`): new tokens (b, s,
    hk, d) take the cache's per-(batch, kv head) descales (dequantised =
    stored * descale): round and clip to +-127 for int8, a cast for fp8."""
    b, _, hk, _ = x.shape
    ds = _per_kv_head(descale, b, hk, x.device,
                      torch.ones(b, hk, device=x.device))
    xs = x.float() / ds[:, None, :, None]
    if cache_dtype == torch.int8:
        return torch.round(xs).clamp(-127, 127).to(torch.int8)
    return xs.to(cache_dtype)


def fuse_kv_cache(k_cache, v_cache):
    """Paged caches (npages, page, hk, d) -> the fused layout (npages, 2,
    page, hk, d): K and V of a page in one slab (`flash_decode.py:1243`).
    Pass the result as `k_cache` with `v_cache=None`."""
    if k_cache.shape != v_cache.shape:
        raise ValueError("fused layout requires k/v caches of equal shape "
                         f"(got {tuple(k_cache.shape)} vs "
                         f"{tuple(v_cache.shape)})")
    return torch.stack([k_cache, v_cache], dim=1)


def split_kv_cache(kv_cache):
    """Inverse of `fuse_kv_cache`: (npages, 2, page, hk, d) -> (K, V), views
    of the fused tensor."""
    return kv_cache[:, 0], kv_cache[:, 1]


def flash_attn_with_kvcache(q, k_cache, v_cache, k=None, v=None,
                            rotary_cos=None, rotary_sin=None,
                            cache_seqlens=None, cache_batch_idx=None,
                            cache_leftpad=None, block_table=None,
                            softmax_scale=None, causal=False,
                            window_size=(-1, -1), softcap=0.0,
                            rotary_interleaved=False, alibi_slopes=None,
                            num_splits=0, attention_chunk=0, k_descale=None,
                            v_descale=None, sinks=None,
                            scheduler_metadata=None, pack_gqa=None,
                            sm_margin=0, return_softmax_lse=False,
                            return_updated_cache=False, qv=None):
    """Decode attention with a KV cache (`flash_decode.py:1259`).

    q (b, sq, h, d); k_cache/v_cache (bc, smax, hk, d), or paged (npages,
    page, hk, d) with block_table (b, pages), or fused (npages, 2, page, hk,
    d) with v_cache=None.  k/v (b, snew, hk, d) are rotated (with
    rotary_cos/sin) and written into the caches at cache_seqlens, in place;
    int8/fp8 caches quantise them with k/v_descale.  Returns out, then lse
    with `return_softmax_lse`, then the caches ((k_cache, v_cache), or the
    fused tensor) with `return_updated_cache`."""
    b, sq, h, d = q.shape
    fused = v_cache is None
    if fused and (block_table is None or k_cache.ndim != 5
                  or k_cache.shape[1] != 2):
        raise ValueError(
            "v_cache=None selects the fused layout: k_cache must be "
            "(npages, 2, page, hk, d) with a block_table")
    del pack_gqa, sm_margin  # GQA rows are always packed; no SM carve-out
    if q.device.type != "cpu":
        # what the kernel does not take raises before the caches change
        if q.device.type != "cuda":
            raise RuntimeError(
                f"flash_attn_with_kvcache: no kernel for {q.device}")
        dv = k_cache.shape[-1] if fused else v_cache.shape[-1]
        _kernel_codes(q.dtype, d + (0 if qv is None else qv.shape[-1]), dv,
                      k_cache.dtype)
    if scheduler_metadata is not None and not num_splits:
        num_splits = int(scheduler_metadata.get("num_splits", 0))
    scale_was_default = softmax_scale is None
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    dev = q.device
    paged = block_table is not None
    if paged:
        page = k_cache.shape[2] if fused else k_cache.shape[1]
    if cache_seqlens is None:
        smax = block_table.shape[1] * page if paged else k_cache.shape[1]
        cache_seqlens = torch.full((b,), smax, dtype=torch.int32, device=dev)
    elif not torch.is_tensor(cache_seqlens) or cache_seqlens.ndim == 0:
        cache_seqlens = torch.as_tensor(cache_seqlens, device=dev).expand(b)
    cache_seqlens = cache_seqlens.to(device=dev, dtype=torch.int32)
    lens = cache_seqlens.long()
    start = lens if cache_leftpad is None else (
        lens - torch.as_tensor(cache_leftpad, device=dev).long())

    if rotary_cos is not None:
        q_pos = start[:, None] + torch.arange(sq, device=dev)[None, :]
        q = _apply_rotary(q, rotary_cos, rotary_sin, q_pos,
                          rotary_interleaved)
    quant_cache = k_cache.element_size() == 1 and k_cache.dtype != torch.uint8

    new_len = cache_seqlens
    if k is not None:
        snew = k.shape[1]
        if rotary_cos is not None:
            k_pos = start[:, None] + torch.arange(snew, device=dev)[None, :]
            k = _apply_rotary(k, rotary_cos, rotary_sin, k_pos,
                              rotary_interleaved)
        if quant_cache:
            k = quantise_append(k, k_descale, k_cache.dtype)
            v = quantise_append(v, v_descale, k_cache.dtype)
        k, v = k.to(k_cache.dtype), v.to(k_cache.dtype)
        sidx = lens[:, None] + torch.arange(snew, device=dev)[None, :]
        if paged:
            table = torch.as_tensor(block_table, device=dev).long()
            pids = table[torch.arange(b, device=dev)[:, None], sidx // page]
            poff = sidx % page
            if fused:
                k_cache[pids, 0, poff] = k
                k_cache[pids, 1, poff] = v
            else:
                k_cache[pids, poff] = k
                v_cache[pids, poff] = v
        else:
            bidx = (torch.arange(b, device=dev) if cache_batch_idx is None
                    else torch.as_tensor(cache_batch_idx, device=dev).long())
            k_cache[bidx[:, None], sidx] = k
            v_cache[bidx[:, None], sidx] = v
        new_len = cache_seqlens + snew

    qd, kcd, vcd = q, k_cache, v_cache
    if qv is not None:
        if fused:
            kcd, vcd = split_kv_cache(k_cache)
        # S = Q K^T + Qv V^T folded as [Q|Qv] [K|V]^T (`:1397-1435`); the
        # default scale becomes 1/sqrt(d + dv)
        if scale_was_default:
            softmax_scale = 1.0 / math.sqrt(d + qv.shape[-1])
        qv_eff = qv.float()
        if quant_cache:
            # one descale per (batch, kv head) follows the fused product,
            # so Qv carries the ratio vd / kd
            hk = kcd.shape[-2]
            ones = torch.ones(b, hk, device=dev)
            kd = _per_kv_head(k_descale, b, hk, dev, ones)
            vd = _per_kv_head(v_descale, b, hk, dev, ones)
            ratio = (vd / kd.clamp_min(1e-30)).repeat_interleave(h // hk,
                                                                 dim=1)
            qv_eff = qv_eff * ratio[:, None, :, None]
            v_descale = vd
        qd = torch.cat([q, qv_eff.to(q.dtype)], dim=-1)
        kcd = torch.cat([kcd, vcd.to(kcd.dtype)], dim=-1)

    out, lse = decode_attn_ref_layout(
        qd, kcd, vcd, new_len, softmax_scale=softmax_scale, causal=causal,
        window_size=window_size, softcap=softcap, alibi_slopes=alibi_slopes,
        block_table=block_table, cache_batch_idx=cache_batch_idx,
        cache_leftpad=cache_leftpad, num_splits=num_splits,
        attention_chunk=attention_chunk, k_descale=k_descale,
        v_descale=v_descale, sinks=sinks)
    results = (out,)
    if return_softmax_lse:
        results += (lse,)
    if return_updated_cache:
        results += ((k_cache,) if fused else ((k_cache, v_cache),))
    return results[0] if len(results) == 1 else results
