"""Public flash-attention functions (counterpart of
`flash_attn_tpu/interface.py`): with gradients, `_make_core:48-120`,
`flash_attn_func:209`, `flash_attn_qkvpacked_func:310`,
`flash_attn_kvpacked_func:329`, `flash_attn_varlen_func:382` and its
`qkvpacked` / `kvpacked` forms (`:613-657`); for inference,
`flash_attn_with_kvcache`, `fuse_kv_cache`, `split_kv_cache` (`:660-679`,
in `kernels/flash_decode`), `flash_attn_combine:682`,
`get_scheduler_metadata:701`.

Dense inputs are in the (batch, seqlen, nheads, head_dim) layout and the
kernels run on (b, h, s, d).  `FlashAttnFunc` is the `torch.autograd.Function`
that takes the place of the JAX `custom_vjp`: its forward is
`flash_attn_fwd_bhsd`, which saves q, k, v, o and lse, and its backward is
`flash_attn_bwd_bhsd`.  Varlen inputs are packed (total, nheads, head_dim)
streams cut by `cu_seqlens`; `flash_attn_varlen_func` routes them as the JAX
function does (`:496-517`): batches of more than one sequence, without
`seqused_q/k` or `return_attn_probs` and with max lengths <= 65535, take the
packed kernels (`kernels/varlen.py`); every other call is gathered to the
padded layout and runs the dense kernels with per-sequence `seqused`; with
`block_table` the q tokens attend a paged KV cache.  fp8 q/k/v are
dequantised to bf16 outside the kernels (forward only).

* `deterministic` is accepted and ignored: the backward is always
  deterministic (`interface.py:15`).
* Attention dropout (`dropout_p` in [0, 1), else `ValueError`) runs inside
  the kernels: the keep mask is a stateless hash of (`dropout_seed`, None
  meaning 0, batch, q head, row, key), `kernels.flash_fwd.dropout_keep`,
  bit for bit the JAX package's.  The dense and padded varlen routes hash
  each tensor's own batch index, row and key; the packed varlen route
  batch 0 and the token indices in the packed streams.  fp8 and paged
  varlen with dropout raise `NotImplementedError`, as in JAX.
* `return_attn_probs=True` returns (out, lse, S_dmask) and carries the
  lse's gradient (`dlse`) into the backward.  S_dmask is None, or, for a
  dense call with dropout, the debug probabilities of `_attn_probs_dmask`
  (kept entries P / (1 - p), dropped -P).
* Not ported yet, and raising `NotImplementedError`: in `flash_attn_func`,
  `qv`, `sinks`, fp8 descale and `attention_chunk`.  The CUDA kernels take
  bf16 and fp16 at head dims up to 256, forward and gradient (in tiles of
  d rounded up to a multiple of 64; a d that is not a multiple of 8
  through zero-padded copies), and raise `NotImplementedError` on
  anything else (a float32 q on CUDA included).
"""

from __future__ import annotations

import math

import torch

from flash_attn_tpu_torch.kernels.block_sizes import fwd_block_sizes
from flash_attn_tpu_torch.kernels.combine import combine_attn_partials
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attn_bwd_bhsd
from flash_attn_tpu_torch.kernels.flash_decode import (  # noqa: F401
    FP8_DTYPES, decode_attn_ref_layout, flash_attn_with_kvcache,
    fuse_kv_cache, split_kv_cache)
from flash_attn_tpu_torch.kernels.flash_fwd import (check_dropout,
                                                    dropout_mask,
                                                    dropout_seed_value,
                                                    flash_attn_fwd_bhsd)
from flash_attn_tpu_torch.kernels.varlen import (MAX_SEQLEN,
                                                 flash_attn_varlen_sched_func)


class FlashAttnFunc(torch.autograd.Function):
    """(q, k, v) in (b, h, s, d), contiguous -> (o, lse) with the backward
    kernel as its gradient.  seqused_q/k (b,) int32 limit each batch row's
    query rows and keys; None means the full lengths.  The dropout's p and
    seed are kept for the backward, which recomputes the keep mask."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale, causal, window_size, softcap,
                alibi_slopes, seqused_q=None, seqused_k=None, dropout_p=0.0,
                dropout_seed=None):
        b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
        if seqused_q is None:
            seqused_q = torch.full((b,), sq, dtype=torch.int32,
                                   device=q.device)
        if seqused_k is None:
            seqused_k = torch.full((b,), sk, dtype=torch.int32,
                                   device=q.device)
        kw = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap,
                  alibi_slopes=alibi_slopes, dropout_p=dropout_p,
                  dropout_seed=dropout_seed)
        o, lse = flash_attn_fwd_bhsd(q, k, v, seqused_q, seqused_k, **kw)
        ctx.save_for_backward(q, k, v, o, lse, seqused_q, seqused_k)
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, seqused_q, seqused_k = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = flash_attn_bwd_bhsd(do, q, k, v, o, lse, seqused_q,
                                         seqused_k, dlse=dlse, **ctx.kw)
        return (dq, dk, dv) + (None,) * 9


def _attn_bhsd(q, k, v, *, softmax_scale, causal=False, window_size=(-1, -1),
               softcap=0.0, alibi_slopes=None, seqused_q=None,
               seqused_k=None, dropout_p=0.0, dropout_seed=None):
    """Differentiable attention on (b, h, s, d) operands with per-batch
    seqused (`interface.py:123`).  Returns (o, lse (b, h, sq))."""
    return FlashAttnFunc.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), float(softmax_scale),
        bool(causal), (int(window_size[0]), int(window_size[1])),
        float(softcap), alibi_slopes, seqused_q, seqused_k, float(dropout_p),
        dropout_seed)


def _attn_probs_dmask(q, k, lse, *, softmax_scale, causal, window_size,
                      softcap, alibi_slopes, dropout_p, dropout_seed):
    """The debug S_dmask of `return_attn_probs` with dropout
    (`interface.py::_attn_probs_dmask:155`): post-softmax probabilities
    from the kernel's lse, kept entries P / (1 - p) and dropped ones -P, so
    that `S_dmask >= 0` recovers the keep mask.  Plain PyTorch on the
    tensors' device, O(b h sq sk) memory.  q: (b, sq, h, d); k: (b, sk,
    hk, d); lse (b, h, sq).  Returns (b, h, sq, sk) float32."""
    b, sq, h, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dev = q.device
    kf = k.repeat_interleave(h // hk, dim=2) if h != hk else k
    s = torch.einsum("bihd,bjhd->bhij", q.float(), kf.float()) * softmax_scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    rows = torch.arange(sq, device=dev)[:, None]
    cols = torch.arange(sk, device=dev)[None, :]
    offset = sk - sq  # bottom-right aligned, the kernels' convention
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=dev).float()
        slopes = slopes.reshape(-1, h).expand(b, h)
        s = s - slopes[:, :, None, None] * (rows + offset - cols).abs()
    wl, wr = int(window_size[0]), 0 if causal else int(window_size[1])
    mask = torch.zeros((sq, sk), dtype=torch.bool, device=dev)
    if wr >= 0:
        mask = mask | (cols > rows + offset + wr)
    if wl >= 0:
        mask = mask | (cols < rows + offset - wl)
    p = torch.where(mask, 0.0, torch.exp(s - lse.float()[..., None]))
    keep = dropout_mask(dropout_seed_value(dropout_seed), dropout_p, b, h, sq,
                        sk, dev)
    return torch.where(keep, p / (1.0 - dropout_p), -p)


def flash_attn_func(q, k, v, dropout_p=0.0, softmax_scale=None, causal=False,
                    window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
                    deterministic=False, return_attn_probs=False,
                    q_descale=None, k_descale=None, v_descale=None,
                    sinks=None, dropout_seed=None, attention_chunk=0,
                    qv=None):
    """Multi-head attention, (b, s, h, d) layout (`interface.py:209`).

    q: (b, sq, h, d); k, v: (b, sk, hk, d) with h % hk == 0.  Returns out
    (b, sq, h, d), or (out, lse (b, h, sq) float32, S_dmask) when
    `return_attn_probs` (S_dmask None without dropout).  Runs on the
    tensors' device: the CUDA kernels on CUDA tensors, the plain versions
    on CPU tensors."""
    del deterministic  # always deterministic
    check_dropout(dropout_p)
    if qv is not None:
        raise NotImplementedError("qv is not ported yet")
    if sinks is not None:
        raise NotImplementedError("attention sinks are not ported yet")
    if any(x is not None for x in (q_descale, k_descale, v_descale)):
        raise NotImplementedError("fp8 descale is not ported yet")
    if attention_chunk:
        raise NotImplementedError("attention_chunk is not ported yet")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _attn_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, alibi_slopes=alibi_slopes, dropout_p=dropout_p,
        dropout_seed=dropout_seed)
    o = o.transpose(1, 2)
    if not return_attn_probs:
        return o
    s_dmask = None
    if dropout_p > 0.0:
        s_dmask = _attn_probs_dmask(
            q, k, lse.detach(), softmax_scale=softmax_scale, causal=causal,
            window_size=window_size, softcap=softcap,
            alibi_slopes=alibi_slopes, dropout_p=dropout_p,
            dropout_seed=dropout_seed)
    return o, lse, s_dmask


def flash_attn_qkvpacked_func(qkv, dropout_p=0.0, softmax_scale=None,
                              causal=False, window_size=(-1, -1), softcap=0.0,
                              alibi_slopes=None, deterministic=False,
                              return_attn_probs=False, dropout_seed=None):
    """qkv: (b, s, 3, h, d) (`interface.py:310`)."""
    return flash_attn_func(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout_p, softmax_scale, causal, window_size,
                           softcap, alibi_slopes, deterministic,
                           return_attn_probs, dropout_seed=dropout_seed)


def flash_attn_kvpacked_func(q, kv, dropout_p=0.0, softmax_scale=None,
                             causal=False, window_size=(-1, -1), softcap=0.0,
                             alibi_slopes=None, deterministic=False,
                             return_attn_probs=False, dropout_seed=None):
    """kv: (b, s, 2, hk, d) (`interface.py:329`)."""
    return flash_attn_func(q, kv[:, :, 0], kv[:, :, 1], dropout_p,
                           softmax_scale, causal, window_size, softcap,
                           alibi_slopes, deterministic, return_attn_probs,
                           dropout_seed=dropout_seed)


def _varlen_to_padded(x, cu_seqlens, max_seqlen):
    """(total, ...) packed -> (b, max_seqlen, ...); rows past a sequence's
    end repeat other tokens, which the callers mask (`interface.py:361`)."""
    total = x.shape[0]
    cu = cu_seqlens.long()
    idx = cu[:-1, None] + torch.arange(max_seqlen, device=x.device)[None, :]
    return x[idx.clamp(max=total - 1)]


def _segment_ids(cu_seqlens, total):
    """Sequence index of each of `total` packed tokens, clipped to [0, b)."""
    cu = cu_seqlens.long()
    t = torch.arange(total, device=cu.device)
    return (torch.searchsorted(cu, t, right=True) - 1).clamp(
        0, cu.shape[0] - 2)


def _padded_to_varlen(xp, cu_seqlens, total):
    """(b, max_seqlen, ...) -> (total, ...) packed (`interface.py:369`)."""
    seg = _segment_ids(cu_seqlens, total)
    pos = torch.arange(total, device=xp.device) - cu_seqlens.long()[seg]
    return xp[seg, pos.clamp(0, xp.shape[1] - 1)]


def flash_attn_varlen_func(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                           max_seqlen_k, dropout_p=0.0, softmax_scale=None,
                           causal=False, window_size=(-1, -1), softcap=0.0,
                           alibi_slopes=None, deterministic=False,
                           return_attn_probs=False, seqused_q=None,
                           seqused_k=None, block_table=None,
                           dropout_seed=None, q_descale=None, k_descale=None,
                           v_descale=None, qv=None):
    """Varlen attention over packed tokens (`interface.py:382`).

    q: (total_q, h, d); k, v: (total_k, hk, d); cu_seqlens_q/k: (b + 1,)
    int32 prefix sums; max_seqlen_q/k: Python ints.  Returns out
    (total_q, h, d), or (out, lse (b, h, max_seqlen_q), None) with
    `return_attn_probs`.  `seqused_q/k` (b,) limit the used tokens of each
    sequence.  With `block_table`, k and v are paged caches (npages, page,
    hk, d) and each sequence's q tokens are its newest, at the end of its
    seqused_k (or cu_seqlens_k) keys: chunked prefill against a paged cache.
    fp8 q/k/v take per-(sequence, kv head) descales and give a bf16 output
    with no gradient.  Differentiable on the packed and padded routes.
    Dropout hashes packed-stream coordinates on the packed route and each
    sequence's own rows and keys (batch index, position) on the padded
    one, as JAX does; with `return_attn_probs` S_dmask is None."""
    del deterministic
    check_dropout(dropout_p)
    if qv is not None:
        if q.dtype in FP8_DTYPES:
            raise NotImplementedError("qv is not supported with fp8 inputs")
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(q.shape[-1] + qv.shape[-1])
        q = torch.cat([q, qv.to(q.dtype)], dim=-1)
        k = torch.cat([k, v.to(k.dtype)], dim=-1)
    if q.dtype in FP8_DTYPES and block_table is None:
        if dropout_p > 0.0:
            raise NotImplementedError(
                "dropout_p > 0 is not supported with fp8 inputs")
        return _varlen_fp8(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                           max_seqlen_k, softmax_scale, causal, window_size,
                           softcap, alibi_slopes, return_attn_probs,
                           seqused_q, seqused_k, q_descale, k_descale,
                           v_descale)
    if block_table is not None:
        if dropout_p > 0.0:
            raise NotImplementedError(
                "paged varlen prefill supports dropout_p=0 (inference path)")
        return _varlen_paged_prefill(
            q, k, v, cu_seqlens_q, max_seqlen_q, block_table,
            seqused_k=seqused_k, cu_seqlens_k=cu_seqlens_k,
            softmax_scale=softmax_scale, causal=causal,
            window_size=window_size, softcap=softcap,
            alibi_slopes=alibi_slopes, return_lse=return_attn_probs)
    d = q.shape[-1]
    b = cu_seqlens_q.shape[0] - 1
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    # The JAX router (`interface.py:496-517`), unchanged: batches of more
    # than one sequence take the packed kernels unless they need seqused,
    # the lse, or longer sequences than the packed kernels' 16-bit
    # positions hold.
    routable = (seqused_q is None and seqused_k is None
                and not return_attn_probs)
    fits_packed = max(int(max_seqlen_q), int(max_seqlen_k)) <= MAX_SEQLEN
    if routable and fits_packed and b > 1:
        return flash_attn_varlen_sched_func(
            q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
            softmax_scale=float(softmax_scale), causal=causal,
            window_size=window_size, softcap=softcap,
            alibi_slopes=alibi_slopes, dropout_p=dropout_p,
            dropout_seed=dropout_seed)
    return _varlen_padded(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                          max_seqlen_k, softmax_scale, causal, window_size,
                          softcap, alibi_slopes, return_attn_probs, seqused_q,
                          seqused_k, dropout_p, dropout_seed)


def _varlen_padded(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                   max_seqlen_k, softmax_scale, causal, window_size, softcap,
                   alibi_slopes, return_lse, seqused_q, seqused_k,
                   dropout_p=0.0, dropout_seed=None):
    """The padded route (`interface.py:518-545`): gather the packed streams
    to (b, max_seqlen), run the dense kernels with per-sequence seqused,
    zero the rows past each sequence's used length and scatter back."""
    dev = q.device
    cu_q = torch.as_tensor(cu_seqlens_q, device=dev).int()
    cu_k = torch.as_tensor(cu_seqlens_k, device=dev).int()
    b = cu_q.shape[0] - 1
    max_sq, max_sk = int(max_seqlen_q), int(max_seqlen_k)
    used_q = (cu_q[1:] - cu_q[:-1] if seqused_q is None
              else torch.as_tensor(seqused_q, device=dev).int())
    used_k = (cu_k[1:] - cu_k[:-1] if seqused_k is None
              else torch.as_tensor(seqused_k, device=dev).int())
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, device=dev).float()
        slopes = slopes.reshape(-1, q.shape[1]).expand(b, -1)
    qp = _varlen_to_padded(q, cu_q, max_sq).transpose(1, 2)
    kp = _varlen_to_padded(k, cu_k, max_sk).transpose(1, 2)
    vp = _varlen_to_padded(v, cu_k, max_sk).transpose(1, 2)
    o, lse = _attn_bhsd(qp, kp, vp, softmax_scale=softmax_scale,
                        causal=causal, window_size=window_size,
                        softcap=softcap, alibi_slopes=slopes,
                        seqused_q=used_q, seqused_k=used_k,
                        dropout_p=dropout_p, dropout_seed=dropout_seed)
    o = o.transpose(1, 2)  # (b, max_sq, h, d)
    row_valid = torch.arange(max_sq, device=dev)[None, :] < used_q[:, None]
    o = torch.where(row_valid[:, :, None, None], o, 0)
    out = _padded_to_varlen(o, cu_q, q.shape[0])
    return (out, lse, None) if return_lse else out


def _varlen_fp8(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                max_seqlen_k, softmax_scale, causal, window_size, softcap,
                alibi_slopes, return_attn_probs, seqused_q, seqused_k,
                q_descale, k_descale, v_descale):
    """fp8 q/k/v (`interface.py:435-470`): q is dequantised per token with
    its own sequence's q and k descales, k and v are cast to bf16, and the
    v descale scales each output row afterwards (every key a row attends
    belongs to its sequence).  Rides the bf16 kernels; forward only."""
    total_q, h, _ = q.shape
    hk = k.shape[1]
    g = h // hk
    b = cu_seqlens_q.shape[0] - 1
    dev = q.device

    def norm_ds(ds):
        if ds is None:
            return torch.ones(b, hk, device=dev)
        return torch.as_tensor(ds, device=dev).float().reshape(-1, hk)\
            .expand(b, hk)

    qd, kd, vd = norm_ds(q_descale), norm_ds(k_descale), norm_ds(v_descale)
    seg_q = _segment_ids(torch.as_tensor(cu_seqlens_q, device=dev), total_q)
    deq = (qd * kd)[seg_q].repeat_interleave(g, dim=1)  # (total_q, h)
    q_bf = (q.float() * deq[..., None]).to(torch.bfloat16)
    out = flash_attn_varlen_func(
        q_bf, k.to(torch.bfloat16), v.to(torch.bfloat16), cu_seqlens_q,
        cu_seqlens_k, max_seqlen_q, max_seqlen_k, 0.0, softmax_scale, causal,
        window_size, softcap, alibi_slopes, True, return_attn_probs,
        seqused_q, seqused_k)
    out, rest = (out[0], out[1:]) if return_attn_probs else (out, ())
    vscale = vd[seg_q].repeat_interleave(g, dim=1)  # (total_q, h)
    out = (out.float() * vscale[..., None]).to(torch.bfloat16).detach()
    return (out, *rest) if rest else out


def _varlen_paged_prefill(q, k_cache, v_cache, cu_seqlens_q, max_seqlen_q,
                          block_table, *, seqused_k, cu_seqlens_k,
                          softmax_scale, causal, window_size, alibi_slopes,
                          softcap=0.0, return_lse=False):
    """Chunked prefill against a paged KV cache (`interface.py:548`): each
    sequence's queries are left-padded to max_seqlen_q, so its real rows sit
    at the bottom, where the bottom-right causal offset is exact, and go
    through `decode_attn_ref_layout`; the padding rows are dropped on the
    scatter back.  With `return_lse` the LSE (b, h, max_seqlen_q) holds
    token t of sequence i at row t and +inf on padding rows."""
    total_q, h, d = q.shape
    dev = q.device
    max_sq = int(max_seqlen_q)
    cu = torch.as_tensor(cu_seqlens_q, device=dev).long()
    b = cu.shape[0] - 1
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    lens_q = cu[1:] - cu[:-1]
    if seqused_k is not None:
        lens_k = torch.as_tensor(seqused_k, device=dev).int()
    else:
        cu_k = torch.as_tensor(cu_seqlens_k, device=dev).int()
        lens_k = cu_k[1:] - cu_k[:-1]

    # left-pad gather: padded row r holds token r - (max_sq - len_q)
    r = torch.arange(max_sq, device=dev)[None, :]
    src = cu[:-1, None] + r - (max_sq - lens_q[:, None])
    valid = src >= cu[:-1, None]
    qp = q[src.clamp(0, total_q - 1)]  # (b, max_sq, h, d)
    o, lse = decode_attn_ref_layout(
        qp, k_cache, v_cache, lens_k, softmax_scale=float(softmax_scale),
        causal=causal, window_size=window_size, softcap=softcap,
        alibi_slopes=alibi_slopes, block_table=block_table)
    o = torch.where(valid[:, :, None, None], o, 0)
    # scatter back: token t of sequence i is padded row
    # (max_sq - len_q[i]) + (t - cu[i])
    seg = _segment_ids(cu, total_q)
    pos = torch.arange(total_q, device=dev) - cu[seg] + max_sq - lens_q[seg]
    out = o[seg, pos.clamp(0, max_sq - 1)]
    if not return_lse:
        return out
    src_row = (r + (max_sq - lens_q[:, None])).clamp(0, max_sq - 1)
    lse_r = torch.gather(lse, 2, src_row[:, None, :].expand(b, h, max_sq))
    lse_r = torch.where((r < lens_q[:, None])[:, None, :], lse_r, torch.inf)
    return out, lse_r, None


def flash_attn_varlen_qkvpacked_func(qkv, cu_seqlens, max_seqlen,
                                     dropout_p=0.0, softmax_scale=None,
                                     causal=False, window_size=(-1, -1),
                                     softcap=0.0, alibi_slopes=None,
                                     deterministic=False,
                                     return_attn_probs=False,
                                     dropout_seed=None):
    """qkv: (total, 3, h, d) (`interface.py:613`)."""
    return flash_attn_varlen_func(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens, max_seqlen,
        max_seqlen, dropout_p, softmax_scale, causal, window_size, softcap,
        alibi_slopes, deterministic, return_attn_probs,
        dropout_seed=dropout_seed)


def flash_attn_varlen_kvpacked_func(q, kv, cu_seqlens_q, cu_seqlens_k,
                                    max_seqlen_q, max_seqlen_k, dropout_p=0.0,
                                    softmax_scale=None, causal=False,
                                    window_size=(-1, -1), softcap=0.0,
                                    alibi_slopes=None, deterministic=False,
                                    return_attn_probs=False,
                                    dropout_seed=None):
    """kv: (total_k, 2, hk, d) (`interface.py:634`)."""
    return flash_attn_varlen_func(
        q, kv[:, 0], kv[:, 1], cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
        max_seqlen_k, dropout_p, softmax_scale, causal, window_size, softcap,
        alibi_slopes, deterministic, return_attn_probs,
        dropout_seed=dropout_seed)


def flash_attn_combine(out_partial, lse_partial, out=None, out_dtype=None):
    """Combine split-attention partials (`interface.py:682`).
    out_partial: (num_splits, b, s, h, d) per-split normalised outputs;
    lse_partial: (num_splits, b, h, s), +inf for an empty split.  Returns
    (out (b, s, h, d), lse (b, h, s)); with `out` given, the result is also
    copied into it."""
    o, lse = combine_attn_partials(out_partial.transpose(2, 3), lse_partial,
                                   axis=0)
    o = o.transpose(1, 2)
    if out_dtype is not None:
        o = o.to(out_dtype)
    if out is not None:
        out.copy_(o)
        o = out
    return o, lse


def get_scheduler_metadata(batch_size, max_seqlen_q, max_seqlen_k,
                           num_heads_q, num_heads_kv, headdim,
                           cache_seqlens=None, qkv_dtype=torch.bfloat16,
                           headdim_v=None, cu_seqlens_q=None,
                           cu_seqlens_k_new=None, cache_leftpad=None,
                           page_size=None, max_seqlen_k_new=0, causal=False,
                           window_size=(-1, -1), attention_chunk=0,
                           has_softcap=False, num_splits=0, pack_gqa=None,
                           sm_margin=0):
    """Decode-scheduling metadata (`interface.py:701`): the JAX package's
    host-side split and GQA-packing heuristic, returned as the same dict
    (`num_splits` is what `flash_attn_with_kvcache` reads from it)."""
    g = num_heads_q // max(num_heads_kv, 1)
    if pack_gqa is None:
        pack_gqa = max_seqlen_q * g <= 512 and g > 1
    bs = fwd_block_sizes(max(max_seqlen_q, 1), max_seqlen_k, headdim,
                         boundary_heavy=causal)
    if num_splits <= 0:
        eff_k = max_seqlen_k
        if cache_seqlens is not None:
            eff_k = int(torch.as_tensor(cache_seqlens).max())
        if batch_size * num_heads_kv >= 8 or eff_k <= 4096:
            num_splits = 1
        else:
            num_splits = min(8, max(1, eff_k // 4096))
    return dict(num_splits=int(num_splits), pack_gqa=bool(pack_gqa),
                block_q=bs.block_q, block_k=bs.block_k,
                block_k_sub=bs.block_k_sub, page_size=page_size)
