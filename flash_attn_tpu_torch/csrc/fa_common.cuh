// Helpers shared by the flash-attention kernels (flash_fwd.cu; flash_bwd.cu,
// flex.cu and flash_decode_ref.cu use some): the mma.sync.m16n8k16
// wrappers, fragment loads, quad reductions, tile copies, the dense and
// packed varlen layouts (SeqLayout), and the score transform.
//
// ScoreMod is where the forward turns a raw Q K^T score into the exponent
// of the softmax.  The backward (flash_bwd.cu's modded) recomputes p =
// exp2(score - lse * log2(e)) in the same order (scale, softcap, ALiBi,
// masks, then the log2(e) factor), its tanh on the special function unit,
// so its probabilities are the forward's to within that tanh's rounding;
// this is the role of the JAX backward's `folded` mode
// (flash_attn_tpu/kernels/flash_bwd.py:75-81).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16-bit elements from different rows, lower address half = first.
__device__ __forceinline__ uint32_t pack16(const void* lo, const void* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// The A fragment of a row-major 16x16 tile at `tile` (row stride `stride`
// elements): rows gid and gid + 8, columns tig*2 and tig*2 + 8.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* tile, int stride,
                                       int gid, int tig) {
  const T* r0 = tile + gid * stride + tig * 2;
  const T* r1 = r0 + 8 * stride;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}

// The B fragment of B = X^T, for an 8x16 block of row-major X at `rows`
// (n along X's rows, k along its columns): one 32-bit load per register.
template <typename T>
__device__ __forceinline__ void load_b_t(uint32_t* b, const T* rows, int stride,
                                         int gid, int tig) {
  const T* r = rows + gid * stride + tig * 2;
  b[0] = ld32(r);
  b[1] = ld32(r + 8);
}

// The B fragment of B = X, for a 16x8 block of row-major X at `block`
// (k along X's rows, n along its columns): two rows per register.
template <typename T>
__device__ __forceinline__ void load_b(uint32_t* b, const T* block, int stride,
                                       int gid, int tig) {
  const T* c = block + (tig * 2) * stride + gid;
  b[0] = pack16(c, c + stride);
  b[1] = pack16(c + 8 * stride, c + 9 * stride);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy kRows rows of D elements (row stride `src_stride` elements in global)
// into shared rows of stride D + 8, 16 bytes per thread per step; rows at or
// past `valid` are zero-filled and never read, so stale memory, another
// sequence's rows or the end of the tensor never reach the math.
template <typename T, int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int valid,
                                          int src_stride) {
  constexpr int kStride = D + 8;
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * src_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

// Where the rows of one batch entry live, in one of two layouts:
// * dense: (b, h, s, d) tensors; lens_q/k are the per-batch seqused_q/k;
// * varlen: packed (total, h, d) streams; lens_q/k are cu_seqlens_q/k
//   (b + 1,), sequence bb owning the rows
//   [cu_q[bb], cu_q[bb+1]) of q, o, do, dq and [cu_k[bb], cu_k[bb+1]) of k,
//   v, dk, dv.  Its lengths are those of the sequence, and tiles never cross
//   into the next one.
// Offsets and strides are in elements; lse and delta are (b, h, sq) dense
// and (h, total_q) varlen.
struct SeqLayout {
  int sq_b, sk_b;          // query rows and keys that take part (the masks)
  int q_rows, k_rows;      // rows present in memory: loads and stores stop
  size_t q0, k0, l0;       // row 0 of head 0: q-like, kv-like, lse-like
  size_t q_hs, k_hs, l_hs; // head strides
  int q_rs, k_rs;          // row strides

  __device__ __forceinline__ size_t q_head(int hq) const { return q0 + hq * q_hs; }
  __device__ __forceinline__ size_t k_head(int hk) const { return k0 + hk * k_hs; }
  __device__ __forceinline__ size_t l_head(int hq) const { return l0 + hq * l_hs; }
};

// sq, sk: the tensors' lengths (dense) or the calls' max lengths (varlen,
// where they only size the grid).  The layout is a template argument, so
// the dense kernels see their strides (d) as compile-time constants.
template <bool kVarlen>
__device__ __forceinline__ SeqLayout seq_layout(
    const int* lens_q, const int* lens_k, int bb, int h, int hk, int sq,
    int sk, int total_q, int d) {
  SeqLayout L;
  if constexpr (kVarlen) {
    const int q_start = lens_q[bb], k_start = lens_k[bb];
    L.sq_b = L.q_rows = lens_q[bb + 1] - q_start;
    L.sk_b = L.k_rows = lens_k[bb + 1] - k_start;
    L.q0 = (size_t)q_start * h * d;
    L.k0 = (size_t)k_start * hk * d;
    L.l0 = q_start;
    L.q_hs = d;
    L.k_hs = d;
    L.l_hs = total_q;
    L.q_rs = h * d;
    L.k_rs = hk * d;
  } else {
    L.sq_b = lens_q[bb];
    L.sk_b = min(lens_k[bb], sk);
    L.q_rows = sq;
    L.k_rows = sk;
    L.q0 = (size_t)bb * h * sq * d;
    L.k0 = (size_t)bb * hk * sk * d;
    L.l0 = (size_t)bb * h * sq;
    L.q_hs = (size_t)sq * d;
    L.k_hs = (size_t)sk * d;
    L.l_hs = sq;
    L.q_rs = d;
    L.k_rs = d;
  }
  return L;
}

// Scale, softcap, ALiBi and the bottom-right aligned masks of one
// (batch, head): offset = sk_b - sq_b (seqused_k - seqused_q dense, len_k -
// len_q of the sequence varlen).  |row + offset - col| is the distance of
// the two tokens counted from their sequences' ends, the ALiBi distance of
// the JAX packed kernel (|from_end_q - from_end_k|).
struct ScoreMod {
  float scale, softcap, slope;
  bool alibi;
  int offset, sk_b, has_upper, wr, has_lower, wl;

  // The scaled and softcapped score, in natural units (before ALiBi).
  __device__ __forceinline__ float capped(float s) const {
    float x = s * scale;
    if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
    return x;
  }

  // The capped score with ALiBi, in log2 units; -inf where masked.
  __device__ __forceinline__ float log2_score(float x, int row, int col) const {
    if (alibi) x -= slope * fabsf((float)(row + offset - col));
    bool masked = col >= sk_b;
    if (has_upper) masked |= col > row + offset + wr;
    if (has_lower) masked |= col < row + offset - wl;
    return masked ? -INFINITY : x * kLog2e;
  }
};

}  // namespace fa
