// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu;
// flex.cu and flash_decode_ref.cu use some): the mma.sync.m16n8k16
// wrappers (the decode's products; the others take Mma<T>::pack), quad
// reductions, the head-dim rule (kernel_head_dim), the dense and packed
// varlen layouts (SeqLayout), and the bottom-right causal / window mask
// arithmetic (key_band, interior).
//
// The forward and the backward (flash_bwd.cu's modded) turn a raw Q K^T
// score into the softmax's exponent in the same order (scale, softcap on
// the special function unit, ALiBi, masks, then the log2(e) factor), so the
// backward's p = exp2(score - lse * log2(e)) are the forward's
// probabilities; this is the role of the JAX backward's `folded` mode
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

// The head dim D the kernels are instantiated at for a call's head dim d:
// d rounded up to a multiple of 64, the width of a tile's column block
// (kernels/flash_fwd.py::kernel_head_dim).  0, no kernel, unless 0 < d <=
// 256 and d is a multiple of 8: a row of d 16-bit values must be a whole
// number of 16-byte units for the tensor maps' strides and the cp.async
// rows.  The columns d..D-1 are zero in shared memory and never stored.
inline int kernel_head_dim(int d) {
  return d > 0 && d <= 256 && d % 8 == 0 ? (d + 63) / 64 * 64 : 0;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Where the rows of one batch entry live, in one of two layouts:
// * dense: (b, h, s, d) tensors; lens_q/k are the per-batch seqused_q/k;
// * varlen: packed (total, h, d) streams; lens_q/k are cu_seqlens_q/k
//   (b + 1,), sequence bb owning the rows
//   [cu_q[bb], cu_q[bb+1]) of q, o, do, dq and [cu_k[bb], cu_k[bb+1]) of k,
//   v, dk, dv.  Its lengths are those of the sequence; a tile may run past
//   it into the next one's rows, which the kernels mask out and never
//   write.
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
// where they only size the grid); d: the call's head dim, the row stride
// of the tensors (not the kernel's D, whose columns past d are padding).
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

// The bottom-right aligned causal / window masks of one (batch, head), for
// a parameter struct P with has_upper, wr, has_lower, wl: offset = sk_b -
// sq_b (seqused_k - seqused_q dense, len_k - len_q of the sequence varlen).

// The keys [lo, hi] that row attends under the masks: below seqused_k,
// inside the bottom-right causal / window band.
template <class P>
__device__ __forceinline__ int2 key_band(const P& p, int row, int offset,
                                         int sk_b) {
  int hi = sk_b - 1;
  if (p.has_upper) hi = min(hi, row + offset + p.wr);
  return make_int2(p.has_lower ? row + offset - p.wl : 0, hi);
}

// Attention dropout: the keep mask of flash_attn_tpu/kernels/flash_fwd.py::
// dropout_keep (:80), a stateless hash of absolute positions, so that the
// forward and both backward kernels draw the same mask whatever their
// tiles: x = row C3 + col C4 + (seed ^ b C1 ^ h C2), lowbias32-mixed, and
// keep <=> (x & 0xFFFFFF) >= thresh, where thresh = ceil(float32(p) 2^24)
// is computed on the host (kernels/flash_fwd.py::dropout_threshold): the
// integer form of JAX's float32 compare u >= p.  Multiplication mod 2^32
// and >> on uint32_t give JAX's int32 wraparound and logical shifts bit for
// bit.  h is the q head.  The dense layout hashes the tensor's batch index,
// row and key; the packed varlen layout batch 0 and the token indices in
// the packed streams (varlen_sched.py:307-314).  A kernel keeps the
// per-row (or per-key) term and the base in registers and adds the tile's
// column (or row) term once a tile, so that an element costs one add, the
// mixer and a compare.
constexpr uint32_t kHashC1 = 0x9E3779B1u, kHashC2 = 0x85EBCA77u;
constexpr uint32_t kHashC3 = 0xC2B2AE3Du, kHashC4 = 0x27D4EB2Fu;

// The dropout's parameters: seed, thresh as above (0: no dropout), and
// rp = 1 / (1 - p) rounded to float32, as JAX scales the kept entries.
struct Dropout {
  uint32_t seed, thresh;
  float rp;
};

__device__ __forceinline__ uint32_t drop_base(uint32_t seed, int b, int h) {
  return seed ^ ((uint32_t)b * kHashC1) ^ ((uint32_t)h * kHashC2);
}

// keep for x = row C3 + col C4 + drop_base(...)
__device__ __forceinline__ bool drop_keep(uint32_t x, uint32_t thresh) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (x & 0xFFFFFFu) >= thresh;
}

// Whether every (row, key) of rows [r0, r0 + nr) and keys [c0, c0 + nc) is
// live, so that the tile needs no mask test.
template <class P>
__device__ __forceinline__ bool interior(const P& p, int r0, int nr, int c0,
                                         int nc, int offset, int sk_b) {
  return c0 + nc <= sk_b &&
         (!p.has_upper || c0 + nc - 1 <= r0 + offset + p.wr) &&
         (!p.has_lower || c0 >= r0 + nr - 1 + offset - p.wl);
}

}  // namespace fa
