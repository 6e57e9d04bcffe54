// Decode-body ladder for Hopper (sm_90a): the production decode kernel's
// per-tile body (csrc/flash_decode_ref.cu, a decode step's 16-row tile)
// with its later stages cut off, over int8 or bf16 K/V slabs (b, smax,
// hk*d) and 8 query rows a kv head.
//
// Replaces the Pallas TPU kernel benchmarks/diag_int8_decode.py::make_kernel
// (:37, launched at :144), a ladder over the slab layout of
// flash_attn_tpu/kernels/flash_decode.py::_decode_ref_kernel:
//   dma    : stream the K/V slabs, touch them once
//   qk     : + per-head Q K^T (s8 mma with int32 sums for int8, bf16 mma)
//   cast   : + score cast / scale to f32 (0.0883883)
//   soft   : + online-softmax update (max, exp2, sum; m/l state)
//   pquant : + P requantisation (rint(127 p) for int8, bf16 cast for bf16)
//   full   : + P V and the accumulator update (the whole decode body)
// Stages qk..pquant add one row sum into column 0 of each head's output;
// soft and pquant sum each bk-key block's p against the running max at the
// block's end (no rescale across blocks); full returns the unnormalised
// accumulator.  JAX's dma stage writes no output; here it returns, in
// column 0, the sum over key blocks of each block's first 8 key rows summed
// over d, K plus V (the port's own definition, held only against its plain
// twin).
//
// What bounds it on the H100: bytes.  Every stage reads each K/V row once
// (2 b smax hk d bytes per element size); the math is ~4 * 8 FLOPs per row
// element at most.
//
// What the design does about it: each rung is flash_decode_ref.cu's
// decode body (kRowWarps = 1) cut after its stage, over the same contiguous
// (bc, smax, hk, d) cache, so the rungs' differences split the time of the
// kernel the main path runs:
// * One block of 4 warps per (kv head, batch, split).  The 8 rows take one
//   m16 tile (rows 8-15 are zero padding and skip the softmax); the warps
//   share out each 64-key tile, 16 keys a warp, and each warp copies and
//   waits for its own 16 keys through its own part of a cp.async ring (2
//   deep for bf16, 4 for int8, as the decode kernel's).  The dma rung is
//   that ring with only the touch: the floor of the others.
// * Q K^T on tensor cores with mma.sync: bf16 m16n8k16 with K fragments
//   from ldmatrix; int8 m16n8k32 s8 with int32 sums, K's bytes straight
//   from an 8-bit ldmatrix.  P V: bf16 m16n8k16 with V from ldmatrix.trans;
//   int8 rint(127 p) and V widened to fp16 (ldmatrix + movmatrix), the fp16
//   mma exact for a 16-key warp share.  8-bit tiles stay 8-bit in shared
//   memory.  Q fragments, O, m and l stay in registers; shared memory holds
//   the ring and a few per-row words, no per-(row, key) score array.
// * The running max moves once per 64-key tile, as the decode kernel's: a
//   warp's own 16 keys for bf16 (merged at the end, each warp rescaled to
//   the largest), the tile's 64 keys for int8 (the warps agree on each
//   tile's maximum through shared memory, since P is quantised against
//   it).  JAX moves it once per bk-key block.  soft and pquant keep a block
//   sum a warp, rescaled with each move; at a block's end the warps' sums
//   are rescaled to the block's running max and added into column 0, so
//   soft (and bf16 full) compute JAX's function up to rounding; pquant and
//   int8 full quantise against another max and differ from it by the
//   rounding of p (decode_ladder_ref(max_every=64) is the kernel's own
//   function).
// * The key split (grid y) is merged in the kernel: each block writes its
//   partial rows and (m, l), and the last block of a (kv head, batch) to
//   finish, counted on a semaphore it resets, merges them (full weighs
//   split j by exp2((m_j - M) log2 e), the other stages add).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fa_common.cuh"

namespace {

using fa::Mma;
using fa::quad_max;
using fa::quad_sum;

constexpr int kRows = 8;       // query rows a kv head (JAX's rows_n)
constexpr int kTileN = 64;     // keys a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWK = kTileN / kWarps;  // keys of a tile a warp
constexpr int kNT = kWK / 8;          // S n-tiles a warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScale = 0.0883883f;
constexpr float kPvScale = (float)(0.0883883 / 127.0);

enum Stage { kDma = 0, kQk = 1, kCast = 2, kSoft = 3, kPquant = 4, kFull = 5 };

struct Params {
  const void* q;           // (b, hk, 8, D) int8 or bf16
  const unsigned char* k;  // (b, smax, hk * D)
  const unsigned char* v;
  float* out;    // (b, hk, 8, D)
  float* part;   // (b, hk, splits, 8, D), splits > 1
  float* stats;  // (b, hk, splits, 8, 2): each split's m (full's merge) and l,
                 // stored so that soft..full keep the decode body's l update
  int* sems;     // (b * hk) zeroed counters, splits > 1
  int hk, smax, bk, splits, split_keys;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// C += A B on int8 tensor cores with int32 sums (flash_decode_ref.cu's).
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An 8x8 16-bit matrix held as an ldmatrix fragment, transposed.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// Bytes 0 and 2 (`even`), 1 and 3 (`odd`) of an int8 word, each pair as
// fp16, exact (flash_decode_ref.cu's Cache<int8_t>::split4): with the sign
// bit flipped a byte is x + 128, and fp16 0x64XX is 1024 + XX.
__device__ __forceinline__ void split4(uint32_t w, uint32_t& even, uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t e = __byte_perm(u, 0x64646464u, 0x4240);
  uint32_t o = __byte_perm(u, 0x64646464u, 0x4341);
  const __half2 bias = __half2half2(__ushort_as_half(0x6480));  // 1152
  const __half2 he = __hsub2(*reinterpret_cast<__half2*>(&e), bias);
  const __half2 ho = __hsub2(*reinterpret_cast<__half2*>(&o), bias);
  even = *reinterpret_cast<const uint32_t*>(&he);
  odd = *reinterpret_cast<const uint32_t*>(&ho);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kInt8, int D>
struct Layout {
  static constexpr int kBytes = kInt8 ? 1 : 2;
  static constexpr int kStages = kInt8 ? 4 : 2;       // the decode kernel's ring depths
  static constexpr int kRowBytes = D * kBytes + 16;   // 16 B pad: no bank conflicts
  static constexpr int kChunks = D * kBytes / 16;     // 16 B chunks per key row
  static constexpr int kSlotBytes = kWK * kRowBytes;  // a warp's K (or V) rows of a tile
  static constexpr int kSmem = kWarps * kStages * 2 * kSlotBytes;
};

template <int kStage, bool kInt8, int D>
__global__ void __launch_bounds__(kThreads) decode_ladder_kernel(const Params p) {
  using T = typename std::conditional<kInt8, __half, __nv_bfloat16>::type;  // P V type
  using L = Layout<kInt8, D>;
  constexpr int kStages = L::kStages, kRowBytes = L::kRowBytes;
  constexpr int kKS = D / 16;  // 16-column steps of d
  constexpr int kDT = D / 8;   // O n-tiles
  constexpr int kQS = kInt8 ? D / 32 : kKS;
  constexpr bool kSoftmax = kStage >= kSoft;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sMax[2][kWarps * kRows];     // int8: tile maxima, by tile parity
  __shared__ float sBlk[2][2][kWarps * kRows];  // block-end (m, sum), by block parity
  __shared__ float sRow[3][kWarps * kRows];     // the warps' column 0, m and l at the end
  __shared__ int sLast;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int kh = bh % p.hk, bb = bh / p.hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  unsigned char* my_ring = smem + (size_t)warp * kStages * 2 * L::kSlotBytes;
  constexpr size_t kRow = (size_t)D * L::kBytes;  // one key of one kv head
  const size_t key_stride = (size_t)p.hk * kRow;
  const int start = split * p.split_keys;
  const int n_tiles = p.split_keys / kTileN, tiles_per_block = p.bk / kTileN;

  // Q's A fragments: a0 / a2 row gid (the 8 rows); a1 / a3 rows gid + 8,
  // zero (flash_decode_ref.cu's layout, int8 in 32-column s8 steps)
  uint32_t qa[kQS][4];
  {
    const size_t base = ((size_t)bh * kRows + gid) * D;
#pragma unroll
    for (int kk = 0; kk < kQS; ++kk) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t x;
        if constexpr (kInt8) {
          x = *reinterpret_cast<const uint32_t*>(static_cast<const int8_t*>(p.q) + base + kk * 32 +
                                                 c * 16 + tig * 4);
        } else {
          x = *reinterpret_cast<const uint32_t*>(static_cast<const __nv_bfloat16*>(p.q) + base +
                                                 kk * 16 + tig * 2 + c * 8);
        }
        qa[kk][2 * c] = x;
        qa[kk][1 + 2 * c] = 0u;
      }
    }
  }

  // this warp's 16 keys of the tile at col0, K and V, into ring slot `slot`
  auto issue = [&](int col0, int slot) {
    const size_t at = ((size_t)bb * p.smax + col0 + warp * kWK) * key_stride + kh * kRow;
    const unsigned char* kb = p.k + at;
    const unsigned char* vb = p.v + at;
    unsigned char* dk = my_ring + (size_t)(slot * 2) * L::kSlotBytes;
    unsigned char* dv = dk + L::kSlotBytes;
#pragma unroll
    for (int idx = lane; idx < kWK * L::kChunks; idx += 32) {
      const int r = idx / L::kChunks, c = (idx % L::kChunks) * 16;
      cp_async16(dk + r * kRowBytes + c, kb + r * key_stride + c);
      cp_async16(dv + r * kRowBytes + c, vb + r * key_stride + c);
    }
  };

  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // row gid; l_run this thread's columns
  float acc0 = 0.f;                      // column 0 (dma..pquant): this thread's share
  float bsum = 0.f;                      // soft / pquant: the block's sum, this thread's keys
  int isum = 0;                          // int8 qk: the block's int32 sum

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(start + s * kTileN, s);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // tile it has landed; the slot refilled next was read at it - 1
    if (it + kStages - 1 < n_tiles) issue(start + (it + kStages - 1) * kTileN, (it + kStages - 1) % kStages);
    cp_async_commit();

    const unsigned char* sK = my_ring + (size_t)((it % kStages) * 2) * L::kSlotBytes;
    const unsigned char* sV = sK + L::kSlotBytes;
    const int t_in_block = it % tiles_per_block;
    const bool block_end = t_in_block == tiles_per_block - 1;

    if constexpr (kStage == kDma) {
      // the block's first 8 key rows (warp 0's rows 0-7): row gid, chunks
      // tig, tig + 4, ... of K and V
      if (warp == 0 && t_in_block == 0) {
#pragma unroll
        for (int c = tig; c < L::kChunks; c += 4) {
#pragma unroll
          for (int which = 0; which < 2; ++which) {
            const uint4 u = *reinterpret_cast<const uint4*>((which ? sV : sK) + gid * kRowBytes + c * 16);
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (kInt8) {
#pragma unroll
                for (int bt = 0; bt < 4; ++bt) acc0 += (float)(int8_t)(w[e] >> (8 * bt));
              } else {
                const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
                acc0 += f.x + f.y;
              }
            }
          }
        }
      }
      continue;
    }

    // S = Q K^T over this warp's 16 keys (flash_decode_ref.cu's products)
    float s[kNT][4];
    if constexpr (kInt8) {
      int si[kNT][4];
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt) si[jt][0] = si[jt][1] = si[jt][2] = si[jt][3] = 0;
#pragma unroll
      for (int c0 = 0; c0 < kKS; c0 += 4) {
        uint32_t r[kNT][4];
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt)
          ldsm_x4(r[jt], sK + (jt * 8 + (lane & 7)) * kRowBytes + (c0 + (lane >> 3)) * 16);
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) mma_s8(si[jt], qa[c0 / 2], r[jt]);
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) mma_s8(si[jt], qa[c0 / 2 + 1], r[jt] + 2);
      }
      if constexpr (kStage == kQk) {
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) isum += si[jt][0] + si[jt][1];
        if (block_end) {
          acc0 += (float)isum;
          isum = 0;
        }
        continue;
      }
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jt][e] = (float)si[jt][e];
    } else {
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt) s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 2) {
        uint32_t b[kNT][4];
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt)
          ldsm_x4(b[jt], sK + (jt * 8 + (lane & 7)) * kRowBytes + (kk * 16 + (lane >> 3) * 8) * 2);
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) Mma<__nv_bfloat16>::mma(s[jt], qa[kk], b[jt]);
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) Mma<__nv_bfloat16>::mma(s[jt], qa[kk + 1], b[jt] + 2);
      }
      if constexpr (kStage == kQk) {
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) acc0 += s[jt][0] + s[jt][1];
        continue;
      }
    }

    // the scale; the 8 rows only (elements 0, 1 of each n-tile)
#pragma unroll
    for (int jt = 0; jt < kNT; ++jt) {
      s[jt][0] *= kScale;
      s[jt][1] *= kScale;
    }
    if constexpr (kStage == kCast) {
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt) acc0 += s[jt][0] + s[jt][1];
      continue;
    }

    // online softmax against the running max of the tiles seen so far
    float mx = -INFINITY;
#pragma unroll
    for (int jt = 0; jt < kNT; ++jt) mx = fmaxf(mx, fmaxf(s[jt][0], s[jt][1]));
    mx = quad_max(mx);
    if constexpr (kInt8) {
      // int8 quantises against the whole tile's maximum: the warps agree
      float* sm = sMax[it & 1];
      if (tig == 0) sm[warp * kRows + gid] = mx;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * kRows + gid]);
    }
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f((m_run - m_new) * kLog2e);
    m_run = m_new;
    float rs = 0.f, qs = 0.f;
#pragma unroll
    for (int jt = 0; jt < kNT; ++jt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp2f((s[jt][e] - m_new) * kLog2e);
        rs += pe;
        if constexpr (kStage >= kPquant) {
          const float pq = kInt8 ? rintf(pe * 127.f) : round_bf16(pe);
          qs += pq;
          s[jt][e] = pq;
        }
      }
    }
    l_run = l_run * alpha + rs;
    if constexpr (kStage == kSoft || kStage == kPquant) {
      bsum = bsum * alpha + (kStage == kSoft ? rs : qs);
      if (block_end) {
        // the warps' block sums, rescaled to the block's running max
        const int par = (it / tiles_per_block) & 1;
        const float row = quad_sum(bsum);
        if (tig == 0) {
          sBlk[par][0][warp * kRows + gid] = m_run;
          sBlk[par][1][warp * kRows + gid] = row;
        }
        __syncthreads();
        if (warp == 0 && tig == 0) {
          float mb = -INFINITY;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sBlk[par][0][w * kRows + gid]);
          float tot = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            tot += sBlk[par][1][w * kRows + gid] * exp2f((sBlk[par][0][w * kRows + gid] - mb) * kLog2e);
          // JAX sums the bf16 p in bf16: one rounding of the block's sum
          acc0 += (kStage == kPquant && !kInt8) ? round_bf16(tot) : tot;
        }
        bsum = 0.f;
      }
      continue;
    }

    if constexpr (kStage == kFull) {
      // O = alpha O + P V (int8: the tile's exact integer sums times
      // 0.0883883 / 127); P's rows 8-15 are zero
      uint32_t pa[4];
      pa[0] = Mma<T>::pack(s[0][0], s[0][1]);
      pa[1] = 0u;
      pa[2] = Mma<T>::pack(s[1][0], s[1][1]);
      pa[3] = 0u;
      auto pv_step = [&](float (*c)[4], int dp) {  // n-tiles dp, dp + 1
        uint32_t b[4];
        if constexpr (!kInt8) {
          ldsm_x4_t(b, sV + (lane & 15) * kRowBytes + (dp + (lane >> 4)) * 16);
        } else {
          // chunk dp / 2, keys 0-7 and 8-15; even and odd d's (see put_row)
          uint32_t r[2];
          const unsigned char* at = sV + (lane & 15) * kRowBytes + (dp >> 1) * 16;
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                       : "=r"(r[0]), "=r"(r[1])
                       : "r"(static_cast<unsigned>(__cvta_generic_to_shared(at))));
          split4(movmatrix_t(r[0]), b[0], b[2]);
          split4(movmatrix_t(r[1]), b[1], b[3]);
        }
        Mma<T>::mma(c[0], pa, b);
        Mma<T>::mma(c[1], pa, b + 2);
      };
      if constexpr (kInt8) {
#pragma unroll
        for (int dp = 0; dp < kDT; dp += 2) {
          float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          pv_step(c, dp);
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) o[dp + t][e] = o[dp + t][e] * alpha + c[t][e] * kPvScale;
        }
      } else {
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          o[dt][0] *= alpha;
          o[dt][1] *= alpha;
        }
#pragma unroll
        for (int dp = 0; dp < kDT; dp += 2) pv_step(o + dp, dp);
      }
    }
  }
  cp_async_wait<0>();

  // The warps' rows, into this split's rows: column 0 summed (dma..pquant),
  // O merged at the largest m (full), m and l for the stats.
  const size_t split_row0 = ((size_t)bh * p.splits + split) * kRows;  // part, stats
  float* dst = p.splits > 1 ? p.part + split_row0 * D : p.out + (size_t)bh * kRows * D;
  {
    const float c0 = quad_sum(acc0), l_row = quad_sum(l_run);
    if (tig == 0) {
      sRow[0][warp * kRows + gid] = c0;
      sRow[1][warp * kRows + gid] = m_run;
      sRow[2][warp * kRows + gid] = l_row;
    }
  }
  __syncthreads();  // the ring is free
  float* sO = reinterpret_cast<float*>(smem);  // (kWarps, 8, D)
  if constexpr (kStage == kFull) {
    // this thread's O values of row gid, in d order
#pragma unroll
    for (int c = 0; c < (kInt8 ? D / 16 : kDT); ++c) {
      float* row = sO + (warp * kRows + gid) * D;
      if constexpr (kInt8) {
        // n-tiles 2c and 2c + 1 hold chunk c's d 4 tig, 4 tig + 2 and
        // 4 tig + 1, 4 tig + 3
        *reinterpret_cast<float4*>(row + c * 16 + tig * 4) =
            make_float4(o[2 * c][0], o[2 * c + 1][0], o[2 * c][1], o[2 * c + 1][1]);
      } else {
        *reinterpret_cast<float2*>(row + c * 8 + tig * 2) = make_float2(o[c][0], o[c][1]);
      }
    }
    __syncthreads();
  }
  auto row_max = [&](int r) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sRow[1][w * kRows + r]);
    return mx;
  };
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    float x = 0.f;
    if constexpr (kStage == kFull) {
      const float mx = row_max(r);
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        x += exp2f((sRow[1][w * kRows + r] - mx) * kLog2e) * sO[(w * kRows + r) * D + dd];
    } else if (dd == 0) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += sRow[0][w * kRows + r];
    }
    dst[idx] = x;
  }
  if (kSoftmax && tid < kRows) {
    const float mx = row_max(tid);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += exp2f((sRow[1][w * kRows + tid] - mx) * kLog2e) * sRow[2][w * kRows + tid];
    p.stats[(split_row0 + tid) * 2] = mx;
    p.stats[(split_row0 + tid) * 2 + 1] = l;
  }
  if (p.splits == 1) return;

  // The last block of this (kv head, batch) merges the splits' rows into
  // out, in split order, and resets the counter for the next launch.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(p.sems + bh, 1);
    sLast = done == p.splits - 1;
    if (sLast) p.sems[bh] = 0;
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  const size_t r0 = (size_t)bh * p.splits * kRows;  // split 0's row 0
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    float mx = -INFINITY;
    if constexpr (kStage == kFull)
      for (int j = 0; j < p.splits; ++j) mx = fmaxf(mx, __ldcg(p.stats + (r0 + j * kRows + r) * 2));
    float x = 0.f;
    for (int j = 0; j < p.splits; ++j) {
      const float y = __ldcg(p.part + (r0 + j * kRows) * D + idx);
      if constexpr (kStage == kFull) {
        x += exp2f((__ldcg(p.stats + (r0 + j * kRows + r) * 2) - mx) * kLog2e) * y;
      } else {
        x += y;
      }
    }
    p.out[(size_t)bh * kRows * D + idx] = x;
  }
}

template <int kStage, bool kInt8, int D>
cudaError_t set_smem(int* smem) {
  auto kernel = decode_ladder_kernel<kStage, kInt8, D>;
  *smem = Layout<kInt8, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, as the decode kernel
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int kStage, bool kInt8, int D>
cudaError_t occupancy(int* blocks) {
  int smem = 0;
  cudaError_t err = set_smem<kStage, kInt8, D>(&smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_ladder_kernel<kStage, kInt8, D>, kThreads, smem);
}

template <int kStage, bool kInt8, int D>
cudaError_t launch(const Params& p, int b, cudaStream_t s) {
  int smem = 0;
  cudaError_t err = set_smem<kStage, kInt8, D>(&smem);
  if (err != cudaSuccess) return err;
  dim3 grid(b * p.hk, p.splits);
  decode_ladder_kernel<kStage, kInt8, D><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int kStage, bool kInt8>
cudaError_t by_dim(int d, const Params& p, int b, cudaStream_t s, int* blocks) {
  if (d == 64) return blocks ? occupancy<kStage, kInt8, 64>(blocks) : launch<kStage, kInt8, 64>(p, b, s);
  if (d == 128) return blocks ? occupancy<kStage, kInt8, 128>(blocks) : launch<kStage, kInt8, 128>(p, b, s);
  return cudaErrorInvalidValue;
}

template <bool kInt8>
cudaError_t by_stage(int stage, int d, const Params& p, int b, cudaStream_t s, int* blocks) {
  switch (stage) {
    case kDma: return by_dim<kDma, kInt8>(d, p, b, s, blocks);
    case kQk: return by_dim<kQk, kInt8>(d, p, b, s, blocks);
    case kCast: return by_dim<kCast, kInt8>(d, p, b, s, blocks);
    case kSoft: return by_dim<kSoft, kInt8>(d, p, b, s, blocks);
    case kPquant: return by_dim<kPquant, kInt8>(d, p, b, s, blocks);
    case kFull: return by_dim<kFull, kInt8>(d, p, b, s, blocks);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int stage, int int8, int d, const Params& p, int b, cudaStream_t s, int* blocks) {
  return int8 ? by_stage<true>(stage, d, p, b, s, blocks) : by_stage<false>(stage, d, p, b, s, blocks);
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of one (stage, type, d) that fit on an SM at once.
extern "C" int diag_decode_ladder_occupancy(int stage, int int8, int d, int* blocks) {
  Params p{};
  return dispatch(stage, int8, d, p, 0, nullptr, blocks);
}

// stage: 0 dma, 1 qk, 2 cast, 3 soft, 4 pquant, 5 full.  q (b, hk, 8, d)
// int8 (int8 = 1) or bf16; k, v (b, smax, hk * d) of the same type; out
// (b, hk, 8, d) fp32; stats (b, hk, splits, 8, 2) fp32.  With splits > 1,
// part (b, hk, splits, 8, d) fp32 holds the splits before the merge and
// sems b * hk zeroed int32 counters, which the kernel leaves zeroed.
// smax / splits must be a multiple of bk, bk of 64.  Returns
// cudaGetLastError() after the launch.
extern "C" int diag_decode_ladder(int stage, int int8, const void* q, const void* k,
                                  const void* v, float* out, float* part, float* stats, int* sems,
                                  int b, int hk, int smax, int d, int bk, int splits,
                                  void* stream) {
  if (b == 0) return 0;
  if (splits > 1 && (part == nullptr || sems == nullptr)) return cudaErrorInvalidValue;
  Params p{q, static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v), out, part,
           stats, sems, hk, smax, bk, splits, smax / splits};
  return dispatch(stage, int8, d, p, b, static_cast<cudaStream_t>(stream), nullptr);
}
