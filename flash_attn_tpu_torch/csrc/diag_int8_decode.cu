// Decode-body ladder for Hopper (sm_90a): the decode kernel's inner loop
// stripped one stage at a time, over int8 or bf16 K/V slabs (b, smax, hk*d)
// and 8 query rows a kv head.
//
// Replaces the Pallas TPU kernel benchmarks/diag_int8_decode.py::make_kernel
// (:37, launched at :144), a ladder over the slab layout of
// flash_attn_tpu/kernels/flash_decode.py::_decode_ref_kernel:
//   dma    : stream the K/V slabs, touch them once
//   qk     : + per-head Q K^T (int32 dp4a for int8, fp32 for bf16)
//   cast   : + score cast / scale to f32 (0.0883883)
//   soft   : + online-softmax update (max, exp2, sum; m/l state)
//   pquant : + P requantisation (rint(127 p) for int8, bf16 cast for bf16)
//   full   : + P V and the accumulator update (the whole decode body)
// Stages qk..pquant add one row sum into column 0 of each head's output;
// soft and pquant sum p against the running max of each key block without
// a rescale; full returns the unnormalised accumulator.  JAX's dma stage
// writes no output; here it returns, in column 0, the sum over key blocks of
// each block's first 8 key rows summed over d, K plus V (the port's own
// definition, held only against its plain twin).
//
// What bounds it on the H100: bytes.  Every stage reads each K/V row once
// (2 b smax hk d bytes per element size); the math is ~4 * 8 FLOPs per row
// element at most.
//
// What the design does about it, and how it follows csrc/flash_decode_ref.cu
// (the kernel whose time the stage deltas decompose): the same block per
// (split, kv head, batch), 8 warps, cp.async ring of 64-key tiles (kStages
// deep, 16 B a thread), thread per (row, key) scores with __dp4a int32 sums
// for int8 and fp32 FMAs for bf16, warp per row softmax with exp2f, thread
// per (row, dim) P V in int32 (int8) or fp32.  Two differences, both so that
// the ladder computes JAX's function: the running max moves once per key
// block of `bk` keys (JAX's grid block, 1024 by default), not per 64-key
// tile, so a block's scores are kept in shared memory until the block's max
// is known; and the ring therefore carries a block's K tiles, then its V
// tiles (each K/V byte is still read once).  A key split (grid y) fills the
// card; a second kernel merges the splits: exp2((m_j - M) log2 e) weights
// for full, plain sums otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;       // query rows a kv head (JAX's rows_n)
constexpr int kTileN = 64;     // keys per ring tile
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kThreads = 256;  // 8 warps: warp r owns row r in the softmax
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScale = 0.0883883f;
constexpr float kPvScale = (float)(0.0883883 / 127.0);

enum Stage { kDma = 0, kQk = 1, kCast = 2, kSoft = 3, kPquant = 4, kFull = 5 };

struct Params {
  const void* q;            // (b, hk, 8, D) int8 or bf16
  const unsigned char* k;   // (b, smax, hk * D)
  const unsigned char* v;
  float* out;               // (b, hk, 8, D), or (b, hk, splits, 8, D) partials
  float* m_part;            // (b, hk, splits, 8)
  int hk, smax, bk, splits, split_keys;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool kInt8, int D>
struct Layout {
  static constexpr int kBytes = kInt8 ? 1 : 2;
  static constexpr int kRowBytes = D * kBytes + 16;  // 16 B pad: no bank conflicts
  static constexpr int kChunks = D * kBytes / 16;    // 16 B chunks per key row
  static constexpr int kTileBytes = kTileN * kRowBytes;
  // fp32 words before the ring: q (as fp32, or int8 packed), acc0, m, l, alpha,
  // then the block's scores (8 x bk)
  static constexpr int kHead = kRows * D + 4 * kRows;
  static __host__ __device__ constexpr size_t smem_bytes(int bk) {
    return (size_t)(kHead + kRows * bk) * 4 + (size_t)kStages * kTileBytes;
  }
};

template <int kStage, bool kInt8, int D>
__global__ void __launch_bounds__(kThreads) decode_ladder_kernel(const Params p) {
  using L = Layout<kInt8, D>;
  constexpr int kRowBytes = L::kRowBytes, kChunks = L::kChunks;
  constexpr int kPer = kRows * D / kThreads;  // (row, dim) pairs a thread in P V

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sAcc0 = sQ + kRows * D;  // column 0 of the stages qk..pquant and dma
  float* sM = sAcc0 + kRows;
  float* sL = sM + kRows;
  float* sAlpha = sL + kRows;
  float* sS = sAlpha + kRows;     // (8, bk): the block's scores, then its p
  unsigned char* ring = smem + (size_t)(L::kHead + kRows * p.bk) * 4;

  const int split = blockIdx.y, kh = blockIdx.x % p.hk, bb = blockIdx.x / p.hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bk = p.bk, tiles = bk / kTileN;
  const int nblocks = p.split_keys / bk;
  const int key_base = split * p.split_keys;

  const size_t q_row0 = (size_t)(bb * p.hk + kh) * kRows * D;
  if constexpr (kInt8) {
    const int* qi = reinterpret_cast<const int*>(static_cast<const int8_t*>(p.q) + q_row0);
    int* sQi = reinterpret_cast<int*>(sQ);
    for (int i = tid; i < kRows * D / 4; i += kThreads) sQi[i] = qi[i];
  } else {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + q_row0;
    for (int i = tid; i < kRows * D; i += kThreads) sQ[i] = __bfloat162float(q[i]);
  }
  if (tid < kRows) {
    sAcc0[tid] = 0.f;
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  float acc[kPer], pv[kPer];
  int pvi[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    acc[e] = 0.f;
    pv[e] = 0.f;
    pvi[e] = 0;
  }

  // ring tile i: block i / (2 tiles), K (which 0) or V (1), tile i % tiles
  const int n_tiles = nblocks * 2 * tiles;
  const size_t key_stride = (size_t)p.hk * D * L::kBytes;
  auto fetch = [&](int i, int slot) {
    const int blk = i / (2 * tiles), which = (i / tiles) % 2, t = i % tiles;
    const int key0 = key_base + blk * bk + t * kTileN;
    const unsigned char* src = (which ? p.v : p.k) + ((size_t)bb * p.smax + key0) * key_stride +
                               (size_t)kh * D * L::kBytes;
    unsigned char* dst = ring + (size_t)slot * L::kTileBytes;
    for (int idx = tid; idx < kTileN * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 16;
      cp_async16(dst + r * kRowBytes + c, src + r * key_stride + c);
    }
  };

  int load = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (load < n_tiles) fetch(load++, s);
    cp_async_commit();
  }
  __syncthreads();  // q and the state are in shared memory

  for (int i = 0; i < n_tiles; ++i) {
    if (load < n_tiles) fetch(load++, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile i is in shared memory for every thread

    const unsigned char* sT = ring + (size_t)(i % kStages) * L::kTileBytes;
    const int which = (i / tiles) % 2, t = i % tiles;

    if constexpr (kStage == kDma) {
      if (t == 0) {  // touch the block's first 8 key rows: warp r, row r
        const unsigned char* row = sT + warp * kRowBytes;
        float s = 0.f;
        for (int c = lane; c < D; c += 32) {
          if constexpr (kInt8) {
            s += (float)reinterpret_cast<const int8_t*>(row)[c];
          } else {
            s += __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[c]);
          }
        }
        s = warp_sum(s);
        if (lane == 0) sAcc0[warp] += s;
      }
    } else if (which == 0) {
      // scores of the tile: thread per (row, key), neighbouring threads on
      // neighbouring keys
      for (int idx = tid; idx < kRows * kTileN; idx += kThreads) {
        const int r = idx / kTileN, j = idx % kTileN;
        const unsigned char* kr = sT + j * kRowBytes;
        float x;
        if constexpr (kInt8) {
          const int4* qr = reinterpret_cast<const int4*>(reinterpret_cast<const int8_t*>(sQ) + r * D);
          int a = 0;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int4 kw = *reinterpret_cast<const int4*>(kr + c * 16);
            const int4 qw = qr[c];
            a = __dp4a(qw.x, kw.x, a);
            a = __dp4a(qw.y, kw.y, a);
            a = __dp4a(qw.z, kw.z, a);
            a = __dp4a(qw.w, kw.w, a);
          }
          if constexpr (kStage == kQk) {
            reinterpret_cast<int*>(sS)[r * bk + t * kTileN + j] = a;
            continue;
          }
          x = (float)a * kScale;
        } else {
          const float* qr = sQ + r * D;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const uint4 u = *reinterpret_cast<const uint4*>(kr + c * 16);
            const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h2[e]);
              dot = fmaf(qr[c * 8 + 2 * e], f.x, dot);
              dot = fmaf(qr[c * 8 + 2 * e + 1], f.y, dot);
            }
          }
          x = kStage == kQk ? dot : dot * kScale;
        }
        sS[r * bk + t * kTileN + j] = x;
      }
      if (t == tiles - 1) {
        __syncthreads();  // the block's scores are complete
        // warp per row over the block's bk keys
        const int r = warp;
        float* sr = sS + r * bk;
        if constexpr (kStage == kQk && kInt8) {
          int a = 0;
          for (int j = lane; j < bk; j += 32) a += reinterpret_cast<const int*>(sr)[j];
          a = warp_sum_int(a);
          if (lane == 0) sAcc0[r] += (float)a;
        } else if constexpr (kStage == kQk || kStage == kCast) {
          float s = 0.f;
          for (int j = lane; j < bk; j += 32) s += sr[j];
          s = warp_sum(s);
          if (lane == 0) sAcc0[r] += s;
        } else {
          float mx = -INFINITY;
          for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, sr[j]);
          const float m_prev = sM[r];
          const float m_curr = fmaxf(m_prev, warp_max(mx));
          float psum = 0.f, qsum = 0.f;
          for (int j = lane; j < bk; j += 32) {
            const float pj = exp2f((sr[j] - m_curr) * kLog2e);
            psum += pj;
            if constexpr (kStage >= kPquant) {
              if constexpr (kInt8) {
                const int pq = __float2int_rn(pj * 127.f);
                qsum += (float)pq;
                if constexpr (kStage == kFull) reinterpret_cast<int*>(sr)[j] = pq;
              } else {
                const float pb = __bfloat162float(__float2bfloat16_rn(pj));
                qsum += pb;
                if constexpr (kStage == kFull) sr[j] = pb;
              }
            }
          }
          psum = warp_sum(psum);
          if constexpr (kStage == kPquant) qsum = warp_sum(qsum);
          if (lane == 0) {
            const float alpha = exp2f((m_prev - m_curr) * kLog2e);
            sL[r] = sL[r] * alpha + psum;
            sM[r] = m_curr;
            sAlpha[r] = alpha;
            if constexpr (kStage == kSoft) sAcc0[r] += psum;
            // JAX sums bf16 p in bf16: one rounding of the block's sum
            if constexpr (kStage == kPquant)
              sAcc0[r] += kInt8 ? qsum : __bfloat162float(__float2bfloat16_rn(qsum));
          }
        }
      }
    } else if constexpr (kStage == kFull) {
      // P V of the tile: thread per (row, dim), summed over the block
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int idx = e * kThreads + tid, r = idx / D, dd = idx % D;
        if constexpr (kInt8) {
          const int* pr = reinterpret_cast<const int*>(sS + r * bk + t * kTileN);
          const int8_t* vc = reinterpret_cast<const int8_t*>(sT) + dd;
          int s = 0;
#pragma unroll 16
          for (int j = 0; j < kTileN; ++j) s += pr[j] * (int)vc[j * kRowBytes];
          pvi[e] += s;
        } else {
          const float* pr = sS + r * bk + t * kTileN;
          const __nv_bfloat16* vc = reinterpret_cast<const __nv_bfloat16*>(sT) + dd;
          float s = pv[e];
#pragma unroll 16
          for (int j = 0; j < kTileN; ++j)
            s = fmaf(pr[j], __bfloat162float(vc[j * (kRowBytes / 2)]), s);
          pv[e] = s;
        }
      }
      if (t == tiles - 1) {  // the block's P V is complete
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int r = (e * kThreads + tid) / D;
          const float x = kInt8 ? (float)pvi[e] * kPvScale : pv[e];
          acc[e] = acc[e] * sAlpha[r] + x;
          pv[e] = 0.f;
          pvi[e] = 0;
        }
      }
    }
    __syncthreads();  // this tile's slot and the block's scores may be reused
  }
  cp_async_wait<0>();

  float* dst = p.out;
  if (p.splits > 1) {
    dst += (((size_t)(bb * p.hk + kh) * p.splits + split) * kRows) * D;
    if (tid < kRows) p.m_part[((size_t)(bb * p.hk + kh) * p.splits + split) * kRows + tid] = sM[tid];
  } else {
    dst += (size_t)(bb * p.hk + kh) * kRows * D;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = e * kThreads + tid, r = idx / D, dd = idx % D;
    float x;
    if constexpr (kStage == kFull) {
      x = acc[e];
    } else {
      x = dd == 0 ? sAcc0[r] : 0.f;
    }
    dst[idx] = x;
  }
}

// out[b, kh, r, d] from the splits' partials, in split order: full weighs
// split j by exp2((m_j - M) log2 e), M the largest m_j; other stages add.
template <bool kWeighted>
__global__ void merge_splits(const float* part, const float* m_part, float* out, int splits,
                             int rows_d, int d) {
  const int bh = blockIdx.x;
  for (int idx = threadIdx.x; idx < rows_d; idx += blockDim.x) {
    const int r = idx / d;
    const float* mp = m_part + (size_t)bh * splits * kRows + r;
    float mmax = -INFINITY;
    if (kWeighted)
      for (int j = 0; j < splits; ++j) mmax = fmaxf(mmax, mp[j * kRows]);
    float s = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float x = part[((size_t)bh * splits + j) * rows_d + idx];
      s += kWeighted ? exp2f((mp[j * kRows] - mmax) * kLog2e) * x : x;
    }
    out[(size_t)bh * rows_d + idx] = s;
  }
}

template <int kStage, bool kInt8, int D>
cudaError_t set_smem(int bk, int* smem) {
  *smem = (int)Layout<kInt8, D>::smem_bytes(bk);
  return cudaFuncSetAttribute(decode_ladder_kernel<kStage, kInt8, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <int kStage, bool kInt8, int D>
cudaError_t occupancy(int bk, int* blocks) {
  int smem = 0;
  cudaError_t err = set_smem<kStage, kInt8, D>(bk, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_ladder_kernel<kStage, kInt8, D>, kThreads, smem);
}

template <int kStage, bool kInt8, int D>
cudaError_t launch(const Params& p, int b, float* out, cudaStream_t s) {
  int smem = 0;
  cudaError_t err = set_smem<kStage, kInt8, D>(p.bk, &smem);
  if (err != cudaSuccess) return err;
  dim3 grid(b * p.hk, p.splits);
  decode_ladder_kernel<kStage, kInt8, D><<<grid, kThreads, smem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess || p.splits == 1) return err;
  if (kStage == kFull)
    merge_splits<true><<<b * p.hk, 256, 0, s>>>(p.out, p.m_part, out, p.splits, kRows * D, D);
  else
    merge_splits<false><<<b * p.hk, 256, 0, s>>>(p.out, p.m_part, out, p.splits, kRows * D, D);
  return cudaGetLastError();
}

template <int kStage, bool kInt8>
cudaError_t by_dim(int d, const Params& p, int b, float* out, cudaStream_t s, int* blocks) {
  if (d == 64)
    return blocks ? occupancy<kStage, kInt8, 64>(p.bk, blocks) : launch<kStage, kInt8, 64>(p, b, out, s);
  if (d == 128)
    return blocks ? occupancy<kStage, kInt8, 128>(p.bk, blocks) : launch<kStage, kInt8, 128>(p, b, out, s);
  return cudaErrorInvalidValue;
}

template <bool kInt8>
cudaError_t by_stage(int stage, int d, const Params& p, int b, float* out, cudaStream_t s,
                     int* blocks) {
  switch (stage) {
    case kDma: return by_dim<kDma, kInt8>(d, p, b, out, s, blocks);
    case kQk: return by_dim<kQk, kInt8>(d, p, b, out, s, blocks);
    case kCast: return by_dim<kCast, kInt8>(d, p, b, out, s, blocks);
    case kSoft: return by_dim<kSoft, kInt8>(d, p, b, out, s, blocks);
    case kPquant: return by_dim<kPquant, kInt8>(d, p, b, out, s, blocks);
    case kFull: return by_dim<kFull, kInt8>(d, p, b, out, s, blocks);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int stage, int int8, int d, const Params& p, int b, float* out,
                     cudaStream_t s, int* blocks) {
  return int8 ? by_stage<true>(stage, d, p, b, out, s, blocks)
              : by_stage<false>(stage, d, p, b, out, s, blocks);
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of one (stage, type, d, bk) that fit on an SM at once.
extern "C" int diag_decode_ladder_occupancy(int stage, int int8, int d, int bk, int* blocks) {
  Params p{};
  p.bk = bk;
  return dispatch(stage, int8, d, p, 0, nullptr, nullptr, blocks);
}

// stage: 0 dma, 1 qk, 2 cast, 3 soft, 4 pquant, 5 full.  q (b, hk, 8, d)
// int8 (int8 = 1) or bf16; k, v (b, smax, hk * d) of the same type; out
// (b, hk, 8, d) fp32.  With splits > 1, part (b, hk, splits, 8, d) and
// m_part (b, hk, splits, 8) fp32 hold the splits before the merge.
// smax / splits must be a multiple of bk, bk of 64.  Returns
// cudaGetLastError() after the launches.
extern "C" int diag_decode_ladder(int stage, int int8, const void* q, const void* k,
                                  const void* v, float* out, float* part, float* m_part, int b,
                                  int hk, int smax, int d, int bk, int splits, void* stream) {
  if (b == 0) return 0;
  Params p{q, static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v),
           splits > 1 ? part : out, m_part, hk, smax, bk, splits, smax / splits};
  return dispatch(stage, int8, d, p, b, out, static_cast<cudaStream_t>(stream), nullptr);
}
