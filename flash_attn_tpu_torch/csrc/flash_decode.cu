// Split-KV decode attention for Hopper (sm_90a), bf16 / fp16 KV cache,
// fp32 math.
//
// Replaces the Pallas TPU kernel flash_attn_tpu/kernels/flash_decode.py::
// _decode_kernel (launched at flash_decode.py:369 by decode_attn_bhsd) for
// contiguous (bc, hk, smax, d) caches.
//
// What bounds it on the H100: bytes.  One decode step reads every live K/V row
// of every (batch, kv head) once and does only ~4*g*sq FLOPs per byte pair, so
// the whole cost is streaming len*d*2 elements per (batch, kv head) from HBM.
//
// What the design does about it:
// * One block per (split, kv head, batch) reads each live K/V row exactly
//   once, for all g*sq packed query rows of that kv head at the same time (the
//   GQA packing of flash_decode.py:281: packed row r is query position r % sq
//   of head group r // sq), so GQA costs no extra cache traffic.
// * Rows are streamed in 64-key tiles with 16-byte coalesced loads; keys past
//   cache_seqlens, before a window's left edge and outside this split are
//   never read.
// * The math is small (rows x 64 dot products of length d per tile), so it
//   runs on CUDA cores in fp32 from shared memory: scores, then one warp per
//   row for the online softmax, then one thread per (row, dim) for P V.
// * num_splits > 1 cuts the key range into splits that run on separate SMs;
//   each writes fp32 partial O and LSE that the wrapper merges with
//   combine_attn_partials.  With num_splits = 1 (the default, as in the JAX
//   package) the grid is b * hk blocks.
// This first version loads each tile synchronously (no cp.async/TMA double
// buffering); overlapping the next tile's load with the current math is the
// first performance step.
//
// Masks use offset = cache_seqlens[b] - sq with causal / window / ALiBi /
// softcap as in the JAX kernel.  A row with no valid key in a split writes
// o = 0 and lse = +inf.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 64;     // keys per tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  float* o_part;    // (b, hk, splits, rows, d)
  float* lse_part;  // (b, hk, splits, rows)
  const int* seqlens;
  const int* cache_batch_idx;  // (b,) or null
  const float* alibi;          // (b, h) or null
  int b, h, hk, g, sq, rows, smax, splits, split_keys;
  float scale;
  int has_upper, wr, has_lower, wl;
  float softcap;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 x) { return __bfloat1622float2(x); }
__device__ __forceinline__ float2 to_float2(__half2 x) { return __half22float2(x); }

template <typename T> struct Vec2;
template <> struct Vec2<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Vec2<__half> { using type = __half2; };

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

// Shared-memory layout, in order: q (rows x D fp32), acc (rows x D fp32),
// scores / probabilities (rows x kTileN fp32), m, l, alpha (rows fp32 each),
// padded to 16 bytes; K tile (kTileN x (D+2) elements: odd word stride, so a
// warp reading one dim of 32 keys hits 32 banks); V tile (kTileN x D
// elements, 16-byte aligned for the vector stores).
template <int D>
__host__ __device__ constexpr int float_words(int rows) {
  return (rows * (2 * D + kTileN + 3) + 3) / 4 * 4;
}

template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes(int rows) {
  return (size_t)float_words<D>(rows) * sizeof(float) +
         (size_t)kTileN * (D + 2) * sizeof(T) + (size_t)kTileN * D * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const DecodeParams p) {
  using T2 = typename Vec2<T>::type;
  constexpr int kKStride = D + 2;
  constexpr int kChunks = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = p.rows;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sAcc = sQ + rows * D;
  float* sS = sAcc + rows * D;
  float* sM = sS + rows * kTileN;
  float* sL = sM + rows;
  float* sAlpha = sL + rows;
  T* sK = reinterpret_cast<T*>(sQ + float_words<D>(rows));
  T* sV = sK + kTileN * kKStride;

  const int split = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(p.seqlens[bb], p.smax);
  const int offset = len - p.sq;
  const int cb = p.cache_batch_idx ? p.cache_batch_idx[bb] : bb;

  // packed rows of this kv head are contiguous in q: heads kh*g .. kh*g+g-1
  const T* q = static_cast<const T*>(p.q) + (size_t)(bb * p.h + kh * p.g) * p.sq * D;
  const size_t kv_base = (size_t)(cb * p.hk + kh) * p.smax * D;
  const T* kc = static_cast<const T*>(p.k) + kv_base;
  const T* vc = static_cast<const T*>(p.v) + kv_base;

  for (int i = tid; i < rows * D; i += kThreads) {
    sQ[i] = to_float(q[i]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

  // key range of this split that any row can see
  int start = split * p.split_keys;
  int end = min(start + p.split_keys, len);
  if (p.has_lower) start = max(start, offset - p.wl);
  start = max(start, 0);

  for (int col0 = start; col0 < end; col0 += kTileN) {
    const int valid = min(kTileN, end - col0);
    __syncthreads();  // previous tile's K/V/P are no longer read
    for (int idx = tid; idx < kTileN * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (r < valid) {
        kv = *reinterpret_cast<const uint4*>(kc + (size_t)(col0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vc + (size_t)(col0 + r) * D + c);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(sK + r * kKStride + c);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<uint4*>(sV + r * D + c) = vv;
    }
    __syncthreads();

    // scores: thread per (row, key), consecutive threads on consecutive keys
    for (int idx = tid; idx < rows * kTileN; idx += kThreads) {
      const int r = idx / kTileN, j = idx % kTileN;
      const int col = col0 + j;
      const int pos = r % p.sq;
      const float* qr = sQ + r * D;
      const T2* kr = reinterpret_cast<const T2*>(sK + j * kKStride);
      float dot = 0.f;
#pragma unroll 8
      for (int i = 0; i < D / 2; ++i) {
        const float2 kf = to_float2(kr[i]);
        dot = fmaf(qr[2 * i], kf.x, fmaf(qr[2 * i + 1], kf.y, dot));
      }
      float x = dot * p.scale;
      if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      if (p.alibi) {
        const float slope = p.alibi[bb * p.h + kh * p.g + r / p.sq];
        x -= slope * fabsf((float)(pos + offset - col));
      }
      bool masked = j >= valid;
      if (p.has_upper) masked |= col > pos + offset + p.wr;
      if (p.has_lower) masked |= col < pos + offset - p.wl;
      sS[idx] = masked ? -INFINITY : x;
    }
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int r = warp; r < rows; r += kWarps) {
      float* sr = sS + r * kTileN;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(x0 - m_use), p1 = expf(x1 - m_use);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V: thread per (row, dim)
    for (int idx = tid; idx < rows * D; idx += kThreads) {
      const int r = idx / D, dd = idx % D;
      const float* pr = sS + r * kTileN;
      float a = sAcc[idx] * sAlpha[r];
#pragma unroll 8
      for (int j = 0; j < kTileN; ++j) a = fmaf(pr[j], to_float(sV[j * D + dd]), a);
      sAcc[idx] = a;
    }
  }
  __syncthreads();

  const size_t part = ((size_t)(bb * p.hk + kh) * p.splits + split) * rows;
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const float l = sL[idx / D];
    p.o_part[part * D + idx] = l > 0.f ? sAcc[idx] / l : 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    const float l = sL[r];
    p.lse_part[part + r] = l > 0.f ? sM[r] + logf(l) : INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  const int smem = (int)smem_bytes<T, D>(p.rows);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.splits, p.hk, p.b);
  flash_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = bf16, 1 = fp16.  Returns cudaGetLastError() after the launch.
extern "C" int flash_decode(const void* q, const void* k_cache,
                            const void* v_cache, float* o_part,
                            float* lse_part, const int* cache_seqlens,
                            const int* cache_batch_idx, const float* alibi,
                            int b, int h, int hk, int sq, int d, int smax,
                            int num_splits, int split_keys, int dtype,
                            float scale, int has_upper, int wr, int has_lower,
                            int wl, float softcap, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  const int g = h / hk;
  DecodeParams p{q, k_cache, v_cache, o_part, lse_part, cache_seqlens,
                 cache_batch_idx, alibi, b, h, hk, g, sq, g * sq, smax,
                 num_splits, split_keys, scale, has_upper, wr, has_lower, wl,
                 softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 0 && d == 128) return launch<__nv_bfloat16, 128>(p, s);
  if (dtype == 1 && d == 64) return launch<__half, 64>(p, s);
  if (dtype == 1 && d == 128) return launch<__half, 128>(p, s);
  return cudaErrorInvalidValue;
}
