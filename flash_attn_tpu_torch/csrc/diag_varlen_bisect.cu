// Fixed-cost bisect of the scheduled varlen forward for Hopper (sm_90a):
// kernels stripped level by level that walk (qi, ki, fl) tick tables over
// q, k, v (H, total, 128) bf16 with packed aux words (segment << 16 | pos).
//
// Replaces the Pallas TPU kernels of benchmarks/diag_varlen_overhead_bisect.py:
//   make_kernel (:36, launched at :144)   K0 empty body, K1 + table and aux
//       reads, K2 + the predicated init, K3 + one interior body, K4 the full
//       kernel (interior and boundary bodies, finalize);
//   launch2's kernel (:214, at :334)      K4 + four predicated bodies
//       (first / boundary; K6), an lse output (K7), both (K8); K5's cost
//       estimate has no CUDA counterpart and runs K4;
//   launch3's kernel (:412, at :485)      K9: four bodies chosen by
//       code == i from a fourth table;
//   launch4's kernel (:547, at :599)      K10: n identical bodies at block_h
//       = bh, the code in fl >> 4.
// What each level computes follows the JAX kernels: raw scores s = q k^T in
// fp32 (no scale), boundary ticks add -3e38 where seg_q != seg_k or
// pos_k < pos_q, p = exp2(s - m) with m from -1e30, P cast to bf16 for P V,
// finalize o = acc / (l, or 1 where l = 0).  K0..K8 initialise under
// first & empty, K9 and K10 under first.
//
// What a tick is on the card.  On the TPU a tick is one step of the
// sequential grid axis, a (block_h, 1024-row) q block against a 1024-key
// block in VMEM.  That does not fit a CTA's shared memory, so here a CTA per
// (64-row slice of the q block, head group) walks the whole tick table in
// order, as the TPU's grid does, and for each tick does what the JAX level
// does for its 64 rows: the table and aux reads, the init, the bodies over
// the key block in 64-key tiles, the finalize.  A tick therefore costs each
// of the bq / 64 CTAs of a head group one pass of this loop.
//
// What bounds it on the H100: for the probe's all-empty tables, nothing but
// the tables (the time is the fixed cost the probe is after); for a live
// tick, 4 * 64 * bk * 128 FLOPs a head and 64-row slice.  The bodies are
// plain fp32 FMAs over shared-memory tiles, simple and not fast: they only
// run in the live checks.  Shared memory is sized as the JAX scratch
// (acc, m, l for block_h heads) for every level but K0, which takes none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kSlice = 64;   // q rows a CTA
constexpr int kTileN = 64;   // keys a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStat = 8;     // q-aux lanes
constexpr int kPadRow = kD + 8;  // bf16 row stride in shared memory
constexpr int kSRow = kTileN + 4;  // fp32 score row stride
constexpr float kBias = -3e38f;
constexpr float kMInit = -1e30f;
constexpr int kFirst = 1, kLast = 2, kBound = 4, kEmpty = 8;

enum Variant { K0 = 0, K1, K2, K3, K4, K5, K6, K7, K8, K9, K10 };

struct Params {
  const int* qi;
  const int* ki;
  const int* fl;
  const int* code;  // K9
  const __nv_bfloat16* q;  // (H, total, 128)
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* qa;  // (total, kStat)
  const int* ka;  // (total / bk, kStat, bk)
  __nv_bfloat16* o;  // (H, total, 128)
  float* lse;        // (H, total), K7 / K8
  int total, bq, bk, bh, T;
};

struct Smem {
  float* acc;   // (bh, 64, D)
  float* m;     // (bh, 64)
  float* l;     // (bh, 64)
  float* alpha; // (64)
  __nv_bfloat16* q;  // (64, kPadRow)
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  float* s;     // (64, kSRow)
  int* qa;      // (64)
  int* ka;      // (bk)
};

__host__ __device__ inline size_t smem_bytes(int bh, int bk) {
  return (size_t)bh * kSlice * kD * 4 + (size_t)2 * bh * kSlice * 4 + kSlice * 4 +
         (size_t)3 * kSlice * kPadRow * 2 + (size_t)kSlice * kSRow * 4 + kSlice * 4 +
         (size_t)bk * 4;
}

__device__ inline Smem carve(unsigned char* base, int bh) {
  Smem s;
  s.acc = reinterpret_cast<float*>(base);
  s.m = s.acc + bh * kSlice * kD;
  s.l = s.m + bh * kSlice;
  s.alpha = s.l + bh * kSlice;
  s.q = reinterpret_cast<__nv_bfloat16*>(s.alpha + kSlice);
  s.k = s.q + kSlice * kPadRow;
  s.v = s.k + kSlice * kPadRow;
  s.s = reinterpret_cast<float*>(s.v + kSlice * kPadRow);
  s.qa = reinterpret_cast<int*>(s.s + kSlice * kSRow);
  s.ka = s.qa + kSlice;
  return s;
}

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

// 64 rows of 128 bf16 from global rows at `src` (row stride kD) into shared
// rows of kPadRow: 16 B a thread and copy.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  for (int idx = threadIdx.x; idx < kSlice * kD / 8; idx += kThreads) {
    const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * kPadRow + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * kD + c);
  }
}

// One body of the JAX levels for the CTA's 64 rows: for each of the bh heads,
// s = q k^T over the key block (plus the boundary bias with kMask), then the
// online-softmax update and P V into acc.  kFresh starts each head's state
// anew (m = -1e30, l = 0, acc = 0), which is the JAX `fresh` update.
template <bool kMask, bool kFresh>
__device__ __forceinline__ void body(const Params& p, const Smem& sm, int hb, int q0, int k0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int hh = 0; hh < p.bh; ++hh) {
    const int head = hb * p.bh + hh;
    float* acc = sm.acc + hh * kSlice * kD;
    float* mrow = sm.m + hh * kSlice;
    float* lrow = sm.l + hh * kSlice;
    if (kFresh) {
      for (int i = tid; i < kSlice * kD; i += kThreads) acc[i] = 0.f;
      if (tid < kSlice) {
        mrow[tid] = kMInit;
        lrow[tid] = 0.f;
      }
    }
    load_rows(sm.q, p.q + ((size_t)head * p.total + q0) * kD);
    for (int kt = 0; kt < p.bk / kTileN; ++kt) {
      const size_t key0 = (size_t)k0 + kt * kTileN;
      load_rows(sm.k, p.k + ((size_t)head * p.total + key0) * kD);
      load_rows(sm.v, p.v + ((size_t)head * p.total + key0) * kD);
      __syncthreads();

      // scores: thread per key j and rows rg, rg + 4, ..., rg + 60
      {
        const int j = tid % kTileN, rg = tid / kTileN;
        float s[kSlice / 4];
#pragma unroll
        for (int i = 0; i < kSlice / 4; ++i) s[i] = 0.f;
        for (int c = 0; c < kD; c += 8) {
          const uint4 ku = *reinterpret_cast<const uint4*>(sm.k + j * kPadRow + c);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&ku);
          float kf[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(k2[e]);
            kf[2 * e] = f.x;
            kf[2 * e + 1] = f.y;
          }
#pragma unroll
          for (int i = 0; i < kSlice / 4; ++i) {
            const uint4 qu =
                *reinterpret_cast<const uint4*>(sm.q + (rg + 4 * i) * kPadRow + c);
            const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qu);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(q2[e]);
              s[i] = fmaf(f.x, kf[2 * e], s[i]);
              s[i] = fmaf(f.y, kf[2 * e + 1], s[i]);
            }
          }
        }
        int seg_k = 0, pos_k = 0;
        if (kMask) {
          const int a = sm.ka[kt * kTileN + j];
          seg_k = (int)((unsigned)a >> 16);
          pos_k = a & 0xFFFF;
        }
#pragma unroll
        for (int i = 0; i < kSlice / 4; ++i) {
          const int r = rg + 4 * i;
          float x = s[i];
          if (kMask) {
            const int a = sm.qa[r];
            if ((int)((unsigned)a >> 16) != seg_k || pos_k < (a & 0xFFFF)) x = x + kBias;
          }
          sm.s[r * kSRow + j] = x;
        }
      }
      __syncthreads();

      // online softmax: warp per row, two keys a lane; P rounded to bf16
      for (int r = warp; r < kSlice; r += kWarps) {
        float* sr = sm.s + r * kSRow;
        const float x0 = sr[lane], x1 = sr[lane + 32];
        const float m_prev = mrow[r];
        const float m_curr = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
        const float p0 = exp2f(x0 - m_curr), p1 = exp2f(x1 - m_curr);
        const float psum = warp_sum(p0 + p1);
        sr[lane] = __bfloat162float(__float2bfloat16_rn(p0));
        sr[lane + 32] = __bfloat162float(__float2bfloat16_rn(p1));
        if (lane == 0) {
          const float alpha = exp2f(m_prev - m_curr);
          sm.alpha[r] = alpha;
          lrow[r] = lrow[r] * alpha + psum;
          mrow[r] = m_curr;
        }
      }
      __syncthreads();

      // acc = alpha acc + P V: thread per dim dd and rows rg, rg + 2, ...
      {
        const int dd = tid % kD, rg = tid / kD;
        float a[kSlice / 2];
#pragma unroll
        for (int i = 0; i < kSlice / 2; ++i) a[i] = 0.f;
        for (int j = 0; j < kTileN; ++j) {
          const float vj = __bfloat162float(sm.v[j * kPadRow + dd]);
#pragma unroll
          for (int i = 0; i < kSlice / 2; ++i) a[i] = fmaf(sm.s[(rg + 2 * i) * kSRow + j], vj, a[i]);
        }
#pragma unroll
        for (int i = 0; i < kSlice / 2; ++i) {
          const int r = rg + 2 * i;
          acc[r * kD + dd] = acc[r * kD + dd] * sm.alpha[r] + a[i];
        }
      }
      __syncthreads();  // tiles, scores and alpha may be refilled
    }
  }
}

template <int V, int kBodies>
__global__ void __launch_bounds__(kThreads) bisect_kernel(const Params p) {
  if constexpr (V == K0) {
    return;
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    const Smem sm = carve(smem, p.bh);
    const int sl = blockIdx.x, hb = blockIdx.y, tid = threadIdx.x;
    constexpr bool kAux = V != K10;
    constexpr bool kLse = V == K7 || V == K8;
    for (int t = 0; t < p.T; ++t) {
      const int qi = p.qi[t], ki = p.ki[t], fl = p.fl[t];
      const bool first = fl & kFirst, empty = fl & kEmpty, bound = fl & kBound,
                 last = fl & kLast, live = !empty;
      const int q0 = qi * p.bq + sl * kSlice, k0 = ki * p.bk;
      if (kAux) {  // the tick's aux prologue: q rows' words, the key row
        if (tid < kSlice) sm.qa[tid] = p.qa[(size_t)(q0 + tid) * kStat];
        for (int j = tid; j < p.bk; j += kThreads) sm.ka[j] = p.ka[(size_t)ki * kStat * p.bk + j];
        __syncthreads();
      }
      if constexpr (V == K1) {
        if (first && empty && tid < kSlice) {
          const int a = sm.qa[tid], b = sm.ka[0];
          sm.m[tid] = (float)((a & 0xFFFF) + (b & 0xFFFF) + (int)((unsigned)a >> 16) +
                              (int)((unsigned)b >> 16));
        }
      } else {
        const bool init = V >= K9 ? first : (first && empty);
        if (init) {
          for (int i = tid; i < p.bh * kSlice * kD; i += kThreads) sm.acc[i] = 0.f;
          for (int i = tid; i < p.bh * kSlice; i += kThreads) {
            sm.m[i] = kMInit;
            sm.l[i] = 0.f;
          }
        }
        __syncthreads();
        if constexpr (V == K3) {
          if (live) body<false, false>(p, sm, hb, q0, k0);
        } else if constexpr (V == K4 || V == K7) {
          if (live && !bound) body<false, false>(p, sm, hb, q0, k0);
          if (live && bound) body<true, false>(p, sm, hb, q0, k0);
        } else if constexpr (V == K6 || V == K8) {
          if (live && first && !bound) body<false, true>(p, sm, hb, q0, k0);
          if (live && first && bound) body<true, true>(p, sm, hb, q0, k0);
          if (live && !first && !bound) body<false, false>(p, sm, hb, q0, k0);
          if (live && !first && bound) body<true, false>(p, sm, hb, q0, k0);
        } else if constexpr (V == K9) {
          const int code = p.code[t];
          if (code == 0) body<false, false>(p, sm, hb, q0, k0);
          if (code == 1) body<true, false>(p, sm, hb, q0, k0);
          if (code == 2) body<false, true>(p, sm, hb, q0, k0);
          if (code == 3) body<true, true>(p, sm, hb, q0, k0);
        } else if constexpr (V == K10) {
          const int code = (int)((unsigned)fl >> 4);
#pragma unroll
          for (int idx = 0; idx < kBodies; ++idx)
            if (code == idx) body<false, false>(p, sm, hb, q0, k0);
        }
        if (V != K2 && last) {
          for (int hh = 0; hh < p.bh; ++hh) {
            const int head = hb * p.bh + hh;
            const float* acc = sm.acc + hh * kSlice * kD;
            const float* lrow = sm.l + hh * kSlice;
            for (int i = tid; i < kSlice * kD; i += kThreads) {
              const int r = i / kD;
              const float l = lrow[r];
              const float ls = l == 0.f ? 1.f : l;
              p.o[((size_t)head * p.total + q0 + r) * kD + i % kD] =
                  __float2bfloat16_rn(acc[i] / ls);
            }
            if (kLse && tid < kSlice) {
              const float l = lrow[tid];
              const float ls = l == 0.f ? 1.f : l;
              p.lse[(size_t)head * p.total + q0 + tid] = sm.m[hh * kSlice + tid] + logf(ls);
            }
          }
        }
      }
      __syncthreads();  // the next tick rewrites the aux and the state
    }
  }
}

template <int V, int kBodies>
cudaError_t launch(const Params& p, int heads, int empty_ctas, cudaStream_t s) {
  const int smem = V == K0 ? 0 : (int)smem_bytes(p.bh, p.bk);
  cudaError_t err = cudaFuncSetAttribute(bisect_kernel<V, kBodies>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.bq / kSlice, heads / p.bh, empty_ctas ? p.T : 1);
  bisect_kernel<V, kBodies><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// variant: 0..10 for K0..K10; n_bodies (K10): 1..4; empty_ctas (K0 only):
// one CTA per (tick, head group, row slice).  q, k, v, o (heads, total,
// 128) bf16; qa (total, 8), ka (total / bk, 8, bk) int32 (null for K10);
// code (T,) for K9; lse (heads, total) fp32 for K7 / K8.  Returns
// cudaGetLastError() after the launch.
extern "C" int diag_varlen_bisect(int variant, int n_bodies, int empty_ctas, const int* qi,
                                  const int* ki, const int* fl, const int* code, const void* q,
                                  const void* k, const void* v, const int* qa, const int* ka,
                                  void* o, float* lse, int heads, int total, int d, int bq,
                                  int bk, int bh, int T, void* stream) {
  if (d != kD || bq % kSlice || bk % kTileN || bh < 1 || bh > 4 || heads % bh) {
    return cudaErrorInvalidValue;
  }
  Params p{qi, ki, fl, code, static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), qa, ka,
           static_cast<__nv_bfloat16*>(o), lse, total, bq, bk, bh, T};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (empty_ctas && variant != K0) return cudaErrorInvalidValue;
  switch (variant) {
    case K0: return launch<K0, 0>(p, heads, empty_ctas, s);
    case K1: return launch<K1, 0>(p, heads, 0, s);
    case K2: return launch<K2, 0>(p, heads, 0, s);
    case K3: return launch<K3, 0>(p, heads, 0, s);
    case K4: return launch<K4, 0>(p, heads, 0, s);
    case K5: return launch<K4, 0>(p, heads, 0, s);  // no cost estimate here
    case K6: return launch<K6, 0>(p, heads, 0, s);
    case K7: return launch<K7, 0>(p, heads, 0, s);
    case K8: return launch<K8, 0>(p, heads, 0, s);
    case K9: return launch<K9, 0>(p, heads, 0, s);
    case K10:
      switch (n_bodies) {
        case 1: return launch<K10, 1>(p, heads, 0, s);
        case 2: return launch<K10, 2>(p, heads, 0, s);
        case 3: return launch<K10, 3>(p, heads, 0, s);
        case 4: return launch<K10, 4>(p, heads, 0, s);
      }
  }
  return cudaErrorInvalidValue;
}
