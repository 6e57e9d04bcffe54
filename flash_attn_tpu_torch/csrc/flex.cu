// Block-sparse programmable attention for Hopper (sm_90a): forward, dQ and
// dK/dV kernels, bf16 / fp16 in, fp32 accumulate.
//
// Replaces the Pallas TPU kernels of flash_attn_tpu/kernels/flex.py:
// * flex_fwd_kernel: _flex_fwd_sched_kernel (:430, launched at :868) and
//   _flex_fwd_hb_kernel (:521, launched at :741), which compute the same
//   function (the second for head-invariant masks, HB heads a grid tick);
// * flex_bwd_dq_kernel: _flex_bwd_dq_kernel (:912, launched at :1204), with
//   the attn_bias gradient;
// * flex_bwd_dkv_kernel: _flex_bwd_dkv_kernel (:1010, launched at :1290).
//
// What bounds them on the H100: operations.  Each listed (q block, kv block)
// pair costs 4*d FLOPs per (row, key) forward and 6*d + 8*d backward, against
// q, k, v, o bytes read or written about once; at the shapes of the flex path
// (d = 128, blocks of 128) that is far above the card's ~295 FLOP/byte
// balance point.
//
// What the design does about it, first version:
// * The TPU kernels walk a flattened (b, h, T) table of tile steps on a
//   sequential grid (flex.py::_flex_schedule:360).  Here one block of 4 warps
//   owns one 64-row tile of one q block of one (head, batch) and walks that
//   q block's lists itself: full_kv_idx[:full_kv_num], then
//   kv_idx[:kv_num], each listed block_k-wide block in 64-key tiles.  So
//   skipped blocks cost nothing, and no schedule is built.  Head-invariant
//   tables (one head) are read with head stride 0, which is all the
//   head-blocked TPU kernel is for here: its HB-head pipelining feeds the
//   MXU, and a CUDA block per head fills the SMs instead.
// * Both products run on the tensor cores with mma.sync.m16n8k16 (the
//   dense kernels' fragments, fa_common.cuh); each warp owns 16 rows, so
//   S = Q K^T and O += P V stay in registers.  Online softmax in fp32 on
//   exp2, as flash_fwd.cu.
// * The mask: a partial block reads one bit per (row, key) from `bits`,
//   which the wrapper filled by evaluating the Python mask_mod once per call
//   over the partial blocks (a CUDA kernel cannot call it); full blocks read
//   nothing.  Keys at or past sk are never attended.
// * The score: s * scale, + attn_bias (fp32, read from device memory),
//   then the compiled-in score mod (softcap or relative position), in fp32,
//   in JAX's order (_mod_score, flex.py:903).  The backward multiplies dS by
//   the mod's derivative, in place of the TPU kernels' in-kernel jax.vjp.
// * The backward is the deterministic recompute split of flash_bwd.cu: the
//   dQ kernel walks the kv lists and writes dQ (and the dbias tiles of the
//   blocks it visits) once; the dK/dV kernel, one block of 8 warps per
//   64-key tile of one kv block of one (kv head, batch), walks each query
//   head of its GQA group's full_q and q lists in a fixed order and keeps dK,
//   dV in registers.  No atomics: the result is bitwise deterministic.
// * Calls with neither a score mod nor a bias run kernels compiled apart
//   (kMods = false), free of the per-element branches on the mod and the
//   bias, which cost the mask-only case a third of its time on an H100.
// Tiles load synchronously (no cp.async/TMA, no wgmma); that is later work.
//
// Layouts: q, k, v, do (b, s, heads, d) read in place through their batch,
// row and head strides; o and dq (b, sq, h, d), dk and dv (b, sk, hk, d)
// contiguous; lse and delta (b, h, sq) fp32; bias (b|1, h|1, sq, sk) fp32
// with stride 0 on a broadcast dimension, dbias (b, h, sq, sk).  Tables are
// (b, th, n_major, len) int32, th = 1 or h; slot (b, th, nq, nk) numbers the
// partial pairs, whose bits are (slot, bq, bk / 32) words.

#include "fa_common.cuh"

namespace {

using namespace fa;

constexpr int kTile = 64;          // q rows and keys per tile
constexpr int kThreads = 128;      // forward and dQ: 4 warps x 16 rows
constexpr int kDkvThreads = 256;   // dK/dV: 8 warps
constexpr int kPStride = kTile + 8;  // shared P^T / dS^T row stride

enum { kModNone = 0, kModSoftcap = 1, kModRelPos = 2 };

// Field for field as flex.py's _Params (checked at load by flex_params_size).
struct FlexParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const void* dout;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* dbias;
  const float* bias;
  const float* slopes;
  const int* kv_num;
  const int* kv_idx;
  const int* full_kv_num;
  const int* full_kv_idx;
  const int* q_num;
  const int* q_idx;
  const int* full_q_num;
  const int* full_q_idx;
  const int* slot;
  const uint32_t* bits;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, bias_sb, bias_sh, bias_ss;
  int b, h, hk, sq, sk, bq, bk, nq, nk, th;
  int l_kv_part, l_kv_full, l_q_part, l_q_full, words, mod;
  float scale, softcap;
};

// The score before the mask, in natural units: s * scale + bias, then the
// score mod.  *dmod is the mod's derivative.  kMods is false for a call
// with neither a score mod nor a bias: the kernels are compiled apart for
// it, so the plain masked case carries no per-element branch.
template <bool kMods>
__device__ __forceinline__ float flex_score(const FlexParams& p, float s,
                                            const float* bias_bh, float slope,
                                            int row, int col, float* dmod) {
  float x = s * p.scale;
  if constexpr (!kMods) {
    *dmod = 1.f;
    return x;
  }
  if (bias_bh != nullptr && row < p.sq && col < p.sk)
    x += bias_bh[row * p.bias_ss + col];
  *dmod = 1.f;
  if (p.mod == kModSoftcap) {
    const float t = tanhf(x / p.softcap);
    *dmod = 1.f - t * t;
    return t * p.softcap;
  }
  if (p.mod == kModRelPos) return x - slope * fabsf((float)(row - col));
  return x;
}

__device__ __forceinline__ bool bit_set(const uint32_t* row_words, int c) {
  return (row_words[c >> 5] >> (c & 31)) & 1u;
}

// The kv list of (bb, hq, qi): n_full full blocks then n_part partial ones.
struct KvList {
  const int* full;
  const int* part;
  const int* slot;  // slot of (qi, kv block), -1 if not partial
  int n_full, n_part;
};

__device__ __forceinline__ KvList kv_list(const FlexParams& p, int bb, int hq,
                                          int qi) {
  const int ht = p.th == 1 ? 0 : hq;
  const size_t t = ((size_t)bb * p.th + ht) * p.nq + qi;
  return KvList{p.full_kv_idx + t * p.l_kv_full, p.kv_idx + t * p.l_kv_part,
                p.slot + t * p.nk, p.full_kv_num[t], p.kv_num[t]};
}

__device__ __forceinline__ const float* bias_head(const FlexParams& p, int bb,
                                                  int hq) {
  return p.bias ? p.bias + bb * p.bias_sb + hq * p.bias_sh : nullptr;
}

template <typename T, int D, bool kMods>
__global__ void __launch_bounds__(kThreads)
    flex_fwd_kernel(const FlexParams p) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kOTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kTile * kStride;
  T* sV = sK + kTile * kStride;

  const int sub_q = p.bq / kTile;
  const int qi = blockIdx.x / sub_q;
  const int row0 = qi * p.bq + (blockIdx.x % sub_q) * kTile;
  const int hq = blockIdx.y, bb = blockIdx.z;
  if (row0 >= p.sq) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int hkv = hq / (p.h / p.hk);
  const KvList L = kv_list(p, bb, hq, qi);
  const float* bias_bh = bias_head(p, bb, hq);
  const float slope = p.mod == kModRelPos ? p.slopes[hq] : 0.f;

  const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hq * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + hkv * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + hkv * p.v_sh;
  load_rows<T, D, kTile, kThreads>(sQ, q + row0 * p.q_ss, p.sq - row0,
                                   (int)p.q_ss);
  __syncthreads();

  const int r_lo = warp * 16 + gid;
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    load_a(qf[kk], sQ + warp * 16 * kStride + kk * 16, kStride, gid, tig);

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // log2 units
  float l_run[2] = {0.f, 0.f};
  const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};
  // bit rows of this thread's two rows within the q block
  const int brow[2] = {rows[0] - qi * p.bq, rows[1] - qi * p.bq};

  for (int j = 0; j < L.n_full + L.n_part; ++j) {
    const bool partial = j >= L.n_full;
    const int kb = partial ? L.part[j - L.n_full] : L.full[j];
    const uint32_t* bits =
        partial ? p.bits + (size_t)L.slot[kb] * p.bq * p.words : nullptr;
    for (int u = 0; u < p.bk / kTile; ++u) {
      const int col0 = kb * p.bk + u * kTile;
      if (col0 >= p.sk) break;
      __syncthreads();  // every warp is done with the previous K/V tile
      load_rows<T, D, kTile, kThreads>(sK, k + col0 * p.k_ss, p.sk - col0,
                                       (int)p.k_ss);
      load_rows<T, D, kTile, kThreads>(sV, v + col0 * p.v_ss, p.sk - col0,
                                       (int)p.v_ss);
      __syncthreads();

      float s[kTile / 8][4];
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj) {
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t bfrag[2];
          load_b_t(bfrag, sK + jj * 8 * kStride + kk * 16, kStride, gid, tig);
          Mma<T>::mma(s[jj], qf[kk], bfrag);
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = u * kTile + jj * 8 + tig * 2 + (e & 1);  // in block
          const int col = kb * p.bk + c;
          float dm;
          float x = flex_score<kMods>(p, s[jj][e], bias_bh, slope, rows[i],
                                      col, &dm);
          bool keep = col < p.sk;
          if (partial) keep = keep && bit_set(bits + brow[i] * p.words, c);
          x = keep ? x * kLog2e : -INFINITY;
          s[jj][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }

      float alpha[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = exp2f(m_run[i] - m_use[i]);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[jj][e] - m_use[e >> 1]);
          s[jj][e] = pe;
          l_run[e >> 1] += pe;
        }
      }

#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < kOTiles; ++n) {
          uint32_t bfrag[2];
          load_b(bfrag, sV + kk * 16 * kStride + n * 8, kStride, gid, tig);
          Mma<T>::mma(acc[n], a, bfrag);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.o);
  float* lse = p.lse + ((size_t)bb * p.h + hq) * p.sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    const int row = rows[i];
    if (row >= p.sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + (((size_t)bb * p.sq + row) * p.h + hq) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          Mma<T>::pack(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (tig == 0) lse[row] = l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : INFINITY;
  }
}

template <typename T, int D, bool kMods>
__global__ void __launch_bounds__(kThreads)
    flex_bwd_dq_kernel(const FlexParams p) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kTile * kStride;
  T* sK = sdO + kTile * kStride;
  T* sV = sK + kTile * kStride;

  const int sub_q = p.bq / kTile;
  const int qi = blockIdx.x / sub_q;
  const int row0 = qi * p.bq + (blockIdx.x % sub_q) * kTile;
  const int hq = blockIdx.y, bb = blockIdx.z;
  if (row0 >= p.sq) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int hkv = hq / (p.h / p.hk);
  const KvList L = kv_list(p, bb, hq, qi);
  const float* bias_bh = bias_head(p, bb, hq);
  float* dbias_bh =
      p.dbias ? p.dbias + ((size_t)bb * p.h + hq) * p.sq * p.sk : nullptr;
  const float slope = p.mod == kModRelPos ? p.slopes[hq] : 0.f;

  const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hq * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + bb * p.do_sb + hq * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + hkv * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + hkv * p.v_sh;
  load_rows<T, D, kTile, kThreads>(sQ, q + row0 * p.q_ss, p.sq - row0,
                                   (int)p.q_ss);
  load_rows<T, D, kTile, kThreads>(sdO, dout + row0 * p.do_ss, p.sq - row0,
                                   (int)p.do_ss);

  const int r_lo = warp * 16 + gid;
  const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};
  const int brow[2] = {rows[0] - qi * p.bq, rows[1] - qi * p.bq};
  const size_t loff = ((size_t)bb * p.h + hq) * p.sq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < p.sq;
    lse2[i] = in ? p.lse[loff + rows[i]] * kLog2e : INFINITY;
    dlt[i] = in ? p.delta[loff + rows[i]] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const T* sQw = sQ + warp * 16 * kStride;
  const T* sdOw = sdO + warp * 16 * kStride;
  for (int j = 0; j < L.n_full + L.n_part; ++j) {
    const bool partial = j >= L.n_full;
    const int kb = partial ? L.part[j - L.n_full] : L.full[j];
    const uint32_t* bits =
        partial ? p.bits + (size_t)L.slot[kb] * p.bq * p.words : nullptr;
    for (int u = 0; u < p.bk / kTile; ++u) {
      const int col0 = kb * p.bk + u * kTile;
      if (col0 >= p.sk) break;
      __syncthreads();
      load_rows<T, D, kTile, kThreads>(sK, k + col0 * p.k_ss, p.sk - col0,
                                       (int)p.k_ss);
      load_rows<T, D, kTile, kThreads>(sV, v + col0 * p.v_ss, p.sk - col0,
                                       (int)p.v_ss);
      __syncthreads();

      float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t aq[4], ado[4];
        load_a(aq, sQw + kk * 16, kStride, gid, tig);
        load_a(ado, sdOw + kk * 16, kStride, gid, tig);
#pragma unroll
        for (int jj = 0; jj < kTile / 8; ++jj) {
          uint32_t b[2];
          load_b_t(b, sK + jj * 8 * kStride + kk * 16, kStride, gid, tig);
          Mma<T>::mma(s[jj], aq, b);
          load_b_t(b, sV + jj * 8 * kStride + kk * 16, kStride, gid, tig);
          Mma<T>::mma(dp[jj], ado, b);
        }
      }

      // dS = p (dP - delta) times the mod's derivative; it is also dbias.
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = u * kTile + jj * 8 + tig * 2 + (e & 1);
          const int col = kb * p.bk + c;
          float dm;
          const float x = flex_score<kMods>(p, s[jj][e], bias_bh, slope,
                                            rows[i], col, &dm);
          bool keep = col < p.sk;
          if (partial) keep = keep && bit_set(bits + brow[i] * p.words, c);
          const float pe = keep ? exp2f(x * kLog2e - lse2[i]) : 0.f;
          const float ds = pe * (dp[jj][e] - dlt[i]) * dm;
          if constexpr (kMods) {
            if (dbias_bh != nullptr && rows[i] < p.sq && col < p.sk)
              dbias_bh[(size_t)rows[i] * p.sk + col] = ds;
          }
          s[jj][e] = ds;
        }
      }

      // dQ += dS K (the scale is applied once at the end)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < kDTiles; ++n) {
          uint32_t b[2];
          load_b(b, sK + kk * 16 * kStride + n * 8, kStride, gid, tig);
          Mma<T>::mma(acc[n], a, b);
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.sq) continue;
    T* drow = dq + (((size_t)bb * p.sq + rows[i]) * p.h + hq) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) =
          Mma<T>::pack(acc[n][2 * i] * p.scale, acc[n][2 * i + 1] * p.scale);
  }
}

template <typename T, int D, bool kMods>
__global__ void __launch_bounds__(kDkvThreads)
    flex_bwd_dkv_kernel(const FlexParams p) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kHTiles = D / 16;  // n-tiles of 8 columns in half of d
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * kStride;
  T* sQ = sV + kTile * kStride;
  T* sdO = sQ + kTile * kStride;
  T* sP = sdO + kTile * kStride;     // P^T (keys x q rows)
  T* sdS = sP + kTile * kPStride;    // dS^T
  float* sLse2 = reinterpret_cast<float*>(sdS + kTile * kPStride);
  float* sDelta = sLse2 + kTile;
  uint32_t* sBits = reinterpret_cast<uint32_t*>(sDelta + kTile);  // 64 x 2

  const int sub_k = p.bk / kTile;
  const int kb = blockIdx.x / sub_k;
  const int c_in = (blockIdx.x % sub_k) * kTile;  // first key in the block
  const int col0 = kb * p.bk + c_in;
  const int hkv = blockIdx.y, bb = blockIdx.z;
  if (col0 >= p.sk) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = p.h / p.hk;

  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + hkv * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + hkv * p.v_sh;
  load_rows<T, D, kTile, kDkvThreads>(sK, k + col0 * p.k_ss, p.sk - col0,
                                      (int)p.k_ss);
  load_rows<T, D, kTile, kDkvThreads>(sV, v + col0 * p.v_ss, p.sk - col0,
                                      (int)p.v_ss);

  // Phase A: this warp's 16 keys x 32 q rows of S^T and dP^T.
  const int kw = (warp & 3) * 16;
  const int qw = (warp >> 2) * 32;
  // Phase B: this warp's 16 keys x d/2 columns of dK and dV.
  const int dcol = (warp >> 2) * (D / 2);
  float dk_acc[kHTiles][4], dv_acc[kHTiles][4];
#pragma unroll
  for (int n = 0; n < kHTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const int hq = hkv * g + gi;
    const int ht = p.th == 1 ? 0 : hq;
    const size_t t = ((size_t)bb * p.th + ht) * p.nk + kb;
    const int n_full = p.full_q_num[t], n_part = p.q_num[t];
    const int* full = p.full_q_idx + t * p.l_q_full;
    const int* part = p.q_idx + t * p.l_q_part;
    const int* slot = p.slot + ((size_t)bb * p.th + ht) * p.nq * p.nk + kb;
    const float* bias_bh = bias_head(p, bb, hq);
    const float slope = p.mod == kModRelPos ? p.slopes[hq] : 0.f;
    const size_t loff = ((size_t)bb * p.h + hq) * p.sq;
    const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hq * p.q_sh;
    const T* dout =
        static_cast<const T*>(p.dout) + bb * p.do_sb + hq * p.do_sh;
    for (int j = 0; j < n_full + n_part; ++j) {
      const bool partial = j >= n_full;
      const int qi = partial ? part[j - n_full] : full[j];
      const uint32_t* bits =
          partial ? p.bits + (size_t)slot[(size_t)qi * p.nk] * p.bq * p.words
                  : nullptr;
      for (int tq = 0; tq < p.bq / kTile; ++tq) {
        const int row0 = qi * p.bq + tq * kTile;
        if (row0 >= p.sq) break;
        __syncthreads();  // every warp is done with the previous tiles
        load_rows<T, D, kTile, kDkvThreads>(sQ, q + row0 * p.q_ss,
                                            p.sq - row0, (int)p.q_ss);
        load_rows<T, D, kTile, kDkvThreads>(sdO, dout + row0 * p.do_ss,
                                            p.sq - row0, (int)p.do_ss);
        for (int r = threadIdx.x; r < kTile; r += kDkvThreads) {
          const bool in = row0 + r < p.sq;
          sLse2[r] = in ? p.lse[loff + row0 + r] * kLog2e : INFINITY;
          sDelta[r] = in ? p.delta[loff + row0 + r] : 0.f;
        }
        if (partial) {
          for (int r = threadIdx.x; r < 2 * kTile; r += kDkvThreads)
            sBits[r] = bits[(size_t)(tq * kTile + (r >> 1)) * p.words +
                            (c_in >> 5) + (r & 1)];
        }
        __syncthreads();

        float st[4][4], dpt[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[jj][e] = dpt[jj][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t ak[4], av[4];
          load_a(ak, sK + kw * kStride + kk * 16, kStride, gid, tig);
          load_a(av, sV + kw * kStride + kk * 16, kStride, gid, tig);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t b[2];
            load_b_t(b, sQ + (qw + jj * 8) * kStride + kk * 16, kStride, gid,
                     tig);
            Mma<T>::mma(st[jj], ak, b);
            load_b_t(b, sdO + (qw + jj * 8) * kStride + kk * 16, kStride, gid,
                     tig);
            Mma<T>::mma(dpt[jj], av, b);
          }
        }

        // Element e of n-tile jj: key kw + gid (+8 for e >= 2), q row
        // qw + jj*8 + tig*2 (+1 for odd e).
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int qc = qw + jj * 8 + tig * 2;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qr = qc + (e & 1);
            const int kr = kw + gid + 8 * (e >> 1);
            const int row = row0 + qr, col = col0 + kr;
            float dm;
            const float x = flex_score<kMods>(p, st[jj][e], bias_bh, slope,
                                              row, col, &dm);
            bool keep = col < p.sk;
            if (partial) keep = keep && bit_set(sBits + qr * 2, kr);
            const float pe = keep ? exp2f(x * kLog2e - sLse2[qr]) : 0.f;
            st[jj][e] = pe;
            dpt[jj][e] = pe * (dpt[jj][e] - sDelta[qr]) * dm;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = kw + gid + 8 * i;
            *reinterpret_cast<uint32_t*>(sP + key * kPStride + qc) =
                Mma<T>::pack(st[jj][2 * i], st[jj][2 * i + 1]);
            *reinterpret_cast<uint32_t*>(sdS + key * kPStride + qc) =
                Mma<T>::pack(dpt[jj][2 * i], dpt[jj][2 * i + 1]);
          }
        }
        __syncthreads();

        // Phase B: dV += P^T dO and dK += dS^T Q over the tile's 64 q rows.
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t ap[4], ads[4];
          load_a(ap, sP + kw * kPStride + kk * 16, kPStride, gid, tig);
          load_a(ads, sdS + kw * kPStride + kk * 16, kPStride, gid, tig);
#pragma unroll
          for (int n = 0; n < kHTiles; ++n) {
            uint32_t b[2];
            load_b(b, sdO + kk * 16 * kStride + dcol + n * 8, kStride, gid,
                   tig);
            Mma<T>::mma(dv_acc[n], ap, b);
            load_b(b, sQ + kk * 16 * kStride + dcol + n * 8, kStride, gid,
                   tig);
            Mma<T>::mma(dk_acc[n], ads, b);
          }
        }
      }
    }
  }

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = col0 + kw + gid + 8 * i;
    if (key >= p.sk) continue;
    const size_t base = (((size_t)bb * p.sk + key) * p.hk + hkv) * D + dcol +
                        tig * 2;
#pragma unroll
    for (int n = 0; n < kHTiles; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + n * 8) = Mma<T>::pack(
          dk_acc[n][2 * i] * p.scale, dk_acc[n][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv + base + n * 8) =
          Mma<T>::pack(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <typename T, int D, bool kMods>
cudaError_t launch_fwd(const FlexParams& p, cudaStream_t stream) {
  const int smem = 3 * kTile * (D + 8) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flex_fwd_kernel<T, D, kMods>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.nq * (p.bq / kTile), p.h, p.b);
  flex_fwd_kernel<T, D, kMods><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool kMods>
cudaError_t launch_dq(const FlexParams& p, cudaStream_t stream) {
  const int smem = 4 * kTile * (D + 8) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flex_bwd_dq_kernel<T, D, kMods>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.nq * (p.bq / kTile), p.h, p.b);
  flex_bwd_dq_kernel<T, D, kMods><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool kMods>
cudaError_t launch_dkv(const FlexParams& p, cudaStream_t stream) {
  const int smem = (4 * kTile * (D + 8) + 2 * kTile * kPStride) *
                       (int)sizeof(T) +
                   2 * kTile * (int)sizeof(float) +
                   2 * kTile * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      flex_bwd_dkv_kernel<T, D, kMods>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.nk * (p.bk / kTile), p.hk, p.b);
  flex_bwd_dkv_kernel<T, D, kMods><<<grid, kDkvThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum { kFwd, kDq, kDkv };

template <int kKind, typename T, int D, bool kMods>
cudaError_t launch_kind(const FlexParams& p, cudaStream_t s) {
  if constexpr (kKind == kFwd) return launch_fwd<T, D, kMods>(p, s);
  if constexpr (kKind == kDq) return launch_dq<T, D, kMods>(p, s);
  return launch_dkv<T, D, kMods>(p, s);
}

template <int kKind, typename T, int D>
cudaError_t launch(const FlexParams& p, cudaStream_t s) {
  if (p.mod != kModNone || p.bias != nullptr)
    return launch_kind<kKind, T, D, true>(p, s);
  return launch_kind<kKind, T, D, false>(p, s);
}

template <int kKind>
int dispatch(const FlexParams* params, int d, int dtype, void* stream) {
  const FlexParams& p = *params;
  if (p.b == 0 || p.h == 0 || p.sq == 0 || p.sk == 0) return 0;
  if (p.bq % kTile || p.bk % kTile || p.bk / 32 != p.words)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch<kKind, __nv_bfloat16, 64>(p, s);
  if (dtype == 0 && d == 128) return launch<kKind, __nv_bfloat16, 128>(p, s);
  if (dtype == 1 && d == 64) return launch<kKind, __half, 64>(p, s);
  if (dtype == 1 && d == 128) return launch<kKind, __half, 128>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int flex_params_size() { return (int)sizeof(FlexParams); }

// `params` points at a FlexParams (typed void here: the struct lives in this
// file's anonymous namespace, and a C entry point taking it would not be
// exported).  dtype: 0 = bf16, 1 = fp16.  Each returns cudaGetLastError()
// after its launch on `stream`.
extern "C" int flex_fwd(const void* params, int d, int dtype, void* stream) {
  return dispatch<kFwd>(static_cast<const FlexParams*>(params), d, dtype,
                        stream);
}

extern "C" int flex_bwd_dq(const void* params, int d, int dtype,
                           void* stream) {
  return dispatch<kDq>(static_cast<const FlexParams*>(params), d, dtype,
                       stream);
}

extern "C" int flex_bwd_dkv(const void* params, int d, int dtype,
                            void* stream) {
  return dispatch<kDkv>(static_cast<const FlexParams*>(params), d, dtype,
                        stream);
}
