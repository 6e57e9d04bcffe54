// Flash-attention backward for Hopper (sm_90a), bf16 / fp16 in, fp32 accumulate.
//
// Replaces the Pallas TPU kernels flash_attn_tpu/kernels/flash_bwd.py::
// _bwd_dq_kernel (:121, launched at :1185) and _bwd_dkv_kernel (:232, launched
// at :1230), and serves the calls the JAX package sends to the fused kernels
// _bwd_fused_kernel (:507) and _bwd_fused_sched_kernel (:851): all four compute
// (dq, dk, dv) from (do, q, k, v, lse, delta).  Its varlen mode
// (flash_bwd_varlen) replaces the packed varlen backward
// flash_attn_tpu/kernels/varlen_sched.py::_varlen_bwd_kernel (:643, launched
// at :874).
//
// Why two kernels and not one fused pass: the TPU's fused kernels keep a whole
// head's dQ in VMEM across a grid that runs in order on one core.  On Hopper
// blocks run in parallel and in no order, so a single pass would have to sum
// dQ across blocks with atomics (non-deterministic) or through a second pass
// over a large partial buffer.  The recompute split needs neither:
// * flash_bwd_dkv_kernel: one block of 8 warps per (batch, kv head, 64-key
//   tile).  It loops over the g query heads of its GQA group and over the q
//   tiles the masks leave live (_q_block_bounds, flash_bwd.py:214), keeps dK
//   and dV in fp32 registers and writes each once, so the GQA group is
//   reduced inside the kernel.
// * flash_bwd_dq_kernel: one block of 4 warps per (batch, head, 64-row q
//   tile); it loops over the live key tiles (_kv_block_bounds) and writes dQ
//   once.
// No atomics and no order between blocks: the result is bitwise
// deterministic.  The price is recomputing S and dP in both kernels: 7 tile
// products (S, dP, dQ; S, dP, dV, dK) against the minimal 5.
//
// What bounds it on the H100: operations.  The minimal backward does 10*d
// FLOPs per live (row, key) pair and head against ~(4 sq + 4 sk) * d bytes per
// head; at the GPT-2 training shape that is ~32 GFLOP against ~0.1 GB, far
// above the card's ~295 FLOP/byte balance point.
//
// What the design does about it: every product runs on the tensor cores with
// mma.sync.m16n8k16.  In the dq kernel each warp owns 16 q rows, and dS goes
// from the S accumulators straight into the A operand of dQ += dS K.  In the
// dkv kernel S^T and dP^T are computed by 8 warps (16 keys x 32 q rows each)
// and written to shared memory as P^T and dS^T, so that the 8 warps can then
// split dV += P^T dO and dK += dS^T Q by key rows and by halves of d: each
// thread holds d/2 fp32 accumulators, not 2d, which keeps d = 128 free of
// spills.  Tiles are loaded synchronously (no cp.async/TMA, no wgmma); that
// and a fused deterministic design are later work.
//
// Semantics: the scores are recomputed with fa_common.cuh's ScoreMod, the
// forward's own arithmetic, and p = exp2(score - lse * log2(e)).  A row with
// lse = +inf gives p = 0 and dq = 0, keys at or past seqused_k get dk = dv = 0,
// and rows at or past seqused_q are masked out (the callers pass do = 0
// there).  dS carries the softcap derivative 1 - tanh^2 and the softmax scale
// is applied once to dQ and dK at the end.
//
// Varlen mode: the packed (total, h, d) streams are read and written in
// place, as in flash_fwd.cu's varlen mode (fa_common.cuh's SeqLayout), with
// lse and delta (h, total_q).  The dkv grid is (cdiv(max_seqlen_k, 64), hk,
// b) and the dq grid (cdiv(max_seqlen_q, 64), h, b); blocks past their
// sequence's length exit at once.  The TPU kernel is dK/dV-stationary over
// a device-built tile table and sums dQ for the whole stream in VMEM
// scratch, falling back to the padded dense backward when that scratch
// outgrows VMEM (varlen_sched.py:983-1037); that limit is the TPU's memory,
// not part of the function, and the two kernels here cover every size.
// Keys that no query sees get dk = dv = 0; tokens outside every sequence are
// not written.

#include "fa_common.cuh"

namespace {

using namespace fa;

constexpr int kBlockM = 64;        // q rows per tile
constexpr int kBlockN = 64;        // keys per tile
constexpr int kDqThreads = 128;    // dq kernel: 4 warps x 16 q rows
constexpr int kDkvThreads = 256;   // dkv kernel: 8 warps
constexpr int kPStride = kBlockM + 8;  // shared P^T / dS^T row stride

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b, h, sq), natural log
  const float* delta;  // (b, h, sq): rowsum(dO * O) - dlse
  void* dq;
  void* dk;
  void* dv;
  // dense: seqused_q/k (b,); varlen: cu_seqlens_q/k (b + 1,)
  const int* lens_q;
  const int* lens_k;
  const float* alibi;  // (b, h) or null
  int b, h, hk, g, sq, sk;  // varlen: sq, sk are the max lengths
  float scale;
  int has_upper, wr, has_lower, wl;
  float softcap;
  int total_q;  // varlen: the head stride of lse and delta
};

__device__ __forceinline__ ScoreMod score_mod(const BwdParams& p, int bb,
                                              int hq, int offset, int sk_b) {
  return ScoreMod{p.scale, p.softcap,
                  p.alibi ? p.alibi[bb * p.h + hq] : 0.f, p.alibi != nullptr,
                  offset, sk_b, p.has_upper, p.wr, p.has_lower, p.wl};
}

// p and dS of one score: p = exp2(score - lse2) (0 on rows past seqused_q),
// dS = p (dP - delta), times the softcap derivative.
__device__ __forceinline__ void p_and_ds(const ScoreMod& sm, float s, float dp,
                                         int row, int col, int sq_b,
                                         float lse2, float delta, float* pe,
                                         float* ds) {
  const float xc = sm.capped(s);
  const float x = sm.log2_score(xc, row, col);
  const float pv = row < sq_b ? exp2f(x - lse2) : 0.f;
  float d = pv * (dp - delta);
  if (sm.softcap > 0.f) {
    const float t = xc / sm.softcap;
    d *= 1.f - t * t;
  }
  *pe = pv;
  *ds = d;
}

template <typename T, int D, bool kVarlen>
__global__ void __launch_bounds__(kDqThreads)
    flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;  // k-steps of S = Q K^T and dP = dO V^T
  constexpr int kDTiles = D / 8;   // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kBlockM * kStride;
  T* sK = sdO + kBlockM * kStride;
  T* sV = sK + kBlockN * kStride;

  const int qblk = blockIdx.x, hq = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int hkv = hq / p.g;
  const SeqLayout L = seq_layout<kVarlen>(p.lens_q, p.lens_k, bb, p.h, p.hk,
                                          p.sq, p.sk, p.total_q, D);
  const int row0 = qblk * kBlockM;
  if constexpr (kVarlen) {
    if (row0 >= L.q_rows) return;  // past this sequence's rows
  }
  const int sq_b = L.sq_b, sk_b = L.sk_b;
  const int offset = sk_b - sq_b;
  const ScoreMod sm = score_mod(p, bb, hq, offset, sk_b);

  const size_t qoff = L.q_head(hq), loff = L.l_head(hq);
  const T* q = static_cast<const T*>(p.q) + qoff;
  const T* dout = static_cast<const T*>(p.dout) + qoff;
  const T* k = static_cast<const T*>(p.k) + L.k_head(hkv);
  const T* v = static_cast<const T*>(p.v) + L.k_head(hkv);

  // Key tiles that any valid row (< seqused_q) of this q tile can see.
  const int row_max = min(row0 + kBlockM, sq_b) - 1;
  int max_col = row_max >= row0 ? sk_b - 1 : -1;
  if (p.has_upper) max_col = min(max_col, row_max + offset + p.wr);
  const int min_col = p.has_lower ? max(0, row0 + offset - p.wl) : 0;
  const int n_min = min_col / kBlockN;
  const int n_max = max_col >= 0 ? max_col / kBlockN : -1;

  load_rows<T, D, kBlockM, kDqThreads>(sQ, q + (size_t)row0 * L.q_rs,
                                       L.q_rows - row0, L.q_rs);
  load_rows<T, D, kBlockM, kDqThreads>(sdO, dout + (size_t)row0 * L.q_rs,
                                       L.q_rows - row0, L.q_rs);

  const int r_lo = warp * 16 + gid;  // this thread's two rows in the tile
  const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < L.q_rows;
    lse2[i] = in ? p.lse[loff + rows[i]] * kLog2e : INFINITY;
    dlt[i] = in ? p.delta[loff + rows[i]] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const T* sQw = sQ + warp * 16 * kStride;
  const T* sdOw = sdO + warp * 16 * kStride;
  for (int nb = n_min; nb <= n_max; ++nb) {
    const int col0 = nb * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D, kBlockN, kDqThreads>(sK, k + (size_t)col0 * L.k_rs,
                                         sk_b - col0, L.k_rs);
    load_rows<T, D, kBlockN, kDqThreads>(sV, v + (size_t)col0 * L.k_rs,
                                         sk_b - col0, L.k_rs);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, each summed over k-steps in order, as the
    // forward sums S.
    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, sQw + kk * 16, kStride, gid, tig);
      load_a(ado, sdOw + kk * 16, kStride, gid, tig);
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        uint32_t b[2];
        load_b_t(b, sK + j * 8 * kStride + kk * 16, kStride, gid, tig);
        Mma<T>::mma(s[j], aq, b);
        load_b_t(b, sV + j * 8 * kStride + kk * 16, kStride, gid, tig);
        Mma<T>::mma(dp[j], ado, b);
      }
    }

#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pe;
        p_and_ds(sm, s[j][e], dp[j][e], rows[i], col0 + j * 8 + tig * 2 + (e & 1),
                 sq_b, lse2[i], dlt[i], &pe, &s[j][e]);
      }
    }

    // dQ += dS K: the dS accumulators of n-tiles 2kk and 2kk+1 are exactly
    // the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
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

  T* dq = static_cast<T*>(p.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= L.q_rows) continue;
    T* drow = dq + (size_t)rows[i] * L.q_rs + tig * 2;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) =
          Mma<T>::pack(acc[n][2 * i] * p.scale, acc[n][2 * i + 1] * p.scale);
  }
}

template <typename T, int D, bool kVarlen>
__global__ void __launch_bounds__(kDkvThreads)
    flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;  // k-steps of S^T = K Q^T and dP^T = V dO^T
  constexpr int kHTiles = D / 16;  // n-tiles of 8 columns in half of d
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBlockN * kStride;
  T* sQ = sV + kBlockN * kStride;
  T* sdO = sQ + kBlockM * kStride;
  T* sP = sdO + kBlockM * kStride;  // P^T (keys x q rows)
  T* sdS = sP + kBlockN * kPStride;  // dS^T
  float* sLse2 = reinterpret_cast<float*>(sdS + kBlockN * kPStride);
  float* sDelta = sLse2 + kBlockM;

  const int nblk = blockIdx.x, hkv = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const SeqLayout L = seq_layout<kVarlen>(p.lens_q, p.lens_k, bb, p.h, p.hk,
                                          p.sq, p.sk, p.total_q, D);
  const int col0 = nblk * kBlockN;
  if constexpr (kVarlen) {
    if (col0 >= L.k_rows) return;  // past this sequence's keys
  }
  const int sq_b = L.sq_b, sk_b = L.sk_b;
  const int offset = sk_b - sq_b;

  const size_t kvoff = L.k_head(hkv) + (size_t)col0 * L.k_rs;
  load_rows<T, D, kBlockN, kDkvThreads>(
      sK, static_cast<const T*>(p.k) + kvoff, sk_b - col0, L.k_rs);
  load_rows<T, D, kBlockN, kDkvThreads>(
      sV, static_cast<const T*>(p.v) + kvoff, sk_b - col0, L.k_rs);

  // q tiles holding a live (row, key) pair with this key tile.
  int qt_min = 0, qt_max = -1;
  if (col0 < sk_b) {
    const int c1 = min(col0 + kBlockN, sk_b) - 1;
    const int min_row = p.has_upper ? max(0, col0 - offset - p.wr) : 0;
    int max_row = sq_b - 1;
    if (p.has_lower) max_row = min(max_row, c1 - offset + p.wl);
    if (max_row >= min_row) {
      qt_min = min_row / kBlockM;
      qt_max = max_row / kBlockM;
    }
  }

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

  for (int gi = 0; gi < p.g; ++gi) {
    const int hq = hkv * p.g + gi;
    const ScoreMod sm = score_mod(p, bb, hq, offset, sk_b);
    const size_t qoff = L.q_head(hq), loff = L.l_head(hq);
    const T* q = static_cast<const T*>(p.q) + qoff;
    const T* dout = static_cast<const T*>(p.dout) + qoff;
    for (int qt = qt_min; qt <= qt_max; ++qt) {
      const int row0 = qt * kBlockM;
      __syncthreads();  // every warp is done with the previous Q/dO/P/dS
      load_rows<T, D, kBlockM, kDkvThreads>(sQ, q + (size_t)row0 * L.q_rs,
                                            L.q_rows - row0, L.q_rs);
      load_rows<T, D, kBlockM, kDkvThreads>(sdO, dout + (size_t)row0 * L.q_rs,
                                            L.q_rows - row0, L.q_rs);
      for (int r = threadIdx.x; r < kBlockM; r += kDkvThreads) {
        const bool in = row0 + r < L.q_rows;
        sLse2[r] = in ? p.lse[loff + row0 + r] * kLog2e : INFINITY;
        sDelta[r] = in ? p.delta[loff + row0 + r] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK + kw * kStride + kk * 16, kStride, gid, tig);
        load_a(av, sV + kw * kStride + kk * 16, kStride, gid, tig);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[2];
          load_b_t(b, sQ + (qw + j * 8) * kStride + kk * 16, kStride, gid, tig);
          Mma<T>::mma(st[j], ak, b);
          load_b_t(b, sdO + (qw + j * 8) * kStride + kk * 16, kStride, gid, tig);
          Mma<T>::mma(dpt[j], av, b);
        }
      }

      // Element e of n-tile j: key kw + gid (+8 for e >= 2), q row
      // qw + j*8 + tig*2 (+1 for odd e).  Store P^T and dS^T in pairs.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = qw + j * 8 + tig * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = qc + (e & 1);
          p_and_ds(sm, st[j][e], dpt[j][e], row0 + qr,
                   col0 + kw + gid + 8 * (e >> 1), sq_b, sLse2[qr], sDelta[qr],
                   &st[j][e], &dpt[j][e]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = kw + gid + 8 * i;
          *reinterpret_cast<uint32_t*>(sP + key * kPStride + qc) =
              Mma<T>::pack(st[j][2 * i], st[j][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(sdS + key * kPStride + qc) =
              Mma<T>::pack(dpt[j][2 * i], dpt[j][2 * i + 1]);
        }
      }
      __syncthreads();

      // Phase B: dV += P^T dO and dK += dS^T Q over the tile's 64 q rows.
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        uint32_t ap[4], ads[4];
        load_a(ap, sP + kw * kPStride + kk * 16, kPStride, gid, tig);
        load_a(ads, sdS + kw * kPStride + kk * 16, kPStride, gid, tig);
#pragma unroll
        for (int n = 0; n < kHTiles; ++n) {
          uint32_t b[2];
          load_b(b, sdO + kk * 16 * kStride + dcol + n * 8, kStride, gid, tig);
          Mma<T>::mma(dv_acc[n], ap, b);
          load_b(b, sQ + kk * 16 * kStride + dcol + n * 8, kStride, gid, tig);
          Mma<T>::mma(dk_acc[n], ads, b);
        }
      }
    }
  }

  T* dk = static_cast<T*>(p.dk) + L.k_head(hkv);
  T* dv = static_cast<T*>(p.dv) + L.k_head(hkv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = col0 + kw + gid + 8 * i;
    if (key >= L.k_rows) continue;
    const size_t base = (size_t)key * L.k_rs + dcol + tig * 2;
#pragma unroll
    for (int n = 0; n < kHTiles; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + n * 8) = Mma<T>::pack(
          dk_acc[n][2 * i] * p.scale, dk_acc[n][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv + base + n * 8) =
          Mma<T>::pack(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <typename T, int D, bool kVarlen>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  constexpr int kStride = D + 8;
  const int dkv_smem = (4 * kBlockM * kStride + 2 * kBlockN * kPStride) *
                           (int)sizeof(T) + 2 * kBlockM * (int)sizeof(float);
  const int dq_smem = 4 * kBlockM * kStride * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, kVarlen>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, kVarlen>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return err;
  dim3 grid_dkv((p.sk + kBlockN - 1) / kBlockN, p.hk, p.b);
  flash_bwd_dkv_kernel<T, D, kVarlen>
      <<<grid_dkv, kDkvThreads, dkv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_dq((p.sq + kBlockM - 1) / kBlockM, p.h, p.b);
  flash_bwd_dq_kernel<T, D, kVarlen>
      <<<grid_dq, kDqThreads, dq_smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kVarlen>
int dispatch(const BwdParams& p, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch<__nv_bfloat16, 64, kVarlen>(p, s);
  if (dtype == 0 && d == 128)
    return launch<__nv_bfloat16, 128, kVarlen>(p, s);
  if (dtype == 1 && d == 64) return launch<__half, 64, kVarlen>(p, s);
  if (dtype == 1 && d == 128) return launch<__half, 128, kVarlen>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = bf16, 1 = fp16.  Launches the dK/dV kernel, then the dQ kernel,
// on `stream`; returns cudaGetLastError() after the launches.
extern "C" int flash_bwd(const void* dout, const void* q, const void* k,
                         const void* v, const float* lse, const float* delta,
                         void* dq, void* dk, void* dv, const int* seqused_q,
                         const int* seqused_k, const float* alibi, int b,
                         int h, int hk, int sq, int sk, int d, int dtype,
                         float scale, int has_upper, int wr, int has_lower,
                         int wl, float softcap, void* stream) {
  if (b == 0 || h == 0 || sq == 0 || sk == 0) return 0;
  BwdParams p{q, k, v, dout, lse, delta, dq, dk, dv, seqused_q, seqused_k,
              alibi, b, h, hk, h / hk, sq, sk, scale, has_upper, wr,
              has_lower, wl, softcap, 0};
  return dispatch<false>(p, d, dtype, stream);
}

// The packed varlen mode: do, q, dq (total_q, h, d), k, v, dk, dv (total_k,
// hk, d), lse and delta (h, total_q); cu_q, cu_k (b + 1,) int32 offsets;
// max_sq, max_sk the longest sequence (they size the grids).  Tokens outside
// every sequence are not written.
extern "C" int flash_bwd_varlen(const void* dout, const void* q, const void* k,
                                const void* v, const float* lse,
                                const float* delta, void* dq, void* dk,
                                void* dv, const int* cu_q, const int* cu_k,
                                const float* alibi, int b, int h, int hk,
                                int max_sq, int max_sk, int total_q, int d,
                                int dtype, float scale, int has_upper, int wr,
                                int has_lower, int wl, float softcap,
                                void* stream) {
  if (b == 0 || h == 0 || max_sq == 0 || max_sk == 0) return 0;
  BwdParams p{q, k, v, dout, lse, delta, dq, dk, dv, cu_q, cu_k, alibi, b,
              h, hk, h / hk, max_sq, max_sk, scale, has_upper, wr, has_lower,
              wl, softcap, total_q};
  return dispatch<true>(p, d, dtype, stream);
}
