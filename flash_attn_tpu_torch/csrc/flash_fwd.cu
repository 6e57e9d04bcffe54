// Flash-attention forward for Hopper (sm_90a), bf16 / fp16 in, fp32 accumulate.
//
// Replaces the Pallas TPU kernel flash_attn_tpu/kernels/flash_fwd.py::_fwd_kernel
// (launched at flash_fwd.py:1517 by flash_attn_fwd_bhsd), and serves the
// full-length causal/local calls that the JAX package sends to
// _fwd_sched_kernel (flash_fwd.py:870).  Its varlen mode (flash_fwd_varlen)
// replaces the packed varlen kernel
// flash_attn_tpu/kernels/varlen_sched.py::_varlen_sched_kernel (:211,
// launched at :440).
//
// What bounds it on the H100: operations.  Prefill at the serving shapes does
// 4*sq*sk*d FLOPs per head (about half of it for causal) against 2*(sq+2*sk)*d
// bytes, far above the card's ~295 FLOP/byte balance point, so the tensor cores
// are the limit.
//
// What the design does about it:
// * Both products run on the tensor cores with mma.sync.m16n8k16 (bf16/fp16 ->
//   fp32).  One block of 4 warps owns a 64-row Q tile of one (batch, head);
//   each warp owns 16 rows, so S = Q K^T and O += P V stay in registers and P
//   goes from the S accumulators straight into the A operand of the second
//   product without touching shared memory.
// * The KV loop runs only over the 64-key tiles the masks leave
//   ([n_min, n_max] from the causal/window bounds and seqused_k, as
//   _kv_block_bounds at flash_fwd.py:176 does), so a causal call does about
//   half the work and a cache read stops at seqused_k, not at max_seqlen.
// * Online softmax in fp32 on exp2: each score is scaled (and softcapped,
//   ALiBi-biased) in natural units, then multiplied by log2(e) once, so the
//   exponent is a bare exp2.  A masked element is -inf and its p is exactly 0.
//   That transform is fa_common.cuh's ScoreMod, which the backward
//   (flash_bwd.cu) shares, so both see the same scores.
// * Shared-memory rows are padded by 8 elements so the 32-bit fragment loads
//   are free of bank conflicts.
// This first version loads K/V tiles synchronously (no cp.async/TMA pipeline,
// no wgmma); overlapping loads with math is later work.
//
// GQA: q head h reads kv head h / g.  Rows at or past seqused_q are computed
// like any other row (the JAX kernel does not mask them either); rows past the
// tensor's sq are not written.  A row with no valid key writes o = 0 and
// lse = +inf.
//
// Varlen mode: q, o are packed (total_q, h, d) streams and k, v (total_k, hk,
// d), read in place with token strides h*d and hk*d (no transpose copy); lse
// is (h, total_q).  The TPU kernel walks a device-built table of (q tile, kv
// tile) pairs over the whole stream and masks tiles that straddle two
// sequences with per-token segment words.  Here the grid is (cdiv(max_seqlen_q,
// 64), h, b): a block owns a 64-row tile of one sequence and head, and blocks
// past that sequence's length exit at once.  A tile never crosses a sequence
// boundary, so no segment compare is needed, the masks run on per-sequence
// coordinates (offset len_k - len_q, bottom-right), and the KV loop visits the
// sequence's own key tiles only, within the causal and window bounds.  The
// grid was chosen over a compact (sequence, tile) work list for simplicity:
// an idle block costs one load of cu_seqlens, and a batch whose lengths vary
// by 32x (BERT's 16-512) leaves about half the blocks idle.  Bounded like
// the dense mode, by operations: the live (row, key) pairs of each sequence.

#include "fa_common.cuh"

namespace {

using namespace fa;

constexpr int kBlockM = 64;   // q rows per block
constexpr int kBlockN = 64;   // keys per KV tile
constexpr int kThreads = 128; // 4 warps x 16 rows

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  // dense: seqused_q/k (b,); varlen: cu_seqlens_q/k (b + 1,)
  const int* lens_q;
  const int* lens_k;
  const float* alibi;  // (b, h) or null
  // varlen: sq, sk are the max lengths and total_q the lse's head stride.
  // The struct keeps the dense kernel's size (112 bytes): three more
  // fields made the dense forward ~20 % slower on an H100.
  int b, h, hk, total_q, sq, sk;
  float scale;
  int has_upper, wr, has_lower, wl;
  float softcap;
};

template <typename T, int D, bool kVarlen>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FwdParams p) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;  // k-steps of S = Q K^T
  constexpr int kOTiles = D / 8;   // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBlockM * kStride;
  T* sV = sK + kBlockN * kStride;

  const int qblk = blockIdx.x, hq = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int hkv = hq / (p.h / p.hk);
  const SeqLayout L = seq_layout<kVarlen>(p.lens_q, p.lens_k, bb, p.h, p.hk,
                                          p.sq, p.sk, p.total_q, D);
  const int row0 = qblk * kBlockM;
  if constexpr (kVarlen) {
    if (row0 >= L.q_rows) return;  // past this sequence's rows
  }
  const int sk_b = L.sk_b;
  const int offset = sk_b - L.sq_b;
  const ScoreMod sm{p.scale, p.softcap, p.alibi ? p.alibi[bb * p.h + hq] : 0.f,
                    p.alibi != nullptr, offset, sk_b, p.has_upper, p.wr,
                    p.has_lower, p.wl};

  const T* q = static_cast<const T*>(p.q) + L.q_head(hq);
  const T* k = static_cast<const T*>(p.k) + L.k_head(hkv);
  const T* v = static_cast<const T*>(p.v) + L.k_head(hkv);

  // KV tiles that any row of this q tile can see.
  const int row_max = min(row0 + kBlockM, L.q_rows) - 1;
  int max_col = sk_b - 1;
  if (p.has_upper) max_col = min(max_col, row_max + offset + p.wr);
  const int min_col = p.has_lower ? max(0, row0 + offset - p.wl) : 0;
  const int n_min = min_col / kBlockN;
  const int n_max = max_col >= 0 ? max_col / kBlockN : -1;

  load_rows<T, D, kBlockM, kThreads>(sQ, q + (size_t)row0 * L.q_rs,
                                     L.q_rows - row0, L.q_rs);
  __syncthreads();

  const int r_lo = warp * 16 + gid;  // this thread's two rows in the tile
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    load_a(qf[kk], sQ + warp * 16 * kStride + kk * 16, kStride, gid, tig);

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // in log2 units of scaled scores
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
  const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};

  for (int nb = n_min; nb <= n_max; ++nb) {
    const int col0 = nb * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D, kBlockN, kThreads>(sK, k + (size_t)col0 * L.k_rs,
                                       sk_b - col0, L.k_rs);
    load_rows<T, D, kBlockN, kThreads>(sV, v + (size_t)col0 * L.k_rs,
                                       sk_b - col0, L.k_rs);
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t bfrag[2];
        load_b_t(bfrag, sK + j * 8 * kStride + kk * 16, kStride, gid, tig);
        Mma<T>::mma(s[j], qf[kk], bfrag);
      }
    }

    // scale, softcap, ALiBi and masks; then the tile's row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int col = col0 + j * 8 + tig * 2 + (e & 1);
        const float x = sm.log2_score(sm.capped(s[j][e]), row, col);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }

    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
      // A row with nothing valid so far keeps m = -inf; exponentiate against
      // 0 then, so p = exp2(-inf) = 0 and no inf - inf appears.
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
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = pe;
        l_run[e >> 1] += pe;
      }
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are exactly the
    // A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
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

  T* o = static_cast<T*>(p.o) + L.q_head(hq);
  float* lse = p.lse + L.l_head(hq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    const int row = rows[i];
    if (row >= L.q_rows) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + (size_t)row * L.q_rs + tig * 2;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          Mma<T>::pack(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (tig == 0) lse[row] = l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : INFINITY;
  }
}

template <typename T, int D, bool kVarlen>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  const int smem = 3 * kBlockM * (D + 8) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kVarlen>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBlockM - 1) / kBlockM, p.h, p.b);
  flash_fwd_kernel<T, D, kVarlen><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kVarlen>
int dispatch(const FwdParams& p, int d, int dtype, void* stream) {
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

// dtype: 0 = bf16, 1 = fp16.  Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, const int* seqused_q, const int* seqused_k,
                         const float* alibi, int b, int h, int hk, int sq,
                         int sk, int d, int dtype, float scale, int has_upper,
                         int wr, int has_lower, int wl, float softcap,
                         void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  FwdParams p{q, k, v, o, lse, seqused_q, seqused_k, alibi, b, h, hk, 0, sq,
              sk, scale, has_upper, wr, has_lower, wl, softcap};
  return dispatch<false>(p, d, dtype, stream);
}

// The packed varlen mode: q, o (total_q, h, d), k, v (total_k, hk, d), lse
// (h, total_q); cu_q, cu_k (b + 1,) int32 offsets; max_sq, max_sk the
// longest sequence (they size the grid).  Tokens outside every sequence are
// not written.
extern "C" int flash_fwd_varlen(const void* q, const void* k, const void* v,
                                void* o, float* lse, const int* cu_q,
                                const int* cu_k, const float* alibi, int b,
                                int h, int hk, int max_sq, int max_sk,
                                int total_q, int d, int dtype, float scale,
                                int has_upper, int wr, int has_lower, int wl,
                                float softcap, void* stream) {
  if (b == 0 || h == 0 || max_sq == 0) return 0;
  FwdParams p{q, k, v, o, lse, cu_q, cu_k, alibi, b, h, hk, total_q, max_sq,
              max_sk, scale, has_upper, wr, has_lower, wl, softcap};
  return dispatch<true>(p, d, dtype, stream);
}
