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
// The forward (redesigned for Hopper):
// * The TPU kernels walk a flattened (b, h, T) table of tile steps on a
//   sequential grid (flex.py::_flex_schedule:360).  Here a block owns one
//   q tile of one q block of one (head, batch) and walks that q block's
//   lists itself: full_kv_idx[:full_kv_num], then kv_idx[:kv_num], each
//   listed block_k-wide block in key tiles.  So skipped blocks cost nothing
//   and no schedule is built.  Head-invariant tables (one head) are read at
//   head stride 0, which is all the head-blocked TPU kernel is for here: its
//   HB-head pipelining feeds the MXU, and a block per head fills the SMs.
// * At the flex path's shapes (d = 128, 128-blocks) it is bound by
//   operations: 4*d FLOPs per live (row, key) pair against q, k, v, o bytes
//   read or written about once.  So the tensor cores must not wait.
// * Tiles: 128 q rows (two consumer warpgroups of 64 rows, sharing every
//   K/V tile) when block_q % 128 == 0, else 64 (one consumer); keys in
//   tiles of 128 when block_k % 128 == 0, else 64.  Four template
//   instantiations, picked by launch_fwd from (block_q, block_k):
//   128/128 serves the 128- and 512-blocks of the flex path, blocksparse
//   and the packed varlen route; 128/64, 64/128, 64/64 the rest (e.g.
//   block_q 64 or 192).
// * Loads: warpgroup 0 is the producer.  One thread loads Q once, then keeps
//   a ring of K/V stages full with TMA (as many as 227 KB hold, 2 to 4: 3
//   at d = 128 with 128-key tiles; 4-D tensor maps over (d, heads, s, b)
//   built from the strides on the host, rows past s zero-filled, the
//   128-byte swizzle); full / empty mbarriers hand each stage to the
//   consumers and back.  setmaxnreg moves the producer's registers to the
//   consumers (24 / 240 a thread at 128 rows).  On the H100 the loads hide
//   entirely behind the products (flex_ab's noload variant times the same).
// * Products on wgmma: S = Q K^T as m64n{64|128}k16 from shared memory,
//   both K-major; P converted to bf16 / fp16 in registers is the A operand
//   of O += P V (the accumulator of two adjacent n8 blocks is the A
//   fragment), V read MN-major from the same swizzled tile.  Each consumer
//   issues a tile's Q K^T together with the previous tile's P V, and the
//   two consumers take turns (named barriers), so that one's softmax runs
//   while the other's products hold the tensor cores.  A wgmma accumulator
//   gives each thread rows 16 warp + gid and + 8 and keys 8 j + 2 tig +
//   {0, 1}, the per-warp mma.sync layout, so the mask, the score and the
//   online softmax (fp32, exp2) are the first version's; without a mod the
//   scale is folded into the exponent, and full tiles inside sk skip the
//   mask.  A tile's fp32 bias is loaded into registers before its products
//   where it fits (d + keys <= 192), as its loads hide worse behind 8
//   consumer warps an SM than behind the first version's 16.
// * The mask: a partial block reads one bit per (row, key) from `bits`,
//   which the wrapper filled by evaluating the Python mask_mod once per call
//   over the partial blocks (a CUDA kernel cannot call it); full blocks read
//   nothing.  Keys at or past sk are never attended.
// * The score: s * scale, + attn_bias (fp32, read from device memory),
//   then the compiled-in score mod (softcap or relative position), in fp32,
//   in JAX's order (_mod_score, flex.py:903).  The backward multiplies dS by
//   the mod's derivative, in place of the TPU kernels' in-kernel jax.vjp.
// * Calls with neither a score mod nor a bias run kernels compiled apart
//   (kMods = false), free of the per-element branches on the mod and the
//   bias, which cost the mask-only case a third of its time on an H100.
//
// The backward (redesigned for Hopper) is the deterministic recompute
// split of flash_bwd.cu: a dQ kernel and a dK/dV kernel, each recomputing
// P from lse.  It is bound by operations: 6*d FLOPs per live (row, key)
// pair for dQ (S, dP, dS K) and 8*d for dK/dV (S^T, dP^T, P^T dO, dS^T Q),
// against q, k, v, do bytes read about once.  The first version ran
// mma.sync on fragments read element by element from shared memory, with
// every tile loaded synchronously between __syncthreads, 64-row blocks
// that re-read each K/V tile for every 64 q rows, and P^T, dS^T making a
// round trip through shared memory: 9-16 % of its bound.  Now:
// * dQ (flex_bwd_dq_kernel) has the forward's shape: a block owns 128 q
//   rows (two consumer warpgroups; 64 and one where block_q % 128 != 0) of
//   one (head, batch), Q and dO loaded once by TMA, and a producer thread
//   keeps a ring of 64-key K/V stages (4 at d = 128).  S = Q K^T and
//   dP = dO V^T run on wgmma from shared memory; dS = P (dP - delta) (times
//   the mod's derivative; also dbias) is formed in fp32 registers and
//   becomes the A operand of dQ += dS K in place, K read MN-major, issued
//   beside the next tile's S and dP.  The two consumers take the tensor
//   cores in turns, as in the forward.
// * dK/dV (flex_bwd_dkv_kernel): a block owns 128 keys of one kv block of
//   one (kv head, batch), K and V resident, two consumer warpgroups of 64
//   keys each, and walks the q lists of its GQA group's heads in a fixed
//   order (head, then full_q then q list, then 64-row tiles).  A producer
//   thread keeps a ring of (Q, dO) stages full: the tiles by TMA, and the
//   rows' lse and delta and a partial block's bit words by bulk copies on
//   the same barrier, from buffers the wrapper lays out for it (lse in
//   log2 units and delta padded to 64 rows; bits by 64- or 128-key block).
//   S^T = K Q^T and dP^T = V dO^T run on wgmma from shared memory; P^T and
//   dS^T are formed in registers and become the A operands of dV += P^T dO
//   and dK += dS^T Q, Q and dO read MN-major: no shared-memory round trip.
//   dK and dV (64 + 64 fp32 a thread at d = 128) leave no room to overlap
//   one tile's dV, dK with the next tile's products inside a warpgroup, so
//   the warpgroups issue their two product groups in turns.  Where
//   block_k % 128 != 0 a block owns 64 keys: both warpgroups own all of
//   them, take the stages (of 32 q rows) in turn and add their sums in a
//   fixed order at the end (one warpgroup, at the 232 registers two
//   blocks an SM allow, spilled; so did two on 64-row stages with a mod).
// * Both grids start their heaviest blocks first (bwd_block: an order the
//   wrapper builds on the device from the lists' lengths): under a
//   document mask the blocks' work differs up to ~32x, and in the grid's
//   own order the longest started last.
// * What was hard: registers.  dK/dV's consumers need 192 of them for dK,
//   dV, S^T and dP^T alone; a producer that copied lse, delta and bits
//   with its lanes needed 40 (its own spills, and the consumers' at 232),
//   and one that did so with a single warp held every TMA issue behind
//   those loads' latency.  Bulk copies keep the producer at one thread of
//   24 registers and the consumers at 240, with no spill.  setmaxnreg:
//   24 / 240 (dQ: 24 / 232 at 64 rows).  The descriptors are the
//   forward's (K-major Q, K, V, dO as A or B of the ss products; MN-major
//   K, Q, dO as B of the rs ones).
// * Sums run in a fixed order and no atomics are used: the result is
//   bitwise deterministic.  A wait on a stage traps after ~10 s instead of
//   hanging the card, as in the forward.

// Layouts: q, k, v, do (b, s, heads, d) read in place through their batch,
// row and head strides; o and dq (b, sq, h, d), dk and dv (b, sk, hk, d)
// contiguous; lse (b, h, sq) fp32 from the forward; the backward's lse (in
// log2 units) and delta (b, h, sq rounded up to 64) fp32, +inf and 0 past
// sq; bias (b|1, h|1, sq, sk) fp32 with stride 0 on a broadcast dimension,
// dbias (b, h, sq, sk).  Tables are (b, th, n_major, len) int32, th = 1 or
// h; slot (b, th, nq, nk) numbers the partial pairs, whose bits are (slot,
// bq, bk / 32) words, for the dK/dV kernel (slot, bk / keys, bq, keys / 32)
// with keys its block's.  In the backward, o carries a block order
// (bwd_block).

// The Hopper pieces (mbarriers, TMA, wgmma, tensor maps) live in hopper.cuh,
// shared with flash_bwd.cu.

#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

using namespace fa;

constexpr int kTile = 64;  // the smallest tile: block_q, block_k multiples

enum { kModNone = 0, kModSoftcap = 1, kModRelPos = 2 };

// Field for field as flex.py's _Params (checked at load by flex_params_size).
struct FlexParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // forward: the output; backward: the block order (see bwd_block)
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

// The compiled-in score mod of x = s * scale + bias; *dmod is its
// derivative.
__device__ __forceinline__ float flex_mod(const FlexParams& p, float x,
                                          float slope, int row, int col,
                                          float* dmod) {
  *dmod = 1.f;
  if (p.mod == kModSoftcap) {
    const float t = tanhf(x / p.softcap);
    *dmod = 1.f - t * t;
    return t * p.softcap;
  }
  if (p.mod == kModRelPos) return x - slope * fabsf((float)(row - col));
  return x;
}

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
  return flex_mod(p, x, slope, row, col, dmod);
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

// The forward's tiles and shared memory: a block owns kRows q rows (one
// consumer warpgroup per 64) and walks K/V in kKeys-key tiles through a ring
// of kStages; warpgroup 0 is the producer.  Every tile is stored as D / 64
// column blocks of (rows, 64) in the 128-byte swizzle, 1024-byte aligned.
template <int D, int kRows, int kKeys>
struct FwdCfg {
  static constexpr int kConsumers = kRows / 64;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;  // K or V
  // launch registers a thread, and what setmaxnreg moves them to: exactly
  // the block's share of the SM's 65536 (one block of 384 threads, or two
  // of 256)
  static constexpr int kMinBlocks = kConsumers == 2 ? 1 : 2;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 232;
  // as many K/V stages (2 to 4) as the shared memory of kMinBlocks blocks
  // an SM holds (227 KB a block at most)
  static constexpr int kFit =
      ((kMinBlocks == 2 ? 113 : 227) * 1024 - 1024 - kQBytes - 64) /
      (2 * kTileBytes);
  static constexpr int kStages = kFit < 2 ? 2 : kFit > 4 ? 4 : kFit;
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // barriers: Q, then full[kStages], then empty[kStages]; 1024 bytes of
  // slack to align the dynamic buffer
  static constexpr int kSmem = 1024 + kBarOffset + (1 + 2 * kStages) * 8;
};

// The forward's TMA descriptors (built on the host from FlexParams by
// flex_fwd, passed beside it so that FlexParams keeps its layout).
struct FwdMaps {
  CUtensorMap q, k, v;
};

template <typename T, int D, bool kMods, int kRows, int kKeys>
__global__ void __launch_bounds__(FwdCfg<D, kRows, kKeys>::kThreads,
                                  FwdCfg<D, kRows, kKeys>::kMinBlocks)
    flex_fwd_kernel(const FlexParams p, const __grid_constant__ FwdMaps maps) {
  using Cfg = FwdCfg<D, kRows, kKeys>;
  constexpr int kStages = Cfg::kStages;
  constexpr int kDBlocks = D / 64;
  constexpr bool kPingPong = Cfg::kConsumers == 2;
  // a tile's bias fits in registers beside S, O and P where d + keys <= 192
  constexpr bool kBiasRegs = kMods && D + kKeys <= 192;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* sQ = reinterpret_cast<T*>(smem);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOffset);
  uint64_t* bar_full = bar_q + 1;
  uint64_t* bar_empty = bar_full + kStages;
  auto sK = [&](int stage) {
    return reinterpret_cast<T*>(smem + Cfg::kQBytes +
                                stage * 2 * Cfg::kTileBytes);
  };
  auto sV = [&](int stage) { return sK(stage) + kKeys * D; };

  const int sub_q = p.bq / kRows;
  const int qi = blockIdx.x / sub_q;
  const int row0 = qi * p.bq + (blockIdx.x % sub_q) * kRows;
  const int hq = blockIdx.y, bb = blockIdx.z;
  if (row0 >= p.sq) return;
  const KvList L = kv_list(p, bb, hq, qi);
  const int n_list = L.n_full + L.n_part;
  const int k_tiles = p.bk / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], Cfg::kConsumers * 4);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full; the rest of the
    // warpgroup gives its registers to the consumers and leaves.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kProducerRegs));
    if (threadIdx.x != 0 || n_list == 0) return;
    const int hkv = hq / (p.h / p.hk);
    mbar_expect_tx(bar_q, Cfg::kQBytes);
#pragma unroll
    for (int c = 0; c < kDBlocks; ++c)
      tma_load(&maps.q, sQ + c * kRows * 64, bar_q, c * 64, hq, row0, bb);
    int it = 0;
    for (int j = 0; j < n_list; ++j) {
      const int kb = j < L.n_full ? L.full[j] : L.part[j - L.n_full];
      for (int u = 0; u < k_tiles; ++u, ++it) {
        const int col0 = kb * p.bk + u * kKeys;
        if (col0 >= p.sk) break;
        const int stage = it % kStages;
        mbar_wait(&bar_empty[stage], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&bar_full[stage], 2 * Cfg::kTileBytes);
#pragma unroll
        for (int c = 0; c < kDBlocks; ++c) {
          tma_load(&maps.k, sK(stage) + c * kKeys * 64, &bar_full[stage],
                   c * 64, hkv, col0, bb);
          tma_load(&maps.v, sV(stage) + c * kKeys * 64, &bar_full[stage],
                   c * 64, hkv, col0, bb);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Cfg::kConsumerRegs));
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float* bias_bh = bias_head(p, bb, hq);
  const float slope = p.mod == kModRelPos ? p.slopes[hq] : 0.f;
  // the exponent's factor on s: the scale in log2 units without a mod (the
  // launcher sends a scale <= 0 to kMods), 1 with one
  const float sc = kMods ? 1.f : p.scale * kLog2e;

  float acc[D / 2];  // O: the m64nD accumulator
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // log2 units
  float l_run[2] = {0.f, 0.f};
  const int r_lo = cw * 64 + warp * 16 + gid;
  const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};
  // bit rows of this thread's two rows within the q block
  const int brow[2] = {rows[0] - qi * p.bq, rows[1] - qi * p.bq};
  // the bias rows of this thread's two rows (null without a bias or past
  // sq)
  const float* bias_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bias_row[i] = bias_bh != nullptr && rows[i] < p.sq
                      ? bias_bh + rows[i] * p.bias_ss
                      : nullptr;

  // Q: K-major, this warpgroup's 64 rows of each column block.  K: K-major.
  // V: MN-major (keys along k, d along n), column blocks kKeys*128 bytes
  // apart.
  const uint64_t q_desc = sw128_desc(sQ + cw * 64 * 64, 16, 1024);
  if (n_list > 0) {
    mbar_wait(bar_q, 0);
    if (cw == 1) their_turn<kPingPong>(cw);  // warpgroup 0 goes first
  }

  // P of the previous tile (the A operand of its P V, issued beside the
  // next tile's Q K^T) and its stage; -1 before the first tile.
  uint32_t pa[kKeys / 16][4];
  int prev = -1;
  int it = 0;
  for (int j = 0; j < n_list; ++j) {
    const bool partial = j >= L.n_full;
    const int kb = partial ? L.part[j - L.n_full] : L.full[j];
    const uint32_t* bits =
        partial ? p.bits + (size_t)L.slot[kb] * p.bq * p.words : nullptr;
    for (int u = 0; u < k_tiles; ++u, ++it) {
      const int col0 = kb * p.bk + u * kKeys;
      if (col0 >= p.sk) break;
      const int stage = it % kStages;
      // The bias of this tile's elements, loaded before the wait so that
      // its latency hides behind the products (a register array where it
      // fits beside S, O and P; else read where it is added).
      float bv[kBiasRegs ? kKeys / 2 : 1];
      if constexpr (kBiasRegs) {
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + jj * 8 + tig * 2 + (e & 1);
            bv[jj * 4 + e] = bias_row[e >> 1] != nullptr && col < p.sk
                                 ? bias_row[e >> 1][col]
                                 : 0.f;
          }
      }
      mbar_wait(&bar_full[stage], (it / kStages) & 1);

      // S = Q K^T, and O += P V of the previous tile
      float s[kKeys / 2];
      const uint64_t k_desc = sw128_desc(sK(stage), 16, 1024);
      my_turn<kPingPong>(cw);
      fence_regs<D / 2>(acc);
      fence_regs<kKeys / 4>(&pa[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // d columns [16 kk, 16 kk + 16): column block kk / 4, 32 bytes a step
        const uint32_t q_off = (kk >> 2) * kRows * 128 + (kk & 3) * 32;
        const uint32_t k_off = (kk >> 2) * kKeys * 128 + (kk & 3) * 32;
        wgmma_ss<kKeys, T>(s, q_desc + (q_off >> 4), k_desc + (k_off >> 4),
                           kk > 0);
      }
      if (prev >= 0) pv_product<D, kKeys>(acc, pa, sV(prev));
      wgmma_commit();
      their_turn<kPingPong>(cw);
      wgmma_wait_all();
      fence_regs<kKeys / 2>(s);
      fence_regs<D / 2>(acc);
      fence_regs<kKeys / 4>(&pa[0][0]);
      if (prev >= 0 && lane == 0) mbar_arrive(&bar_empty[prev]);

      // Element e of n8-block jj: row rows[e >> 1], key
      // col0 + 8 jj + 2 tig + (e & 1): the mma.sync layout, by warp.  Full
      // tiles inside sk with no mod take the plain branch.  Without a mod
      // s stays raw (the scale is folded into the exponent below); with
      // one it becomes the modded score in log2 units.
      float mx[2] = {-INFINITY, -INFINITY};
      if (kMods || partial || col0 + kKeys > p.sk) {
        uint32_t w[2][kKeys / 32];  // the two rows' bits of this tile
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < kKeys / 32; ++k)
            w[i][k] = partial ? bits[brow[i] * p.words + u * (kKeys / 32) + k]
                              : ~0u;
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int c = jj * 8 + tig * 2 + (e & 1);  // in the tile
            const int col = col0 + c;
            float x = s[jj * 4 + e];
            if constexpr (kBiasRegs) {
              float dm;
              x = flex_mod(p, x * p.scale + bv[jj * 4 + e], slope, rows[i],
                           col, &dm) *
                  kLog2e;
            } else if constexpr (kMods) {
              float dm;
              x = flex_score<true>(p, x, bias_bh, slope, rows[i], col, &dm) *
                  kLog2e;
            }
            const bool keep = col < p.sk && ((w[i][c >> 5] >> (c & 31)) & 1);
            x = keep ? x : -INFINITY;
            s[jj * 4 + e] = x;
            mx[i] = fmaxf(mx[i], x);
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[jj * 4 + e]);
      }

      float alpha[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_run[i], quad_max(mx[i]) * sc);
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = fast_exp2(m_run[i] - m_use[i]);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
      // P as the A operand: the accumulator of two adjacent n8 blocks is
      // the A fragment of one k16 step.
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p0 =
              fast_exp2(fmaf(s[8 * kk + 2 * r], sc, -m_use[r & 1]));
          const float p1 =
              fast_exp2(fmaf(s[8 * kk + 2 * r + 1], sc, -m_use[r & 1]));
          l_run[r & 1] += p0 + p1;
          pa[kk][r] = Mma<T>::pack(p0, p1);
        }
      }
      prev = stage;
    }
  }
  if (prev >= 0) {  // the last tile's P V
    my_turn<kPingPong>(cw);
    fence_regs<D / 2>(acc);
    fence_regs<kKeys / 4>(&pa[0][0]);
    wgmma_fence();
    pv_product<D, kKeys>(acc, pa, sV(prev));
    wgmma_commit();
    if (cw == 0) their_turn<kPingPong>(cw);  // 1 takes the last turn
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<kKeys / 4>(&pa[0][0]);
    if (lane == 0) mbar_arrive(&bar_empty[prev]);
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
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          Mma<T>::pack(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    if (tig == 0) lse[row] = l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : INFINITY;
  }
}

// The backward's tiles and shared memory.  dQ: a block owns kRows q rows
// (one consumer warpgroup per 64) and walks K/V in 64-key tiles through a
// ring of kStages; Q and dO stay resident.  dK/dV: a block owns kKeys keys
// (two consumer warpgroups), K and V resident, and walks Q/dO in tiles of
// 64 (32 at 64 keys) rows through a ring whose stages also carry the
// tile's lse (log2 units), delta and partial-block bit words.  Warpgroup 0
// is the producer.
// Tiles as the forward's: D / 64 column blocks of (rows, 64) in the 128-byte
// swizzle, 1024-byte aligned.
template <int D, int kRows>
struct DqCfg {
  static constexpr int kKeys = 64;
  static constexpr int kConsumers = kRows / 64;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kQBytes = kRows * D * 2;     // Q or dO
  static constexpr int kTileBytes = kKeys * D * 2;  // K or V
  static constexpr int kMinBlocks = kConsumers == 2 ? 1 : 2;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 232;
  static constexpr int kFit =
      ((kMinBlocks == 2 ? 113 : 227) * 1024 - 1024 - 2 * kQBytes - 64) /
      (2 * kTileBytes);
  static constexpr int kStages = kFit < 2 ? 2 : kFit > 4 ? 4 : kFit;
  static constexpr int kBarOffset = 2 * kQBytes + kStages * 2 * kTileBytes;
  // barriers: Q and dO, then full[kStages], then empty[kStages]
  static constexpr int kSmem = 1024 + kBarOffset + (1 + 2 * kStages) * 8;
};

template <int D, int kKeys>
struct DkvCfg {
  // Two consumer warpgroups: at 128 keys each owns 64 of them; at 64 keys
  // (kSplitQ) both own all of them, take the stages in turn and add their
  // sums at the end, on stages of 32 q rows (one warpgroup of 64 keys at
  // 232 registers, or two on 64-row stages, spilled with a score mod).
  static constexpr bool kSplitQ = kKeys == 64;
  static constexpr int kRows = kSplitQ ? 32 : 64;  // q rows of a stage
  static constexpr int kWords = kKeys / 32;       // bit words of a row
  static constexpr int kThreads = 3 * 128;
  static constexpr int kKBytes = kKeys * D * 2;     // K or V
  static constexpr int kTileBytes = kRows * D * 2;  // Q or dO
  // a stage's lse (log2 units) and delta (kRows fp32 each), then its bits
  static constexpr int kMetaBytes = (2 + kWords) * kRows * 4;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kFit =
      (227 * 1024 - 1024 - 2 * kKBytes - 64) / (2 * kTileBytes + kMetaBytes);
  static constexpr int kStages = kFit < 2 ? 2 : kFit > 4 ? 4 : kFit;
  static constexpr int kMetaOffset = 2 * kKBytes + kStages * 2 * kTileBytes;
  // kSplitQ adds the two warpgroups' dK, dV through the tile buffers
  static_assert(!kSplitQ || D * 512 <= kStages * 2 * kTileBytes, "");
  static constexpr int kBarOffset = kMetaOffset + kStages * kMetaBytes;
  // barriers: K and V, then full[kStages], then empty[kStages]
  static constexpr int kSmem = 1024 + kBarOffset + (1 + 2 * kStages) * 8;
};

// The (x, y, z) block a backward block runs: its own, or, given an order
// in p.o (int32, built on the device by the wrapper from the lengths of
// the lists each block walks, heaviest first), the order's entry at its
// linear index (x fastest), so that the longest blocks start first and the
// grid's tail is short.
__device__ __forceinline__ dim3 bwd_block(const FlexParams& p) {
  if (p.o == nullptr) return blockIdx;
  const int lin = static_cast<const int*>(p.o)[
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)];
  return dim3(lin % gridDim.x, lin / gridDim.x % gridDim.y,
              lin / (gridDim.x * gridDim.y));
}

// The backward's TMA descriptors (built on the host by encode_bwd_maps):
// q and do in boxes of the kernel's q rows, k and v of its keys.
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

template <typename T, int D, bool kMods, int kRows>
__global__ void __launch_bounds__(DqCfg<D, kRows>::kThreads,
                                  DqCfg<D, kRows>::kMinBlocks)
    flex_bwd_dq_kernel(const FlexParams p,
                       const __grid_constant__ BwdMaps maps) {
  using Cfg = DqCfg<D, kRows>;
  constexpr int kKeys = Cfg::kKeys;
  constexpr int kStages = Cfg::kStages;
  constexpr int kDBlocks = D / 64;
  constexpr bool kPingPong = Cfg::kConsumers == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // aligned by an offset, so that its pointers stay shared (32-bit) ones
  unsigned char* smem = smem_raw + (-smem_u32(smem_raw) & 1023);
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = reinterpret_cast<T*>(smem + Cfg::kQBytes);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOffset);
  uint64_t* bar_full = bar_q + 1;
  uint64_t* bar_empty = bar_full + kStages;
  auto sK = [&](int stage) {
    return reinterpret_cast<T*>(smem + 2 * Cfg::kQBytes +
                                stage * 2 * Cfg::kTileBytes);
  };
  auto sV = [&](int stage) { return sK(stage) + kKeys * D; };

  const dim3 blk = bwd_block(p);
  const int sub_q = p.bq / kRows;
  const int qi = blk.x / sub_q;
  const int row0 = qi * p.bq + (blk.x % sub_q) * kRows;
  const int hq = blk.y, bb = blk.z;
  if (row0 >= p.sq) return;
  const KvList L = kv_list(p, bb, hq, qi);
  const int n_list = L.n_full + L.n_part;
  const int k_tiles = p.bk / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], Cfg::kConsumers * 4);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread loads Q and dO once, then keeps the K/V ring
    // full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kProducerRegs));
    if (threadIdx.x != 0 || n_list == 0) return;
    const int hkv = hq / (p.h / p.hk);
    mbar_expect_tx(bar_q, 2 * Cfg::kQBytes);
#pragma unroll
    for (int c = 0; c < kDBlocks; ++c) {
      tma_load(&maps.q, sQ + c * kRows * 64, bar_q, c * 64, hq, row0, bb);
      tma_load(&maps.dout, sdO + c * kRows * 64, bar_q, c * 64, hq, row0, bb);
    }
    int it = 0;
    for (int j = 0; j < n_list; ++j) {
      const int kb = j < L.n_full ? L.full[j] : L.part[j - L.n_full];
      for (int u = 0; u < k_tiles; ++u, ++it) {
        const int col0 = kb * p.bk + u * kKeys;
        if (col0 >= p.sk) break;
        const int stage = it % kStages;
        mbar_wait(&bar_empty[stage], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&bar_full[stage], 2 * Cfg::kTileBytes);
#pragma unroll
        for (int c = 0; c < kDBlocks; ++c) {
          tma_load(&maps.k, sK(stage) + c * kKeys * 64, &bar_full[stage],
                   c * 64, hkv, col0, bb);
          tma_load(&maps.v, sV(stage) + c * kKeys * 64, &bar_full[stage],
                   c * 64, hkv, col0, bb);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Cfg::kConsumerRegs));
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float* bias_bh = bias_head(p, bb, hq);
  float* dbias_bh =
      p.dbias ? p.dbias + ((size_t)bb * p.h + hq) * p.sq * p.sk : nullptr;
  const float slope = p.mod == kModRelPos ? p.slopes[hq] : 0.f;
  // p = 2^(v sc - lse2): v the raw score without a mod, the modded score
  // in natural units with one
  const float sc = kMods ? kLog2e : p.scale * kLog2e;

  const int r_lo = cw * 64 + warp * 16 + gid;
  const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};
  const int brow[2] = {rows[0] - qi * p.bq, rows[1] - qi * p.bq};
  // lse (log2 units) and delta rows, padded by the wrapper
  const size_t loff = ((size_t)bb * p.h + hq) * ((p.sq + 63) & ~63);
  float lse2[2], dlt[2];
  const float* bias_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < p.sq;
    lse2[i] = in ? p.lse[loff + rows[i]] : INFINITY;
    dlt[i] = in ? p.delta[loff + rows[i]] : 0.f;
    bias_row[i] =
        bias_bh != nullptr && in ? bias_bh + rows[i] * p.bias_ss : nullptr;
  }

  float acc[D / 2];  // dQ: the m64nD accumulator
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
  const uint32_t q_lo = kmajor_lo(sQ + cw * 64 * 64);
  const uint32_t do_lo = kmajor_lo(sdO + cw * 64 * 64);
  if (n_list > 0) {
    mbar_wait(bar_q, 0);
    if (cw == 1) their_turn<kPingPong>(cw);  // warpgroup 0 goes first
  }

  // dS of the previous tile (the A operand of its dS K, issued beside the
  // next tile's S and dP) and its stage; -1 before the first tile.
  uint32_t pa[kKeys / 16][4];
  int prev = -1;
  int it = 0;
  for (int j = 0; j < n_list; ++j) {
    const bool partial = j >= L.n_full;
    const int kb = partial ? L.part[j - L.n_full] : L.full[j];
    const uint32_t* bits =
        partial ? p.bits + (size_t)L.slot[kb] * p.bq * p.words : nullptr;
    for (int u = 0; u < k_tiles; ++u, ++it) {
      const int col0 = kb * p.bk + u * kKeys;
      if (col0 >= p.sk) break;
      const int stage = it % kStages;
      // the tile's bias, loaded before the wait so that its latency hides
      // behind the products
      float bv[kMods ? kKeys / 2 : 1];
      if constexpr (kMods) {
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + jj * 8 + tig * 2 + (e & 1);
            bv[jj * 4 + e] = bias_row[e >> 1] != nullptr && col < p.sk
                                 ? bias_row[e >> 1][col]
                                 : 0.f;
          }
      }
      mbar_wait(&bar_full[stage], (it / kStages) & 1);

      // S = Q K^T, dP = dO V^T, and dQ += dS K of the previous tile
      float s[kKeys / 2], dp[kKeys / 2];
      my_turn<kPingPong>(cw);
      fence_regs<D / 2>(acc);
      fence_regs<kKeys / 4>(&pa[0][0]);
      wgmma_fence();
      qk_product<D, kKeys, T>(s, q_lo, kRows, kmajor_lo(sK(stage)));
      qk_product<D, kKeys, T>(dp, do_lo, kRows, kmajor_lo(sV(stage)));
      if (prev >= 0) pv_product<D, kKeys>(acc, pa, sK(prev));
      wgmma_commit();
      their_turn<kPingPong>(cw);
      wgmma_wait_all();
      fence_regs<kKeys / 2>(s);
      fence_regs<kKeys / 2>(dp);
      fence_regs<D / 2>(acc);
      fence_regs<kKeys / 4>(&pa[0][0]);
      if (prev >= 0 && lane == 0) mbar_arrive(&bar_empty[prev]);

      // dS = p (dP - delta) times the mod's derivative, also dbias.
      // Element e of n8-block jj: row rows[e >> 1], key
      // col0 + 8 jj + 2 tig + (e & 1).  Full tiles inside sk with no mod
      // take the plain branch.
      if (kMods || partial || col0 + kKeys > p.sk) {
        uint32_t w[2][kKeys / 32];  // the two rows' bits of this tile
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < kKeys / 32; ++k)
            w[i][k] = partial ? bits[brow[i] * p.words + u * (kKeys / 32) + k]
                              : ~0u;
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int c = jj * 8 + tig * 2 + (e & 1);  // in the tile
            const int col = col0 + c;
            float x = s[jj * 4 + e], dm = 1.f;
            if constexpr (kMods)
              x = flex_mod(p, x * p.scale + bv[jj * 4 + e], slope, rows[i],
                           col, &dm);
            const bool keep = col < p.sk && ((w[i][c >> 5] >> (c & 31)) & 1);
            const float pe = keep ? fast_exp2(fmaf(x, sc, -lse2[i])) : 0.f;
            const float ds = pe * (dp[jj * 4 + e] - dlt[i]) * dm;
            if constexpr (kMods) {
              if (dbias_bh != nullptr && rows[i] < p.sq && col < p.sk)
                dbias_bh[(size_t)rows[i] * p.sk + col] = ds;
            }
            s[jj * 4 + e] = ds;
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            s[jj * 4 + e] = fast_exp2(fmaf(s[jj * 4 + e], sc, -lse2[i])) *
                            (dp[jj * 4 + e] - dlt[i]);
          }
      }
      // dS as the A operand of dQ += dS K (the forward's P trick)
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = Mma<T>::pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      prev = stage;
    }
  }
  if (prev >= 0) {  // the last tile's dS K
    my_turn<kPingPong>(cw);
    fence_regs<D / 2>(acc);
    fence_regs<kKeys / 4>(&pa[0][0]);
    wgmma_fence();
    pv_product<D, kKeys>(acc, pa, sK(prev));
    wgmma_commit();
    if (cw == 0) their_turn<kPingPong>(cw);  // 1 takes the last turn
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<kKeys / 4>(&pa[0][0]);
    if (lane == 0) mbar_arrive(&bar_empty[prev]);
  }

  // dQ = scale * sum dS K (the scale applied once, here)
  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.sq) continue;
    T* drow = dq + (((size_t)bb * p.sq + rows[i]) * p.h + hq) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) = Mma<T>::pack(
          acc[4 * n + 2 * i] * p.scale, acc[4 * n + 2 * i + 1] * p.scale);
  }
}

template <typename T, int D, bool kMods, int kKeys>
__global__ void __launch_bounds__(DkvCfg<D, kKeys>::kThreads, 1)
    flex_bwd_dkv_kernel(const FlexParams p,
                        const __grid_constant__ BwdMaps maps) {
  using Cfg = DkvCfg<D, kKeys>;
  constexpr int kRows = Cfg::kRows;
  constexpr int kWords = Cfg::kWords;
  constexpr int kStages = Cfg::kStages;
  constexpr int kDBlocks = D / 64;
  constexpr bool kSplitQ = Cfg::kSplitQ;
  // the tile's bias fits in registers beside dK, dV, S^T and dP^T at d = 64
  constexpr bool kBiasRegs = kMods && D == 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // aligned by an offset, so that its pointers stay shared (32-bit) ones
  unsigned char* smem = smem_raw + (-smem_u32(smem_raw) & 1023);
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + Cfg::kKBytes);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOffset);
  uint64_t* bar_full = bar_kv + 1;
  uint64_t* bar_empty = bar_full + kStages;
  auto sQ = [&](int stage) {
    return reinterpret_cast<T*>(smem + 2 * Cfg::kKBytes +
                                stage * 2 * Cfg::kTileBytes);
  };
  auto sdO = [&](int stage) { return sQ(stage) + kRows * D; };
  // lse2[kRows], delta[kRows], then bits[kRows][kWords] of a stage
  auto meta = [&](int stage) {
    return reinterpret_cast<float*>(smem + Cfg::kMetaOffset +
                                    stage * Cfg::kMetaBytes);
  };

  const dim3 blk = bwd_block(p);
  const int sub_k = p.bk / kKeys;
  const int kb = blk.x / sub_k;
  const int c_in = (blk.x % sub_k) * kKeys;  // first key in the block
  const int key0 = kb * p.bk + c_in;
  const int hkv = blk.y, bb = blk.z;
  if (key0 >= p.sk) return;
  const int g = p.h / p.hk;
  const int sq_pad = (p.sq + 63) & ~63;  // lse and delta rows (the wrapper's)

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      // one arrival per consuming warp
      mbar_init(&bar_empty[s], kSplitQ ? 4 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread loads K and V once, then keeps the ring of
    // (Q, dO) stages full: the two tiles by TMA, and the rows' lse (log2
    // units) and delta and, for a partial block, the bit words of the
    // block's keys by bulk copies, all completing on the stage's barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kProducerRegs));
    if (threadIdx.x != 0) return;
    mbar_expect_tx(bar_kv, 2 * Cfg::kKBytes);
#pragma unroll
    for (int c = 0; c < kDBlocks; ++c) {
      tma_load(&maps.k, sK + c * kKeys * 64, bar_kv, c * 64, hkv, key0, bb);
      tma_load(&maps.v, sV + c * kKeys * 64, bar_kv, c * 64, hkv, key0, bb);
    }
    int it = 0;
    for (int hq = hkv * g; hq < (hkv + 1) * g; ++hq) {
      // (bb, table head, kb) and (bb, table head) as flat indices
      const int bt = bb * p.th + (p.th == 1 ? 0 : hq);
      const int t = bt * p.nk + kb;
      const int n_full = p.full_q_num[t], n_list = n_full + p.q_num[t];
      const size_t loff = ((size_t)bb * p.h + hq) * sq_pad;
      for (int j = 0; j < n_list; ++j) {
        const bool partial = j >= n_full;
        const int qi =
            partial ? p.q_idx[(size_t)t * p.l_q_part + j - n_full]
                    : p.full_q_idx[(size_t)t * p.l_q_full + j];
        // the bits of (slot, key chunk), kRows * kWords words a stage
        const uint32_t* bits =
            partial ? p.bits + ((size_t)p.slot[((size_t)bt * p.nq + qi) *
                                                   p.nk + kb] * sub_k +
                                c_in / kKeys) * p.bq * kWords
                    : nullptr;
        for (int tq = 0; tq < p.bq / kRows; ++tq, ++it) {
          const int row0 = qi * p.bq + tq * kRows;
          if (row0 >= p.sq) break;
          const int stage = it % kStages;
          mbar_wait(&bar_empty[stage], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&bar_full[stage],
                         2 * Cfg::kTileBytes + 8 * kRows +
                             (partial ? 4 * kRows * kWords : 0));
#pragma unroll
          for (int c = 0; c < kDBlocks; ++c) {
            tma_load(&maps.q, sQ(stage) + c * kRows * 64, &bar_full[stage],
                     c * 64, hq, row0, bb);
            tma_load(&maps.dout, sdO(stage) + c * kRows * 64,
                     &bar_full[stage], c * 64, hq, row0, bb);
          }
          float* m = meta(stage);
          bulk_load(m, p.lse + loff + row0, 4 * kRows, &bar_full[stage]);
          bulk_load(m + kRows, p.delta + loff + row0, 4 * kRows,
                    &bar_full[stage]);
          if (partial)
            bulk_load(m + 2 * kRows, bits + tq * kRows * kWords,
                      4 * kRows * kWords, &bar_full[stage]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns keys [64 cw, 64 cw + 64) of the block
  // (kSplitQ: all 64, and the stages it % 2 == cw); this thread keys
  // key_lo and key_lo + 8, bits bsh and bsh + 8 of bit word wsel; vm has
  // those two bits set where the key is below sk.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Cfg::kConsumerRegs));
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kw = kSplitQ ? 0 : cw * 64;  // the warpgroup's first key
  const int kl = kw + warp * 16 + gid;   // key in the block
  const int key_lo = key0 + kl;
  const int wsel = kl >> 5, bsh = kl & 31;
  const uint32_t vm = (key_lo < p.sk ? 1u << bsh : 0u) |
                      (key_lo + 8 < p.sk ? 1u << (bsh + 8) : 0u);
  const float sc = kMods ? kLog2e : p.scale * kLog2e;

  float dk[D / 2], dv[D / 2];  // m64nD accumulators
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dk[n] = dv[n] = 0.f;
  // K, V: this warpgroup's 64 rows, K-major (the A operands of S^T and
  // dP^T); Q, dO of a stage: K-major as B of those, MN-major as B of
  // dK += dS^T Q and dV += P^T dO.
  const uint32_t k_lo = kmajor_lo(sK + kw * 64);
  const uint32_t v_lo = kmajor_lo(sV + kw * 64);
  mbar_wait(bar_kv, 0);
  if (cw == 1) their_turn<true>(cw);  // warpgroup 0 goes first

  int it = 0;
  for (int hq = hkv * g; hq < (hkv + 1) * g; ++hq) {
    const int t = (bb * p.th + (p.th == 1 ? 0 : hq)) * p.nk + kb;
    const int n_full = p.full_q_num[t], n_list = n_full + p.q_num[t];
    const float* bias_bh = bias_head(p, bb, hq);
    const float slope = p.mod == kModRelPos ? p.slopes[hq] : 0.f;
    for (int j = 0; j < n_list; ++j) {
      const bool partial = j >= n_full;
      const int qi = partial ? p.q_idx[(size_t)t * p.l_q_part + j - n_full]
                             : p.full_q_idx[(size_t)t * p.l_q_full + j];
      for (int tq = 0; tq < p.bq / kRows; ++tq, ++it) {
        const int row0 = qi * p.bq + tq * kRows;
        if (row0 >= p.sq) break;
        if (kSplitQ && (it & 1) != cw) continue;
        const int stage = it % kStages;
        // Element e of n8-block jj: key key_lo + 8 (e >> 1), q row
        // row0 + 8 jj + 2 tig + (e & 1).
        float bv[kBiasRegs ? kRows / 2 : 1];
        if constexpr (kBiasRegs) {
#pragma unroll
          for (int jj = 0; jj < kRows / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row0 + jj * 8 + tig * 2 + (e & 1);
              const int col = key_lo + 8 * (e >> 1);
              bv[jj * 4 + e] =
                  bias_bh != nullptr && row < p.sq && col < p.sk
                      ? bias_bh[row * p.bias_ss + col]
                      : 0.f;
            }
        }
        mbar_wait(&bar_full[stage], (it / kStages) & 1);

        // S^T = K Q^T, dP^T = V dO^T
        float st[kRows / 2], dpt[kRows / 2];
        my_turn<true>(cw);
        wgmma_fence();
        qk_product<D, kRows, T>(st, k_lo, kKeys, kmajor_lo(sQ(stage)));
        qk_product<D, kRows, T>(dpt, v_lo, kKeys, kmajor_lo(sdO(stage)));
        wgmma_commit();
        their_turn<true>(cw);
        wgmma_wait_all();
        fence_regs<kRows / 2>(st);
        fence_regs<kRows / 2>(dpt);

        // P^T and dS^T = P^T (dP^T - delta) times the mod's derivative,
        // packed into the A operands one k16 step (two n8 blocks) at a time
        const float* ml = meta(stage);
        const uint32_t* mb = reinterpret_cast<const uint32_t*>(ml + 2 * kRows);
        uint32_t pa[kRows / 16][4], pds[kRows / 16][4];
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
          for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj) {
            const int qc = jj * 8 + tig * 2;  // q row in the tile
            const float2 l2 = *reinterpret_cast<const float2*>(ml + qc);
            const float2 dl =
                *reinterpret_cast<const float2*>(ml + kRows + qc);
            uint32_t w[2] = {vm, vm};
            if (partial) {
              w[0] &= mb[qc * kWords + wsel];
              w[1] &= mb[(qc + 1) * kWords + wsel];
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = e & 1, i = e >> 1;
              float x = st[jj * 4 + e], dm = 1.f;
              if constexpr (kBiasRegs)
                x = flex_mod(p, x * p.scale + bv[jj * 4 + e], slope,
                             row0 + qc + c, key_lo + 8 * i, &dm);
              else if constexpr (kMods)
                x = flex_score<true>(p, x, bias_bh, slope, row0 + qc + c,
                                     key_lo + 8 * i, &dm);
              const bool keep = (w[c] >> (bsh + 8 * i)) & 1;
              const float pe =
                  keep ? fast_exp2(fmaf(x, sc, -(c ? l2.y : l2.x))) : 0.f;
              st[jj * 4 + e] = pe;
              dpt[jj * 4 + e] =
                  pe * (dpt[jj * 4 + e] - (c ? dl.y : dl.x)) * dm;
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] =
                Mma<T>::pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            pds[kk][r] =
                Mma<T>::pack(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
          }
        }

        // dV += P^T dO, dK += dS^T Q
        my_turn<true>(cw);
        fence_regs<D / 2>(dk);
        fence_regs<D / 2>(dv);
        fence_regs<kRows / 4>(&pa[0][0]);
        fence_regs<kRows / 4>(&pds[0][0]);
        wgmma_fence();
        pv_product<D, kRows>(dv, pa, sdO(stage));
        pv_product<D, kRows>(dk, pds, sQ(stage));
        wgmma_commit();
        their_turn<true>(cw);
        wgmma_wait_all();
        fence_regs<D / 2>(dk);
        fence_regs<D / 2>(dv);
        fence_regs<kRows / 4>(&pa[0][0]);
        fence_regs<kRows / 4>(&pds[0][0]);
        if (lane == 0) mbar_arrive(&bar_empty[stage]);
      }
    }
  }
  if constexpr (kSplitQ) {
    // warpgroup 1 took one stage fewer where the count is odd: it gives
    // that stage's two turns without products
    if (cw == 1 && (it & 1)) {
      my_turn<true>(cw);
      their_turn<true>(cw);
      my_turn<true>(cw);
      their_turn<true>(cw);
    }
  }
  if (cw == 0) my_turn<true>(cw);  // the turn 1 gave first
  if constexpr (kSplitQ) {
    // dK, dV = warpgroup 0's sums + warpgroup 1's, through the stages'
    // tile buffers (free once both are done: named barrier 3)
    float4* red = reinterpret_cast<float4*>(smem + 2 * Cfg::kKBytes);
    const int t = ct & 127;
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    if (cw == 1) {
      // the buffers' last writes came through the async proxy (TMA)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        red[n * 128 + t] =
            make_float4(dk[4 * n], dk[4 * n + 1], dk[4 * n + 2], dk[4 * n + 3]);
        red[(D / 8 + n) * 128 + t] =
            make_float4(dv[4 * n], dv[4 * n + 1], dv[4 * n + 2], dv[4 * n + 3]);
      }
    }
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    if (cw == 1) return;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float4 a = red[n * 128 + t];
      dk[4 * n] += a.x;
      dk[4 * n + 1] += a.y;
      dk[4 * n + 2] += a.z;
      dk[4 * n + 3] += a.w;
    }
    // warpgroup 0 alone: keeps dV's loads behind dK's adds (registers)
    asm volatile("bar.sync 4, 128;\n" ::: "memory");
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float4 b = red[(D / 8 + n) * 128 + t];
      dv[4 * n] += b.x;
      dv[4 * n + 1] += b.y;
      dv[4 * n + 2] += b.z;
      dv[4 * n + 3] += b.w;
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= p.sk) continue;
    const size_t base =
        (((size_t)bb * p.sk + key) * p.hk + hkv) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dkp + base + n * 8) = Mma<T>::pack(
          dk[4 * n + 2 * i] * p.scale, dk[4 * n + 2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + base + n * 8) =
          Mma<T>::pack(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
}

template <typename T, int D, bool kMods, int kRows, int kKeys>
int launch_fwd_tiles(const FlexParams& p, cudaStream_t stream) {
  using Cfg = FwdCfg<D, kRows, kKeys>;
  FwdMaps maps;
  int err = encode_map<T>(&maps.q, p.q, D, p.h, p.sq, p.b, p.q_sh, p.q_ss,
                          p.q_sb, kRows);
  if (!err)
    err = encode_map<T>(&maps.k, p.k, D, p.hk, p.sk, p.b, p.k_sh, p.k_ss,
                        p.k_sb, kKeys);
  if (!err)
    err = encode_map<T>(&maps.v, p.v, D, p.hk, p.sk, p.b, p.v_sh, p.v_ss,
                        p.v_sb, kKeys);
  if (err) return err;
  auto kernel = flex_fwd_kernel<T, D, kMods, kRows, kKeys>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.nq * (p.bq / kRows), p.h, p.b);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p, maps);
  return cudaGetLastError();
}

// The forward's tiles (kernels/flex.py::fwd_tile mirrors this rule): 128 q
// rows when block_q allows, else 64; 128 keys when block_k allows, else 64.
template <typename T, int D, bool kMods>
int launch_fwd(const FlexParams& p, cudaStream_t stream) {
  const bool rows128 = p.bq % 128 == 0, keys128 = p.bk % 128 == 0;
  if (rows128 && keys128)
    return launch_fwd_tiles<T, D, kMods, 128, 128>(p, stream);
  if (rows128) return launch_fwd_tiles<T, D, kMods, 128, 64>(p, stream);
  if (keys128) return launch_fwd_tiles<T, D, kMods, 64, 128>(p, stream);
  return launch_fwd_tiles<T, D, kMods, 64, 64>(p, stream);
}

// The backward's descriptors: q and do in boxes of q_rows rows, k and v of
// k_rows.
template <typename T>
int encode_bwd_maps(BwdMaps* m, const FlexParams& p, int d, int q_rows,
                    int k_rows) {
  int err = encode_map<T>(&m->q, p.q, d, p.h, p.sq, p.b, p.q_sh, p.q_ss,
                          p.q_sb, q_rows);
  if (!err)
    err = encode_map<T>(&m->dout, p.dout, d, p.h, p.sq, p.b, p.do_sh,
                        p.do_ss, p.do_sb, q_rows);
  if (!err)
    err = encode_map<T>(&m->k, p.k, d, p.hk, p.sk, p.b, p.k_sh, p.k_ss,
                        p.k_sb, k_rows);
  if (!err)
    err = encode_map<T>(&m->v, p.v, d, p.hk, p.sk, p.b, p.v_sh, p.v_ss,
                        p.v_sb, k_rows);
  return err;
}

template <typename T, int D, bool kMods, int kRows>
int launch_dq_tiles(const FlexParams& p, cudaStream_t stream) {
  using Cfg = DqCfg<D, kRows>;
  BwdMaps maps;
  const int err = encode_bwd_maps<T>(&maps, p, D, kRows, Cfg::kKeys);
  if (err) return err;
  auto kernel = flex_bwd_dq_kernel<T, D, kMods, kRows>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.nq * (p.bq / kRows), p.h, p.b);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <typename T, int D, bool kMods, int kKeys>
int launch_dkv_tiles(const FlexParams& p, cudaStream_t stream) {
  using Cfg = DkvCfg<D, kKeys>;
  BwdMaps maps;
  const int err = encode_bwd_maps<T>(&maps, p, D, Cfg::kRows, kKeys);
  if (err) return err;
  auto kernel = flex_bwd_dkv_kernel<T, D, kMods, kKeys>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.nk * (p.bk / kKeys), p.hk, p.b);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p, maps);
  return cudaGetLastError();
}

// The backward's tiles (kernels/flex.py::bwd_tile mirrors this rule): dQ
// 128 q rows when block_q allows, else 64; dK/dV 128 keys when block_k
// allows, else 64.
template <typename T, int D, bool kMods>
int launch_dq(const FlexParams& p, cudaStream_t stream) {
  if (p.bq % 128 == 0) return launch_dq_tiles<T, D, kMods, 128>(p, stream);
  return launch_dq_tiles<T, D, kMods, 64>(p, stream);
}

template <typename T, int D, bool kMods>
int launch_dkv(const FlexParams& p, cudaStream_t stream) {
  if (p.bk % 128 == 0) return launch_dkv_tiles<T, D, kMods, 128>(p, stream);
  return launch_dkv_tiles<T, D, kMods, 64>(p, stream);
}

enum { kFwd, kDq, kDkv };

template <int kKind, typename T, int D, bool kMods>
int launch_kind(const FlexParams& p, cudaStream_t s) {
  if constexpr (kKind == kFwd) return launch_fwd<T, D, kMods>(p, s);
  if constexpr (kKind == kDq) return launch_dq<T, D, kMods>(p, s);
  return launch_dkv<T, D, kMods>(p, s);
}

template <int kKind, typename T, int D>
int launch(const FlexParams& p, cudaStream_t s) {
  // kMods = false also folds the scale into the forward's exponent and
  // takes row maxima of raw scores, which needs scale > 0
  if (p.mod != kModNone || p.bias != nullptr || !(p.scale > 0.f))
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
  if (err >= kTmaError)
    return "cuTensorMapEncodeTiled failed (the code less 1 << 20 is its "
           "CUresult)";
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
