// Flash-attention forward for Hopper (sm_90a), bf16 / fp16 in, fp32
// accumulate.
//
// Replaces the Pallas TPU kernel flash_attn_tpu/kernels/flash_fwd.py::
// _fwd_kernel (:200, launched at :1517 by flash_attn_fwd_bhsd), and serves
// the full-length causal/local calls that the JAX package sends to
// _fwd_sched_kernel (:870, launched at :1377).  Its varlen mode
// (flash_fwd_varlen) replaces the packed varlen kernel
// flash_attn_tpu/kernels/varlen_sched.py::_varlen_sched_kernel (:211,
// launched at :440).  Each computes o and lse (natural log, fp32).
//
// What bounds it on the H100: operations.  The forward does 4*d FLOPs per
// live (row, key) pair against q, k, v, o bytes read or written about once;
// at the serving and training shapes that is far above the card's ~295
// FLOP/byte balance point.  So the tensor cores must not wait.
//
// The design (that of flex.cu's forward, with arithmetic masks in place of
// its block lists and bits, as flash_bwd.cu's backward has them):
// * Tiles: at d = 128 a block owns 128 q rows of one (head, batch): two
//   consumer warpgroups of 64 rows that share every K/V tile and take the
//   tensor cores in turns (named barriers, hopper.cuh's my_turn /
//   their_turn), so that one's softmax runs while the other's products
//   run.  At d = 64 a block owns 64 rows, one consumer warpgroup, and two
//   blocks share an SM: one's loads, start and stores overlap the other's
//   products, where at d = 64 they weigh more against the products
//   (FwdTiles; kernels/flash_fwd.py::fwd_rows has the numbers that chose
//   it).  Key tiles are 128 wide.
// * Loads: warpgroup 0 is the producer.  One thread loads Q once by TMA,
//   then keeps a ring of K/V stages full (as many as the shared memory
//   holds: 3 at d = 64, two blocks an SM; 3 at d = 128), through full /
//   empty mbarriers.  4-D tensor maps over (d, heads, s, b) (dense) or
//   (d, heads, total, 1) (varlen) are built on the host from the strides
//   (hopper.cuh's encode_map); rows past s read as zeros.  setmaxnreg moves the
//   producer's registers to the consumers (24 / 240 at 128 rows, 24 / 232
//   at 64).
// * Products on wgmma: S = Q K^T from shared memory, both K-major; P,
//   converted to bf16 / fp16 in registers, is the A operand of O += P V,
//   V read MN-major.  Each consumer issues tile j's Q K^T beside tile
//   j - 1's P V in one commit group.
// * Masks by arithmetic: a block's key tiles are bounded by [n_min, n_max]
//   from the causal / window band and seqused_k (as _kv_block_bounds at
//   flash_fwd.py:176 does), so a causal call does about half the work and a
//   cache read stops at seqused_k.  A warpgroup's tile wholly inside
//   seqused_k and the band takes no mask test; only the diagonal and edge
//   tiles test each element against the band of keys its row sees.
// * Calls with neither softcap nor ALiBi (and a positive scale) run kernels
//   compiled apart (kMods = false): the raw score's scale is folded into
//   the exponent, and the element loop is a bare max.  The mod kernels
//   compute tanh on the special function unit (hopper.cuh's tanh_ex2), as
//   the backward does, so both see the same scores.
// * Dropout (kDropout, a template argument beside kMods, both with and
//   without the mods: instantiated with the mods only, a dropout forward
//   took 1.46-1.69x the time without dropout at the training shapes, and
//   without them 1.16-1.36x, on an H100 80GB HBM3 at 700 W; the file
//   builds in 39 s, 30 s before): the keep mask is fa_common.cuh's drop_keep,
//   whose seed, threshold and scale ride in FwdMaps (FwdParams keeps its
//   size).  Each consumer thread keeps its two rows' hash terms and its
//   first key's column term, adds the tile's column term, and per element
//   mixes and compares as P is packed (hashing a tile into bits while its
//   Q K^T ran was no faster).  The row sums l (and so the lse) are those of
//   the undropped P, as _fwd_kernel:336-348 has them; dropped entries enter
//   P V as 0, and the 1 / (1 - p) of the kept ones is folded into the
//   epilogue's 1 / l.
// * Order: under a causal or right-windowed mask the blocks run in reverse
//   order of their q tile, heaviest first.  Dense: the tile is the grid's
//   slowest dimension, so every head's heaviest tiles start before any
//   lighter one; varlen: its fastest (see below).
// * Stores: o and lse go from registers to device memory with per-row
//   guards: in varlen mode a tile can run past its sequence into the
//   neighbour's rows, which a whole-tile store would overwrite.
//
// Semantics: GQA reads kv head h / g.  Scores are scaled, softcapped (tanh),
// ALiBi-biased (slope times |row + offset - col|, the distance from the
// sequences' ends) and masked bottom-right (offset = seqused_k - seqused_q,
// len_k - len_q of the sequence varlen), then the online softmax runs in
// fp32 on exp2.  Rows at or past seqused_q are computed like any other row
// (the JAX kernel does not mask them either); rows past the tensor's sq are
// not written.  A row with no valid key writes o = 0 and lse = +inf.
//
// Varlen mode: q, o are packed (total_q, h, d) streams and k, v (total_k,
// hk, d), read in place with token strides h*d and hk*d (fa_common.cuh's
// SeqLayout); lse is (h, total_q).  The grid is (cdiv(max_seqlen_q, rows),
// h, b): a block owns one tile of one sequence and head, one sequence's
// blocks run together (a tile-major order would start the long sequences'
// last tiles, which only they have, last), and blocks past that
// sequence's length exit at once.  A tile that runs past its sequence
// reads the neighbour's rows and keys: the per-sequence key masks keep the
// keys out, and rows outside the sequence are not written.  Tokens outside
// every sequence are not written.

#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

using namespace fa;

struct FwdParams {
  const void* q;  // q, k, v: read by the tensor maps, built from these
  const void* k;
  const void* v;
  void* o;
  float* lse;
  // dense: seqused_q/k (b,); varlen: cu_seqlens_q/k (b + 1,)
  const int* lens_q;
  const int* lens_k;
  const float* alibi;  // (b, h) or null
  // varlen: sq, sk are the max lengths and total_q the lse's head stride.
  // The struct keeps its size (112 bytes): three more fields made the first
  // version's kernel ~20 % slower on an H100.  A new mode is a template
  // argument, never a field.
  int b, h, hk, total_q, sq, sk;
  float scale;
  int has_upper, wr, has_lower, wl;
  float softcap;
};

// The TMA descriptors (built on the host by launch), passed beside
// FwdParams so that it keeps its layout: q in boxes of the kernel's rows,
// k and v of its keys; then the dropout's parameters, which only the
// kDropout kernels read.
struct FwdMaps {
  CUtensorMap q, k, v;
  Dropout drop;
};

// The tiles and shared memory of head dim D: a block owns kRows q rows (one
// consumer warpgroup per 64) and walks K/V in kKeys-key tiles through a
// ring of kStages; warpgroup 0 is the producer.  Tiles as hopper.cuh's: D /
// 64 column blocks of (rows, 64) in the 128-byte swizzle, 1024-byte
// aligned.
template <int D>
struct FwdTiles {
  // kernels/flash_fwd.py::fwd_rows mirrors this rule
  static constexpr int kRows = D == 64 ? 64 : 128;
  static constexpr int kConsumers = kRows / 64;
  // 128; 64 where a 64-row block would otherwise not fit twice an SM (d =
  // 128 at 64 rows: diag/flash_ab.py's rows64 variant)
  static constexpr int kKeys = kRows == 64 && D == 128 ? 64 : 128;
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

// The scores of one key tile for one consumer thread, in place: s (the
// m64nK accumulator: element e of n8 block jj is row rows[e >> 1], key col0
// + 8 jj + 2 tig + (e & 1)) becomes the exponent's argument, and mx the
// two rows' maxima of it.  kMods: s becomes the modded score in log2 units
// (scale, softcap, ALiBi); else it stays raw, the scale folded into the
// exponent by the caller.  kMask: each element is tested against its row's
// band of keys (-inf outside).
template <bool kMods, bool kMask, int kKeys>
__device__ __forceinline__ void score_tile(const FwdParams& p, float* s,
                                           float* mx, int col0,
                                           const int* rows, int offset,
                                           int sk_b, float slope,
                                           float cap_k2, int tig) {
  int2 band[2];
  if constexpr (kMask) {
#pragma unroll
    for (int i = 0; i < 2; ++i) band[i] = key_band(p, rows[i], offset, sk_b);
  }
#pragma unroll
  for (int jj = 0; jj < kKeys / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int col = col0 + jj * 8 + tig * 2 + (e & 1);
      float x = s[jj * 4 + e];
      if constexpr (kMods) {
        x *= p.scale;
        if (p.softcap > 0.f) x = tanh_ex2(x, cap_k2) * p.softcap;
        x = (x - slope * fabsf((float)(rows[i] + offset - col))) * kLog2e;
      }
      if constexpr (kMask)
        x = col >= band[i].x && col <= band[i].y ? x : -INFINITY;
      s[jj * 4 + e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
}

template <typename T, int D, bool kVarlen, bool kMods, bool kDropout>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads,
                                  FwdTiles<D>::kMinBlocks)
    flash_fwd_kernel(const FwdParams p, const __grid_constant__ FwdMaps maps) {
  using Cfg = FwdTiles<D>;
  constexpr int kRows = Cfg::kRows;
  constexpr int kKeys = Cfg::kKeys;
  constexpr int kStages = Cfg::kStages;
  constexpr int kDBlocks = D / 64;
  constexpr bool kPingPong = Cfg::kConsumers == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // aligned by an offset, so that its pointers stay shared (32-bit) ones
  unsigned char* smem = smem_raw + (-smem_u32(smem_raw) & 1023);
  T* sQ = reinterpret_cast<T*>(smem);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOffset);
  uint64_t* bar_full = bar_q + 1;
  uint64_t* bar_empty = bar_full + kStages;
  auto sK = [&](int stage) {
    return reinterpret_cast<T*>(smem + Cfg::kQBytes +
                                stage * 2 * Cfg::kTileBytes);
  };
  auto sV = [&](int stage) { return sK(stage) + kKeys * D; };

  // The block's q tile, heaviest first under a causal or right-windowed
  // mask (a q tile sees more keys the later its rows); the grids' orders
  // are the note's (dense tile-major, varlen sequence-major).
  const int hq = kVarlen ? blockIdx.y : blockIdx.x;
  const int bb = kVarlen ? blockIdx.z : blockIdx.y;
  const int n_q = kVarlen ? gridDim.x : gridDim.z;
  const int tile_idx = kVarlen ? blockIdx.x : blockIdx.z;
  const int tile = p.has_upper ? n_q - 1 - tile_idx : tile_idx;
  const int row0 = tile * kRows;
  const SeqLayout L = seq_layout<kVarlen>(p.lens_q, p.lens_k, bb, p.h, p.hk,
                                          p.sq, p.sk, p.total_q, D);
  if (row0 >= L.q_rows) return;  // past this sequence's rows
  const int sk_b = L.sk_b;
  const int offset = sk_b - L.sq_b;
  // the key tiles [n_lo, n_lo + n_tiles) that any row of this q tile
  // present in memory sees
  const int row_max = min(row0 + kRows, L.q_rows) - 1;
  int max_col = sk_b - 1;
  if (p.has_upper) max_col = min(max_col, row_max + offset + p.wr);
  const int min_col = p.has_lower ? max(0, row0 + offset - p.wl) : 0;
  const int n_lo = min_col / kKeys;
  const int n_tiles = max_col >= min_col ? max_col / kKeys - n_lo + 1 : 0;
  // TMA coordinates: a row of the packed stream in batch 0 (varlen), or a
  // row of the batch's own tensor
  const int q_start = kVarlen ? p.lens_q[bb] : 0;
  const int k_start = kVarlen ? p.lens_k[bb] : 0;
  const int tb = kVarlen ? 0 : bb;

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
    // Producer: one thread loads Q, then keeps the K/V ring full; the rest
    // of the warpgroup gives its registers to the consumers and leaves.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kProducerRegs));
    if (threadIdx.x != 0 || n_tiles == 0) return;
    const int hkv = hq / (p.h / p.hk);
    mbar_expect_tx(bar_q, Cfg::kQBytes);
#pragma unroll
    for (int c = 0; c < kDBlocks; ++c)
      tma_load(&maps.q, sQ + c * kRows * 64, bar_q, c * 64, hq,
               q_start + row0, tb);
    for (int t = 0; t < n_tiles; ++t) {
      const int col0 = (n_lo + t) * kKeys;
      const int stage = t % kStages;
      mbar_wait(&bar_empty[stage], ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(&bar_full[stage], 2 * Cfg::kTileBytes);
#pragma unroll
      for (int c = 0; c < kDBlocks; ++c) {
        tma_load(&maps.k, sK(stage) + c * kKeys * 64, &bar_full[stage],
                 c * 64, hkv, k_start + col0, tb);
        tma_load(&maps.v, sV(stage) + c * kKeys * 64, &bar_full[stage],
                 c * 64, hkv, k_start + col0, tb);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of the tile; this
  // thread rows r_lo and r_lo + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Cfg::kConsumerRegs));
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_lo = cw * 64 + warp * 16 + gid;
  const int w_row0 = row0 + cw * 64;
  const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};
  const float slope = kMods && p.alibi ? p.alibi[bb * p.h + hq] : 0.f;
  // tanh(x / softcap) = 1 - 2 / (2^(x cap_k2) + 1)
  const float cap_k2 = kMods && p.softcap > 0.f ? 2.f * kLog2e / p.softcap
                                                : 0.f;
  // the exponent's factor on s: the scale in log2 units without a mod (the
  // launcher sends a scale <= 0 to kMods), 1 with one
  const float sc = kMods ? 1.f : p.scale * kLog2e;
  // dropout: each row's hash term (row C3 plus the (seed, batch, head)
  // base) and this thread's column term at a tile's key 0
  uint32_t drow[2] = {0u, 0u};
  uint32_t dcol = 0u;
  if constexpr (kDropout) {
    const uint32_t base = drop_base(maps.drop.seed, kVarlen ? 0 : bb, hq);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      drow[i] = (uint32_t)(q_start + rows[i]) * kHashC3 + base;
    dcol = (uint32_t)(k_start + tig * 2) * kHashC4;
  }

  float acc[D / 2];  // O: the m64nD accumulator
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
  const uint32_t q_lo = kmajor_lo(sQ + cw * 64 * 64);
  if (n_tiles > 0) {
    mbar_wait(bar_q, 0);
    if (cw == 1) their_turn<kPingPong>(cw);  // warpgroup 0 goes first
  }

  // P of the previous tile (the A operand of its P V, issued beside the
  // next tile's Q K^T)
  uint32_t pa[kKeys / 16][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int col0 = (n_lo + t) * kKeys;
    const int stage = t % kStages;
    const int prev = (t + kStages - 1) % kStages;
    mbar_wait(&bar_full[stage], (t / kStages) & 1);

    // S = Q K^T, and O += P V of the previous tile
    float s[kKeys / 2];
    my_turn<kPingPong>(cw);
    fence_regs<D / 2>(acc);
    fence_regs<kKeys / 4>(&pa[0][0]);
    wgmma_fence();
    qk_product<D, kKeys, T>(s, q_lo, kRows, kmajor_lo(sK(stage)));
    if (t > 0) pv_product<D, kKeys>(acc, pa, sV(prev));
    wgmma_commit();
    their_turn<kPingPong>(cw);
    wgmma_wait_all();
    fence_regs<kKeys / 2>(s);
    fence_regs<D / 2>(acc);
    fence_regs<kKeys / 4>(&pa[0][0]);
    if (t > 0 && lane == 0) mbar_arrive(&bar_empty[prev]);

    float mx[2] = {-INFINITY, -INFINITY};
    if (interior(p, w_row0, 64, col0, kKeys, offset, sk_b))
      score_tile<kMods, false, kKeys>(p, s, mx, col0, rows, offset, sk_b,
                                      slope, cap_k2, tig);
    else
      score_tile<kMods, true, kKeys>(p, s, mx, col0, rows, offset, sk_b,
                                     slope, cap_k2, tig);

    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], quad_max(mx[i]) * sc);
      // A row with nothing valid so far keeps m = -inf; exponentiate
      // against 0 then, so p = exp2(-inf) = 0 and no inf - inf appears.
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
    // P as the A operand: the accumulator of two adjacent n8 blocks is the
    // A fragment of one k16 step.  Dropout zeroes P after the row sums.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p0 = fast_exp2(fmaf(s[8 * kk + 2 * r], sc, -m_use[r & 1]));
        float p1 = fast_exp2(fmaf(s[8 * kk + 2 * r + 1], sc, -m_use[r & 1]));
        l_run[r & 1] += p0 + p1;
        if constexpr (kDropout) {
          const uint32_t x = drow[r & 1] + dcol + (uint32_t)col0 * kHashC4 +
                             (uint32_t)(8 * (2 * kk + (r >> 1))) * kHashC4;
          p0 = drop_keep(x, maps.drop.thresh) ? p0 : 0.f;
          p1 = drop_keep(x + kHashC4, maps.drop.thresh) ? p1 : 0.f;
        }
        pa[kk][r] = Mma<T>::pack(p0, p1);
      }
    }
  }
  if (n_tiles > 0) {  // the last tile's P V
    const int last = (n_tiles + kStages - 1) % kStages;
    my_turn<kPingPong>(cw);
    fence_regs<D / 2>(acc);
    fence_regs<kKeys / 4>(&pa[0][0]);
    wgmma_fence();
    pv_product<D, kKeys>(acc, pa, sV(last));
    wgmma_commit();
    if (cw == 0) their_turn<kPingPong>(cw);  // 1 takes the last turn
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<kKeys / 4>(&pa[0][0]);
  }

  // the layout read again: kept from the prologue, it held registers
  // through the loop
  const SeqLayout Lo = seq_layout<kVarlen>(p.lens_q, p.lens_k, bb, p.h,
                                           p.hk, p.sq, p.sk, p.total_q, D);
  T* o = static_cast<T*>(p.o) + Lo.q_head(hq);
  float* lse = p.lse + Lo.l_head(hq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    const int row = rows[i];
    if (row >= Lo.q_rows) continue;
    const float inv = l > 0.f ? (kDropout ? maps.drop.rp : 1.f) / l : 0.f;
    T* orow = o + (size_t)row * Lo.q_rs + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          Mma<T>::pack(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    if (tig == 0) lse[row] = l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : INFINITY;
  }
}

// Builds the tensor maps and launches the kernel.  Dense tensors are (b,
// heads, s, d); a varlen stream (total, heads, d) is mapped as one batch of
// `total` rows.  With no key at all (sk = 0) the K/V maps are built over q,
// which the kernel then never reads through them.
template <typename T, int D, bool kVarlen, bool kMods, bool kDropout>
int launch(const FwdParams& p, const Dropout& drop, int total_k,
           cudaStream_t stream) {
  using Cfg = FwdTiles<D>;
  constexpr int kRows = Cfg::kRows;
  const int nb = kVarlen ? 1 : p.b;
  const int sq = kVarlen ? p.total_q : p.sq;
  const int sk = kVarlen ? total_k : p.sk;
  // element strides of a head, a row and a batch
  const long long q_sh = kVarlen ? D : (long long)sq * D;
  const long long q_ss = kVarlen ? (long long)p.h * D : D;
  const long long q_sb = (long long)p.h * sq * D;
  FwdMaps maps{};
  maps.drop = drop;
  int err = encode_map<T>(&maps.q, p.q, D, p.h, sq, nb, q_sh, q_ss, q_sb,
                          kRows);
  if (sk > 0) {
    const long long k_sh = kVarlen ? D : (long long)sk * D;
    const long long k_ss = kVarlen ? (long long)p.hk * D : D;
    const long long k_sb = (long long)p.hk * sk * D;
    if (!err)
      err = encode_map<T>(&maps.k, p.k, D, p.hk, sk, nb, k_sh, k_ss, k_sb,
                          Cfg::kKeys);
    if (!err)
      err = encode_map<T>(&maps.v, p.v, D, p.hk, sk, nb, k_sh, k_ss, k_sb,
                          Cfg::kKeys);
  } else {
    maps.k = maps.v = maps.q;
  }
  if (err) return err;
  auto kernel = flash_fwd_kernel<T, D, kVarlen, kMods, kDropout>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  const int q_tiles = (p.sq + kRows - 1) / kRows;
  const dim3 grid = kVarlen ? dim3(q_tiles, p.h, p.b)
                            : dim3(p.h, p.b, q_tiles);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p, maps);
  return cudaGetLastError();
}

// Calls with neither softcap nor ALiBi, and a positive scale, run the
// kMods = false kernels; calls with dropout the kDropout ones.
template <typename T, int D, bool kVarlen>
int launch_mods(const FwdParams& p, const Dropout& drop, int total_k,
                cudaStream_t stream) {
  const bool mods = p.softcap > 0.f || p.alibi != nullptr || !(p.scale > 0.f);
  if (drop.thresh != 0)
    return mods ? launch<T, D, kVarlen, true, true>(p, drop, total_k, stream)
                : launch<T, D, kVarlen, false, true>(p, drop, total_k, stream);
  if (mods) return launch<T, D, kVarlen, true, false>(p, drop, total_k, stream);
  return launch<T, D, kVarlen, false, false>(p, drop, total_k, stream);
}

template <bool kVarlen>
int dispatch(const FwdParams& p, const Dropout& drop, int total_k, int d,
             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_mods<__nv_bfloat16, 64, kVarlen>(p, drop, total_k, s);
  if (dtype == 0 && d == 128)
    return launch_mods<__nv_bfloat16, 128, kVarlen>(p, drop, total_k, s);
  if (dtype == 1 && d == 64)
    return launch_mods<__half, 64, kVarlen>(p, drop, total_k, s);
  if (dtype == 1 && d == 128)
    return launch_mods<__half, 128, kVarlen>(p, drop, total_k, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  if (err >= kTmaError)
    return "cuTensorMapEncodeTiled failed (the code less 1 << 20 is its "
           "CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = bf16, 1 = fp16.  q, o (b, h, sq, d), k, v (b, hk, sk, d), all
// contiguous and 16-byte aligned; lse (b, h, sq) fp32; seqused_q/k (b,)
// int32; alibi (b, h) fp32 or null; drop_seed, drop_thresh, drop_rp the
// dropout's (fa_common.cuh's Dropout; a threshold of 0 is no dropout).
// Returns cudaGetLastError() after the launch (or a tensor-map error, see
// fa_error_string).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, const int* seqused_q, const int* seqused_k,
                         const float* alibi, int b, int h, int hk, int sq,
                         int sk, int d, int dtype, float scale, int has_upper,
                         int wr, int has_lower, int wl, float softcap,
                         int drop_seed, int drop_thresh, float drop_rp,
                         void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  FwdParams p{q, k, v, o, lse, seqused_q, seqused_k, alibi, b, h, hk, 0, sq,
              sk, scale, has_upper, wr, has_lower, wl, softcap};
  const Dropout drop{(uint32_t)drop_seed, (uint32_t)drop_thresh, drop_rp};
  return dispatch<false>(p, drop, sk, d, dtype, stream);
}

// The packed varlen mode: q, o (total_q, h, d), k, v (total_k, hk, d),
// contiguous and 16-byte aligned; lse (h, total_q); cu_q, cu_k (b + 1,)
// int32 offsets; max_sq, max_sk the longest sequence (they size the grid);
// the dropout's as flash_fwd's, hashed at packed-stream coordinates.
// Tokens outside every sequence are not written.
extern "C" int flash_fwd_varlen(const void* q, const void* k, const void* v,
                                void* o, float* lse, const int* cu_q,
                                const int* cu_k, const float* alibi, int b,
                                int h, int hk, int max_sq, int max_sk,
                                int total_q, int total_k, int d, int dtype,
                                float scale, int has_upper, int wr,
                                int has_lower, int wl, float softcap,
                                int drop_seed, int drop_thresh, float drop_rp,
                                void* stream) {
  if (b == 0 || h == 0 || max_sq == 0) return 0;
  FwdParams p{q, k, v, o, lse, cu_q, cu_k, alibi, b, h, hk, total_q, max_sq,
              max_sk, scale, has_upper, wr, has_lower, wl, softcap};
  const Dropout drop{(uint32_t)drop_seed, (uint32_t)drop_thresh, drop_rp};
  return dispatch<true>(p, drop, total_k, d, dtype, stream);
}
