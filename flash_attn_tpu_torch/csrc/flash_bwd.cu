// Flash-attention backward for Hopper (sm_90a), bf16 / fp16 in, fp32
// accumulate.
//
// Replaces the Pallas TPU kernels flash_attn_tpu/kernels/flash_bwd.py::
// _bwd_dq_kernel (:121, launched at :1185) and _bwd_dkv_kernel (:232,
// launched at :1230), and serves the calls the JAX package sends to the
// fused kernels _bwd_fused_kernel (:507) and _bwd_fused_sched_kernel (:851):
// all four compute (dq, dk, dv) from (do, q, k, v, lse, delta).  The dO.O
// preprocess that the JAX wrapper leaves to XLA (:1063-1067) is folded into
// the dQ kernel.  Its varlen mode (flash_bwd_varlen) replaces the packed
// varlen backward flash_attn_tpu/kernels/varlen_sched.py::_varlen_bwd_kernel
// (:643, launched at :874).
//
// What bounds it on the H100: operations.  The minimal backward does 10*d
// FLOPs per live (row, key) pair and head against ~(4 sq + 4 sk) * d bytes
// per head; at the GPT-2 training shape that is ~32 GFLOP against ~0.1 GB,
// far above the card's ~295 FLOP/byte balance point.  So the tensor cores
// must not wait.
//
// Why two kernels and not one fused pass: the TPU's fused kernels keep a
// whole head's dQ in VMEM across a grid that runs in order on one core.  On
// Hopper blocks run in parallel and in no order, so one pass would sum dQ
// across blocks with atomics (not deterministic) or through a second pass
// over a large partial buffer.  The recompute split needs neither: each
// kernel recomputes P from lse and writes its outputs once, at the price of
// 7 tile products (S, dP, dQ; S^T, dP^T, dV, dK) against the minimal 5.  No
// atomics, and every sum in a fixed order: bitwise deterministic.
//
// The design (that of flex.cu's backward, with arithmetic masks in place of
// its block lists and bits).  The dQ kernel runs first, then the dK/dV
// kernel, on one stream, because the second reads what the first writes:
// * flash_bwd_dq_kernel: a block owns 128 q rows of one (head, batch), two
//   consumer warpgroups of 64 rows; one producer thread loads Q, dO and O
//   once by TMA and keeps a ring of K/V stages full (128 keys at d = 64, 64
//   at d = 128, as the registers allow).  The consumers first form delta =
//   rowsum(dO O) - dlse in fp32 from the shared tiles, in a fixed order,
//   and write it with the rows' lse in log2 units (+inf on rows that take
//   no part) to a stats buffer the wrapper allocates, padded to the
//   tile.  Then per key tile: S = Q K^T and dP = dO V^T on
//   wgmma from shared memory, dS = P (dP - delta) in fp32 registers, which
//   become the A operand of dQ += dS K (K read MN-major), issued beside the
//   next tile's S and dP.  The two consumers take the tensor cores in turns
//   (named barriers).  Under a causal or right-windowed mask the blocks run
//   in reverse order of their q tile: heaviest first.
// * flash_bwd_dkv_kernel: a block owns 128 keys of one (kv head, batch), K
//   and V resident, two consumer warpgroups of 64 keys.  It walks its GQA
//   group's heads, then the live 64-row q tiles (32 with a mod at d = 128,
//   for registers), in a fixed order: the producer thread keeps a ring of
//   (Q, dO) stages full by TMA, the rows' lse and delta coming from the
//   stats buffer by bulk copies on the same barrier.  S^T = K Q^T and dP^T
//   = V dO^T run on wgmma; P^T and dS^T are formed in registers as the A
//   operands of dV += P^T dO and dK += dS^T Q (Q, dO read MN-major): no
//   shared-memory round trip.  GQA is reduced in the kernel.
// * Masks: a tile wholly inside seqused_k and the causal / window band
//   takes no mask test (rows at or past seqused_q take no part through
//   their lse of +inf); the diagonal and edge tiles test each element
//   against the band of keys its row sees.  Calls with neither softcap nor
//   ALiBi run kernels compiled apart (kMods = false), free of the
//   per-element mod arithmetic.
// * Dropout (kDropout, beside kMods as in flash_fwd.cu, with and without
//   the mods): both kernels recompute the forward's keep mask
//   (fa_common.cuh's drop_keep; seed, threshold and scale in BwdMaps, so
//   BwdParams keeps its layout) and apply it as _bwd_dkv_kernel:300-314
//   does: dP is dropped and scaled by 1 / (1 - p), dS = P (dP - delta) takes
//   the undropped P, and dV the dropped P, its 1 / (1 - p) applied once at
//   the store.  delta = rowsum(dO O) of the forward's (dropped) O needs no
//   change.  The dQ thread keeps its rows' hash terms and adds each key
//   tile's column term; the dK/dV thread keeps its keys' terms (per GQA
//   head) and adds each stage's row term; each element is hashed where it
//   is used, beside the exponentials (hashing a tile into bits between
//   issuing its products and waiting for them was 7-14 % slower).
//   Registers again: with dropout and a mod, the d = 64 dQ kernel spilled
//   48-120 bytes a thread at 128-key stages, and takes 64-key stages; the
//   d = 128 dK/dV kernel with dropout spilled 16-28 at 64-row stages, and
//   takes 32-row stages (DqTiles, DkvTiles).
// * What is hard: registers.  dK/dV's consumers hold dK and dV (64 + 64
//   fp32 a thread at d = 128), S^T and dP^T (32 + 32) and their 16-bit
//   packs; setmaxnreg gives them 240 and the producer 24, which is why the
//   producer only issues copies.  And the varlen tiles' ends: a tile that
//   runs past its sequence loads the neighbour's rows, which the key masks
//   and the rows' lse of +inf keep out of every product; outputs are
//   written only inside the block's own sequence.
//
// Semantics: scores are recomputed in the forward's order (scale, softcap,
// ALiBi, masks; modded below), and p = exp2(score - lse * log2(e)).  A row with
// lse = +inf gives dq = 0, keys at or past seqused_k get dk = dv = 0, and
// rows at or past seqused_q take no part (the callers pass do = 0 there).
// dS carries the softcap derivative 1 - tanh^2, and the softmax scale is
// applied once to dQ and dK at the end.
//
// Layouts: dense (b, h, s, d) tensors through 4-D tensor maps over (d, h,
// s, b), rows past s read as zeros; lse and dlse (b, h, sq).  Varlen:
// packed (total, h, d) streams read and written in place (fa_common.cuh's
// SeqLayout) through maps over (d, h, total, 1); lse (h, total_q); sequence
// bb owns rows [cu_q[bb], cu_q[bb + 1]) and keys [cu_k[bb], cu_k[bb + 1]);
// tokens outside every sequence are not written.  Stats: lse2, then delta,
// each (b, h, stats_len) dense (sq rounded up to 128) or (h, stats_len)
// varlen, sequence bb's rows starting at cu_q[bb] rounded up to 4, plus
// kStatsGap * bb: a 128-row tile never reaches the next sequence's rows,
// and a stage starts 16-byte aligned (kernels/flash_bwd.py::stats_rows and
// varlen_stats_rows mirror this rule).

#include <limits.h>

#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

using namespace fa;

constexpr int kStatsGap = 132;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // natural log: (b, h, sq) dense, (h, total_q) varlen
  const float* dlse;  // the cotangent of lse, in lse's layout, or null
  float* stats;       // lse2 then delta (see the note): dQ writes, dK/dV reads
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
  int total_q;    // varlen: the head stride of lse
  int stats_len;  // rows of one head's stats
  float scale_log2;  // scale * log2(e)
  float cap_k2;      // 2 log2(e) / softcap (0 without softcap): see modded
  int dq_items;      // q tiles a dQ block owns, 1 or DqTiles::kMaxItems
};

// The modded score of raw score s, in the forward's order (scale, softcap,
// ALiBi; the masks are tested apart), in natural units: dist = row +
// offset - col is its ALiBi distance, slope the head's slope (0 without
// ALiBi); *dm is the softcap derivative 1 - tanh^2.  tanh is hopper.cuh's
// tanh_ex2, on the special function unit; cap_k2 is computed once, on the
// host.
__device__ __forceinline__ float modded(const BwdParams& p, float slope,
                                        float s, int dist, float* dm) {
  float x = s * p.scale;
  *dm = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanh_ex2(x, p.cap_k2);
    x = t * p.softcap;
    *dm = 1.f - t * t;
  }
  return x - slope * fabsf((float)dist);
}

__device__ __forceinline__ float alibi_slope(const BwdParams& p, int bb,
                                             int hq) {
  return p.alibi ? p.alibi[bb * p.h + hq] : 0.f;
}

// Row 0 of (bb, hq)'s lse2 in p.stats; its delta lies stats_half(p) further.
template <bool kVarlen>
__device__ __forceinline__ size_t stats_row0(const BwdParams& p, int bb,
                                             int hq, int q_start) {
  if constexpr (kVarlen)
    return (size_t)hq * p.stats_len + ((q_start + 3) & ~3) +
           (size_t)kStatsGap * bb;
  return ((size_t)bb * p.h + hq) * p.stats_len;
}

template <bool kVarlen>
__device__ __forceinline__ size_t stats_half(const BwdParams& p) {
  return (size_t)(kVarlen ? 1 : p.b) * p.h * p.stats_len;
}

// The rows [lo, hi] that attend key col (none past seqused_k).
__device__ __forceinline__ int2 row_band(const BwdParams& p, int col,
                                         int offset, int sk_b) {
  if (col >= sk_b) return make_int2(1, 0);
  return make_int2(p.has_upper ? col - offset - p.wr : INT_MIN,
                   p.has_lower ? col - offset + p.wl : INT_MAX);
}

// p = exp2(score - lse2) of one raw score s, 0 where !keep, and *ds = p (dp
// - delta) times the softcap derivative.  kMods: the score is modded()'s;
// else s * scale.
template <bool kMods>
__device__ __forceinline__ float p_and_ds(const BwdParams& p, float slope,
                                          float s, float dp, int dist,
                                          bool keep, float lse2, float delta,
                                          float* ds) {
  if constexpr (kMods) {
    float dm;
    const float x = modded(p, slope, s, dist, &dm);
    const float pe = keep ? fast_exp2(fmaf(x, kLog2e, -lse2)) : 0.f;
    *ds = pe * (dp - delta) * dm;
    return pe;
  } else {
    const float pe = keep ? fast_exp2(fmaf(s, p.scale_log2, -lse2)) : 0.f;
    *ds = pe * (dp - delta);
    return pe;
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// sum + the products of 8 pairs of 16-bit values, in order, in fp32.
template <typename T>
__device__ __forceinline__ float dot8(float sum, uint4 a, uint4 b) {
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int i = 0; i < 8; ++i) sum = fmaf(to_float(x[i]), to_float(y[i]), sum);
  return sum;
}

// The dQ kernel's tiles and shared memory: a block owns p.dq_items (at most
// kMaxItems) q tiles of 128 rows (two consumer warpgroups of 64) of one
// (head, batch), one after the other, with Q, dO and O of each resident,
// and walks K/V in kKeys-key tiles through a ring of kStages; warpgroup 0
// is the producer.  Tiles as
// hopper.cuh's: D / 64 column blocks of (rows, 64) in the 128-byte swizzle,
// 1024-byte aligned.  kTight: the kernel carries both the mods and dropout.
template <int D, bool kTight>
struct DqTiles {
  static constexpr int kRows = 128;
  // keys of a K/V stage: 128 at d = 64 (S, dP, dQ and dS fit in 240
  // registers), 64 at d = 128 and with both the mods and dropout
  static constexpr int kKeys = D == 64 && !kTight ? 128 : 64;
  // q tiles a block can own: 2 at d = 64, where a second set of Q, dO and
  // O fits beside the ring, so that the second tile's loads and start hide
  // behind the first tile's products (kernels/flash_bwd.py::dq_items
  // chooses, from the grid and the card's SM count)
  static constexpr int kMaxItems = D == 64 ? 2 : 1;
  static constexpr int kThreads = 3 * 128;
  static constexpr int kQBytes = kRows * D * 2;     // Q, dO or O
  static constexpr int kItemBytes = 3 * kQBytes;    // Q, dO and O
  static constexpr int kTileBytes = kKeys * D * 2;  // K or V
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  // as many K/V stages (2 to 4) as 227 KB hold beside the items
  static constexpr int kFit =
      (227 * 1024 - 1024 - kMaxItems * kItemBytes - 64) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 2 ? 2 : kFit > 4 ? 4 : kFit;
  static constexpr int kRingOffset = kMaxItems * kItemBytes;
  static constexpr int kBarOffset = kRingOffset + kStages * 2 * kTileBytes;
  // barriers: one per item, then full[kStages], then empty[kStages]; 1024
  // bytes of slack to align the dynamic buffer
  static constexpr int kSmem =
      1024 + kBarOffset + (kMaxItems + 2 * kStages) * 8;
};

// The key tiles [lo, lo + n) of kKeys keys that any row (< rows_in) of the
// q tile of kRows rows at row0 sees.
template <int kRows, int kKeys>
__device__ __forceinline__ int2 key_tiles(const BwdParams& p, int row0,
                                          int rows_in, int offset,
                                          int sk_b) {
  const int row_max = min(row0 + kRows, rows_in) - 1;
  int max_col = row_max >= row0 ? sk_b - 1 : -1;
  if (p.has_upper) max_col = min(max_col, row_max + offset + p.wr);
  const int min_col = p.has_lower ? max(0, row0 + offset - p.wl) : 0;
  const int lo = min_col / kKeys;
  return make_int2(lo, max_col >= min_col ? max_col / kKeys - lo + 1 : 0);
}

// The dK/dV kernel's: a block owns 128 keys (two consumer warpgroups of 64)
// with K and V resident, and walks Q / dO in kRows-row tiles through a ring
// whose stages also carry the rows' lse2 and delta.  kRows is 64, and 32
// with a mod or dropout (kExtra) at d = 128: there dK, dV, S^T, dP^T and
// the mod's arithmetic spilled 24-44 bytes a thread at 64 rows.
template <int D, bool kExtra>
struct DkvTiles {
  static constexpr int kKeys = 128;
  static constexpr int kRows = kExtra && D == 128 ? 32 : 64;
  static constexpr int kThreads = 3 * 128;
  static constexpr int kKBytes = kKeys * D * 2;     // K or V
  static constexpr int kTileBytes = kRows * D * 2;  // Q or dO
  static constexpr int kMetaBytes = 2 * kRows * 4;  // lse2, delta
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kFit = (227 * 1024 - 1024 - 2 * kKBytes - 64) /
                              (2 * kTileBytes + kMetaBytes);
  static constexpr int kStages = kFit < 2 ? 2 : kFit > 4 ? 4 : kFit;
  static constexpr int kMetaOffset = 2 * kKBytes + kStages * 2 * kTileBytes;
  static constexpr int kBarOffset = kMetaOffset + kStages * kMetaBytes;
  // barriers: K and V, then full[kStages], then empty[kStages]
  static constexpr int kSmem = 1024 + kBarOffset + (1 + 2 * kStages) * 8;
};

// The TMA descriptors (built on the host by launch): q, do and o in boxes
// of the kernel's q rows, k and v of its keys; the dK/dV kernel reads no o.
// Then the dropout's parameters, which only the kDropout kernels read.
struct BwdMaps {
  CUtensorMap q, dout, o, k, v;
  Dropout drop;
};

// dS of one key tile for one dQ consumer thread: s (S, then dS) and dp in
// the m64nK accumulator layout (element e of n8 block jj: row rows[e >> 1],
// key col0 + 8 jj + 2 tig + (e & 1)), packed into pa as the A operand of
// dQ += dS K.  kMask: the masks are tested (edge tiles).  kDropout: dP is
// dropped and scaled first; drow are the rows' hash terms, dtile the
// column term of key col0 + 2 tig.
template <bool kMods, bool kMask, bool kDropout, int kKeys, typename T>
__device__ __forceinline__ void dq_tile_ds(const BwdParams& p, float slope,
                                           float* s,
                                           const float* dp, uint32_t (*pa)[4],
                                           int col0, const int* rows,
                                           int offset, int sk_b,
                                           const float* lse2, const float* dlt,
                                           int tig, const uint32_t* drow,
                                           uint32_t dtile,
                                           const Dropout& drop) {
  int2 band[2] = {make_int2(0, INT_MAX), make_int2(0, INT_MAX)};
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
      const bool keep = !kMask || (col >= band[i].x && col <= band[i].y);
      float dpv = dp[jj * 4 + e];
      if constexpr (kDropout) {
        const uint32_t x =
            drow[i] + dtile + (uint32_t)(jj * 8 + (e & 1)) * kHashC4;
        dpv = drop_keep(x, drop.thresh) ? dpv * drop.rp : 0.f;
      }
      float ds;
      p_and_ds<kMods>(p, slope, s[jj * 4 + e], dpv, rows[i] + offset - col,
                      keep, lse2[i], dlt[i], &ds);
      s[jj * 4 + e] = ds;
    }
  // the accumulator of two adjacent n8 blocks is the A fragment of one k16
  // step
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = Mma<T>::pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <typename T, int D, bool kVarlen, bool kMods, bool kDropout>
__global__ void __launch_bounds__(DqTiles<D, kMods && kDropout>::kThreads,
                                  1)
    flash_bwd_dq_kernel(const BwdParams p,
                        const __grid_constant__ BwdMaps maps) {
  using Cfg = DqTiles<D, kMods && kDropout>;
  constexpr int kRows = Cfg::kRows;
  constexpr int kKeys = Cfg::kKeys;
  constexpr int kMaxItems = Cfg::kMaxItems;
  constexpr int kStages = Cfg::kStages;
  constexpr int kDBlocks = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // aligned by an offset, so that its pointers stay shared (32-bit) ones
  unsigned char* smem = smem_raw + (-smem_u32(smem_raw) & 1023);
  // item j's Q, dO, O
  auto sQ = [&](int j) {
    return reinterpret_cast<T*>(smem + j * Cfg::kItemBytes);
  };
  auto sdO = [&](int j) { return sQ(j) + kRows * D; };
  auto sO = [&](int j) { return sQ(j) + 2 * kRows * D; };
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOffset);
  uint64_t* bar_full = bar_q + kMaxItems;
  uint64_t* bar_empty = bar_full + kStages;
  auto sK = [&](int stage) {
    return reinterpret_cast<T*>(smem + Cfg::kRingOffset +
                                stage * 2 * Cfg::kTileBytes);
  };
  auto sV = [&](int stage) { return sK(stage) + kKeys * D; };

  const int hq = blockIdx.y, bb = blockIdx.z;
  const SeqLayout L = seq_layout<kVarlen>(p.lens_q, p.lens_k, bb, p.h, p.hk,
                                          p.sq, p.sk, p.total_q, D);
  // The block's q tiles, heaviest first: under a causal or right-windowed
  // mask a q tile sees more keys the later its rows.  With two items, block
  // x owns tiles n - 1 - x and x of the sequence's n, which evens the
  // blocks' work under a causal mask; with one, the blocks run in reverse
  // order of their tile.
  int tiles[kMaxItems];
  int n_items;
  if (kMaxItems == 1 || p.dq_items == 1) {
    tiles[0] = p.has_upper ? (int)(gridDim.x - 1 - blockIdx.x)
                           : (int)blockIdx.x;
    n_items = tiles[0] * kRows < L.q_rows ? 1 : 0;
  } else {
    const int x = blockIdx.x;
    const int n = (L.q_rows + kRows - 1) / kRows;
    tiles[0] = n - 1 - x;
    tiles[kMaxItems - 1] = x;
    n_items = tiles[0] > x ? 2 : tiles[0] == x ? 1 : 0;
  }
  if (n_items == 0) return;  // past this sequence's rows
  const int sk_b = L.sk_b;
  const int offset = sk_b - L.sq_b;
  const int rows_in = min(L.sq_b, L.q_rows);  // rows that take part
  // TMA coordinates: a row of the packed stream in batch 0 (varlen), or a
  // row of the batch's own tensor
  const int q_start = kVarlen ? p.lens_q[bb] : 0;
  const int k_start = kVarlen ? p.lens_k[bb] : 0;
  const int tb = kVarlen ? 0 : bb;

  if (threadIdx.x == 0) {
    for (int j = 0; j < kMaxItems; ++j) mbar_init(&bar_q[j], 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread loads every item's Q, dO and O at once, then
    // keeps the K/V ring full, item after item; the rest of the warpgroup
    // gives its registers to the consumers and leaves.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kProducerRegs));
    if (threadIdx.x != 0) return;
    const int hkv = hq / p.g;
    for (int j = 0; j < n_items; ++j) {
      const int row = q_start + tiles[j] * kRows;
      mbar_expect_tx(&bar_q[j], Cfg::kItemBytes);
#pragma unroll
      for (int c = 0; c < kDBlocks; ++c) {
        tma_load(&maps.q, sQ(j) + c * kRows * 64, &bar_q[j], c * 64, hq,
                 row, tb);
        tma_load(&maps.dout, sdO(j) + c * kRows * 64, &bar_q[j], c * 64, hq,
                 row, tb);
        tma_load(&maps.o, sO(j) + c * kRows * 64, &bar_q[j], c * 64, hq,
                 row, tb);
      }
    }
    int it = 0;
    for (int j = 0; j < n_items; ++j) {
      const int2 kt = key_tiles<kRows, kKeys>(p, tiles[j] * kRows, rows_in,
                                              offset, sk_b);
      for (int t = 0; t < kt.y; ++t, ++it) {
        const int col0 = (kt.x + t) * kKeys;
        const int stage = it % kStages;
        mbar_wait(&bar_empty[stage], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&bar_full[stage], 2 * Cfg::kTileBytes);
#pragma unroll
        for (int c = 0; c < kDBlocks; ++c) {
          tma_load(&maps.k, sK(stage) + c * kKeys * 64, &bar_full[stage],
                   c * 64, hkv, k_start + col0, tb);
          tma_load(&maps.v, sV(stage) + c * kKeys * 64, &bar_full[stage],
                   c * 64, hkv, k_start + col0, tb);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each item;
  // this thread rows r_lo and r_lo + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Cfg::kConsumerRegs));
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_lo = cw * 64 + warp * 16 + gid;
  const float slope = alibi_slope(p, bb, hq);
  const size_t loff = L.l_head(hq);
  // dropout: the (seed, batch, head) base and this thread's column term at
  // a tile's key 0
  uint32_t dbase = 0u, dcol = 0u;
  if constexpr (kDropout) {
    dbase = drop_base(maps.drop.seed, kVarlen ? 0 : bb, hq);
    dcol = (uint32_t)(k_start + tig * 2) * kHashC4;
  }
  if (cw == 1) their_turn<true>(cw);  // warpgroup 0 goes first

  int it = 0;  // the ring's stages, counted over the items
  for (int j = 0; j < n_items; ++j) {
    const int row0 = tiles[j] * kRows;
    const int w_row0 = row0 + cw * 64;
    const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};
    const int2 kt = key_tiles<kRows, kKeys>(p, row0, rows_in, offset, sk_b);
    uint32_t drow[2] = {0u, 0u};  // the rows' dropout hash terms
    if constexpr (kDropout) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        drow[i] = (uint32_t)(q_start + rows[i]) * kHashC3 + dbase;
    }
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lse2[i] = rows[i] < rows_in ? p.lse[loff + rows[i]] * kLog2e : INFINITY;

    // delta = rowsum(dO O) - dlse in fp32, in a fixed order: this thread
    // sums the 16-byte chunks tig and tig + 4 of each 64-column block of
    // its row (the 128-byte swizzle keeps chunk j of row r at j ^ (r & 7)),
    // then the quad adds its four sums, which gives each of its threads the
    // same bits.
    mbar_wait(&bar_q[j], 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kDBlocks; ++c)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int chunk = (tig + 4 * u) ^ (r & 7);
          const int off = (c * kRows + r) * 64 + chunk * 8;
          sum = dot8<T>(sum, *reinterpret_cast<const uint4*>(sdO(j) + off),
                        *reinterpret_cast<const uint4*>(sO(j) + off));
        }
      dlt[i] = quad_sum(sum);
      if (p.dlse != nullptr && rows[i] < L.q_rows)
        dlt[i] -= p.dlse[loff + rows[i]];
    }
    if (tig == 0) {
      // for the dK/dV kernel: every row of the tile, padding included
      float* st = p.stats + stats_row0<kVarlen>(p, bb, hq, q_start);
      const size_t half = stats_half<kVarlen>(p);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st[rows[i]] = lse2[i];
        st[half + rows[i]] = dlt[i];
      }
    }

    float acc[D / 2];  // dQ: the m64nD accumulator
#pragma unroll
    for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
    const uint32_t q_lo = kmajor_lo(sQ(j) + cw * 64 * 64);
    const uint32_t do_lo = kmajor_lo(sdO(j) + cw * 64 * 64);

    // dS of the previous tile (the A operand of its dS K, issued beside
    // the next tile's S and dP)
    uint32_t pa[kKeys / 16][4];
    for (int t = 0; t < kt.y; ++t, ++it) {
      const int col0 = (kt.x + t) * kKeys;
      const int stage = it % kStages;
      const int prev = (it + kStages - 1) % kStages;
      mbar_wait(&bar_full[stage], (it / kStages) & 1);

      // S = Q K^T, dP = dO V^T, and dQ += dS K of the previous tile
      float s[kKeys / 2], dp[kKeys / 2];
      my_turn<true>(cw);
      fence_regs<D / 2>(acc);
      fence_regs<kKeys / 4>(&pa[0][0]);
      wgmma_fence();
      qk_product<D, kKeys, T>(s, q_lo, kRows, kmajor_lo(sK(stage)));
      qk_product<D, kKeys, T>(dp, do_lo, kRows, kmajor_lo(sV(stage)));
      if (t > 0) pv_product<D, kKeys>(acc, pa, sK(prev));
      wgmma_commit();
      their_turn<true>(cw);
      wgmma_wait_all();
      fence_regs<kKeys / 2>(s);
      fence_regs<kKeys / 2>(dp);
      fence_regs<D / 2>(acc);
      fence_regs<kKeys / 4>(&pa[0][0]);
      if (t > 0 && lane == 0) mbar_arrive(&bar_empty[prev]);

      const uint32_t dtile = dcol + (uint32_t)col0 * kHashC4;
      if (interior(p, w_row0, 64, col0, kKeys, offset, sk_b))
        dq_tile_ds<kMods, false, kDropout, kKeys, T>(
            p, slope, s, dp, pa, col0, rows, offset, sk_b, lse2, dlt, tig,
            drow, dtile, maps.drop);
      else
        dq_tile_ds<kMods, true, kDropout, kKeys, T>(
            p, slope, s, dp, pa, col0, rows, offset, sk_b, lse2, dlt, tig,
            drow, dtile, maps.drop);
    }
    if (kt.y > 0) {  // the last tile's dS K
      const int last = (it + kStages - 1) % kStages;
      my_turn<true>(cw);
      fence_regs<D / 2>(acc);
      fence_regs<kKeys / 4>(&pa[0][0]);
      wgmma_fence();
      pv_product<D, kKeys>(acc, pa, sK(last));
      wgmma_commit();
      their_turn<true>(cw);
      wgmma_wait_all();
      fence_regs<D / 2>(acc);
      fence_regs<kKeys / 4>(&pa[0][0]);
      if (lane == 0) mbar_arrive(&bar_empty[last]);
    }

    // dQ = scale * sum dS K (the scale applied once, here)
    T* dq = static_cast<T*>(p.dq) + L.q_head(hq);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= L.q_rows) continue;
      T* drow = dq + (size_t)rows[i] * L.q_rs + tig * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(drow + n * 8) = Mma<T>::pack(
            acc[4 * n + 2 * i] * p.scale, acc[4 * n + 2 * i + 1] * p.scale);
    }
  }
  if (cw == 0) my_turn<true>(cw);  // the turn warpgroup 1 gave first
}

// P^T and dS^T of one stage for one dK/dV consumer thread: st (S^T, then
// P^T) and dpt (dP^T, then dS^T) in the m64nR accumulator layout (element
// e of n8 block jj: key key_lo + 8 (e >> 1), q row row0 + 8 jj + 2 tig +
// (e & 1)), the rows' lse2 and delta at ml, packed into pa and pds as the A
// operands of dV += P^T dO and dK += dS^T Q.  kDropout: dP^T is dropped
// and scaled, and P^T for dV dropped (its scale applied at the store); dkey
// are the keys' hash terms, dstage the row term of row row0 + 2 tig.
template <bool kMods, bool kMask, bool kDropout, int kRows, typename T>
__device__ __forceinline__ void dkv_tile_p_ds(const BwdParams& p,
                                              float slope, float* st,
                                              float* dpt,
                                              uint32_t (*pa)[4],
                                              uint32_t (*pds)[4],
                                              const float* ml, int row0,
                                              int key_lo, int offset,
                                              int sk_b, int tig,
                                              const uint32_t* dkey,
                                              uint32_t dstage,
                                              const Dropout& drop) {
  int2 band[2] = {make_int2(INT_MIN, INT_MAX), make_int2(INT_MIN, INT_MAX)};
  if constexpr (kMask) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      band[i] = row_band(p, key_lo + 8 * i, offset, sk_b);
  }
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
    for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj) {
      const int qc = jj * 8 + tig * 2;  // q row in the stage
      const float2 l2 = *reinterpret_cast<const float2*>(ml + qc);
      const float2 dl = *reinterpret_cast<const float2*>(ml + kRows + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1, i = e >> 1;
        const int row = row0 + qc + c;
        const bool keep = !kMask || (row >= band[i].x && row <= band[i].y);
        float dpv = dpt[jj * 4 + e];
        bool kept = true;
        if constexpr (kDropout) {
          kept = drop_keep(dkey[i] + dstage + (uint32_t)(jj * 8 + c) * kHashC3,
                           drop.thresh);
          dpv = kept ? dpv * drop.rp : 0.f;
        }
        float ds;
        const float pe = p_and_ds<kMods>(
            p, slope, st[jj * 4 + e], dpv, row + offset - key_lo - 8 * i,
            keep, c ? l2.y : l2.x, c ? dl.y : dl.x, &ds);
        st[jj * 4 + e] = kept ? pe : 0.f;
        dpt[jj * 4 + e] = ds;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kk][r] = Mma<T>::pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
      pds[kk][r] = Mma<T>::pack(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
    }
  }
}

template <typename T, int D, bool kVarlen, bool kMods, bool kDropout>
__global__ void __launch_bounds__(
    DkvTiles<D, kMods || kDropout>::kThreads, 1)
    flash_bwd_dkv_kernel(const BwdParams p,
                         const __grid_constant__ BwdMaps maps) {
  using Cfg = DkvTiles<D, kMods || kDropout>;
  constexpr int kRows = Cfg::kRows;
  constexpr int kKeys = Cfg::kKeys;
  constexpr int kStages = Cfg::kStages;
  constexpr int kDBlocks = D / 64;
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
  // lse2[kRows], then delta[kRows] of a stage
  auto meta = [&](int stage) {
    return reinterpret_cast<float*>(smem + Cfg::kMetaOffset +
                                    stage * Cfg::kMetaBytes);
  };

  const int hkv = blockIdx.y, bb = blockIdx.z;
  const SeqLayout L = seq_layout<kVarlen>(p.lens_q, p.lens_k, bb, p.h, p.hk,
                                          p.sq, p.sk, p.total_q, D);
  const int col0 = blockIdx.x * kKeys;
  if (col0 >= L.k_rows) return;  // past this sequence's keys
  const int sk_b = L.sk_b;
  const int offset = sk_b - L.sq_b;
  const int rows_in = min(L.sq_b, L.q_rows);
  // the 64-row q tiles holding a live (row, key) pair with this block's
  // keys below sk_b
  int qt_lo = 0, n_q = 0;
  const int c1 = min(col0 + kKeys, sk_b) - 1;
  if (c1 >= col0) {
    const int min_row = p.has_upper ? max(0, col0 - offset - p.wr) : 0;
    int max_row = rows_in - 1;
    if (p.has_lower) max_row = min(max_row, c1 - offset + p.wl);
    if (max_row >= min_row) {
      qt_lo = min_row / kRows;
      n_q = max_row / kRows - qt_lo + 1;
    }
  }
  const int q_start = kVarlen ? p.lens_q[bb] : 0;
  const int k_start = kVarlen ? p.lens_k[bb] : 0;
  const int tb = kVarlen ? 0 : bb;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread loads K and V once, then keeps the ring of (Q,
    // dO) stages full: the two tiles by TMA, the rows' lse2 and delta by
    // bulk copies, all completing on the stage's barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kProducerRegs));
    if (threadIdx.x != 0) return;
    mbar_expect_tx(bar_kv, 2 * Cfg::kKBytes);
#pragma unroll
    for (int c = 0; c < kDBlocks; ++c) {
      tma_load(&maps.k, sK + c * kKeys * 64, bar_kv, c * 64, hkv,
               k_start + col0, tb);
      tma_load(&maps.v, sV + c * kKeys * 64, bar_kv, c * 64, hkv,
               k_start + col0, tb);
    }
    const size_t half = stats_half<kVarlen>(p);
    int it = 0;
    for (int hq = hkv * p.g; hq < (hkv + 1) * p.g; ++hq) {
      const float* st = p.stats + stats_row0<kVarlen>(p, bb, hq, q_start);
      for (int t = 0; t < n_q; ++t, ++it) {
        const int row0 = (qt_lo + t) * kRows;
        const int stage = it % kStages;
        mbar_wait(&bar_empty[stage], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&bar_full[stage],
                       2 * Cfg::kTileBytes + Cfg::kMetaBytes);
#pragma unroll
        for (int c = 0; c < kDBlocks; ++c) {
          tma_load(&maps.q, sQ(stage) + c * kRows * 64, &bar_full[stage],
                   c * 64, hq, q_start + row0, tb);
          tma_load(&maps.dout, sdO(stage) + c * kRows * 64, &bar_full[stage],
                   c * 64, hq, q_start + row0, tb);
        }
        float* m = meta(stage);
        bulk_load(m, st + row0, 4 * kRows, &bar_full[stage]);
        bulk_load(m + kRows, st + half + row0, 4 * kRows, &bar_full[stage]);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns keys [64 cw, 64 cw + 64) of the block;
  // this thread keys key_lo and key_lo + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Cfg::kConsumerRegs));
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kw = cw * 64;
  const int w_col0 = col0 + kw;
  const int key_lo = w_col0 + warp * 16 + gid;

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
  for (int hq = hkv * p.g; hq < (hkv + 1) * p.g; ++hq) {
    const float slope = alibi_slope(p, bb, hq);
    // dropout: the keys' hash terms (key C4 plus the (seed, batch, q head)
    // base)
    uint32_t dkey[2] = {0u, 0u};
    if constexpr (kDropout) {
      const uint32_t base = drop_base(maps.drop.seed, kVarlen ? 0 : bb, hq);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        dkey[i] = (uint32_t)(k_start + key_lo + 8 * i) * kHashC4 + base;
    }
    for (int t = 0; t < n_q; ++t, ++it) {
      const int row0 = (qt_lo + t) * kRows;
      const int stage = it % kStages;
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

      uint32_t pa[kRows / 16][4], pds[kRows / 16][4];
      const uint32_t dstage = (uint32_t)(q_start + row0 + tig * 2) * kHashC3;
      if (interior(p, row0, kRows, w_col0, 64, offset, sk_b))
        dkv_tile_p_ds<kMods, false, kDropout, kRows, T>(
            p, slope, st, dpt, pa, pds, meta(stage), row0, key_lo, offset,
            sk_b, tig, dkey, dstage, maps.drop);
      else
        dkv_tile_p_ds<kMods, true, kDropout, kRows, T>(
            p, slope, st, dpt, pa, pds, meta(stage), row0, key_lo, offset,
            sk_b, tig, dkey, dstage, maps.drop);

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
  if (cw == 0) my_turn<true>(cw);  // the turn warpgroup 1 gave first

  // the layout read again: kept from the prologue, it held registers
  // through the loop
  const SeqLayout Lo = seq_layout<kVarlen>(p.lens_q, p.lens_k, bb, p.h,
                                           p.hk, p.sq, p.sk, p.total_q, D);
  T* dkp = static_cast<T*>(p.dk) + Lo.k_head(hkv);
  T* dvp = static_cast<T*>(p.dv) + Lo.k_head(hkv);
  const float dv_scale = kDropout ? maps.drop.rp : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= Lo.k_rows) continue;
    const size_t base = (size_t)key * Lo.k_rs + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dkp + base + n * 8) = Mma<T>::pack(
          dk[4 * n + 2 * i] * p.scale, dk[4 * n + 2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + base + n * 8) =
          Mma<T>::pack(dv[4 * n + 2 * i] * dv_scale,
                       dv[4 * n + 2 * i + 1] * dv_scale);
    }
  }
}

// Builds the two kernels' tensor maps and launches the dQ kernel, then the
// dK/dV kernel.  Dense tensors are (b, heads, s, d); a varlen stream
// (total, heads, d) is mapped as one batch of `total` rows.
template <typename T, int D, bool kVarlen, bool kMods, bool kDropout>
int launch(const BwdParams& p, const Dropout& drop, int total_k,
           cudaStream_t stream) {
  using Dq = DqTiles<D, kMods && kDropout>;
  using Dkv = DkvTiles<D, kMods || kDropout>;
  const int nb = kVarlen ? 1 : p.b;
  const int sq = kVarlen ? p.total_q : p.sq;
  const int sk = kVarlen ? total_k : p.sk;
  // element strides of a head, a row and a batch
  const long long q_sh = kVarlen ? D : (long long)sq * D;
  const long long q_ss = kVarlen ? (long long)p.h * D : D;
  const long long q_sb = (long long)p.h * sq * D;
  const long long k_sh = kVarlen ? D : (long long)sk * D;
  const long long k_ss = kVarlen ? (long long)p.hk * D : D;
  const long long k_sb = (long long)p.hk * sk * D;
  auto q_map = [&](CUtensorMap* m, const void* base, int rows) {
    return encode_map<T>(m, base, D, p.h, sq, nb, q_sh, q_ss, q_sb, rows);
  };
  auto k_map = [&](CUtensorMap* m, const void* base, int rows) {
    return encode_map<T>(m, base, D, p.hk, sk, nb, k_sh, k_ss, k_sb, rows);
  };
  BwdMaps dq_maps{}, dkv_maps{};
  dq_maps.drop = dkv_maps.drop = drop;
  int err = q_map(&dq_maps.q, p.q, Dq::kRows);
  if (!err) err = q_map(&dq_maps.dout, p.dout, Dq::kRows);
  if (!err) err = q_map(&dq_maps.o, p.o, Dq::kRows);
  if (!err) err = k_map(&dq_maps.k, p.k, Dq::kKeys);
  if (!err) err = k_map(&dq_maps.v, p.v, Dq::kKeys);
  if (!err) err = q_map(&dkv_maps.q, p.q, Dkv::kRows);
  if (!err) err = q_map(&dkv_maps.dout, p.dout, Dkv::kRows);
  if (!err) err = k_map(&dkv_maps.k, p.k, Dkv::kKeys);
  if (!err) err = k_map(&dkv_maps.v, p.v, Dkv::kKeys);
  if (err) return err;
  auto dq_kernel = flash_bwd_dq_kernel<T, D, kVarlen, kMods, kDropout>;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, D, kVarlen, kMods, kDropout>;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq::kSmem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Dkv::kSmem);
  if (e != cudaSuccess) return e;
  BwdParams pq = p;
  pq.dq_items = Dq::kMaxItems == 2 && p.dq_items == 2 ? 2 : 1;
  const int q_tiles = (p.sq + Dq::kRows - 1) / Dq::kRows;
  dim3 grid_dq((q_tiles + pq.dq_items - 1) / pq.dq_items, p.h, p.b);
  dq_kernel<<<grid_dq, Dq::kThreads, Dq::kSmem, stream>>>(pq, dq_maps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid_dkv((p.sk + Dkv::kKeys - 1) / Dkv::kKeys, p.hk, p.b);
  dkv_kernel<<<grid_dkv, Dkv::kThreads, Dkv::kSmem, stream>>>(p, dkv_maps);
  return cudaGetLastError();
}

// The parameters the kernels would otherwise compute in registers.
void set_host_constants(BwdParams* p) {
  p->scale_log2 = p->scale * kLog2e;
  p->cap_k2 = p->softcap > 0.f ? 2.f * kLog2e / p->softcap : 0.f;
}

// Calls with neither softcap nor ALiBi run the kMods = false kernels;
// calls with dropout the kDropout ones.
template <typename T, int D, bool kVarlen>
int launch_mods(const BwdParams& p, const Dropout& drop, int total_k,
                cudaStream_t stream) {
  const bool mods = p.softcap > 0.f || p.alibi != nullptr;
  if (drop.thresh != 0)
    return mods ? launch<T, D, kVarlen, true, true>(p, drop, total_k, stream)
                : launch<T, D, kVarlen, false, true>(p, drop, total_k, stream);
  if (mods) return launch<T, D, kVarlen, true, false>(p, drop, total_k, stream);
  return launch<T, D, kVarlen, false, false>(p, drop, total_k, stream);
}

template <bool kVarlen>
int dispatch(const BwdParams& p, const Dropout& drop, int total_k, int d,
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

// dtype: 0 = bf16, 1 = fp16.  Launches the dQ kernel, then the dK/dV
// kernel, on `stream`; returns cudaGetLastError() after the launches (or a
// tensor-map error, see fa_error_string).  do, q, o, dq (b, h, sq, d), k, v,
// dk, dv (b, hk, sk, d), all contiguous and 16-byte aligned; lse and dlse
// (or null) (b, h, sq) fp32; stats 2 * b * h * stats_len fp32 of scratch
// (stats_len = sq rounded up to 128); dq_items the q tiles a dQ block owns
// (2 is taken at d = 64 only; kernels/flash_bwd.py::dq_items); drop_seed,
// drop_thresh, drop_rp the forward's dropout (fa_common.cuh's Dropout; a
// threshold of 0 is no dropout).
extern "C" int flash_bwd(const void* dout, const void* q, const void* k,
                         const void* v, const void* o, const float* lse,
                         const float* dlse, float* stats, void* dq, void* dk,
                         void* dv, const int* seqused_q, const int* seqused_k,
                         const float* alibi, int b, int h, int hk, int sq,
                         int sk, int d, int dtype, float scale, int has_upper,
                         int wr, int has_lower, int wl, float softcap,
                         int stats_len, int dq_items, int drop_seed,
                         int drop_thresh, float drop_rp, void* stream) {
  if (b == 0 || h == 0 || sq == 0 || sk == 0) return 0;
  BwdParams p{q,     k,         v,         o,         dout,
              lse,   dlse,      stats,     dq,        dk,
              dv,    seqused_q, seqused_k, alibi,     b,
              h,     hk,        h / hk,    sq,        sk,
              scale, has_upper, wr,        has_lower, wl,
              softcap, 0, stats_len};
  set_host_constants(&p);
  p.dq_items = dq_items;
  const Dropout drop{(uint32_t)drop_seed, (uint32_t)drop_thresh, drop_rp};
  return dispatch<false>(p, drop, sk, d, dtype, stream);
}

// The packed varlen mode: do, q, o, dq (total_q, h, d), k, v, dk, dv
// (total_k, hk, d), contiguous and 16-byte aligned; lse (h, total_q); cu_q,
// cu_k (b + 1,) int32 offsets; max_sq, max_sk the longest sequence (they
// size the grids); stats 2 * h * stats_len fp32 of scratch (stats_len from
// kernels/flash_bwd.py::varlen_stats_rows); dq_items and the dropout's as
// flash_bwd's, hashed at packed-stream coordinates.  Tokens outside every
// sequence are not written.
extern "C" int flash_bwd_varlen(const void* dout, const void* q, const void* k,
                                const void* v, const void* o, const float* lse,
                                float* stats, void* dq, void* dk, void* dv,
                                const int* cu_q, const int* cu_k,
                                const float* alibi, int b, int h, int hk,
                                int max_sq, int max_sk, int total_q,
                                int total_k, int d, int dtype, float scale,
                                int has_upper, int wr, int has_lower, int wl,
                                float softcap, int stats_len, int dq_items,
                                int drop_seed, int drop_thresh,
                                float drop_rp, void* stream) {
  if (b == 0 || h == 0 || max_sq == 0 || max_sk == 0) return 0;
  BwdParams p{q,     k,         v,      o,         dout,
              lse,   nullptr,   stats,  dq,        dk,
              dv,    cu_q,      cu_k,   alibi,     b,
              h,     hk,        h / hk, max_sq,    max_sk,
              scale, has_upper, wr,     has_lower, wl,
              softcap, total_q, stats_len};
  set_host_constants(&p);
  p.dq_items = dq_items;
  const Dropout drop{(uint32_t)drop_seed, (uint32_t)drop_thresh, drop_rp};
  return dispatch<true>(p, drop, total_k, d, dtype, stream);
}
