// Split-KV decode attention over contiguous or paged KV caches, for Hopper
// (sm_90a): contiguous (bc, smax, hk, d) or heads-first (bc, hk, smax, d),
// paged (npages, page, hk, d) with a block table, and fused pages (npages, 2,
// page, hk, d); bf16 / fp16, int8 and fp8 (e4m3, e5m2) caches with
// per-(batch, kv head) descales.
//
// Replaces the Pallas TPU kernels flash_attn_tpu/kernels/flash_decode.py::
// _decode_ref_kernel (launched at flash_decode.py:1016 by
// decode_attn_ref_layout), _decode_paged_pipe_kernel (:1083, launched at
// :978), which computes the same function for paged bf16/fp16 caches with
// _PIPE_DEPTH page copies in flight, and _decode_kernel (:117, launched at
// :369 by decode_attn_bhsd), the same function over heads-first caches.
//
// What bounds it on the H100: bytes.  A decode step reads every live K/V row
// once and does ~4*g*sq FLOPs per pair of rows; at Llama-3-8B's widths (hk 8,
// d 128, g 4, batch 8, 64 pages of 256 rows a sequence) one call moves
// 536,870,912 B of bf16 cache for 2.1 GFLOP, far below the card's ratio of
// FLOPs to bytes.  The kernel has to keep the memory busy: enough blocks,
// enough loads in flight, and little work per byte between them.
//
// What the design does about it:
// * One block of 4 warps per (row tile, split, kv head, batch).  The q heads
//   of one kv head are packed into rows (packed row r is query position
//   r % sq of group head r // sq, flash_decode.py:836-840), so every cache
//   row a block reads serves all of its rows.  Up to 16 rows (a decode step)
//   take one 16-row tile and the 4 warps share out each key tile (16 keys a
//   warp); more rows (a chunked prefill) take 64-row tiles, 16 rows a warp,
//   each warp over the whole key tile.
// * Both products run on tensor cores with mma.sync.m16n8k16 and fp32
//   accumulation: Q K^T with K fragments from ldmatrix, P V with V fragments
//   from ldmatrix.trans (V is key-major).  Not wgmma: its 64-row minimum
//   would do 16x the needed math for the 4 rows a kv head of a decode step,
//   and bytes, not the tensor cores, are the limit here; a decode tile uses
//   4 of the m16 tile's 16 rows and that is accepted.  Q's fragments, the O
//   accumulator and the running max and sum stay in registers; shared memory
//   holds only the key ring, so no fp32 per-(row, key) array is kept there.
// * The grid's key split comes from the wrapper (decode_num_splits fills the
//   card with about two blocks an SM when b*hk*tiles does not), and the
//   splits are merged in the kernel: each block writes its partial O and LSE,
//   and the last block of a (row tile, kv head, batch) to finish, counted on
//   a semaphore it resets, merges them as combine_attn_partials does.
// * A block reads only its kv head's d contiguous elements of each key (at
//   stride hk*d, or d in the heads-first layout) in tiles of at most 64 keys
//   that never cross a page, and only the keys its rows can see (leftpad,
//   length, window, causal bound of the tile's positions).  Tiles arrive
//   through a cp.async ring (2 deep for 16-bit caches, with three blocks an
//   SM; 4 for 8-bit ones), the counterpart of the TPU pipe kernel's page
//   copies in flight.  With the key tile shared out, each warp copies and
//   waits for its own 16 rows: the warps of a block do not wait for each
//   other inside the loop, except int8's agreement on each tile's maximum.
// * 8-bit caches stay 8-bit in shared memory and are widened to the 16-bit
//   compute type in registers, on their way to the fragments: K through an
//   8-bit ldmatrix whose bytes land in the B fragment's slots once Q's
//   columns are taken in the same order, V through ldmatrix and a movmatrix
//   transpose (sm_90 has no 8-bit ldmatrix.trans), its bytes split into the
//   fragments of the even and the odd d's.  fp8 (e4m3, e5m2) into bf16 or
//   fp16 is exact; kfac (scale times k descale) scales the scores and vfac
//   (v descale) P V, as flash_decode.py:594-628 does.  int8 stays exact:
//   the query arrives quantised per (batch, kv head) (the wrapper does it,
//   :957-963); Q K^T takes route (a), mma.m16n8k32 s8 with int32 sums, K's
//   bytes straight from an 8-bit ldmatrix; P V takes route (b): the
//   quantised P = rint(127 p) (integers in 0..127) and V are widened to
//   fp16, which is exact, and the fp16 mma sums them in fp32 exactly, since
//   every partial sum of a 64-key tile stays below 2^24 (at most 64 * 127^2
//   ~ 1.03e6).  So both integer products are exact, as the JAX kernel's
//   int32 dots (:614, :661); a 16-key warp's share of P V is converted to
//   float before the warps' O are summed.  P is quantised after each 64-key tile against the running
//   maximum of the tiles seen so far in the split (:552-553, :656-662); the
//   warps sharing a tile agree on its maximum through shared memory first.
// * A row with no key in a split writes o = 0 and lse = +inf.
// * Head dims: the kernel is instantiated at D = 64, 128, 192 and 256, and a
//   call's d runs at D = d rounded up to a multiple of 64
//   (kernels/flash_fwd.py::kernel_head_dim).  q, the cache rows and o_part
//   hold d values a row (Params.d); the ring's rows are D wide, their
//   16-byte chunks past d zero-filled by the cp.async (src_bytes = 0), so
//   they add nothing to Q K^T and give O zero columns, which the stores
//   skip.  A cache row must be whole 16-byte chunks: d a multiple of 8 for
//   16-bit caches, of 16 for 8-bit ones.  At D > 128 Q's fragments live in
//   shared memory, read at each k step: in registers they would take 48-64
//   a thread beside O's 96-128, and the 64-row tile would spill.  D 192
//   and 256 build into a library of their own (FA_DECODE_WIDE), beside the
//   one of D 64 and 128, so that the two build in parallel.  For the
//   same reason int8's P V accumulates there into O itself (in units of the
//   V descale, applied at the end) instead of forming each tile's integer
//   sums apart: the products stay exact, and each k16 step's sum rounds
//   once into O's fp32 (against once a tile at D <= 128).
//
// Masks (flash_decode.py:578-590): keys before cache_leftpad and at or past
// cache_seqlens; with rel = key - leftpad and offset = len - leftpad - sq,
// causal / right window rel > pos + offset + wr, left window rel < pos +
// offset - wl, attention_chunk floor(rel / c) != floor((pos + offset) / c).
// Scores: scale (times q scale and k descale), softcap, ALiBi, then masks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fa_common.cuh"

namespace {

using fa::Mma;
using fa::quad_max;
using fa::quad_sum;

constexpr int kTileN = 64;  // keys per tile: the int8 quantisation unit
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;  // (b, hk, rows, d) packed; int8 for int8 caches
  const unsigned char* k;
  const unsigned char* v;  // unused for fused pages
  float* o_part;           // (b, hk, splits, rows, d); split 0 holds the merge
  float* lse_part;         // (b, hk, splits, rows)
  int* sems;               // (b, hk, row tiles) zeroed counters; splits > 1
  const int* seqlens;      // (b,)
  const int* leftpad;      // (b,) or null
  const int* cache_batch_idx;  // (b,) or null; contiguous caches only
  const int* block_table;      // (b, nk_max) or null
  const float* alibi;          // (b, h) or null
  const float* q_scale;        // (b, hk), int8 caches
  const float* k_descale;      // (b, hk) or null
  const float* v_descale;      // (b, hk) or null
  int b, h, hk, g, sq, rows;
  int d;  // the head dim of q, o_part and the cache rows (<= D)
  int paged, fused, page, nk_max, smax;
  int heads_first;  // contiguous cache laid out (bc, hk, smax, d)
  int splits, split_keys;
  float scale;
  int has_upper, wr, has_lower, wl, chunk;
  float softcap;
};

template <__nv_fp8_interpretation_t K>
struct Fp8 {};

// Cache element types: bytes per element, and for 8-bit ones the widening of
// four elements (one 32-bit word) to two words of the compute type T: in
// order (widen4, fp8 K), or as the even and the odd bytes (split4, V).
template <typename TC>
struct Cache {
  static constexpr int kBytes = 2;  // bf16 / fp16: the compute type itself
};

template <>
struct Cache<int8_t> {
  static constexpr int kBytes = 1;
  // Bytes 0 and 2 (`even`), 1 and 3 (`odd`) of w, each pair as fp16, exact:
  // with the sign bit flipped a byte is x + 128, and fp16 0x64XX is
  // 1024 + XX, so subtracting 1152 leaves x.
  template <typename T>
  static __device__ __forceinline__ void split4(uint32_t w, uint32_t& even, uint32_t& odd) {
    static_assert(std::is_same<T, __half>::value, "int8 P V runs in fp16");
    const uint32_t u = w ^ 0x80808080u;
    uint32_t e = __byte_perm(u, 0x64646464u, 0x4240);
    uint32_t o = __byte_perm(u, 0x64646464u, 0x4341);
    const __half2 bias = __half2half2(__ushort_as_half(0x6480));  // 1152
    const __half2 he = __hsub2(*reinterpret_cast<__half2*>(&e), bias);
    const __half2 ho = __hsub2(*reinterpret_cast<__half2*>(&o), bias);
    even = *reinterpret_cast<const uint32_t*>(&he);
    odd = *reinterpret_cast<const uint32_t*>(&ho);
  }
};

template <__nv_fp8_interpretation_t K>
struct Cache<Fp8<K>> {
  static constexpr int kBytes = 1;
  // fp8 -> fp16 is exact, and so is fp16 -> fp32 -> bf16 for these values
  template <typename T>
  static __device__ __forceinline__ uint32_t pair(uint16_t x) {
    const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(x, K));
    if constexpr (std::is_same<T, __half>::value) {
      return *reinterpret_cast<const uint32_t*>(&h);
    } else {
      const float2 f = __half22float2(h);
      return Mma<__nv_bfloat16>::pack(f.x, f.y);
    }
  }
  template <typename T>
  static __device__ __forceinline__ void widen4(uint32_t w, uint32_t* out) {
    out[0] = pair<T>(static_cast<uint16_t>(w & 0xffffu));
    out[1] = pair<T>(static_cast<uint16_t>(w >> 16));
  }
  template <typename T>
  static __device__ __forceinline__ void split4(uint32_t w, uint32_t& even, uint32_t& odd) {
    even = pair<T>(static_cast<uint16_t>(__byte_perm(w, 0, 0x0020)));
    odd = pair<T>(static_cast<uint16_t>(__byte_perm(w, 0, 0x0031)));
  }
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
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

// C += A B on int8 tensor cores with int32 sums: A 16x32 (a0 / a1 rows gid /
// gid + 8 at k 4*tig .. 4*tig + 3, a2 / a3 the same 16 on), B 32x8 (b0 k
// 4*tig .. 4*tig + 3 of column gid, b1 the same 16 on).
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

// Four 8x8 16-bit matrices from shared memory, each transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Keys in the tile that starts at `col`: at most kTileN, never past `end`,
// never across a page.
__device__ __forceinline__ int tile_len(int col, int end, const Params& p) {
  int n = min(kTileN, end - col);
  if (p.paged) n = min(n, p.page - col % p.page);
  return n;
}

template <int D, int kBytes>
struct Layout {
  // cp.async ring depth: 16-bit rings of 2 (three blocks an SM fit, which
  // outran 3-deep rings at two an SM), 8-bit ones of 4
  static constexpr int kStages = kBytes == 2 ? 2 : 4;
  static constexpr int kRowBytes = D * kBytes + 16;     // 16 B pad: no bank conflicts
  static constexpr int kChunks = D * kBytes / 16;       // 16 B chunks per key row
  static constexpr int kTileBytes = kTileN * kRowBytes;
  static constexpr int kSmem = kStages * 2 * kTileBytes;
  // Q's fragments in shared memory at D > 128 (see the note): one uint4 a
  // lane, k step and 16-row group, after the ring
  static constexpr bool kQShared = D > 128;
};

// The dynamic shared memory of a block: the ring, then Q's fragments.
template <int D, int kBytes, bool kInt8, int kRowWarps>
constexpr int decode_smem() {
  using L = Layout<D, kBytes>;
  return L::kSmem +
         (L::kQShared ? kRowWarps * (kInt8 ? D / 32 : D / 16) * 32 * 16 : 0);
}

// T: the 16-bit compute type (bf16 / fp16 q; fp16 for int8 caches, whose q
// arrives pre-quantised as int8).  TC: the cache element type.  kRowWarps:
// 1 (16-row tile, the warps share out each key tile) or 4 (64-row tile,
// 16 rows a warp).
template <typename T, typename TC, int D, int kRowWarps>
__global__ void __launch_bounds__(kThreads) flash_decode_ref_kernel(const Params p) {
  constexpr bool kInt8 = std::is_same<TC, int8_t>::value;
  constexpr bool kWide = Cache<TC>::kBytes == 2;  // the ring feeds the mma
  using L = Layout<D, Cache<TC>::kBytes>;
  constexpr int kStages = L::kStages;
  constexpr int kRowBytes = L::kRowBytes;
  constexpr int kKeyWarps = kWarps / kRowWarps;
  constexpr int kWK = kTileN / kKeyWarps;  // keys of a tile per warp
  constexpr int kNT = kWK / 8;             // S n-tiles per warp
  constexpr int kPK = kWK / 16;            // P V k-steps per warp
  constexpr int kKS = D / 16;              // 16-column steps of d
  constexpr int kDT = D / 8;               // O n-tiles
  constexpr int kRows = 16 * kRowWarps;    // packed rows per block
  // With the key tile shared out (kKeyWarps > 1), each warp streams its own
  // kWK rows of every tile through its own part of the ring and waits only
  // for its own copies; otherwise the block shares each tile.
  constexpr bool kOwnRows = kKeyWarps > 1;
  constexpr int kSlotRows = kOwnRows ? kWK : kTileN;  // rows of a K (or V) slot
  constexpr int kSlotBytes = kSlotRows * L::kRowBytes;
  // The copy loop kept rolled where, unrolled, its chunks' addresses held
  // registers and ptxas spilled: every cache at D > 128, and the 16-bit
  // 64-row tile at D 64 (since the head dim became a runtime value).
  // Rolled everywhere, the 16-bit decode took 2-6 % longer at D 64 and
  // 128 (diag/decode_ab.py, in turns).
  constexpr bool kRollCopies = L::kQShared || (kWide && kRowWarps == 4 && D == 64);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  __shared__ float sMax[2][kKeyWarps * 16];  // by tile parity: warps drift a tile
  __shared__ float sM[kKeyWarps * 16];
  __shared__ int sLast;

  const int tile = blockIdx.x, split = blockIdx.y;
  const int kh = blockIdx.z % p.hk, bb = blockIdx.z / p.hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp / kKeyWarps, kg = warp % kKeyWarps;
  const int r0 = tile * kRows;
  const int nr = min(kRows, p.rows - r0);
  unsigned char* my_ring = ring + (kOwnRows ? (size_t)warp * kStages * 2 * kSlotBytes : 0);
  const int first = kOwnRows ? lane : tid;  // this thread's share of a slot's copies
  constexpr int kStep = kOwnRows ? 32 : kThreads;

  // the heads-first layout's lengths are clamped to the cache, as
  // decode_attn_bhsd does
  const int len = p.heads_first ? min(p.seqlens[bb], p.smax) : p.seqlens[bb];
  const int lp = p.leftpad ? p.leftpad[bb] : 0;
  const int offset = len - lp - p.sq;
  const int cb = p.cache_batch_idx ? p.cache_batch_idx[bb] : bb;
  const size_t row_bytes = (size_t)p.d * Cache<TC>::kBytes;  // one key of one kv head
  const size_t key_stride = p.heads_first ? row_bytes : p.hk * row_bytes;  // bytes between keys

  // this thread's two rows (C fragment rows gid and gid + 8 of its warp):
  // query position and ALiBi slope; rows past the tile read row rows - 1
  int qpos[2];
  float slope[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = min(r0 + rg * 16 + gid + 8 * i, p.rows - 1);
    qpos[i] = gr % p.sq + offset;
    if (p.alibi) slope[i] = p.alibi[bb * p.h + kh * p.g + gr / p.sq];
  }

  // Q's A fragments (rows past the tile are zero): a0 / a1 rows gid / gid + 8
  // at columns tig*2, a2 / a3 the same rows 8 columns on.  int8: the s8
  // fragments of 32-column steps (4 bytes at 4*tig, and 16 on).  fp8: the
  // columns of a 16-column step in K's fragment order (k slots 2*tig,
  // 2*tig + 1 | 8 + 2*tig, 9 + 2*tig are d 4*tig .. 4*tig + 3): the dot product
  // is the same, and K's bytes widen where they land.  Columns past d are
  // zero.  At D > 128 the fragments are stored to shared memory (this
  // lane's uint4 of step kk at q_sm[kk * 32]; a thread reads back only what
  // it stored) and q_frag reads one at each use.
  constexpr int kQS = kInt8 ? D / 32 : kKS;
  constexpr bool kQShared = L::kQShared;
  uint32_t qa[kQS][4];
  uint4* q_sm = reinterpret_cast<uint4*>(smem + L::kSmem) + (size_t)rg * kQS * 32 + lane;
  {
    const size_t q_row0 = (size_t)(bb * p.hk + kh) * p.rows + r0 + rg * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg * 16 + gid + 8 * i;
      const bool ok = r < nr;
      const size_t base = (q_row0 + gid + 8 * i) * p.d;
#pragma unroll
      for (int kk = 0; kk < kQS; ++kk) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = kInt8 ? kk * 32 + c * 16 + tig * 4
                                : kk * 16 + (kWide ? tig * 2 + c * 8 : tig * 4 + c * 2);
          uint32_t x = 0;
          if (ok && col < p.d) {
            if constexpr (kInt8)
              x = *reinterpret_cast<const uint32_t*>(static_cast<const int8_t*>(p.q) + base + col);
            else
              x = *reinterpret_cast<const uint32_t*>(static_cast<const T*>(p.q) + base + col);
          }
          qa[kk][i + 2 * c] = x;
        }
      }
    }
    if constexpr (kQShared) {
#pragma unroll
      for (int kk = 0; kk < kQS; ++kk)
        q_sm[kk * 32] = make_uint4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
    }
  }
  // Q's A fragment of step kk: qa[kk], or at D > 128 a shared-memory read
  // into buf
  auto q_frag = [&](int kk, uint32_t* buf) -> const uint32_t* {
    if constexpr (kQShared) {
      const uint4 v = q_sm[kk * 32];
      buf[0] = v.x, buf[1] = v.y, buf[2] = v.z, buf[3] = v.w;
      return buf;
    } else {
      return qa[kk];
    }
  };

  // positions the tile's rows hold, for the key range they can see
  int pos_lo = 0, pos_hi = p.sq - 1;
  if (nr < p.sq && r0 / p.sq == (r0 + nr - 1) / p.sq) {
    pos_lo = r0 % p.sq;
    pos_hi = (r0 + nr - 1) % p.sq;
  }
  const int cap = p.paged ? p.nk_max * p.page : p.smax;
  int start = max(split * p.split_keys, lp);
  int end = min(min(len, cap), (split + 1) * p.split_keys);
  if (p.has_lower) start = max(start, lp + pos_lo + offset - p.wl);
  if (p.has_upper) end = min(end, lp + pos_hi + offset + p.wr + 1);

  float kfac = p.scale, vfac = 1.f;
  if constexpr (kInt8) {
    kfac = p.scale * p.q_scale[bb * p.hk + kh];
    vfac = (1.f / 127.f);
  }
  if (p.k_descale) kfac *= p.k_descale[bb * p.hk + kh];
  if (p.v_descale) vfac = p.v_descale[bb * p.hk + kh] * vfac;

  // byte address of key `col`'s row for this kv head, K (which = 0) or V (1)
  auto row_ptr = [&](int col, int which) -> const unsigned char* {
    if (p.paged) {
      const size_t pid = (size_t)p.block_table[bb * p.nk_max + col / p.page];
      const int off = col % p.page;
      if (p.fused) return p.k + ((pid * 2 + which) * p.page + off) * key_stride + kh * row_bytes;
      return (which ? p.v : p.k) + (pid * p.page + off) * key_stride + kh * row_bytes;
    }
    const unsigned char* base = which ? p.v : p.k;
    if (p.heads_first) return base + (((size_t)cb * p.hk + kh) * p.smax + col) * row_bytes;
    return base + ((size_t)cb * p.smax + col) * key_stride + kh * row_bytes;
  };

  // Copy the slot's rows of the tile at col0 (a warp's kWK keys, or all of
  // them); rows past the tile's keys are zero-filled, so P = 0 meets V = 0
  // there.  A tile lies in one page, so its rows are at one stride.
  auto issue = [&](int col0, int slot) {
    const int row0 = kOwnRows ? kg * kWK : 0;
    const int valid = tile_len(col0, end, p) - row0;
    const unsigned char* kb = valid > 0 ? row_ptr(col0 + row0, 0) : p.k;
    const unsigned char* vb = valid > 0 ? row_ptr(col0 + row0, 1) : p.k;
    unsigned char* dk = my_ring + (size_t)(slot * 2) * kSlotBytes;
    unsigned char* dv = dk + kSlotBytes;
    auto copy = [&](int idx) {
      const int r = idx / L::kChunks, c = (idx % L::kChunks) * 16;
      const bool ok = r < valid && (size_t)c < row_bytes;  // chunks past d: zeros
      cp_async16(dk + r * L::kRowBytes + c, ok ? kb + r * key_stride + c : p.k, ok ? 16 : 0);
      cp_async16(dv + r * L::kRowBytes + c, ok ? vb + r * key_stride + c : p.k, ok ? 16 : 0);
    };
    if constexpr (kRollCopies) {
#pragma unroll 1
      for (int idx = first; idx < kSlotRows * L::kChunks; idx += kStep) copy(idx);
    } else {
      for (int idx = first; idx < kSlotRows * L::kChunks; idx += kStep) copy(idx);
    }
  };

  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's columns; quad-summed at the end

  int load_col = start;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (load_col < end) {
      issue(load_col, s);
      load_col += tile_len(load_col, end, p);
    }
    cp_async_commit();
  }

  int col0 = start;
  for (int it = 0; col0 < end; ++it) {
    cp_async_wait<kStages - 2>();
    // tile `it` has landed, and the slot refilled next was read at tile it-1
    if constexpr (kOwnRows) __syncwarp(); else __syncthreads();
    if (load_col < end) {
      issue(load_col, (it + kStages - 1) % kStages);
      load_col += tile_len(load_col, end, p);
    }
    cp_async_commit();

    const int n = tile_len(col0, end, p);
    // this warp's keys kg*kWK .. + kWK of the tile: the first rows of its
    // slot, or of the shared tile with kg = 0
    const unsigned char* sK = my_ring + (size_t)((it % kStages) * 2) * kSlotBytes;
    const unsigned char* sV = sK + kSlotBytes;

    // S = Q K^T; consecutive mma go to different n-tiles.  At D > 128 each
    // n-tile's products follow its fragments' load: all of them loaded
    // first spilled beside O's 128 registers.
    float s[kNT][4];
#pragma unroll
    for (int jt = 0; jt < kNT; ++jt) s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.f;
    if constexpr (kWide) {
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 2) {
        uint32_t b[kNT][4], t0[4], t1[4];
        const uint32_t* a0 = q_frag(kk, t0);
        const uint32_t* a1 = q_frag(kk + 1, t1);
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) {
          ldsm_x4(b[jt], sK + (jt * 8 + (lane & 7)) * kRowBytes + (kk * 16 + (lane >> 3) * 8) * 2);
          if constexpr (kQShared) {
            Mma<T>::mma(s[jt], a0, b[jt]);
            Mma<T>::mma(s[jt], a1, b[jt] + 2);
          }
        }
        if constexpr (!kQShared) {
#pragma unroll
          for (int jt = 0; jt < kNT; ++jt) Mma<T>::mma(s[jt], a0, b[jt]);
#pragma unroll
          for (int jt = 0; jt < kNT; ++jt) Mma<T>::mma(s[jt], a1, b[jt] + 2);
        }
      }
    } else if constexpr (kInt8) {
      // an 8-bit ldmatrix gives a thread 4 bytes of its key's row (d
      // 4*tig .. 4*tig + 3 of a 16-byte chunk): as they are, half the s8 B
      // fragment of a 32-column step; the int32 sums are exact
      int si[kNT][4];
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt) si[jt][0] = si[jt][1] = si[jt][2] = si[jt][3] = 0;
#pragma unroll
      for (int c0 = 0; c0 < kKS; c0 += 4) {
        uint32_t r[kNT][4], t0[4], t1[4];
        const uint32_t* a0 = q_frag(c0 / 2, t0);
        const uint32_t* a1 = q_frag(c0 / 2 + 1, t1);
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) {
          ldsm_x4(r[jt], sK + (jt * 8 + (lane & 7)) * kRowBytes + (c0 + (lane >> 3)) * 16);
          if constexpr (kQShared) {
            mma_s8(si[jt], a0, r[jt]);
            mma_s8(si[jt], a1, r[jt] + 2);
          }
        }
        if constexpr (!kQShared) {
#pragma unroll
          for (int jt = 0; jt < kNT; ++jt) mma_s8(si[jt], a0, r[jt]);
#pragma unroll
          for (int jt = 0; jt < kNT; ++jt) mma_s8(si[jt], a1, r[jt] + 2);
        }
      }
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jt][e] = (float)si[jt][e];
    } else {
      // the same 4 bytes, widened: the B fragment of one 16-column step in
      // Q's column order
#pragma unroll
      for (int c0 = 0; c0 < kKS; c0 += 4) {
        uint32_t r[kNT][4];
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt)
          ldsm_x4(r[jt], sK + (jt * 8 + (lane & 7)) * kRowBytes + (c0 + (lane >> 3)) * 16);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t buf[4];
          const uint32_t* a = q_frag(c0 + m, buf);
#pragma unroll
          for (int jt = 0; jt < kNT; ++jt) {
            uint32_t b[2];
            Cache<TC>::template widen4<T>(r[jt][m], b);
            Mma<T>::mma(s[jt], a, b);
          }
        }
      }
    }

    // scale, softcap, ALiBi, masks; the tile's row maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jt = 0; jt < kNT; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int j = kg * kWK + jt * 8 + tig * 2 + (e & 1);
        const int rel = col0 + j - lp;
        bool masked = j >= n;
        if (p.has_upper) masked |= rel > qpos[i] + p.wr;
        if (p.has_lower) masked |= rel < qpos[i] - p.wl;
        if (p.chunk > 0) masked |= floor_div(rel, p.chunk) != floor_div(qpos[i], p.chunk);
        float x = s[jt][e] * kfac;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        if (p.alibi) x -= slope[i] * fabsf((float)(qpos[i] - rel));
        x = masked ? -INFINITY : x;
        s[jt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]);
    if constexpr (kOwnRows && kInt8) {
      // int8 quantises against the tile's maximum over all its keys: the
      // warps sharing the tile agree on it (the others keep a running
      // maximum a warp, merged at the end)
      float* sm = sMax[it & 1];
      if (tig == 0) {
        sm[kg * 16 + gid] = mx[0];
        sm[kg * 16 + gid + 8] = mx[1];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int w = 0; w < kKeyWarps; ++w) mx[i] = fmaxf(mx[i], sm[w * 16 + gid + 8 * i]);
    }

    // online softmax: P against the running maximum (int8: rint(127 p))
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f((m_run[i] - m_use[i]) * kLog2e);
      m_run[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int jt = 0; jt < kNT; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f((s[jt][e] - m_use[e >> 1]) * kLog2e);
        rs[e >> 1] += pe;
        s[jt][e] = kInt8 ? rintf(pe * 127.f) : pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
    uint32_t pa[kPK][4];  // P's A fragments, in the compute type
#pragma unroll
    for (int c = 0; c < kPK; ++c) {
      pa[c][0] = Mma<T>::pack(s[2 * c][0], s[2 * c][1]);
      pa[c][1] = Mma<T>::pack(s[2 * c][2], s[2 * c][3]);
      pa[c][2] = Mma<T>::pack(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[c][3] = Mma<T>::pack(s[2 * c + 1][2], s[2 * c + 1][3]);
    }

    // O = alpha O + P V (times vfac: int8 per tile, the others at the end).
    // 16-bit V: ldmatrix.trans gives the B fragments.  8-bit V: an ldmatrix
    // matrix is 8 keys x 16 bytes; movmatrix transposes it as 8x8 16-bit
    // pairs, so a thread holds keys 2*tig, 2*tig + 1 of d 2*gid, 2*gid + 1,
    // and bytes 0, 2 / 1, 3 widen to the B fragments of two n-tiles: one of
    // the even d's of the 16-byte chunk, one of the odd d's.  O's n-tiles
    // 2c and 2c + 1 then hold chunk c's d 4*tig, 4*tig + 2 and 4*tig + 1,
    // 4*tig + 3 (put_row below writes them back in order).
    auto pv_step = [&](float (*acc)[4], int ks, int dp) {  // n-tiles dp, dp + 1
      uint32_t b[4];
      if constexpr (kWide) {
        ldsm_x4_t(b, sV + (ks * 16 + (lane & 15)) * kRowBytes + (dp + (lane >> 4)) * 16);
        Mma<T>::mma(acc[0], pa[ks], b);
        Mma<T>::mma(acc[1], pa[ks], b + 2);
      } else {
        // chunk dp / 2, keys 0-7 and 8-15: one matrix each
        const int c = dp >> 1;
        uint32_t r[2];
        const unsigned char* at = sV + (ks * 16 + (lane & 15)) * kRowBytes + c * 16;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(r[0]), "=r"(r[1])
                     : "r"(static_cast<unsigned>(__cvta_generic_to_shared(at))));
        Cache<TC>::template split4<T>(movmatrix_t(r[0]), b[0], b[2]);
        Cache<TC>::template split4<T>(movmatrix_t(r[1]), b[1], b[3]);
        Mma<T>::mma(acc[0], pa[ks], b);
        Mma<T>::mma(acc[1], pa[ks], b + 2);
      }
    };
    if constexpr (kInt8 && !kQShared) {
      // the tile's integer sums first, exact in fp32, as today's int32 P V
#pragma unroll
      for (int dp = 0; dp < kDT; dp += 2) {
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < kPK; ++ks) pv_step(c, ks, dp);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[dp + t][e] = o[dp + t][e] * alpha[e >> 1] + c[t][e] * vfac;
      }
    } else {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
#pragma unroll
      for (int ks = 0; ks < kPK; ++ks)
#pragma unroll
        for (int dp = 0; dp < kDT; dp += 2) pv_step(o + dp, ks, dp);
    }
    col0 += n;
  }
  cp_async_wait<0>();
  if constexpr (!kInt8 || kQShared) {
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= vfac;
  }

  const size_t part = ((size_t)(bb * p.hk + kh) * p.splits + split) * p.rows + r0;
  // this thread's values of its row i (gid + 8 i), times f, into a row: its
  // columns below d (an n-tile, or a 16-column chunk, is wholly below d or
  // not)
  auto put_row = [&](float* row, int i, float f) {
    if constexpr (kWide) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        if (dt * 8 < p.d)
          *reinterpret_cast<float2*>(row + dt * 8 + tig * 2) =
              make_float2(o[dt][2 * i] * f, o[dt][2 * i + 1] * f);
    } else {
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        if (c * 16 < p.d)
          *reinterpret_cast<float4*>(row + c * 16 + tig * 4) =
              make_float4(o[2 * c][2 * i] * f, o[2 * c + 1][2 * i] * f,
                          o[2 * c][2 * i + 1] * f, o[2 * c + 1][2 * i + 1] * f);
    }
  };
  float l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) l_row[i] = quad_sum(l_run[i]);
  if constexpr (kKeyWarps == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg * 16 + gid + 8 * i;
      if (r >= nr) continue;
      const float l = l_row[i];
      put_row(p.o_part + (part + r) * p.d, i, l > 0.f ? 1.f / l : 0.f);
      if (tig == 0) p.lse_part[part + r] = l > 0.f ? m_run[i] + logf(l) : INFINITY;
    }
  } else {
    // the warps' O and sums over their keys add up, each rescaled from its
    // running maximum to the largest (int8: one maximum, factors 1)
    __syncthreads();  // the ring is free
    float* sO = reinterpret_cast<float*>(ring);  // (kKeyWarps, 16, D)
    float* sL = sO + kKeyWarps * 16 * D;         // (kKeyWarps, 16)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = gid + 8 * i;
      if (tig == 0) {
        sL[kg * 16 + r] = l_row[i];
        sM[kg * 16 + r] = m_run[i];
      }
      put_row(sO + (kg * 16 + r) * D, i, 1.f);
    }
    __syncthreads();
    // warp w's factor for row r: exp(m_w - M), 0 for a warp that saw no key
    auto factor = [&](int w, int r, float mx) {
      const float m = sM[w * 16 + r];
      return m == -INFINITY ? 0.f : exp2f((m - mx) * kLog2e);
    };
    auto row_max = [&](int r) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kKeyWarps; ++w) mx = fmaxf(mx, sM[w * 16 + r]);
      return mx;
    };
    for (int idx = tid; idx < nr * p.d; idx += kThreads) {
      const int r = idx / p.d, dd = idx % p.d;
      const float mx = row_max(r);
      float l = 0.f, acc = 0.f;
#pragma unroll
      for (int w = 0; w < kKeyWarps; ++w) {
        const float f = factor(w, r, mx);
        l += f * sL[w * 16 + r];
        acc += f * sO[(w * 16 + r) * D + dd];
      }
      p.o_part[(part + r) * p.d + dd] = l > 0.f ? acc / l : 0.f;
    }
    for (int r = tid; r < nr; r += kThreads) {
      const float mx = row_max(r);
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kKeyWarps; ++w) l += factor(w, r, mx) * sL[w * 16 + r];
      p.lse_part[part + r] = l > 0.f ? mx + logf(l) : INFINITY;
    }
  }
  if (p.splits == 1) return;

  // The last block of this (row tile, kv head, batch) merges the splits'
  // partials into split 0's rows (combine_attn_partials: lse = +inf is an
  // empty split of weight 0) and resets the counter for the next launch.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* sem = p.sems + (size_t)(bb * p.hk + kh) * gridDim.x + tile;
    const int done = atomicAdd(sem, 1);
    sLast = done == p.splits - 1;
    if (sLast) *sem = 0;
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  const size_t g0 = (size_t)(bb * p.hk + kh) * p.splits * p.rows + r0;  // split 0, row r0
  for (int idx = tid; idx < nr * p.d; idx += kThreads) {
    const int r = idx / p.d, dd = idx % p.d;
    float mx = -INFINITY;
    for (int s = 0; s < p.splits; ++s) {
      const float l = __ldcg(p.lse_part + g0 + (size_t)s * p.rows + r);
      if (l != INFINITY) mx = fmaxf(mx, l);
    }
    float acc = 0.f, sw = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < p.splits; ++s) {
        const size_t at = g0 + (size_t)s * p.rows + r;
        const float l = __ldcg(p.lse_part + at);
        if (l == INFINITY) continue;
        const float w = expf(l - mx);
        sw += w;
        acc += w * __ldcg(p.o_part + at * p.d + dd);
      }
    }
    p.o_part[(g0 + r) * p.d + dd] = sw > 0.f ? acc / sw : 0.f;
  }
  __syncthreads();  // every split's lse is read before split 0's is replaced
  for (int r = tid; r < nr; r += kThreads) {
    float mx = -INFINITY;
    for (int s = 0; s < p.splits; ++s) {
      const float l = __ldcg(p.lse_part + g0 + (size_t)s * p.rows + r);
      if (l != INFINITY) mx = fmaxf(mx, l);
    }
    float sw = 0.f;
    if (mx != -INFINITY)
      for (int s = 0; s < p.splits; ++s) {
        const float l = __ldcg(p.lse_part + g0 + (size_t)s * p.rows + r);
        if (l != INFINITY) sw += expf(l - mx);
      }
    p.lse_part[g0 + r] = mx == -INFINITY ? INFINITY : mx + logf(sw);
  }
}

template <typename T, typename TC, int D, int kRowWarps>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kSmem =
      decode_smem<D, Cache<TC>::kBytes, std::is_same<TC, int8_t>::value, kRowWarps>();
  auto kernel = flash_decode_ref_kernel<T, TC, D, kRowWarps>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory: two blocks of ring fit
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int rows_per_block = 16 * kRowWarps;
  const int tiles = (p.rows + rows_per_block - 1) / rows_per_block;
  dim3 grid(tiles, p.splits, p.b * p.hk);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TC, int D>
cudaError_t launch_rows(const Params& p, cudaStream_t s) {
  return p.rows <= 16 ? launch<T, TC, D, 1>(p, s) : launch<T, TC, D, 4>(p, s);
}

template <int D>
cudaError_t dispatch(const Params& p, int q_dtype, int cache_dtype, cudaStream_t s) {
  using E4 = Fp8<__NV_E4M3>;
  using E5 = Fp8<__NV_E5M2>;
  if (cache_dtype == 2) return launch_rows<__half, int8_t, D>(p, s);
  if (q_dtype == 0) {
    if (cache_dtype == 0) return launch_rows<__nv_bfloat16, __nv_bfloat16, D>(p, s);
    if (cache_dtype == 3) return launch_rows<__nv_bfloat16, E4, D>(p, s);
    if (cache_dtype == 4) return launch_rows<__nv_bfloat16, E5, D>(p, s);
  } else if (q_dtype == 1) {
    if (cache_dtype == 1) return launch_rows<__half, __half, D>(p, s);
    if (cache_dtype == 3) return launch_rows<__half, E4, D>(p, s);
    if (cache_dtype == 4) return launch_rows<__half, E5, D>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q_dtype: 0 = bf16, 1 = fp16.  cache_dtype: 0 = bf16, 1 = fp16 (the q
// type), 2 = int8 (q pre-quantised to int8, q_scale given), 3 = fp8 e4m3,
// 4 = fp8 e5m2.  d: up to 128 (built with FA_DECODE_WIDE: 129 to 256), a
// multiple of 8 (16 for 8-bit caches), else cudaErrorInvalidValue; q is (b, hk, g * sq, d), o_part (b, hk, splits,
// g * sq, d).  heads_first: a contiguous cache is (bc, hk, smax, d), not
// (bc, smax, hk, d).  With num_splits > 1, `sems` holds one zeroed int32 per
// (batch, kv head, row tile) (row tiles: 1 for up to 16 packed rows, else
// ceil(rows / 64)); the kernel leaves them zeroed, and o_part / lse_part's
// split 0 holds the merged result.  Returns cudaGetLastError() after the
// launch.
extern "C" int flash_decode_ref(
    const void* q, const void* k_cache, const void* v_cache, float* o_part, float* lse_part,
    int* sems, const int* cache_seqlens, const int* cache_leftpad, const int* cache_batch_idx,
    const int* block_table, const float* alibi, const float* q_scale, const float* k_descale,
    const float* v_descale, int b, int h, int hk, int sq, int d, int q_dtype, int cache_dtype,
    int paged, int fused, int page, int nk_max, int smax, int heads_first, int num_splits,
    int split_keys, float scale, int has_upper, int wr, int has_lower, int wl, int chunk,
    float softcap, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  if (num_splits > 1 && sems == nullptr) return cudaErrorInvalidValue;
  const int g = h / hk, rows = g * sq;
  Params p{q, static_cast<const unsigned char*>(k_cache),
           static_cast<const unsigned char*>(v_cache), o_part, lse_part, sems, cache_seqlens,
           cache_leftpad, cache_batch_idx, block_table, alibi, q_scale, k_descale, v_descale,
           b, h, hk, g, sq, rows, d, paged, fused, page, nk_max, smax, heads_first,
           num_splits, split_keys, scale, has_upper, wr, has_lower, wl, chunk, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_dtype >= 2 && d % 16 != 0) return cudaErrorInvalidValue;  // 8-bit rows
  // two libraries from this source, each with half the head dims, so that
  // they build in parallel (kernels/_build.py's DERIVED)
  switch (fa::kernel_head_dim(d)) {
#ifdef FA_DECODE_WIDE
    case 192: return dispatch<192>(p, q_dtype, cache_dtype, s);
    case 256: return dispatch<256>(p, q_dtype, cache_dtype, s);
#else
    case 64: return dispatch<64>(p, q_dtype, cache_dtype, s);
    case 128: return dispatch<128>(p, q_dtype, cache_dtype, s);
#endif
  }
  return cudaErrorInvalidValue;
}
