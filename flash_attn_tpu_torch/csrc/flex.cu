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
// The backward (first version) is the deterministic recompute split of
// flash_bwd.cu, on mma.sync.m16n8k16 (fa_common.cuh's fragments) with tiles
// loaded synchronously (no cp.async / TMA, no wgmma; later work): the dQ
// kernel, 4 warps per 64-row tile, walks the kv lists and writes dQ (and the
// dbias tiles of the blocks it visits) once; the dK/dV kernel, one block of
// 8 warps per 64-key tile of one kv block of one (kv head, batch), walks
// each query head of its GQA group's full_q and q lists in a fixed order and
// keeps dK, dV in registers.  No atomics: the result is bitwise
// deterministic.
//
// Layouts: q, k, v, do (b, s, heads, d) read in place through their batch,
// row and head strides; o and dq (b, sq, h, d), dk and dv (b, sk, hk, d)
// contiguous; lse and delta (b, h, sq) fp32; bias (b|1, h|1, sq, sk) fp32
// with stride 0 on a broadcast dimension, dbias (b, h, sq, sk).  Tables are
// (b, th, n_major, len) int32, th = 1 or h; slot (b, th, nq, nk) numbers the
// partial pairs, whose bits are (slot, bq, bk / 32) words.

#include <cuda.h>

#include <type_traits>

#include "fa_common.cuh"

namespace {

using namespace fa;

constexpr int kTile = 64;          // backward: q rows and keys per tile
constexpr int kThreads = 128;      // dQ: 4 warps x 16 rows
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

// ---------------------------------------------------------------------------
// The forward's Hopper pieces: mbarriers, TMA tile loads, wgmma.

// Shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of copies to complete on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A wait
// that lasts ~10 s of clock traps (the launch fails) instead of hanging the
// card: it can only mean a fault in the ring's bookkeeping.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// A (64, 1, rows, 1) box of a 4-D tensor map over (d, heads, s, b) into
// shared memory at `dst`, completing on `bar`.  Rows past s are zero-filled.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of a tile in the 128-byte swizzled
// layout that the TMA writes (rows of 64 16-bit elements, 8-row atoms of
// 1024 bytes): lbo, sbo in bytes.  Adding (bytes >> 4) moves its start.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x on the special function unit, subnormal results flushed to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their uses across this point or reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x N, fp32, the m64nNk16 accumulator layout) += A B over k = 16.
// ss: A (64 x 16) and B (N x 16) both K-major in shared memory.  rs: A from
// registers (the mma.sync A fragment of each warp's 16 rows), B (16 x N)
// MN-major in shared memory (imm-trans-b = 1).  acc = 0 overwrites D.
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc);
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int acc);

#define FA_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_ss<64, __nv_bfloat16>(
    float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, __nv_bfloat16>(
    float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, __half>(
    float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, __half>(
    float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, __nv_bfloat16>(
    float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24),
        FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, __nv_bfloat16>(
    float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24),
        FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, __half>(
    float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24),
        FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, __half>(
    float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24),
        FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef FA_D8

// O (the m64nD accumulator) += P V over one tile of kKeys keys: P in
// registers (pa[k16 step]), V in shared memory MN-major, its column blocks
// kKeys * 128 bytes apart.
template <int D, int kKeys, typename T>
__device__ __forceinline__ void pv_product(float* acc,
                                           const uint32_t (*pa)[4],
                                           const T* sv) {
  const uint64_t v_desc = sw128_desc(sv, kKeys * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs<D, T>(acc, pa[kk], v_desc + ((kk * 2048) >> 4), 1);
}

// With two consumer warpgroups, each tile's products are issued in turns
// (named barriers 1 and 2, 256 threads), so that one warpgroup's softmax
// runs while the other's products hold the tensor cores.
template <bool kPingPong>
__device__ __forceinline__ void my_turn(int cw) {
  if constexpr (kPingPong) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw));
}

template <bool kPingPong>
__device__ __forceinline__ void their_turn(int cw) {
  if constexpr (kPingPong) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw));
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

// Errors of the forward's host side that are not CUDA's: the TMA descriptor
// could not be built (kTmaError + the driver's CUresult).
constexpr int kTmaError = 1 << 20;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that the library needs no
// -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault,
                                         &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The map of a (b, s, heads, d) tensor read in place through its strides
// (elements), as a 4-D tensor over (d, heads, s, b) in (64, 1, rows, 1)
// boxes with the 128-byte swizzle; rows at or past s read as zeros.  A
// dimension of extent 1 gets the span of the ones below it as its stride
// (its coordinate is always 0).
template <typename T>
int encode_map(CUtensorMap* map, const void* base, int d, int heads, int s,
               int b, long long sh, long long ss, long long sb, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kTmaError + CUDA_ERROR_NOT_FOUND;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s,
                        (cuuint64_t)b};
  const long long el[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  cuuint64_t span = (cuuint64_t)d * sizeof(T);
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? span : (cuuint64_t)el[i] * sizeof(T);
    span = strides[i] * dims[i + 1];
  }
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
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
