// The Hopper (sm_90a) pieces shared by the hand-written kernels that run on
// TMA rings and wgmma (flex.cu, flash_bwd.cu, flash_fwd.cu): mbarriers, TMA
// tile and bulk copies, wgmma shared-memory descriptors and products, the
// turns of two consumer warpgroups, tanh on the special function unit, and
// the host-side encoding of TMA tensor maps through the runtime (no
// -lcuda).
//
// Tiles are stored as the TMA writes them: column blocks of (rows, 64)
// 16-bit elements in the 128-byte swizzle, each 1024-byte aligned; a
// descriptor's K-major form reads such a tile as A or B of Q K^T, its
// MN-major form (imm-trans-b) as B of P V.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fa {

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

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
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

// tanh(x / cap) as 1 - 2 / (2^(x k2) + 1), with k2 = 2 log2(e) / cap computed
// once: on the special function unit, where tanhf and a division an element
// made the softcap kernels slower than the first versions'.
__device__ __forceinline__ float tanh_ex2(float x, float k2) {
  return 1.f - __fdividef(2.f, fast_exp2(x * k2) + 1.f);
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

template <>
__device__ __forceinline__ void wgmma_ss<32, __nv_bfloat16>(
    float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;}\n"
      : FA_D8(0), FA_D8(8)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32, __half>(
    float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;}\n"
      : FA_D8(0), FA_D8(8)
      : "l"(da), "l"(db), "r"(acc));
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

// The low word of sw128_desc(tile, 16, 1024): the tile's shared address
// (and lbo).  Its high word (sbo 1024, the 128-byte swizzle) is constant,
// so the backward keeps descriptors in one register each; offsets within
// a tile never carry into the high word (shared addresses are < 2^18).
__device__ __forceinline__ uint32_t kmajor_lo(const void* tile) {
  return static_cast<uint32_t>(sw128_desc(tile, 16, 1024));
}

__device__ __forceinline__ uint64_t kmajor_desc(uint32_t lo) {
  return (static_cast<uint64_t>((1024 >> 4) | (1u << 30)) << 32) | lo;
}

// S = A B^T over d for one warpgroup: A (64 rows) and B (kN rows) K-major
// in shared memory (descriptor lows a_lo, b_lo), their column blocks
// a_rows * 128 and kN * 128 bytes apart.  The first k16 step overwrites S.
template <int D, int kN, typename T>
__device__ __forceinline__ void qk_product(float* s, uint32_t a_lo,
                                           int a_rows, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // d columns [16 kk, 16 kk + 16): column block kk / 4, 32 bytes a step
    const uint32_t a_off = (kk >> 2) * a_rows * 128 + (kk & 3) * 32;
    const uint32_t b_off = (kk >> 2) * kN * 128 + (kk & 3) * 32;
    wgmma_ss<kN, T>(s, kmajor_desc(a_lo + (a_off >> 4)),
                    kmajor_desc(b_lo + (b_off >> 4)), kk > 0);
  }
}

// Errors of a launcher's host side that are not CUDA's: a TMA descriptor
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
inline EncodeTiled encode_tiled() {
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

}  // namespace fa
