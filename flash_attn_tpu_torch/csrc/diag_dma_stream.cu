// Paged-read bandwidth probe for Hopper (sm_90a): streams whole pages of a
// (n, R, 1024) bf16 array, or two-page blocks of a fused (n, 2, R, 1024)
// one, in the order a page table gives, and returns the (8, 128) fp32 sum
// of each streamed page's [:8, :128] tile.
//
// Replaces the Pallas TPU kernel benchmarks/diag_dma_stream.py::
// stream_kernel (:31, launched at :92), whose pipeline DMAs each (R, 1024)
// block (or (2, R, 1024) fused block) into VMEM through a scalar-prefetched
// page table while the body reads one (8, 128) tile of it.
//
// What bounds it on the H100: bytes.  Every byte of every streamed page is
// read once; the arithmetic is 1024 adds a page.
//
// What the design does about it:
// * A kernel that loaded only the tile would move 2 KiB a page and report a
//   bandwidth that is not there.  Here every byte of every page crosses into
//   the SM's shared memory through cp.async (16 B a thread, neighbouring
//   threads on neighbouring addresses), as the TPU's pipeline copies the
//   whole block into VMEM, and the tile is folded from shared memory.
// * A work item is one 16 KiB chunk (8 page rows) at the same offset of each
//   of a step's `bundle` pages (both halves of a fused block): `bundle`
//   (times 2 fused) separate page loads are in flight per item, the
//   counterpart of the TPU's `bundle` inputs per grid step.  The chunk at
//   offset 0 holds exactly the tile's 8 rows.
// * Items go round-robin over a grid that fills the card (occupancy times
//   SMs), through a kStages-deep cp.async ring, so neighbouring CTAs read
//   neighbouring chunks of one page at the same time.
// * Each CTA keeps its partial tile sums in registers and writes them once;
//   a second kernel adds the partials in CTA order.  No atomics: repeat runs
//   are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 1024;                       // page row width (bf16)
constexpr int kRowBytes = kCols * 2;
constexpr int kChunkRows = 8;                     // the tile's rows
constexpr int kChunkBytes = kChunkRows * kRowBytes;  // 16 KiB
constexpr int kPerThread = kChunkBytes / 16 / kThreads;  // 16 B copies
constexpr int kTile = 8 * 128;                    // folded values
constexpr int kTilePerThread = kTile / kThreads;
constexpr int kStages = 3;

struct Params {
  const unsigned char* arr;  // (n, halves, R, 1024) bf16
  const int* table;          // page ids, (>= steps * bundle,)
  float* partial;            // (gridDim.x, 8, 128)
  int rows;                  // R, a multiple of 8
  int bundle, halves;        // halves: 2 for the fused layout, else 1
  int items;                 // steps * (R / 8)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// L: page loads per item (bundle * halves)
template <int L>
__global__ void __launch_bounds__(kThreads) dma_stream_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int chunks = p.rows / kChunkRows;  // chunks per page (half)
  const size_t half_bytes = (size_t)p.rows * kRowBytes;

  auto fetch = [&](int item, int slot) {
    const int step = item / chunks, c = item % chunks;
    unsigned char* dst = smem + (size_t)slot * L * kChunkBytes;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int j = l / p.halves, half = l % p.halves;
      const size_t page = (size_t)p.table[step * p.bundle + j];
      const unsigned char* src =
          p.arr + (page * p.halves + half) * half_bytes + (size_t)c * kChunkBytes;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        const int off = (e * kThreads + tid) * 16;
        cp_async16(dst + l * kChunkBytes + off, src + off);
      }
    }
  };

  float acc[kTilePerThread];
#pragma unroll
  for (int e = 0; e < kTilePerThread; ++e) acc[e] = 0.f;

  int load_item = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (load_item < p.items) {
      fetch(load_item, s);
      load_item += gridDim.x;
    }
    cp_async_commit();
  }
  int it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++it) {
    if (load_item < p.items) {
      fetch(load_item, (it + kStages - 1) % kStages);
      load_item += gridDim.x;
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // item `it` is in shared memory for every thread
    if (item % chunks == 0) {  // the chunk holding the pages' tiles
      const unsigned char* base = smem + (size_t)(it % kStages) * L * kChunkBytes;
      for (int l = 0; l < L; l += p.halves) {  // half 0 of each page
        const __nv_bfloat16* t = reinterpret_cast<const __nv_bfloat16*>(base + l * kChunkBytes);
#pragma unroll
        for (int e = 0; e < kTilePerThread; ++e) {
          const int idx = e * kThreads + tid, r = idx / 128, col = idx % 128;
          acc[e] += __bfloat162float(t[r * kCols + col]);
        }
      }
    }
    __syncthreads();  // this item's slot may be refilled next iteration
  }
  cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < kTilePerThread; ++e)
    p.partial[(size_t)blockIdx.x * kTile + e * kThreads + tid] = acc[e];
}

// out[i] = sum of the CTAs' partials, in CTA order
__global__ void dma_stream_reduce(const float* partial, float* out, int ctas) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTile) return;
  float s = 0.f;
  for (int c = 0; c < ctas; ++c) s += partial[(size_t)c * kTile + i];
  out[i] = s;
}

template <int L>
constexpr int smem_bytes() {
  return kStages * L * kChunkBytes;
}

template <int L>
cudaError_t ctas_for(int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      dma_stream_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<L>());
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dma_stream_kernel<L>, kThreads,
                                                      smem_bytes<L>());
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  *ctas = per_sm * sms;
  return cudaSuccess;
}

template <int L>
cudaError_t launch(const Params& p, float* out, int ctas, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      dma_stream_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<L>());
  if (err != cudaSuccess) return err;
  dma_stream_kernel<L><<<ctas, kThreads, smem_bytes<L>(), s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dma_stream_reduce<<<(kTile + kThreads - 1) / kThreads, kThreads, 0, s>>>(p.partial, out, ctas);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The CTAs that fill the card for `loads` (bundle * halves) page loads an
// item: occupancy per SM times the SMs.  Returns a CUDA error code.
extern "C" int diag_dma_stream_ctas(int loads, int* ctas) {
  if (loads == 1) return ctas_for<1>(ctas);
  if (loads == 2) return ctas_for<2>(ctas);
  if (loads == 4) return ctas_for<4>(ctas);
  return cudaErrorInvalidValue;
}

// arr: (n, fused ? 2 : 1, rows, 1024) bf16; table: page ids; partial:
// (ctas, 8, 128) fp32 scratch; out: (8, 128) fp32.  `ctas` at most the
// count diag_dma_stream_ctas gave.  Returns cudaGetLastError() after the
// launches.
extern "C" int diag_dma_stream(const void* arr, const int* table, float* partial, float* out,
                               int rows, int bundle, int fused, int steps, int ctas,
                               void* stream) {
  const int halves = fused ? 2 : 1;
  Params p{static_cast<const unsigned char*>(arr), table, partial, rows, bundle, halves,
           steps * (rows / kChunkRows)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.items == 0) return cudaMemsetAsync(out, 0, kTile * sizeof(float), s);
  if (ctas > p.items) ctas = p.items;
  const int loads = bundle * halves;
  if (loads == 1) return launch<1>(p, out, ctas, s);
  if (loads == 2) return launch<2>(p, out, ctas, s);
  if (loads == 4) return launch<4>(p, out, ctas, s);
  return cudaErrorInvalidValue;
}
