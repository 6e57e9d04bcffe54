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
// once and does ~4*g*sq FLOPs per pair of rows; at Llama-3-8B's widths
// (hk 8, d 128, g 4) that is far below the card's ratio of FLOPs to bytes.
//
// What the design does about it:
// * One block per (row tile, split, kv head, batch).  A row tile holds at
//   most 64 of the g*sq packed query rows of one kv head (packed row r is
//   query position r % sq of group head r // sq, flash_decode.py:836-840),
//   so every cache row a block reads serves all of its rows; a decode step
//   (g*sq <= 64) has one tile and reads each live row once.  More rows (a
//   chunked prefill) take more tiles.
// * A block reads only its kv head's d contiguous elements of each key (at
//   stride hk*d, or d in the heads-first layout) in tiles of at most 64 keys that never cross a page, and
//   only the keys that its rows can see (leftpad, length, window, causal
//   bound of the tile's positions).
// * Tiles arrive through a kStages-deep cp.async ring: the loads of the next
//   kStages-1 tiles are in flight while a tile is computed.  This is the
//   counterpart of the TPU pipe kernel's page copies in flight, for every
//   layout.
// * The math is small, so it runs on CUDA cores: fp32 for bf16/fp16 and fp8
//   caches (fp8 is widened to half on load, which is exact, and scaled by
//   the descale as flash_decode.py:594-628 does); for int8 caches the query
//   arrives quantised per (batch, kv head) (the wrapper does it, :957-963),
//   Q K^T runs as exact int32 __dp4a sums, and P is quantised as
//   rint(127 p) against the running maximum for an int32 P V, as :656-662.
// * A row with no key in a split writes o = 0 and lse = +inf; the wrapper
//   merges splits with combine_attn_partials.
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

namespace {

constexpr int kTileN = 64;    // keys per tile
constexpr int kRowTile = 64;  // packed query rows per block
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kThreads = 256;  // 8 warps: the fp32 math is latency-bound
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;  // (b, hk, rows, D) packed; int8 for int8 caches
  const unsigned char* k;
  const unsigned char* v;  // unused for fused pages
  float* o_part;           // (b, hk, splits, rows, D)
  float* lse_part;         // (b, hk, splits, rows)
  const int* seqlens;      // (b,)
  const int* leftpad;      // (b,) or null
  const int* cache_batch_idx;  // (b,) or null; contiguous caches only
  const int* block_table;      // (b, nk_max) or null
  const float* alibi;          // (b, h) or null
  const float* q_scale;        // (b, hk), int8 caches
  const float* k_descale;      // (b, hk) or null
  const float* v_descale;      // (b, hk) or null
  int b, h, hk, g, sq, rows, row_tile;
  int paged, fused, page, nk_max, smax;
  int heads_first;  // contiguous cache laid out (bc, hk, smax, d)
  int splits, split_keys;
  float scale;
  int has_upper, wr, has_lower, wl, chunk;
  float softcap;
};

template <__nv_fp8_interpretation_t K>
struct Fp8 {};

// Cache element types: bytes per element and widening to float.
template <typename T>
struct Cache;

template <>
struct Cache<__nv_bfloat16> {
  static constexpr int kBytes = 2;
  static __device__ __forceinline__ void chunk(const uint4& u, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(p[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ float one(const unsigned char* p) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
};

template <>
struct Cache<__half> {
  static constexpr int kBytes = 2;
  static __device__ __forceinline__ void chunk(const uint4& u, float* f) {
    const __half2* p = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(p[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ float one(const unsigned char* p) {
    return __half2float(*reinterpret_cast<const __half*>(p));
  }
};

template <__nv_fp8_interpretation_t K>
struct Cache<Fp8<K>> {
  static constexpr int kBytes = 1;
  static __device__ __forceinline__ void chunk(const uint4& u, float* f) {
    const __nv_fp8x2_storage_t* p =
        reinterpret_cast<const __nv_fp8x2_storage_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 x = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(p[i], K)));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ float one(const unsigned char* p) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(*p, K)));
  }
};

template <>
struct Cache<int8_t> {
  static constexpr int kBytes = 1;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

// Keys in the tile that starts at `col`: at most kTileN, never past `end`,
// never across a page.
__device__ __forceinline__ int tile_len(int col, int end, const Params& p) {
  int n = min(kTileN, end - col);
  if (p.paged) n = min(n, p.page - col % p.page);
  return n;
}

template <int D, int kBytes>
struct Layout {
  static constexpr int kRowBytes = D * kBytes + 16;  // 16 B pad: no bank conflicts
  static constexpr int kChunks = D * kBytes / 16;    // 16 B chunks per key row
  static constexpr int kTileBytes = kTileN * kRowBytes;
  // fp32 words before the ring: q (or int8 q), acc, scores, m, l, alpha
  static __host__ __device__ constexpr int float_words(int rt) {
    return (rt * (2 * D + kTileN + 3) + 3) / 4 * 4;
  }
  static __host__ __device__ constexpr size_t smem_bytes(int rt) {
    return (size_t)float_words(rt) * 4 + (size_t)kStages * 2 * kTileBytes;
  }
};

// TQ: bf16 / fp16 query, or int8_t (pre-quantised) with an int8 cache.
// TC: the cache element type.
template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(kThreads) flash_decode_ref_kernel(const Params p) {
  constexpr bool kInt8 = sizeof(TQ) == 1;
  constexpr int kBytes = Cache<TC>::kBytes;
  using L = Layout<D, kBytes>;
  constexpr int kRowBytes = L::kRowBytes;
  constexpr int kChunks = L::kChunks;
  constexpr int kPer = 16 / kBytes;  // elements per 16 B chunk

  extern __shared__ __align__(16) unsigned char smem[];
  const int rt = p.row_tile;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sAcc = sQ + rt * D;
  float* sS = sAcc + rt * D;
  float* sM = sS + rt * kTileN;
  float* sL = sM + rt;
  float* sAlpha = sL + rt;
  unsigned char* ring = smem + (size_t)L::float_words(rt) * 4;

  const int tile = blockIdx.x, split = blockIdx.y;
  const int kh = blockIdx.z % p.hk, bb = blockIdx.z / p.hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = tile * rt;
  const int nr = min(rt, p.rows - r0);

  // the heads-first layout's lengths are clamped to the cache, as
  // decode_attn_bhsd does
  const int len = p.heads_first ? min(p.seqlens[bb], p.smax) : p.seqlens[bb];
  const int lp = p.leftpad ? p.leftpad[bb] : 0;
  const int offset = len - lp - p.sq;
  const int cb = p.cache_batch_idx ? p.cache_batch_idx[bb] : bb;
  constexpr size_t kRow = (size_t)D * kBytes;  // one key of one kv head
  const size_t key_stride = p.heads_first ? kRow : p.hk * kRow;  // bytes between keys

  // query rows of this tile, and the online-softmax state
  const size_t q_row0 = ((size_t)(bb * p.hk + kh) * p.rows + r0) * D;
  if constexpr (kInt8) {
    const int* qi = reinterpret_cast<const int*>(static_cast<const int8_t*>(p.q) + q_row0);
    int* sQi = reinterpret_cast<int*>(sQ);
    for (int i = tid; i < nr * D / 4; i += kThreads) sQi[i] = qi[i];
  } else {
    const TQ* q = static_cast<const TQ*>(p.q) + q_row0;
    for (int i = tid; i < nr * D; i += kThreads) sQ[i] = to_float(q[i]);
  }
  for (int i = tid; i < rt * D; i += kThreads) sAcc[i] = 0.f;
  for (int r = tid; r < rt; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

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
      if (p.fused) return p.k + ((pid * 2 + which) * p.page + off) * key_stride + kh * kRow;
      return (which ? p.v : p.k) + (pid * p.page + off) * key_stride + kh * kRow;
    }
    const unsigned char* base = which ? p.v : p.k;
    if (p.heads_first) return base + (((size_t)cb * p.hk + kh) * p.smax + col) * kRow;
    return base + ((size_t)cb * p.smax + col) * key_stride + kh * kRow;
  };

  auto issue = [&](int col0, int slot) {
    const int n = tile_len(col0, end, p);
    const unsigned char* kb = row_ptr(col0, 0);
    const unsigned char* vb = row_ptr(col0, 1);
    unsigned char* dk = ring + (size_t)(slot * 2) * L::kTileBytes;
    unsigned char* dv = dk + L::kTileBytes;
    for (int idx = tid; idx < kTileN * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 16;
      const bool ok = r < n;
      cp_async16(dk + r * kRowBytes + c, ok ? kb + r * key_stride + c : p.k, ok ? 16 : 0);
      cp_async16(dv + r * kRowBytes + c, ok ? vb + r * key_stride + c : p.k, ok ? 16 : 0);
    }
  };

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
    if (load_col < end) {
      issue(load_col, (it + kStages - 1) % kStages);
      load_col += tile_len(load_col, end, p);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile `it` is in shared memory for every thread

    const int n = tile_len(col0, end, p);
    const unsigned char* sK = ring + (size_t)((it % kStages) * 2) * L::kTileBytes;
    const unsigned char* sV = sK + L::kTileBytes;

    // scores: thread per (row, key), consecutive threads on consecutive keys
    for (int idx = tid; idx < nr * kTileN; idx += kThreads) {
      const int r = idx / kTileN, j = idx % kTileN;
      const int gr = r0 + r, pos = gr % p.sq;
      const int col = col0 + j, rel = col - lp;
      const int qpos = pos + offset;
      bool masked = j >= n;
      if (p.has_upper) masked |= rel > qpos + p.wr;
      if (p.has_lower) masked |= rel < qpos - p.wl;
      if (p.chunk > 0) masked |= floor_div(rel, p.chunk) != floor_div(qpos, p.chunk);
      float x = -INFINITY;
      if (!masked) {
        const unsigned char* kr = sK + j * kRowBytes;
        if constexpr (kInt8) {
          const int4* qr = reinterpret_cast<const int4*>(reinterpret_cast<const int8_t*>(sQ) + r * D);
          int acc = 0;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int4 kw = *reinterpret_cast<const int4*>(kr + c * 16);
            const int4 qw = qr[c];
            acc = __dp4a(qw.x, kw.x, acc);
            acc = __dp4a(qw.y, kw.y, acc);
            acc = __dp4a(qw.z, kw.z, acc);
            acc = __dp4a(qw.w, kw.w, acc);
          }
          x = (float)acc * kfac;
        } else {
          const float* qr = sQ + r * D;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const uint4 u = *reinterpret_cast<const uint4*>(kr + c * 16);
            float f[kPer];
            Cache<TC>::chunk(u, f);
#pragma unroll
            for (int e = 0; e < kPer; ++e) dot = fmaf(qr[c * kPer + e], f[e], dot);
          }
          x = dot * kfac;
        }
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        if (p.alibi) {
          const float slope = p.alibi[bb * p.h + kh * p.g + gr / p.sq];
          x -= slope * fabsf((float)(qpos - rel));
        }
      }
      sS[idx] = x;
    }
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int r = warp; r < nr; r += kWarps) {
      float* sr = sS + r * kTileN;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f((x0 - m_use) * kLog2e), p1 = exp2f((x1 - m_use) * kLog2e);
      if constexpr (kInt8) {
        int* si = reinterpret_cast<int*>(sr);
        si[lane] = __float2int_rn(p0 * 127.f);
        si[lane + 32] = __float2int_rn(p1 * 127.f);
      } else {
        sr[lane] = p0;
        sr[lane + 32] = p1;
      }
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = exp2f((m_old - m_use) * kLog2e);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha O + P V: thread per (row, dim)
    for (int idx = tid; idx < nr * D; idx += kThreads) {
      const int r = idx / D, dd = idx % D;
      const unsigned char* vc = sV + dd * kBytes;
      float pv;
      if constexpr (kInt8) {
        const int* pr = reinterpret_cast<const int*>(sS + r * kTileN);
        int s = 0;
#pragma unroll 16
        for (int j = 0; j < kTileN; ++j)
          s += pr[j] * (int)*reinterpret_cast<const int8_t*>(vc + j * kRowBytes);
        pv = (float)s;
      } else {
        const float* pr = sS + r * kTileN;
        float s = 0.f;
#pragma unroll 16
        for (int j = 0; j < kTileN; ++j) s = fmaf(pr[j], Cache<TC>::one(vc + j * kRowBytes), s);
        pv = s;
      }
      sAcc[idx] = sAcc[idx] * sAlpha[r] + pv * vfac;
    }
    __syncthreads();  // this tile's slot may be refilled next iteration
    col0 += n;
  }
  cp_async_wait<0>();

  const size_t part = ((size_t)(bb * p.hk + kh) * p.splits + split) * p.rows + r0;
  for (int idx = tid; idx < nr * D; idx += kThreads) {
    const float l = sL[idx / D];
    p.o_part[part * D + idx] = l > 0.f ? sAcc[idx] / l : 0.f;
  }
  for (int r = tid; r < nr; r += kThreads) {
    const float l = sL[r];
    p.lse_part[part + r] = l > 0.f ? sM[r] + logf(l) : INFINITY;
  }
}

template <typename TQ, typename TC, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<D, Cache<TC>::kBytes>;
  const int smem = (int)L::smem_bytes(p.row_tile);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_ref_kernel<TQ, TC, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.rows + p.row_tile - 1) / p.row_tile;
  dim3 grid(tiles, p.splits, p.b * p.hk);
  flash_decode_ref_kernel<TQ, TC, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Params& p, int q_dtype, int cache_dtype, cudaStream_t s) {
  using E4 = Fp8<__NV_E4M3>;
  using E5 = Fp8<__NV_E5M2>;
  if (cache_dtype == 2) return launch<int8_t, int8_t, D>(p, s);
  if (q_dtype == 0) {
    if (cache_dtype == 0) return launch<__nv_bfloat16, __nv_bfloat16, D>(p, s);
    if (cache_dtype == 3) return launch<__nv_bfloat16, E4, D>(p, s);
    if (cache_dtype == 4) return launch<__nv_bfloat16, E5, D>(p, s);
  } else if (q_dtype == 1) {
    if (cache_dtype == 1) return launch<__half, __half, D>(p, s);
    if (cache_dtype == 3) return launch<__half, E4, D>(p, s);
    if (cache_dtype == 4) return launch<__half, E5, D>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q_dtype: 0 = bf16, 1 = fp16.  cache_dtype: 0 = bf16, 1 = fp16 (the q
// type), 2 = int8 (q pre-quantised to int8, q_scale given), 3 = fp8 e4m3,
// 4 = fp8 e5m2.  heads_first: a contiguous cache is (bc, hk, smax, d), not
// (bc, smax, hk, d).  Returns cudaGetLastError() after the launch.
extern "C" int flash_decode_ref(
    const void* q, const void* k_cache, const void* v_cache, float* o_part, float* lse_part,
    const int* cache_seqlens, const int* cache_leftpad, const int* cache_batch_idx,
    const int* block_table, const float* alibi, const float* q_scale, const float* k_descale,
    const float* v_descale, int b, int h, int hk, int sq, int d, int q_dtype, int cache_dtype,
    int paged, int fused, int page, int nk_max, int smax, int heads_first, int num_splits,
    int split_keys,
    float scale, int has_upper, int wr, int has_lower, int wl, int chunk, float softcap,
    void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  const int g = h / hk, rows = g * sq;
  Params p{q, static_cast<const unsigned char*>(k_cache),
           static_cast<const unsigned char*>(v_cache), o_part, lse_part, cache_seqlens,
           cache_leftpad, cache_batch_idx, block_table, alibi, q_scale, k_descale, v_descale,
           b, h, hk, g, sq, rows, rows < kRowTile ? rows : kRowTile,
           paged, fused, page, nk_max, smax, heads_first, num_splits, split_keys, scale,
           has_upper, wr, has_lower, wl, chunk, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return dispatch<64>(p, q_dtype, cache_dtype, s);
  if (d == 128) return dispatch<128>(p, q_dtype, cache_dtype, s);
  return cudaErrorInvalidValue;
}
