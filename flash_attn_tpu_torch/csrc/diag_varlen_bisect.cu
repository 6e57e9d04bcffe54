// Fixed-cost bisect of the scheduled varlen forward for Hopper (sm_90a):
// kernels stripped level by level that walk (qi, ki, fl) tick tables over
// q, k, v (H, total, 128) bf16 with packed aux words (segment << 16 | pos).
//
// Replaces the Pallas TPU kernels of benchmarks/diag_varlen_overhead_bisect.py:
//   make_kernel (:36, launched at :144)   K0 empty body, K1 + table and aux
//       reads, K2 + the predicated init, K3 + one interior body, K4 the full
//       kernel (interior and boundary bodies, finalize);
//   launch2's kernel (:214, at :334)      K4 + four predicated bodies
//       (first / boundary; K6), an lse output (K7), both (K8); K5's cost
//       estimate has no CUDA counterpart and runs K4;
//   launch3's kernel (:412, at :485)      K9: four bodies chosen by
//       code == i from a fourth table;
//   launch4's kernel (:547, at :599)      K10: n identical bodies at block_h
//       = bh, the code in fl >> 4.
// What each level computes follows the JAX kernels: raw scores s = q k^T in
// fp32 (no scale), boundary ticks add -3e38 where seg_q != seg_k or
// pos_k < pos_q, p = exp2(s - m) with m from -1e30, P cast to bf16 for P V,
// finalize o = acc / (l, or 1 where l = 0).  K0..K8 initialise under
// first & empty, K9 and K10 under first.
//
// What a tick is on the card.  On the TPU a tick is one step of the
// sequential grid axis, a (block_h, 1024-row) q block against a 1024-key
// block in VMEM.  That does not fit a CTA's shared memory, so here a CTA per
// (64-row slice of the q block, head group) walks the whole tick table in
// order, as the TPU's grid does, and for each tick does what the JAX level
// does for its 64 rows: its tables and aux, the init, the bodies over the
// key block in 64-key tiles, the finalize.  A tick therefore costs each of
// the bq / 64 CTAs of a head group one pass of this loop.
//
// What bounds it on the H100: for the probe's all-empty tables, nothing but
// the tables (the time is the fixed cost the probe is after); for a live
// tick, 4 * 64 * bk * 128 FLOPs a head and 64-row slice.
//
// What the design does about it.  A tick's inputs reach the CTA as the
// Pallas pipeline brings them, not by a dependent global load on every tick:
// * The tick tables (qi, ki, fl and K9's code, 4 T int32 at most) are
//   staged into shared memory once, before the loop, by bulk copies
//   (cp.async.bulk, the TMA's 1-D form) on one mbarrier.
// * The aux of tick t + 1 (its q rows' words, 64 x 8 int32, and key block's
//   row, bk int32) is prefetched by bulk copies into the second of two
//   buffers while tick t runs, each buffer with its own mbarrier; as the
//   Pallas pipeline, a tick whose block indices equal the buffer's skips the
//   copy.  A thread waits on a buffer's barrier once per copy.
// * A quiet tick (nothing to do at the level, and the next tick's aux
//   already in the current buffer) costs a lane of one warp step: each warp
//   tests 32 ticks at once and one ballot finds the next tick with work.
//   A tick with work runs on its own and ends with a __syncthreads (the
//   next tick may rewrite the state, and a later copy the other buffer).
// * The live bodies (run only by the checks) take the CTA's 64 rows as 4
//   warps of 16 on mma.sync.m16n8k16 bf16: Q fragments from ldmatrix, S and
//   the head's O, m, l in registers across the key block (loaded from and
//   stored back to the JAX scratch in shared memory), K from ldmatrix, V
//   from ldmatrix.trans.  Shared memory is sized as the JAX scratch (acc, m,
//   l for block_h heads) plus the tiles, tables and aux buffers, for every
//   level but K0, which takes none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

using fa::Mma;
using fa::quad_max;
using fa::quad_sum;

constexpr int kD = 128;
constexpr int kSlice = 64;   // q rows a CTA
constexpr int kTileN = 64;   // keys a tile
constexpr int kThreads = 128;  // 4 warps, 16 rows each in the bodies
constexpr int kStat = 8;     // q-aux lanes
constexpr int kPadRow = kD + 8;  // bf16 row stride in shared memory
constexpr int kTables = 4;   // qi, ki, fl, code
constexpr float kBias = -3e38f;
constexpr float kMInit = -1e30f;
constexpr int kFirst = 1, kLast = 2, kBound = 4, kEmpty = 8;

enum Variant { K0 = 0, K1, K2, K3, K4, K5, K6, K7, K8, K9, K10 };

struct Params {
  const int* qi;
  const int* ki;
  const int* fl;
  const int* code;  // K9
  const __nv_bfloat16* q;  // (H, total, 128)
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* qa;  // (total, kStat)
  const int* ka;  // (total / bk, kStat, bk)
  __nv_bfloat16* o;  // (H, total, 128)
  float* lse;        // (H, total), K7 / K8
  int total, bq, bk, bh, T;
};

__host__ __device__ inline int table_words(int T) { return (T + 3) & ~3; }
__host__ __device__ inline int aux_words(int bk) { return kSlice * kStat + bk; }

struct Smem {
  float* acc;   // (bh, 64, D)
  float* m;     // (bh, 64)
  float* l;     // (bh, 64)
  __nv_bfloat16* q;  // (64, kPadRow)
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  int* tab;     // (kTables, table_words(T)): the tables as staged
  int4* ticks;  // (table_words(T)): (qi, ki, fl, code) a tick
  int* aux;     // (2, aux_words(bk)): a buffer's q rows' words, then the key row
};

// Every region starts 16-byte aligned (the bulk copies' and ldmatrix's
// alignment).
__host__ __device__ inline size_t smem_bytes(int bh, int bk, int T) {
  return (size_t)bh * kSlice * kD * 4 + (size_t)2 * bh * kSlice * 4 +
         (size_t)3 * kSlice * kPadRow * 2 + (size_t)2 * kTables * table_words(T) * 4 +
         (size_t)2 * aux_words(bk) * 4;
}

__device__ inline Smem carve(unsigned char* base, const Params& p) {
  Smem s;
  s.acc = reinterpret_cast<float*>(base);
  s.m = s.acc + p.bh * kSlice * kD;
  s.l = s.m + p.bh * kSlice;
  s.q = reinterpret_cast<__nv_bfloat16*>(s.l + p.bh * kSlice);
  s.k = s.q + kSlice * kPadRow;
  s.v = s.k + kSlice * kPadRow;
  s.tab = reinterpret_cast<int*>(s.v + kSlice * kPadRow);
  s.ticks = reinterpret_cast<int4*>(s.tab + kTables * table_words(p.T));
  s.aux = reinterpret_cast<int*>(s.ticks + table_words(p.T));
  return s;
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fa::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fa::smem_u32(p)));
}

// 64 rows of 128 bf16 from global rows at `src` (row stride kD) into shared
// rows of kPadRow: 16 B a thread and copy.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  for (int idx = threadIdx.x; idx < kSlice * kD / 8; idx += kThreads) {
    const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * kPadRow + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * kD + c);
  }
}

// One body of the JAX levels for the CTA's 64 rows: for each of the bh heads,
// s = q k^T over the key block (plus the boundary bias with kMask, from the
// aux words aq (64 rows x kStat) and ak (bk)), then the online-softmax update
// and P V into acc, a 64-key tile at a time.  Warp w owns rows 16 w .. 16 w +
// 15.  kFresh starts each head's state anew (m = -1e30, l = 0, acc = 0),
// which is the JAX `fresh` update.  Ends with the state in shared memory.
template <bool kMask, bool kFresh>
__device__ __forceinline__ void body(const Params& p, const Smem& sm, const int* aq, const int* ak,
                                  int hb, int q0, int k0) {
  constexpr int kKS = kD / 16, kDT = kD / 8, kNT = kTileN / 8, kPK = kTileN / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
  int seg_q[2] = {0, 0}, pos_q[2] = {0, 0};
  if (kMask) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int a = aq[(r0 + gid + 8 * i) * kStat];
      seg_q[i] = (int)((unsigned)a >> 16);
      pos_q[i] = a & 0xFFFF;
    }
  }
  for (int hh = 0; hh < p.bh; ++hh) {
    const int head = hb * p.bh + hh;
    float* acc = sm.acc + hh * kSlice * kD;
    float* mrow = sm.m + hh * kSlice;
    float* lrow = sm.l + hh * kSlice;
    load_rows(sm.q, p.q + ((size_t)head * p.total + q0) * kD);
    __syncthreads();
    uint32_t qf[kKS][4];
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
      ldsm_x4(qf[kk], sm.q + (r0 + (lane & 15)) * kPadRow + kk * 16 + (lane >> 4) * 8);

    // the head's state of this thread's rows gid, gid + 8 (l: one share a
    // quad, summed back at the end)
    float o[kDT][4], m_run[2], l_run[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + gid + 8 * i;
      m_run[i] = kFresh ? kMInit : mrow[row];
      l_run[i] = (kFresh || tig != 0) ? 0.f : lrow[row];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        float2 x = make_float2(0.f, 0.f);
        if (!kFresh) x = *reinterpret_cast<const float2*>(acc + row * kD + dt * 8 + tig * 2);
        o[dt][2 * i] = x.x;
        o[dt][2 * i + 1] = x.y;
      }
    }

    for (int kt = 0; kt < p.bk / kTileN; ++kt) {
      const size_t key0 = (size_t)k0 + kt * kTileN;
      load_rows(sm.k, p.k + ((size_t)head * p.total + key0) * kD);
      load_rows(sm.v, p.v + ((size_t)head * p.total + key0) * kD);
      __syncthreads();

      float s[kNT][4];
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt) s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 2) {
#pragma unroll
        for (int jt = 0; jt < kNT; ++jt) {
          uint32_t b[4];
          ldsm_x4(b, sm.k + (jt * 8 + (lane & 7)) * kPadRow + kk * 16 + (lane >> 3) * 8);
          Mma<__nv_bfloat16>::mma(s[jt], qf[kk], b);
          Mma<__nv_bfloat16>::mma(s[jt], qf[kk + 1], b + 2);
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float x = s[jt][e];
          if (kMask) {
            const int a = ak[kt * kTileN + jt * 8 + tig * 2 + (e & 1)];
            if ((int)((unsigned)a >> 16) != seg_q[i] || (a & 0xFFFF) < pos_q[i]) x = x + kBias;
          }
          s[jt][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
        alpha[i] = exp2f(m_run[i] - m_new);
        m_run[i] = m_new;
      }
#pragma unroll
      for (int jt = 0; jt < kNT; ++jt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[jt][e] - m_run[e >> 1]);
          rs[e >> 1] += pe;
          s[jt][e] = pe;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
      // P rounded to bf16 (the JAX body's pmat.astype(v.dtype)) as A
      uint32_t pa[kPK][4];
#pragma unroll
      for (int c = 0; c < kPK; ++c) {
        pa[c][0] = Mma<__nv_bfloat16>::pack(s[2 * c][0], s[2 * c][1]);
        pa[c][1] = Mma<__nv_bfloat16>::pack(s[2 * c][2], s[2 * c][3]);
        pa[c][2] = Mma<__nv_bfloat16>::pack(s[2 * c + 1][0], s[2 * c + 1][1]);
        pa[c][3] = Mma<__nv_bfloat16>::pack(s[2 * c + 1][2], s[2 * c + 1][3]);
      }
#pragma unroll
      for (int ks = 0; ks < kPK; ++ks) {
#pragma unroll
        for (int dp = 0; dp < kDT; dp += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, sm.v + (ks * 16 + (lane & 15)) * kPadRow + (dp + (lane >> 4)) * 8);
          Mma<__nv_bfloat16>::mma(o[dp], pa[ks], b);
          Mma<__nv_bfloat16>::mma(o[dp + 1], pa[ks], b + 2);
        }
      }
      __syncthreads();  // the k and v tiles may be refilled
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + gid + 8 * i;
      const float l = quad_sum(l_run[i]);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(acc + row * kD + dt * 8 + tig * 2) =
            make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
      if (tig == 0) {
        mrow[row] = m_run[i];
        lrow[row] = l;
      }
    }
  }
  __syncthreads();  // the state is complete (the finalize reads all rows)
}

template <int V, int kBodies>
__global__ void __launch_bounds__(kThreads) bisect_kernel(const Params p) {
  if constexpr (V == K0) {
    return;
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ __align__(8) uint64_t bars[3];  // the tables; aux buffers 0, 1
    const Smem sm = carve(smem, p);
    const int sl = blockIdx.x, hb = blockIdx.y, tid = threadIdx.x;
    constexpr bool kAux = V != K10;
    constexpr bool kLse = V == K7 || V == K8;
    constexpr int kStaged = V == K9 ? 4 : 3;  // tables staged
    const int tw = table_words(p.T);
    const int* tables[kTables] = {p.qi, p.ki, p.fl, p.code};
    const int aw = aux_words(p.bk);

    // thread 0 copies the aux of block indices (qi, ki) into buffer `buf`
    auto issue_aux = [&](int buf, int qi, int ki) {
      const int q0 = qi * p.bq + sl * kSlice;
      int* dst = sm.aux + buf * aw;
      fa::mbar_expect_tx(&bars[1 + buf], aw * 4);
      fa::bulk_load(dst, p.qa + (size_t)q0 * kStat, kSlice * kStat * 4, &bars[1 + buf]);
      fa::bulk_load(dst + kSlice * kStat, p.ka + (size_t)ki * kStat * p.bk, p.bk * 4,
                    &bars[1 + buf]);
    };

    // Stage the tables: whole 16-byte chunks by bulk copies on bars[0], the
    // last T % 4 words by plain loads; then one (qi, ki, fl, code) record a
    // tick.  Tick 0's aux goes into buffer 0 meanwhile.
    const int bulk_words = p.T & ~3;
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < 3; ++b) fa::mbar_init(&bars[b], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int i = bulk_words + tid; i < p.T; i += kThreads)
#pragma unroll
      for (int j = 0; j < kStaged; ++j) sm.tab[j * tw + i] = tables[j][i];
    __syncthreads();  // the barriers are initialised, the tails in place
    if (tid == 0) {
      if (bulk_words > 0) {
        fa::mbar_expect_tx(&bars[0], kStaged * bulk_words * 4);
#pragma unroll
        for (int j = 0; j < kStaged; ++j)
          fa::bulk_load(sm.tab + j * tw, tables[j], bulk_words * 4, &bars[0]);
      }
      if (kAux && p.T > 0) issue_aux(0, p.qi[0], p.ki[0]);
    }
    if (bulk_words > 0) fa::mbar_wait(&bars[0], 0);
    for (int i = tid; i < p.T; i += kThreads)
      sm.ticks[i] = make_int4(sm.tab[i], sm.tab[tw + i], sm.tab[2 * tw + i],
                              V == K9 ? sm.tab[3 * tw + i] : 0);
    __syncthreads();

    // Whether a tick does anything at this level (init, a body, finalize).
    auto has_work = [&](int4 tk) {
      const int fl = tk.z;
      const bool first = fl & kFirst, empty = fl & kEmpty, last = fl & kLast;
      if constexpr (V <= K2) return first && empty;
      if constexpr (V <= K8) return (first && empty) || !empty || last;
      if constexpr (V == K9) return first || (tk.w >= 0 && tk.w < 4) || last;
      return first || ((unsigned)fl >> 4) < (unsigned)kBodies || last;
    };

    // The aux buffers, the current one (cur) and the other: the block
    // indices each holds, its copies issued (the last one's barrier phase
    // has parity n - 1), and whether this thread has yet to see the last one
    // land.  Every thread keeps the same bookkeeping.
    int cur = 0;
    int cq = -1, ck = -1, cn = 0, oq = -1, ok = -1, on = 0;
    bool c_pend = false, o_pend = false;
    if (kAux && p.T > 0) {
      cq = sm.ticks[0].x;
      ck = sm.ticks[0].y;
      cn = 1;
      c_pend = true;
    }

    const int lane = tid & 31;
    for (int t = 0; t < p.T; ++t) {
      // Skip the quiet ticks from t (nothing to do, and the next tick's aux
      // in the current buffer), 32 at a time: lane i tests tick t + i, and
      // every warp finds the same first tick that is not quiet.
      for (;;) {
        const int i = t + lane;
        bool loud = true;
        if (i < p.T) {
          bool same = true;
          if (kAux && i + 1 < p.T) {
            const int4 b = sm.ticks[i + 1];
            same = b.x == cq && b.y == ck;
          }
          loud = !same || has_work(sm.ticks[i]);
        }
        const unsigned m = __ballot_sync(0xffffffffu, loud);
        if (m != 0) {
          t += __ffs(m) - 1;
          break;
        }
        t += 32;
      }
      if (t >= p.T) break;

      const int4 tk = sm.ticks[t];
      const bool more = t + 1 < p.T;
      const int4 nx = more ? sm.ticks[t + 1] : make_int4(-1, -1, 0, 0);
      const bool same_aux = !kAux || !more || (nx.x == cq && nx.y == ck);

      // tick t + 1's aux: in the other buffer already, or copied there
      bool swap = false;
      if (!same_aux) {
        swap = true;
        if (nx.x != oq || nx.y != ok) {
          // the other buffer was last read before a tick's closing barrier;
          // its last copy has landed before its barrier is armed again
          if (tid == 0) {
            if (o_pend) fa::mbar_wait(&bars[2 - cur], (on - 1) & 1);
            issue_aux(cur ^ 1, nx.x, nx.y);
          }
          oq = nx.x;
          ok = nx.y;
          ++on;
          o_pend = true;
        }
      }
      if (kAux && c_pend) {  // tick t's aux
        fa::mbar_wait(&bars[1 + cur], (cn - 1) & 1);
        c_pend = false;
      }

      const int fl = tk.z;
      const bool first = fl & kFirst, empty = fl & kEmpty, bound = fl & kBound,
                 last = fl & kLast, live = !empty;
      const int q0 = tk.x * p.bq + sl * kSlice, k0 = tk.y * p.bk;
      const int* aq = sm.aux + cur * aw;
      const int* ak = aq + kSlice * kStat;
      if constexpr (V == K1) {
        if (first && empty && tid < kSlice) {
          const int a = aq[tid * kStat], b = ak[0];
          sm.m[tid] = (float)((a & 0xFFFF) + (b & 0xFFFF) + (int)((unsigned)a >> 16) +
                              (int)((unsigned)b >> 16));
        }
      } else {
        const bool init = V >= K9 ? first : (first && empty);
        if (init) {
          float4* acc4 = reinterpret_cast<float4*>(sm.acc);
          for (int i = tid; i < p.bh * kSlice * kD / 4; i += kThreads)
            acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int i = tid; i < p.bh * kSlice; i += kThreads) {
            sm.m[i] = kMInit;
            sm.l[i] = 0.f;
          }
          __syncthreads();
        }
        if constexpr (V == K3) {
          if (live) body<false, false>(p, sm, aq, ak, hb, q0, k0);
        } else if constexpr (V == K4 || V == K7) {
          if (live && !bound) body<false, false>(p, sm, aq, ak, hb, q0, k0);
          if (live && bound) body<true, false>(p, sm, aq, ak, hb, q0, k0);
        } else if constexpr (V == K6 || V == K8) {
          if (live && first && !bound) body<false, true>(p, sm, aq, ak, hb, q0, k0);
          if (live && first && bound) body<true, true>(p, sm, aq, ak, hb, q0, k0);
          if (live && !first && !bound) body<false, false>(p, sm, aq, ak, hb, q0, k0);
          if (live && !first && bound) body<true, false>(p, sm, aq, ak, hb, q0, k0);
        } else if constexpr (V == K9) {
          const int code = tk.w;
          if (code == 0) body<false, false>(p, sm, aq, ak, hb, q0, k0);
          if (code == 1) body<true, false>(p, sm, aq, ak, hb, q0, k0);
          if (code == 2) body<false, true>(p, sm, aq, ak, hb, q0, k0);
          if (code == 3) body<true, true>(p, sm, aq, ak, hb, q0, k0);
        } else if constexpr (V == K10) {
          const int code = (int)((unsigned)fl >> 4);
#pragma unroll
          for (int idx = 0; idx < kBodies; ++idx)
            if (code == idx) body<false, false>(p, sm, aq, ak, hb, q0, k0);
        }
        if (V != K2 && last) {
          for (int hh = 0; hh < p.bh; ++hh) {
            const int head = hb * p.bh + hh;
            const float* acc = sm.acc + hh * kSlice * kD;
            const float* lrow = sm.l + hh * kSlice;
            for (int i = tid; i < kSlice * kD; i += kThreads) {
              const int r = i / kD;
              const float l = lrow[r];
              const float ls = l == 0.f ? 1.f : l;
              p.o[((size_t)head * p.total + q0 + r) * kD + i % kD] =
                  __float2bfloat16_rn(acc[i] / ls);
            }
            if (kLse && tid < kSlice) {
              const float l = lrow[tid];
              const float ls = l == 0.f ? 1.f : l;
              p.lse[(size_t)head * p.total + q0 + tid] = sm.m[hh * kSlice + tid] + logf(ls);
            }
          }
        }
      }
      // the next tick may rewrite the state, and a later copy this buffer
      __syncthreads();
      if (swap) {
        cur ^= 1;
        int x = cq; cq = oq; oq = x;
        x = ck; ck = ok; ok = x;
        x = cn; cn = on; on = x;
        const bool b = c_pend; c_pend = o_pend; o_pend = b;
      }
    }
  }
}

template <int V, int kBodies>
cudaError_t launch(const Params& p, int heads, int empty_ctas, cudaStream_t s) {
  const int smem = V == K0 ? 0 : (int)smem_bytes(p.bh, p.bk, p.T);
  cudaError_t err = cudaFuncSetAttribute(bisect_kernel<V, kBodies>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.bq / kSlice, heads / p.bh, empty_ctas ? p.T : 1);
  bisect_kernel<V, kBodies><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// variant: 0..10 for K0..K10; n_bodies (K10): 1..4; empty_ctas (K0 only):
// one CTA per (tick, head group, row slice).  q, k, v, o (heads, total,
// 128) bf16; qa (total, 8), ka (total / bk, 8, bk) int32 (null for K10);
// code (T,) for K9; lse (heads, total) fp32 for K7 / K8.  The tables and
// the aux must be 16-byte aligned (their bulk copies).  Returns
// cudaGetLastError() after the launch.
extern "C" int diag_varlen_bisect(int variant, int n_bodies, int empty_ctas, const int* qi,
                                  const int* ki, const int* fl, const int* code, const void* q,
                                  const void* k, const void* v, const int* qa, const int* ka,
                                  void* o, float* lse, int heads, int total, int d, int bq,
                                  int bk, int bh, int T, void* stream) {
  if (d != kD || bq % kSlice || bk % kTileN || bh < 1 || bh > 4 || heads % bh) {
    return cudaErrorInvalidValue;
  }
  if (!aligned16(qi) || !aligned16(ki) || !aligned16(fl) || (code && !aligned16(code)) ||
      (qa && !aligned16(qa)) || (ka && !aligned16(ka))) {
    return cudaErrorInvalidValue;
  }
  Params p{qi, ki, fl, code, static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), qa, ka,
           static_cast<__nv_bfloat16*>(o), lse, total, bq, bk, bh, T};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (empty_ctas && variant != K0) return cudaErrorInvalidValue;
  switch (variant) {
    case K0: return launch<K0, 0>(p, heads, empty_ctas, s);
    case K1: return launch<K1, 0>(p, heads, 0, s);
    case K2: return launch<K2, 0>(p, heads, 0, s);
    case K3: return launch<K3, 0>(p, heads, 0, s);
    case K4: return launch<K4, 0>(p, heads, 0, s);
    case K5: return launch<K4, 0>(p, heads, 0, s);  // no cost estimate here
    case K6: return launch<K6, 0>(p, heads, 0, s);
    case K7: return launch<K7, 0>(p, heads, 0, s);
    case K8: return launch<K8, 0>(p, heads, 0, s);
    case K9:
      if (code == nullptr) return cudaErrorInvalidValue;
      return launch<K9, 0>(p, heads, 0, s);
    case K10:
      switch (n_bodies) {
        case 1: return launch<K10, 1>(p, heads, 0, s);
        case 2: return launch<K10, 2>(p, heads, 0, s);
        case 3: return launch<K10, 3>(p, heads, 0, s);
        case 4: return launch<K10, 4>(p, heads, 0, s);
      }
  }
  return cudaErrorInvalidValue;
}
