// Fused two-matmul log-space operator and whole-solve kernels for NVIDIA
// Hopper (sm_90a).
//
// One application of T on a (R, C) field ell (rows and columns are the
// two axis groups of the Kronecker form, see fused_discrete.py):
//
//   p = theta*ell - sub;  sh1[c] = max_r p[r, c]
//   log u = sh1 + log(M1 @ exp(p - sh1));  sh2[r] = max_c log u[r, c]
//   out = log1p(beta * exp((sh2 + log(exp(log u - sh2) @ M2T) + kap) / theta))
//
// sdfs_fused_solve runs, in one cooperative launch of one kernel,
//   mode 0 (apply): one application -> out.  Replaces
//     sdfs_via_autodiff_tpu/kernels/fused_discrete.py:72 (_fused_kernel).
//   mode 1 (SA): ell <- T(ell) while err = max|T(ell) - ell| > tol,
//     it < max_iter and err is not NaN.  Replaces
//     sdfs_via_autodiff_tpu/kernels/solver_kernel.py:41 (_solver_kernel).
//   mode 2 (AA): Type-II Anderson acceleration over T with X/F rings of m
//     fields, the m(m+1)/2 Gram sums in float32, ridge normal equations by
//     Gauss–Jordan, mixing every `mix`-th step once it >= m, and T(x) when
//     the combination is not finite; the JAX kernel's order (err before
//     mixing, explicit slot and mixing counters, ridge * max(tr/m, 1e-30)).
//     Replaces sdfs_via_autodiff_tpu/kernels/anderson_kernel.py:36
//     (_aa_kernel).
//
// What bounds them on an H100: an application is 2*2*R*C*(R + C)/2 FLOPs
// of FP32 FMA (256 MFLOP at 20^4 = 400 x 400 rows x columns, >= 3.8 us at
// 67 TFLOP/s) against a few MB of operands (~1 us at 3.35 TB/s): compute
// bound, and small enough that the whole working set (M1, M2T, kap, the
// field, its scratch copies and for AA the 2m history fields, ~4.5 MB and
// ~11 MB at 20^4) stays in the 50 MB L2 across iterations, but not in one
// block's 227 KB of shared memory.  The operator runs as two phases over
// the field's BM x 32 output tiles, with a grid-wide barrier after each:
//
//   phase 1, per tile: sh1 of the tile's 32 columns from the column
//     partials, U = M1 @ exp(p - sh1), log U + sh1 stored, and the tile's
//     per-row maxima stored as partials;
//   barrier;
//   phase 2, per tile: sh2 from the row partials, V = exp(log U - sh2) @
//     M2T, the epilogue, the tile's partial max |out - ell| and the
//     column maxima of the next iterate (for AA also the tile's Gram
//     partials and the ring stores);
//   barrier; every block reduces the err partials in the same order, so
//     all blocks take the same branch.
//
// Balanced, fixed ownership: the launcher picks the tile height BM (a
// multiple of 4, at most 64) as the smallest that gives every block of
// a one-per-SM grid exactly one tile (40 x 32 at 20^4: 130 tiles on 132
// SMs), so that no SM runs two tile-times while others idle, and the
// block's operands do not change between iterations: its M1 rows (BM x R)
// and M2T columns (C x 32) are copied into shared memory once per launch
// ("resident", 196 KB at 20^4), and only the field operand of each phase
// (exp of the iterate's column strip, exp of log U's row strip) is
// staged per phase, with the exp applied as it is staged and 16 loads in
// flight per thread (the staging is L2-latency and issue bound).  A
// block has 8 warps: all stage and run the epilogues (a warp per tile
// row, lane = column: row maxima by shuffles, column maxima and err
// through shared memory); 4*BM threads (160 at BM = 40) run the product,
// 4 x 2 outputs each, every output one fmaf chain over k in order from
// 0, as the 32 x 32-tile kernel before it summed, so that the iterates
// do not depend on the tiling (the Anderson loop's iteration counts at
// tol 1e-5 are sensitive to rounding; a split of K changed them).  Sets
// whose operands do not fit (continuous GCY 6^6: 36 x 1,296), or that
// have more tiles than SMs, run "chunked": 32-row tiles looped over the
// grid, both operands staged in K-chunks of 256.
//
// AA mixing steps add: block 0 reduces the Gram partials and solves the
// normal equations (one thread), barrier, the combination pass with a
// per-tile non-finite flag, barrier.  A cooperative launch guarantees
// co-residency (and fails instead of deadlocking), and the barrier is a
// generation barrier on two counters the caller zeroes.  Data written
// inside the launch is read with ld.cg (L2, coherent across SMs); only
// the read-only operands go through L1.  Transcendentals are CUDA's
// expf/logf/log1pf, built without fast-math; theta*ell is rounded before
// the subtraction, as the plain PyTorch version computes it.

#include <cuda_runtime.h>
#include <math.h>

#include "occupancy.cuh"

// SDFS_FUSED_SPLIT (compile-time, for timing the phases of the loops; 3,
// the default, is the kernel): 1 runs only phase 1 and its barrier per
// iteration, 2 phase 1, its barrier and phase 2 (no closing barrier, no
// err reduction).  SDFS_FUSED_BARRIER 1 makes grid_sync a bare
// __syncthreads: the results are wrong by construction; the variant only
// times the barriers.  Time the variants at a fixed count (tol -1).
#ifndef SDFS_FUSED_SPLIT
#define SDFS_FUSED_SPLIT 3
#endif
#ifndef SDFS_FUSED_BARRIER
#define SDFS_FUSED_BARRIER 0
#endif

namespace {

constexpr int kAlgoApply = 0;
constexpr int kAlgoSA = 1;
constexpr int kAlgoAA = 2;
constexpr int kMaxHist = 8;
constexpr int kMaxPairs = kMaxHist * (kMaxHist + 1) / 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 32;       // tile columns (one warp's lanes)
constexpr int kMaxBM = 64;    // tile rows, a multiple of 4
constexpr int kChunkBM = 32;  // tile rows of the chunked layout
constexpr int kChunkK = 256;  // K-chunk of the chunked layout
constexpr int kGramTile = 32;      // rows of the Gram sums' element tiles
constexpr int kGramThreads = 128;  // threads of their reduction
constexpr int kPartFloats = kMaxBM * kBN;    // the tile's sums
constexpr int kBatch = 16;    // loads in flight per thread when staging
constexpr size_t kSmemLimit = 232448;        // a block's shared memory

struct Params {
  const float* ell0;
  const float* m1;      // (R, R)
  const float* m2t;     // (C, C)
  const float* kap;     // (R, C)
  const float* sub;     // (R, C) or null
  float* out;           // (R, C)
  float* logu;          // (R, C)
  float* buf;           // (R, C): SA ping-pong partner, AA combination
  float* rowpart;       // (n_ct, R) per-tile row maxima of log U
  float* colpart;       // (n_rt, C) per-tile column maxima of p(iterate)
  float* colpart2;      // (n_rt, C) the same for the AA combination
  float* errpart;       // (n_tiles,)
  float* grampart;      // (n_tiles, kMaxPairs)
  float* flagpart;      // (n_tiles,)
  float* alpha;         // (kMaxHist,)
  float* xring;         // (m, R, C)
  float* fring;         // (m, R, C)
  unsigned* sync;       // barrier counters (count, generation), zeroed
  int* iters_out;
  float* err_out;
  int R, C, n_rt, n_ct;
  int bm;               // tile rows
  int resident;         // 1: the block's operands stay in shared memory
  int kc1, kc2;         // K-chunks of phase 1 (over R) and 2 (over C)
  float theta, beta, tol;
  int max_iter;
  int m, mix;
  float beta_aa, ridge;
};

// Row stride of the k-major staged A operands (BM rows): a multiple of 4
// (float4 rows) that is 4 mod 8, so that the transposing stores of
// consecutive k (phase 2's staging) spread over 8 banks.
__host__ __device__ inline int bm_stride(int bm) {
  return (bm + 4) % 8 == 4 ? bm + 4 : bm + 8;
}

// Floats of the dynamic shared memory: the phase-1 A operand (M1 rows,
// k-major), the phase-2 B operand (M2T columns), the staged field operand
// of either phase and the tile's sums.
__host__ __device__ inline size_t fused_smem_floats(int bm, int kc1,
                                                    int kc2) {
  const size_t bms = bm_stride(bm);
  const size_t x1 = (size_t)kc1 * kBN, x2 = (size_t)kc2 * bms;
  return (size_t)kc1 * bms + (size_t)kc2 * kBN + (x1 > x2 ? x1 : x2) +
         kPartFloats;
}

// Element tiles of the Anderson Gram sums (see gram_tiles_of).
__host__ __device__ inline int gram_tiles(int R, int n_ct) {
  return (R + kGramTile - 1) / kGramTile * n_ct;
}

// Max that propagates NaN (as torch.amax and jnp.max do).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

// Generation barrier over the whole (co-resident) grid.  Thread 0 of
// each block arrives on sync[0]; the last arrival resets it and bumps the
// generation sync[1], which the others spin on.  The fences around it
// publish each block's writes before its arrival and order the later
// reads after the release (the cooperative-groups grid sync pattern).
__device__ void grid_sync(unsigned* sync) {
  __syncthreads();
#if SDFS_FUSED_BARRIER == 1
  return;
#endif
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Smem {
  float shift[kMaxBM];          // sh1 (columns) or sh2 (rows) of the tile
  float red[kWarps][kMaxPairs];
  float scratch[kWarps][kMaxBM];
  float solve[kMaxHist][kMaxHist + 1];
};

// The dynamic shared memory of one block.
struct Dyn {
  float* a1;     // (kc1, bm_stride): M1 rows of the tile, k-major
  float* b2;     // (kc2, kBN): M2T columns of the tile
  float* x;      // staged field operand: (kc1, kBN) or (kc2, bm_stride)
  float* part;   // (bm, kBN) the tile's sums
};

__device__ Dyn dyn_of(const Params& P, float* base) {
  const int bms = bm_stride(P.bm);
  const size_t x1 = (size_t)P.kc1 * kBN, x2 = (size_t)P.kc2 * bms;
  Dyn d;
  d.a1 = base;
  d.b2 = d.a1 + (size_t)P.kc1 * bms;
  d.x = d.b2 + (size_t)P.kc2 * kBN;
  d.part = d.x + (x1 > x2 ? x1 : x2);
  return d;
}

// The thread's place in the tile product: 4 x 2 outputs (rows 4*ty..,
// columns 2*tx..), 4*bm threads (160 at bm = 40); the rest of the block
// stages and runs the epilogues.  Each output is one thread's fmaf chain
// over k in order from 0, so a sum does not depend on the tiling.
struct Sub {
  int tx, ty;
  bool active;
};

__device__ __forceinline__ Sub sub_of(int bm) {
  Sub u;
  u.tx = threadIdx.x % (kBN / 2);
  u.ty = threadIdx.x / (kBN / 2);
  u.active = (int)threadIdx.x < 4 * bm;
  return u;
}

// acc += A[k, 4ty..] (x) B[k, 2tx..] over k < kc, in order of k; A
// k-major with row stride lda, B with row stride kBN.  (Loading the next
// 8 k-steps' operands by hand while the current ones' FMAs run measured
// slower on an H100: 39.2 against 33.4 us per SA iteration at 20^4.)
__device__ __forceinline__ void sub_gemm(const float* A, int lda,
                                         const float* B, int kc,
                                         const Sub& u, float (&acc)[4][2]) {
  const float* a = A + 4 * u.ty;
  const float* b = B + 2 * u.tx;
#pragma unroll 8
  for (int k = 0; k < kc; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + (size_t)k * lda);
    const float2 bv = *reinterpret_cast<const float2*>(b + (size_t)k * kBN);
    acc[0][0] = fmaf(av.x, bv.x, acc[0][0]);
    acc[0][1] = fmaf(av.x, bv.y, acc[0][1]);
    acc[1][0] = fmaf(av.y, bv.x, acc[1][0]);
    acc[1][1] = fmaf(av.y, bv.y, acc[1][1]);
    acc[2][0] = fmaf(av.z, bv.x, acc[2][0]);
    acc[2][1] = fmaf(av.z, bv.y, acc[2][1]);
    acc[3][0] = fmaf(av.w, bv.x, acc[3][0]);
    acc[3][1] = fmaf(av.w, bv.y, acc[3][1]);
  }
}

// The tile's sums into d.part, published by the barrier after.
__device__ __forceinline__ void store_sums(const Dyn& d, const Sub& u,
                                           const float (&acc)[4][2]) {
  if (!u.active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      d.part[(4 * u.ty + i) * kBN + 2 * u.tx + j] = acc[i][j];
}

// put(i, j, load(i, j)) over i < n_rows (a warp per row), j < n_cols
// (lanes), with kBatch loads in flight per thread before their values
// are used (the loads come from L2; one at a time they would leave the
// staging latency-bound).
template <class Load, class Put>
__device__ __forceinline__ void stage(int n_rows, int n_cols, Load load,
                                      Put put) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nj = (n_cols + 31) / 32;
  const int n = (n_rows - warp + kWarps - 1) / kWarps * nj;
  for (int q0 = 0; q0 < n; q0 += kBatch) {
    float2 v[kBatch];
    int qi = q0 / nj, qj = q0 - qi * nj;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = lane + 32 * qj;
      v[b] = (q0 + b < n && j < n_cols) ? load(warp + kWarps * qi, j)
                                         : make_float2(0.f, 0.f);
      if (++qj == nj) {
        qj = 0;
        ++qi;
      }
    }
    qi = q0 / nj;
    qj = q0 - qi * nj;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = lane + 32 * qj;
      if (q0 + b < n && j < n_cols) put(warp + kWarps * qi, j, v[b]);
      if (++qj == nj) {
        qj = 0;
        ++qi;
      }
    }
  }
}

// p = theta*ell - sub from raw (ell, sub), theta*ell rounded first.
__device__ __forceinline__ float p_raw(const Params& P, float v, float sb) {
  const float p = __fmul_rn(P.theta, v);
  return P.sub != nullptr ? p - sb : p;
}

__device__ __forceinline__ float sub_at(const Params& P, size_t idx) {
  return P.sub != nullptr ? __ldg(P.sub + idx) : 0.f;
}

// Column maxima over a tile's rows, each thread holding one column (its
// lane): combine the warps and store the 32 values at col[c0 ..] (columns
// < C).
__device__ void store_colmax(const Params& P, Smem& s, float mx, float* col,
                             int c0) {
  const int lane = threadIdx.x % 32;
  s.scratch[threadIdx.x / 32][lane] = mx;
  __syncthreads();
  if (threadIdx.x < kBN && c0 + threadIdx.x < P.C) {
    float v = s.scratch[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v = nanmax(v, s.scratch[w][threadIdx.x]);
    col[c0 + threadIdx.x] = v;
  }
  __syncthreads();
}

// s.shift[i] = max over g < n of part[g * stride + base + i] for i <
// valid (-inf beyond, i < width <= kMaxBM): the block's threads split
// the partials.  Ends with a barrier that publishes s.shift.
__device__ void shift_from_partials(Smem& s, const float* part, int n,
                                    size_t stride, int base, int valid,
                                    int width) {
  constexpr int kGroups = kThreads / kMaxBM;
  const int i = threadIdx.x % kMaxBM, g0 = threadIdx.x / kMaxBM;
  float mx = -INFINITY;
  if (i < valid && i < width)
    for (int g = g0; g < n; g += kGroups)
      mx = nanmax(mx, ldcg(part + (size_t)g * stride + base + i));
  __syncthreads();                        // s.shift, s.scratch free
  s.scratch[g0][i] = mx;
  __syncthreads();
  if (threadIdx.x < width) {
    float v = s.scratch[0][threadIdx.x];
    for (int w = 1; w < kGroups; ++w) v = nanmax(v, s.scratch[w][threadIdx.x]);
    s.shift[threadIdx.x] = v;
  }
  __syncthreads();
}

// NaN-propagating max of v[0 .. n) by the whole block, the same value
// in every thread (the order does not change a max).
__device__ float block_max_of(Smem& s, const float* v, int n) {
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) m = nanmax(m, ldcg(v + i));
  m = warp_nanmax(m);
  __syncthreads();                        // s.red free
  if (threadIdx.x % 32 == 0) s.red[threadIdx.x / 32][0] = m;
  __syncthreads();
  float r = s.red[0][0];
  for (int w = 1; w < kWarps; ++w) r = nanmax(r, s.red[w][0]);
  return r;
}

// The block's M1 rows [r0, r0 + bm) x k in [k0, k0 + kc) into a1 (k-major,
// zero past R) and M2T columns [c0, c0 + 32) x k in [k0, k0 + kc) into b2
// (zero past C): once per launch when resident, per K-chunk otherwise.
__device__ void stage_m1(const Params& P, const Dyn& d, int r0, int k0,
                         int kc) {
  const int bms = bm_stride(P.bm);
  stage(
      P.bm, kc,
      [&](int r, int k) {
        return make_float2(
            r0 + r < P.R ? __ldg(P.m1 + (size_t)(r0 + r) * P.R + k0 + k)
                         : 0.f,
            0.f);
      },
      [&](int r, int k, float2 v) { d.a1[(size_t)k * bms + r] = v.x; });
}

__device__ void stage_m2t(const Params& P, const Dyn& d, int c0, int k0,
                          int kc) {
  stage(
      kc, kBN,
      [&](int k, int c) {
        return make_float2(
            c0 + c < P.C ? __ldg(P.m2t + (size_t)(k0 + k) * P.C + c0 + c)
                         : 0.f,
            0.f);
      },
      [&](int k, int c, float2 v) { d.b2[(size_t)k * kBN + c] = v.x; });
}

// exp(p - sh1) of the tile's column strip, rows k0 .. k0 + kc of cur,
// into x (k-major, kBN per row; 0 past C): a warp per row, lane =
// column, kBatch rows' loads in flight per thread.
__device__ void stage_cols(const Params& P, const Smem& s, float* x,
                           const float* cur, int c0, int k0, int kc) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool cok = c0 + lane < P.C;
  const float sh = s.shift[lane];
  const size_t C = P.C;
  const float* src = cur + (size_t)k0 * C + c0 + lane;
  const float* sub =
      P.sub != nullptr ? P.sub + (size_t)k0 * C + c0 + lane : nullptr;
  for (int kb = warp; kb < kc; kb += kWarps * kBatch) {
    float v[kBatch], sb[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int k = kb + b * kWarps;
      const bool ok = cok && k < kc;
      v[b] = ok ? ldcg(src + k * C) : 0.f;
      sb[b] = (ok && sub != nullptr) ? __ldg(sub + k * C) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int k = kb + b * kWarps;
      if (k < kc) x[k * kBN + lane] = cok ? expf(p_raw(P, v[b], sb[b]) - sh)
                                          : 0.f;
    }
  }
}

// exp(log U - sh2) of the tile's row strip, columns k0 .. k0 + kc, into x
// (k-major, row stride bm_stride; 0 past R): a warp per row, lanes over
// k, kBatch loads in flight per thread.
__device__ void stage_rows(const Params& P, const Smem& s, float* x, int r0,
                           int k0, int kc) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bms = bm_stride(P.bm);
  for (int r = warp; r < P.bm; r += kWarps) {
    const bool ok = r0 + r < P.R;
    const float sh = s.shift[r];
    const float* src = P.logu + (size_t)(r0 + r) * P.C + k0;
    for (int kb = lane; kb < kc; kb += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int k = kb + 32 * b;
        v[b] = (ok && k < kc) ? ldcg(src + k) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int k = kb + 32 * b;
        if (k < kc) x[k * bms + r] = ok ? expf(v[b] - sh) : 0.f;
      }
    }
  }
}

// Phase 0 for tile t: the tile's column maxima of p(cur) into colpart
// (the first iterate's; later iterates get theirs in phase 2 and in
// the AA combination).
__device__ void phase0(const Params& P, Smem& s, const float* cur,
                       float* colpart, int t) {
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  const int r0 = rt * P.bm, c = ct * kBN + threadIdx.x % 32;
  float mx = -INFINITY;
  for (int r = r0 + threadIdx.x / 32; r < min(r0 + P.bm, P.R); r += kWarps)
    if (c < P.C) {
      const size_t idx = (size_t)r * P.C + c;
      mx = nanmax(mx, p_raw(P, ldcg(cur + idx), sub_at(P, idx)));
    }
  store_colmax(P, s, mx, colpart + (size_t)rt * P.C, ct * kBN);
}

// Phase 1 for tile t: sh1 from the column partials of cur, log U = sh1 +
// log(M1 @ exp(p - sh1)), and the tile's per-row maxima of log U.
__device__ void phase1(const Params& P, Smem& s, const Dyn& d,
                       const float* cur, const float* colpart, int t) {
  const int R = P.R, C = P.C;
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  const int r0 = rt * P.bm, c0 = ct * kBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  shift_from_partials(s, colpart, P.n_rt, C, c0, C - c0, kBN);
  const Sub u = sub_of(P.bm);
  float acc[4][2] = {};
  for (int k0 = 0; k0 < R; k0 += P.kc1) {
    const int kc = min(P.kc1, R - k0);
    if (!P.resident) stage_m1(P, d, r0, k0, kc);
    stage_cols(P, s, d.x, cur, c0, k0, kc);
    __syncthreads();
    if (u.active) sub_gemm(d.a1, bm_stride(P.bm), d.x, kc, u, acc);
    __syncthreads();
  }
  store_sums(d, u, acc);
  __syncthreads();
  // A warp per tile row, lane = column.
  for (int r = warp; r < P.bm; r += kWarps) {
    const int gr = r0 + r, c = c0 + lane;
    float mx = -INFINITY;
    if (gr < R && c < C) {
      const float lu = s.shift[lane] + logf(d.part[r * kBN + lane]);
      P.logu[(size_t)gr * C + c] = lu;
      mx = lu;
    }
    mx = warp_nanmax(mx);
    if (lane == 0 && gr < R) P.rowpart[(size_t)ct * R + gr] = mx;
  }
  __syncthreads();                        // d.part, s.shift free
}

// Phase 2 for tile t: out = epilogue(sh2 + log(exp(log U - sh2) @ M2T) +
// kap) into dst, the tile's partial max |out - cur| and (SA, AA) the
// tile's column maxima of p(out) into colpart; for AA also X[slot] = cur.
template <int ALGO>
__device__ void phase2(const Params& P, Smem& s, const Dyn& d,
                       const float* cur, float* dst, int t, int slot) {
  const int R = P.R, C = P.C;
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  const int r0 = rt * P.bm, c0 = ct * kBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bms = bm_stride(P.bm);
  shift_from_partials(s, P.rowpart, P.n_ct, R, r0, R - r0, P.bm);
  const Sub u = sub_of(P.bm);
  float acc[4][2] = {};
  for (int k0 = 0; k0 < C; k0 += P.kc2) {
    const int kc = min(P.kc2, C - k0);
    if (!P.resident) stage_m2t(P, d, c0, k0, kc);
    stage_rows(P, s, d.x, r0, k0, kc);
    __syncthreads();
    if (u.active) sub_gemm(d.x, bms, d.b2, kc, u, acc);
    __syncthreads();
  }
  store_sums(d, u, acc);
  __syncthreads();
  const size_t field = (size_t)R * C;
  const int c = c0 + lane;
  float err = 0.f, cmax = -INFINITY;
  // The warp's rows' kap, cur and sub loaded before any is used.
  constexpr int kRows = kMaxBM / kWarps;
  float kv[kRows], lv[kRows], sv[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gr = r0 + warp + kWarps * i;
    const bool ok = warp + kWarps * i < P.bm && gr < R && c < C;
    const size_t idx = (size_t)gr * C + c;
    kv[i] = ok ? __ldg(P.kap + idx) : 0.f;
    lv[i] = ok ? ldcg(cur + idx) : 0.f;
    sv[i] = ok ? sub_at(P, idx) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i, gr = r0 + r;
    if (r >= P.bm || gr >= R || c >= C) continue;
    const size_t idx = (size_t)gr * C + c;
    const float lh = s.shift[r] + logf(d.part[r * kBN + lane]) + kv[i];
    const float o = log1pf(P.beta * expf(lh / P.theta));
    const float l = lv[i];
    dst[idx] = o;
    err = nanmax(err, fabsf(o - l));
    if (ALGO != kAlgoApply) cmax = nanmax(cmax, p_raw(P, o, sv[i]));
    if (ALGO == kAlgoAA) P.xring[slot * field + idx] = l;
  }
  // Block reductions: err (NaN-propagating max) and column maxima.
  err = warp_nanmax(err);
  if (lane == 0) s.red[warp][0] = err;
  if (ALGO != kAlgoApply) s.scratch[warp][lane] = cmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = s.red[0][0];
    for (int w = 1; w < kWarps; ++w) v = nanmax(v, s.red[w][0]);
    P.errpart[t] = v;
  }
  if (ALGO != kAlgoApply && threadIdx.x < kBN && c0 + threadIdx.x < C) {
    float v = s.scratch[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v = nanmax(v, s.scratch[w][threadIdx.x]);
    P.colpart[(size_t)rt * C + c0 + threadIdx.x] = v;
  }
  __syncthreads();
}

// The Anderson Gram sums sum g_q g_q2 (g_q = F[q] - X[q]) over element
// tiles of 32 x 32 (kGramTile rows, tile g of n_ct per row of tiles),
// reduced exactly as the kernel with 32 x 32 output tiles and 128
// threads reduced them: thread (ty, tx) of a 128-thread half sums its
// 4 x 2 elements (rows first), a butterfly per warp, its 4 warps in
// order.  The sums are not tied to the product's tiles, so that the
// tiling cannot change the mixing weights' rounding (the Anderson
// loop's iteration count at tol 1e-5 reacts to it).  A block's two
// halves take two tiles; runs after the barrier that ends phase 2, on
// mixing steps.
__device__ void gram_tiles_of(const Params& P, Smem& s, int g0, int n_gram) {
  const int R = P.R, C = P.C;
  const int half = threadIdx.x / kGramThreads;
  const int g = g0 + half;
  const int r0 = (g / P.n_ct) * kGramTile, c0 = (g % P.n_ct) * kBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t field = (size_t)R * C;
  const int pairs = P.m * (P.m + 1) / 2;
  const int tx = threadIdx.x % 16, ty = (threadIdx.x % kGramThreads) / 16;
  float g2[kMaxPairs];
#pragma unroll
  for (int q = 0; q < kMaxPairs; ++q) g2[q] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + ty * 4 + i, c = c0 + tx * 2 + j;
      if (g >= n_gram || r >= R || c >= C) continue;
      const size_t idx = (size_t)r * C + c;
      float gq[kMaxHist];
#pragma unroll
      for (int q = 0; q < kMaxHist; ++q)
        gq[q] = q < P.m ? ldcg(P.fring + q * field + idx) -
                              ldcg(P.xring + q * field + idx)
                        : 0.f;
      int n = 0;
      for (int q = 0; q < P.m; ++q)
        for (int q2 = 0; q2 <= q; ++q2) g2[n++] += gq[q] * gq[q2];
    }
  __syncthreads();                        // s.red free
  for (int q = 0; q < pairs; ++q) {
    const float v = warp_sum(g2[q]);
    if (lane == 0) s.red[warp][q] = v;
  }
  __syncthreads();
  const int q = threadIdx.x % kGramThreads;
  if (q < pairs && g < n_gram) {
    const int w0 = half * (kGramThreads / 32);
    float v = s.red[w0][q];
    for (int w = 1; w < kGramThreads / 32; ++w) v += s.red[w0 + w][q];
    P.grampart[(size_t)g * kMaxPairs + q] = v;
  }
  __syncthreads();
}

// Block 0: Gram matrix from the tile partials (reduced in a fixed order),
// ridge normal equations [A + ridge*max(tr/m, 1e-30) I | 1] by
// Gauss–Jordan without pivoting, alpha = sol / sum(sol).
__device__ void solve_weights(const Params& P, Smem& s, int n_tiles) {
  const int m = P.m, pairs = m * (m + 1) / 2;
  // Every thread sums a strided subset of the tiles, then each pair's
  // sum is reduced over the block in a fixed order.
  float part[kMaxPairs];
  for (int q = 0; q < pairs; ++q) part[q] = 0.f;
  if (threadIdx.x < kGramThreads)
    for (int t = threadIdx.x; t < n_tiles; t += kGramThreads)
      for (int q = 0; q < pairs; ++q)
        part[q] += ldcg(P.grampart + (size_t)t * kMaxPairs + q);
  __syncthreads();                        // s.red free
  for (int q = 0; q < pairs; ++q) {
    const float v = warp_sum(part[q]);
    if (threadIdx.x % 32 == 0) s.red[threadIdx.x / 32][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < pairs) {
    float v = s.red[0][threadIdx.x];
    for (int w = 1; w < kGramThreads / 32; ++w) v += s.red[w][threadIdx.x];
    s.red[0][threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float (*M)[kMaxHist + 1] = s.solve;
    for (int i = 0; i < m; ++i)
      for (int j = 0; j <= m; ++j) M[i][j] = (j == m) ? 1.f : 0.f;
    float tr = 0.f;
    int n = 0;
    for (int p = 0; p < m; ++p)
      for (int q = 0; q <= p; ++q) {
        const float v = s.red[0][n++];
        M[p][q] += v;
        if (p != q) M[q][p] += v;
        else tr += v;
      }
    const float ridge_term = P.ridge * fmaxf(tr / (float)m, 1e-30f);
    for (int i = 0; i < m; ++i) M[i][i] += ridge_term;
    for (int i = 0; i < m; ++i) {
      const float piv = M[i][i];
      for (int j = 0; j <= m; ++j) M[i][j] = M[i][j] / piv;
      for (int r = 0; r < m; ++r) {
        if (r == i) continue;
        const float f = M[r][i];
        for (int j = 0; j <= m; ++j) M[r][j] = M[r][j] - f * M[i][j];
      }
    }
    float total = 0.f;
    for (int i = 0; i < m; ++i) total += M[i][m];
    for (int i = 0; i < m; ++i) P.alpha[i] = M[i][m] / total;
  }
  __syncthreads();
}

// The AA combination over tile t into P.buf, the tile's column maxima
// of p(x) into colpart2, and the tile's non-finite flag.
__device__ void combine(const Params& P, Smem& s, int t) {
  const int R = P.R, C = P.C;
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  const int r0 = rt * P.bm, c0 = ct * kBN;
  const size_t field = (size_t)R * C;
  float a[kMaxHist];
  for (int q = 0; q < P.m; ++q) a[q] = ldcg(P.alpha + q);
  const float w_x = 1.f - P.beta_aa, w_f = P.beta_aa;
  const int c = c0 + threadIdx.x % 32;
  int bad = 0;
  float mx = -INFINITY;
  for (int r = r0 + threadIdx.x / 32; r < min(r0 + P.bm, R); r += kWarps) {
    if (c >= C) continue;
    const size_t idx = (size_t)r * C + c;
    float x = 0.f;
    for (int q = 0; q < P.m; ++q)
      x = x + a[q] * (w_x * ldcg(P.xring + q * field + idx) +
                      w_f * ldcg(P.fring + q * field + idx));
    P.buf[idx] = x;
    bad |= !isfinite(x);
    mx = nanmax(mx, p_raw(P, x, sub_at(P, idx)));
  }
  store_colmax(P, s, mx, P.colpart2 + (size_t)rt * C, c0);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) P.flagpart[t] = bad ? 1.f : 0.f;
}

// dst <- src over tile t.
__device__ void copy_tile(const Params& P, const float* src, float* dst,
                          int t) {
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  const int r0 = rt * P.bm, c = ct * kBN + threadIdx.x % 32;
  for (int r = r0 + threadIdx.x / 32; r < min(r0 + P.bm, P.R); r += kWarps)
    if (c < P.C) dst[(size_t)r * P.C + c] = ldcg(src + (size_t)r * P.C + c);
}

template <int ALGO>
__global__ void __launch_bounds__(kThreads)
fused_solve_kernel(Params P) {
  __shared__ __align__(16) Smem s;
  extern __shared__ __align__(16) float dyn_smem[];
  const Dyn d = dyn_of(P, dyn_smem);
  const int n_tiles = P.n_rt * P.n_ct;
  const size_t field = (size_t)P.R * P.C;
  const float* cur = P.ell0;
  const float* ccol = P.colpart;          // column partials of cur
  float* nxt = P.out;
  float err = INFINITY;
  int it = 0, slot = 0, mix_ctr = 0;
  const int max_iter = (ALGO == kAlgoApply) ? 1 : P.max_iter;
  if (P.resident) {                       // one tile per block, fixed
    const int t = blockIdx.x;
    stage_m1(P, d, (t / P.n_ct) * P.bm, 0, P.R);
    stage_m2t(P, d, (t % P.n_ct) * kBN, 0, P.C);
  }
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
    phase0(P, s, cur, P.colpart, t);
  grid_sync(P.sync);
  while (err > P.tol && it < max_iter && !isnan(err)) {
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
      phase1(P, s, d, cur, ccol, t);
    grid_sync(P.sync);
#if SDFS_FUSED_SPLIT == 1
    if (ALGO != kAlgoApply) {
      ++it;
      continue;
    }
#endif
    const bool use_aa =
        ALGO == kAlgoAA && it >= P.m && mix_ctr == 0;
    float* dst = (ALGO == kAlgoAA) ? P.fring + slot * field : nxt;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
      phase2<ALGO>(P, s, d, cur, dst, t, slot);
    if (ALGO == kAlgoApply) break;
#if SDFS_FUSED_SPLIT == 2
    if (ALGO == kAlgoSA) {
      cur = nxt;
      nxt = (nxt == P.out) ? P.buf : P.out;
    }
    ++it;
    continue;
#endif
    grid_sync(P.sync);
    err = block_max_of(s, P.errpart, n_tiles);
    ccol = P.colpart;
    if (ALGO == kAlgoSA) {
      cur = nxt;
      nxt = (nxt == P.out) ? P.buf : P.out;
    } else {
      cur = dst;                          // fx
      if (use_aa) {
        const int n_gram = gram_tiles(P.R, P.n_ct);
        constexpr int kPer = kThreads / kGramThreads;
        for (int g = blockIdx.x * kPer; g < n_gram; g += gridDim.x * kPer)
          gram_tiles_of(P, s, g, n_gram);
        grid_sync(P.sync);
        if (blockIdx.x == 0) solve_weights(P, s, n_gram);
        grid_sync(P.sync);
        for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
          combine(P, s, t);
        grid_sync(P.sync);
        if (block_max_of(s, P.flagpart, n_tiles) == 0.f) {
          cur = P.buf;
          ccol = P.colpart2;
        }
      }
      slot = (slot + 1 >= P.m) ? 0 : slot + 1;
      mix_ctr = (mix_ctr + 1 >= P.mix) ? 0 : mix_ctr + 1;
    }
    ++it;
  }
  if (ALGO != kAlgoApply && cur != P.out)
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
      copy_tile(P, cur, P.out, t);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (P.iters_out != nullptr) *P.iters_out = it;
    if (P.err_out != nullptr) *P.err_out = err;
  }
}

// The tiling of (R, C) fields on `sms` SMs (mirrored by
// fused_discrete.fused_layout): resident when some tile height bm <=
// kMaxBM gives at most one tile per SM and the block's operands fit
// beside its staging buffers, else chunked.
struct Tiling {
  int bm, resident, kc1, kc2, n_rt, n_ct;
  size_t smem;
};

Tiling tiling(int R, int C, int sms) {
  Tiling T;
  T.n_ct = (C + kBN - 1) / kBN;
  const size_t dyn_limit = kSmemLimit - sizeof(Smem);
  for (int bm = 4; bm <= kMaxBM; bm += 4) {
    const int n_rt = (R + bm - 1) / bm;
    if ((long long)n_rt * T.n_ct > sms) continue;
    const size_t smem = sizeof(float) * fused_smem_floats(bm, R, C);
    if (smem > dyn_limit) break;          // taller tiles need more
    T.bm = bm;
    T.resident = 1;
    T.kc1 = R;
    T.kc2 = C;
    T.n_rt = n_rt;
    T.smem = smem;
    return T;
  }
  T.bm = kChunkBM;
  T.resident = 0;
  T.kc1 = T.kc2 = kChunkK;
  T.n_rt = (R + kChunkBM - 1) / kChunkBM;
  T.smem = sizeof(float) * fused_smem_floats(kChunkBM, kChunkK, kChunkK);
  return T;
}

struct Layout {
  size_t logu, buf, rowpart, colpart, colpart2, errpart, grampart, flagpart,
      alpha, xring, fring, total;
};

Layout layout(int algo, int R, int C, int m, const Tiling& T) {
  const size_t field = (size_t)R * C;
  const size_t n_tiles = (size_t)T.n_rt * T.n_ct;
  Layout L;
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 31) / 32 * 32;            // 128-byte aligned regions
    return at;
  };
  L.logu = take(field);
  L.buf = take(field);
  L.rowpart = take((size_t)T.n_ct * R);
  L.colpart = take((size_t)T.n_rt * C);
  L.colpart2 = take((size_t)T.n_rt * C);
  L.errpart = take(n_tiles);
  L.grampart = take((size_t)gram_tiles(R, T.n_ct) * kMaxPairs);
  L.flagpart = take(n_tiles);
  L.alpha = take(kMaxHist);
  const size_t ring = (algo == kAlgoAA) ? (size_t)m * field : 0;
  L.xring = take(ring);
  L.fring = take(ring);
  L.total = o;
  return L;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int ALGO>
cudaError_t launch(Params& P, const Tiling& T, cudaStream_t st) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_solve_kernel<ALGO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, coop = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = blocks_per_sm((const void*)fused_solve_kernel<ALGO>, kThreads,
                      T.smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_tiles = P.n_rt * P.n_ct;
  // Resident: one block per tile (n_tiles <= sms by construction).
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  if (T.resident && grid != n_tiles) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)fused_solve_kernel<ALGO>,
                                    dim3(grid), dim3(kThreads), args, T.smem,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiling the launcher picks for (R, C) fields on this device: out[0]
// tile rows, out[1] resident (1) or chunked (0), out[2] tiles, out[3]
// dynamic shared-memory bytes, out[4] the SM count (mirrored by
// fused_discrete.fused_layout).
int sdfs_fused_tiling(int R, int C, int* out) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Tiling T = tiling(R, C, sms);
  out[0] = T.bm;
  out[1] = T.resident;
  out[2] = T.n_rt * T.n_ct;
  out[3] = (int)T.smem;
  out[4] = sms;
  return cudaSuccess;
}

// Floats of the scratch buffer sdfs_fused_solve takes for these shapes
// (-1 when the device cannot be queried).
long long sdfs_fused_work_floats(int algo, int R, int C, int m) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return (long long)layout(algo, R, C, m, tiling(R, C, sms)).total;
}

// One cooperative launch on (R, C) fields: mode 0 writes T(ell0) to out;
// modes 1 (SA) and 2 (AA) solve from ell0 and write ell*, the iteration
// count and the last error.  m1 (R, R), m2t (C, C) = M2 transposed, kap
// and sub (null: none) (R, C); work holds sdfs_fused_work_floats floats;
// sync two zeroed counters; 1 <= m <= 8, mix >= 1.
int sdfs_fused_solve(int algo, const float* ell0, const float* m1,
                     const float* m2t, const float* kap, const float* sub,
                     float* out, float* work, unsigned* sync, int* iters,
                     float* err, int R, int C, float theta, float beta,
                     float tol, int max_iter, int m, int mix, float beta_aa,
                     float ridge, void* stream) {
  if (R <= 0 || C <= 0 || m < 1 || m > kMaxHist || mix < 1)
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const Tiling T = tiling(R, C, sms);
  const Layout L = layout(algo, R, C, m, T);
  Params P;
  P.ell0 = ell0;
  P.m1 = m1;
  P.m2t = m2t;
  P.kap = kap;
  P.sub = sub;
  P.out = out;
  P.logu = work + L.logu;
  P.buf = work + L.buf;
  P.rowpart = work + L.rowpart;
  P.colpart = work + L.colpart;
  P.colpart2 = work + L.colpart2;
  P.errpart = work + L.errpart;
  P.grampart = work + L.grampart;
  P.flagpart = work + L.flagpart;
  P.alpha = work + L.alpha;
  P.xring = work + L.xring;
  P.fring = work + L.fring;
  P.sync = sync;
  P.iters_out = iters;
  P.err_out = err;
  P.R = R;
  P.C = C;
  P.n_rt = T.n_rt;
  P.n_ct = T.n_ct;
  P.bm = T.bm;
  P.resident = T.resident;
  P.kc1 = T.kc1;
  P.kc2 = T.kc2;
  P.theta = theta;
  P.beta = beta;
  P.tol = tol;
  P.max_iter = max_iter;
  P.m = m;
  P.mix = mix;
  P.beta_aa = beta_aa;
  P.ridge = ridge;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (algo) {
    case kAlgoApply: return launch<kAlgoApply>(P, T, st);
    case kAlgoSA: return launch<kAlgoSA>(P, T, st);
    case kAlgoAA: return launch<kAlgoAA>(P, T, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* sdfs_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
