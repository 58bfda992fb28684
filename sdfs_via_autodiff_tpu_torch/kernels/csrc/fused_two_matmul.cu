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
// ~11 MB at 20^4) stays in the 50 MB L2 across iterations; but not in one
// block's 227 KB of shared memory, so no single block can run the solve.
// The design therefore keeps the field in global memory (L2) and runs the
// operator as phases over 32 x 32 output tiles spread over a persistent
// grid, with a grid-wide barrier between phases:
//
//   phase 1, per tile: sh1 of the tile's 32 columns (a sweep of the
//     columns), U = M1 @ exp(p - sh1) by 32-deep shared-memory K-tiles
//     with the exp applied as the K-tile is loaded, log U + sh1 stored,
//     and the tile's per-row maxima stored as partials;
//   barrier;
//   phase 2, per tile: sh2 from the row partials, V = exp(log U - sh2) @
//     M2T likewise, the epilogue, and the tile's partial max |out - ell|
//     (for AA also the tile's Gram partials and the ring stores);
//   barrier; every block reduces the err partials in the same order, so
//     all blocks take the same branch.
//
// AA mixing steps add: block 0 reduces the Gram partials and solves the
// normal equations (one thread), barrier, the combination pass with a
// per-tile non-finite flag, barrier.  The grid is min(tiles, co-resident
// blocks); a cooperative launch guarantees co-residency (and fails instead
// of deadlocking), and the barrier is a generation barrier on two counters
// the caller zeroes.  Data written inside the launch is read with ld.cg
// (L2, coherent across SMs); only the read-only operands go through L1.
// Each thread register-tiles 4 x 2 outputs, so every shared-memory load
// (a float4 of A, a float2 of B) feeds 8 FMAs.  Transcendentals are CUDA's
// expf/logf/log1pf, built without fast-math; theta*ell is rounded before
// the subtraction, as the plain PyTorch version computes it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kAlgoApply = 0;
constexpr int kAlgoSA = 1;
constexpr int kAlgoAA = 2;
constexpr int kMaxHist = 8;
constexpr int kMaxPairs = kMaxHist * (kMaxHist + 1) / 2;
constexpr int kThreads = 128;
constexpr int kBM = 32;   // tile rows
constexpr int kBN = 32;   // tile columns
constexpr int kBK = 32;   // K-tile depth
constexpr int kTR = 4;    // rows per thread
constexpr int kTC = 2;    // columns per thread

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
  float theta, beta, tol;
  int max_iter;
  int m, mix;
  float beta_aa, ridge;
};

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
  float a[kBK][kBM + 4];   // A K-tile, transposed (k-major), rows padded
  float b[kBK][kBN];       // B K-tile
  float shift[kBM];        // sh1 (columns) or sh2 (rows) of the tile
  float red[kThreads / 32][kMaxPairs];
  float colred[kThreads / 32][kBN];
  float solve[kMaxHist][kMaxHist + 1];
};

// acc[i][j] += sum_k A(r0 + ty*4 + i, k) * B(k, c0 + tx*2 + j) over
// k < K in 32-deep K-tiles, the sum in order of k.  fetch_a(r, k) /
// fetch_b(k, c) load a K-tile element's raw inputs (tile-local r and c,
// absolute k) into registers, and put_a / put_b turn them into the value
// stored in shared memory (0 outside the matrices): the next K-tile's
// loads are in flight while the current one's FMAs run, and its
// transcendentals wait until the loads have landed.
template <class FetchA, class PutA, class FetchB, class PutB>
__device__ __forceinline__ void tile_gemm(Smem& s, int K,
                                          float (&acc)[kTR][kTC],
                                          FetchA fetch_a, PutA put_a,
                                          FetchB fetch_b, PutB put_b) {
  constexpr int kPer = kBM * kBK / kThreads;
  static_assert(kBM == kBK && kBK == kBN, "square tiles");
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float2 ra[kPer], rb[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      ra[i] = fetch_a(e / kBK, k0 + e % kBK);
      rb[i] = fetch_b(k0 + e / kBN, e % kBN);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();                      // previous K-tile consumed
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      s.a[e % kBK][e / kBK] = put_a(ra[i], e / kBK, k0 + e % kBK);
      s.b[e / kBN][e % kBN] = put_b(rb[i], k0 + e / kBN, e % kBN);
    }
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&s.a[kk][ty * kTR]);
      const float2 b = *reinterpret_cast<const float2*>(&s.b[kk][tx * kTC]);
      acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
      acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
      acc[2][0] = fmaf(a.z, b.x, acc[2][0]);
      acc[2][1] = fmaf(a.z, b.y, acc[2][1]);
      acc[3][0] = fmaf(a.w, b.x, acc[3][0]);
      acc[3][1] = fmaf(a.w, b.y, acc[3][1]);
    }
  }
}

// p = theta*ell - sub from raw (ell, sub), theta*ell rounded first.
__device__ __forceinline__ float p_raw(const Params& P, float2 v) {
  const float p = __fmul_rn(P.theta, v.x);
  return P.sub != nullptr ? p - v.y : p;
}

__device__ __forceinline__ float p_of(const Params& P, const float* cur,
                                      size_t idx) {
  return p_raw(P, make_float2(ldcg(cur + idx),
                              P.sub != nullptr ? __ldg(P.sub + idx) : 0.f));
}

// Column maxima over a tile's rows, each thread holding one column
// (threadIdx.x % 32) of 8 rows: combine the 4 warps and store the 32
// values at col[c0 .. c0 + 31] (columns < C).
__device__ void store_colmax(const Params& P, Smem& s, float mx, float* col,
                             int c0) {
  s.colred[threadIdx.x / 32][threadIdx.x % 32] = mx;
  __syncthreads();
  if (threadIdx.x < kBN && c0 + threadIdx.x < P.C) {
    float v = s.colred[0][threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) v = nanmax(v, s.colred[w][threadIdx.x]);
    col[c0 + threadIdx.x] = v;
  }
  __syncthreads();
}

// s.shift[i] = max over g < n of part[g * stride + base + i] for the
// tile's 32 rows or columns (i < valid; -inf beyond): 4 groups of 32
// threads split the partials, so no thread waits on a long chain of
// dependent loads.  Published by the next __syncthreads.
__device__ void shift_from_partials(Smem& s, const float* part, int n,
                                    size_t stride, int base, int valid) {
  const int i = threadIdx.x % 32, g0 = threadIdx.x / 32;
  float mx = -INFINITY;
  if (i < valid)
    for (int g = g0; g < n; g += kThreads / 32)
      mx = nanmax(mx, ldcg(part + (size_t)g * stride + base + i));
  __syncthreads();                        // s.shift, s.colred free
  s.colred[g0][i] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = s.colred[0][threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) v = nanmax(v, s.colred[w][threadIdx.x]);
    s.shift[threadIdx.x] = v;
  }
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
  for (int w = 1; w < kThreads / 32; ++w) r = nanmax(r, s.red[w][0]);
  return r;
}

// Phase 0 for tile t: the tile's column maxima of p(cur) into colpart
// (the first iterate's; later iterates get theirs in phase 2 and in
// the AA combination).
__device__ void phase0(const Params& P, Smem& s, const float* cur,
                       float* colpart, int t) {
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  const int c = ct * kBN + threadIdx.x % kBN;
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kBM * kBN / kThreads; ++i) {
    const int r = rt * kBM + threadIdx.x / kBN + i * (kThreads / kBN);
    if (r < P.R && c < P.C) mx = nanmax(mx, p_of(P, cur, (size_t)r * P.C + c));
  }
  store_colmax(P, s, mx, colpart + (size_t)rt * P.C, ct * kBN);
}

// Phase 1 for tile t: sh1 from the column partials of cur, log U = sh1 +
// log(M1 @ exp(p - sh1)), and the tile's per-row maxima of log U.
__device__ void phase1(const Params& P, Smem& s, const float* cur,
                       const float* colpart, int t) {
  const int R = P.R, C = P.C;
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  const int r0 = rt * kBM, c0 = ct * kBN;
  shift_from_partials(s, colpart, P.n_rt, C, c0, C - c0);
  // (tile_gemm's first __syncthreads publishes s.shift.)
  float acc[kTR][kTC] = {};
  const float* m1 = P.m1;
  const float* sub = P.sub;
  tile_gemm(
      s, R, acc,
      [&](int r, int k) {
        return (r0 + r < R && k < R)
                   ? make_float2(__ldg(m1 + (size_t)(r0 + r) * R + k), 0.f)
                   : make_float2(0.f, 0.f);
      },
      [&](float2 v, int, int) { return v.x; },
      [&](int k, int c) {
        const size_t idx = (size_t)k * C + c0 + c;
        return (k < R && c0 + c < C)
                   ? make_float2(ldcg(cur + idx),
                                 sub != nullptr ? __ldg(sub + idx) : 0.f)
                   : make_float2(0.f, 0.f);
      },
      [&](float2 v, int k, int c) {
        return (k < R && c0 + c < C) ? expf(p_raw(P, v) - s.shift[c]) : 0.f;
      });
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + ty * kTR + i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const int c = c0 + tx * kTC + j;
      if (r < R && c < C) {
        const float lu = s.shift[tx * kTC + j] + logf(acc[i][j]);
        P.logu[(size_t)r * C + c] = lu;
        mx = nanmax(mx, lu);
      }
    }
    // The 16 threads sharing ty are one half of a warp.
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (tx == 0 && r < R) P.rowpart[(size_t)ct * R + r] = mx;
  }
}

// Phase 2 for tile t: out = epilogue(sh2 + log(exp(log U - sh2) @ M2T) +
// kap) into dst, the tile's partial max |out - cur| and (SA, AA) the
// tile's column maxima of p(out) into colpart; for AA also X[slot] = cur
// and, on a mixing step, the tile's Gram partials.
template <int ALGO>
__device__ void phase2(const Params& P, Smem& s, const float* cur,
                       float* dst, int t, int slot, bool gram) {
  const int R = P.R, C = P.C;
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  const int r0 = rt * kBM, c0 = ct * kBN;
  shift_from_partials(s, P.rowpart, P.n_ct, R, r0, R - r0);
  // (tile_gemm's first __syncthreads publishes s.shift.)
  float acc[kTR][kTC] = {};
  const float* m2t = P.m2t;
  const float* logu = P.logu;
  tile_gemm(
      s, C, acc,
      [&](int r, int k) {
        return (r0 + r < R && k < C)
                   ? make_float2(ldcg(logu + (size_t)(r0 + r) * C + k), 0.f)
                   : make_float2(0.f, 0.f);
      },
      [&](float2 v, int r, int k) {
        return (r0 + r < R && k < C) ? expf(v.x - s.shift[r]) : 0.f;
      },
      [&](int k, int c) {
        return (k < C && c0 + c < C)
                   ? make_float2(__ldg(m2t + (size_t)k * C + c0 + c), 0.f)
                   : make_float2(0.f, 0.f);
      },
      [&](float2 v, int, int) { return v.x; });
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t field = (size_t)R * C;
  float err = 0.f;
  float cmax[kTC] = {-INFINITY, -INFINITY};
  float g2[kMaxPairs];
#pragma unroll
  for (int q = 0; q < kMaxPairs; ++q) g2[q] = 0.f;
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const int r = r0 + ty * kTR + i, c = c0 + tx * kTC + j;
      if (r >= R || c >= C) continue;
      const size_t idx = (size_t)r * C + c;
      const float lh =
          s.shift[ty * kTR + i] + logf(acc[i][j]) + __ldg(P.kap + idx);
      const float o = log1pf(P.beta * expf(lh / P.theta));
      const float l = ldcg(cur + idx);
      dst[idx] = o;
      err = nanmax(err, fabsf(o - l));
      if (ALGO != kAlgoApply)
        cmax[j] = nanmax(cmax[j],
                         p_raw(P, make_float2(o, P.sub != nullptr
                                                     ? __ldg(P.sub + idx)
                                                     : 0.f)));
      if (ALGO == kAlgoAA) {
        P.xring[slot * field + idx] = l;
        if (gram) {
          float g[kMaxHist];
          for (int q = 0; q < P.m; ++q)
            g[q] = (q == slot) ? o - l
                               : ldcg(P.fring + q * field + idx) -
                                     ldcg(P.xring + q * field + idx);
          int n = 0;
          for (int q = 0; q < P.m; ++q)
            for (int q2 = 0; q2 <= q; ++q2) g2[n++] += g[q] * g[q2];
        }
      }
    }
  // Block reductions: err (NaN-propagating max), column maxima, Gram sums.
  err = warp_nanmax(err);
  if (lane == 0) s.red[warp][0] = err;
  if (ALGO != kAlgoApply) {
    // Lanes tx and tx + 16 of a warp hold rows ty = 2*warp and 2*warp + 1.
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      cmax[j] = nanmax(cmax[j], __shfl_xor_sync(0xffffffffu, cmax[j], 16));
      if (lane < 16) s.colred[warp][tx * kTC + j] = cmax[j];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = s.red[0][0];
    for (int w = 1; w < kThreads / 32; ++w) v = nanmax(v, s.red[w][0]);
    P.errpart[t] = v;
  }
  if (ALGO != kAlgoApply && threadIdx.x < kBN && c0 + threadIdx.x < C) {
    float v = s.colred[0][threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) v = nanmax(v, s.colred[w][threadIdx.x]);
    P.colpart[(size_t)rt * C + c0 + threadIdx.x] = v;
  }
  __syncthreads();
  if (ALGO == kAlgoAA && gram) {
    const int pairs = P.m * (P.m + 1) / 2;
    for (int q = 0; q < pairs; ++q) {
      const float v = warp_sum(g2[q]);
      if (lane == 0) s.red[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x < pairs) {
      float v = s.red[0][threadIdx.x];
      for (int w = 1; w < kThreads / 32; ++w) v += s.red[w][threadIdx.x];
      P.grampart[(size_t)t * kMaxPairs + threadIdx.x] = v;
    }
    __syncthreads();
  }
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
  for (int t = threadIdx.x; t < n_tiles; t += kThreads)
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
    for (int w = 1; w < kThreads / 32; ++w) v += s.red[w][threadIdx.x];
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
  const int r0 = rt * kBM, c0 = ct * kBN;
  const size_t field = (size_t)R * C;
  float a[kMaxHist];
  for (int q = 0; q < P.m; ++q) a[q] = ldcg(P.alpha + q);
  const float w_x = 1.f - P.beta_aa, w_f = P.beta_aa;
  const int c = c0 + threadIdx.x % kBN;
  int bad = 0;
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kBM * kBN / kThreads; ++i) {
    const int r = r0 + threadIdx.x / kBN + i * (kThreads / kBN);
    if (r >= R || c >= C) continue;
    const size_t idx = (size_t)r * C + c;
    float x = 0.f;
    for (int q = 0; q < P.m; ++q)
      x = x + a[q] * (w_x * ldcg(P.xring + q * field + idx) +
                      w_f * ldcg(P.fring + q * field + idx));
    P.buf[idx] = x;
    bad |= !isfinite(x);
    mx = nanmax(mx, p_raw(P, make_float2(
                                 x, P.sub != nullptr ? __ldg(P.sub + idx)
                                                     : 0.f)));
  }
  store_colmax(P, s, mx, P.colpart2 + (size_t)rt * C, c0);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) P.flagpart[t] = bad ? 1.f : 0.f;
}

// dst <- src over tile t.
__device__ void copy_tile(const Params& P, const float* src, float* dst,
                          int t) {
  const int rt = t / P.n_ct, ct = t % P.n_ct;
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int r = rt * kBM + e / kBN, c = ct * kBN + e % kBN;
    if (r < P.R && c < P.C)
      dst[(size_t)r * P.C + c] = ldcg(src + (size_t)r * P.C + c);
  }
}

template <int ALGO>
__global__ void __launch_bounds__(kThreads)
fused_solve_kernel(Params P) {
  __shared__ __align__(16) Smem s;
  const int n_tiles = P.n_rt * P.n_ct;
  const size_t field = (size_t)P.R * P.C;
  const float* cur = P.ell0;
  const float* ccol = P.colpart;          // column partials of cur
  float* nxt = P.out;
  float err = INFINITY;
  int it = 0, slot = 0, mix_ctr = 0;
  const int max_iter = (ALGO == kAlgoApply) ? 1 : P.max_iter;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
    phase0(P, s, cur, P.colpart, t);
  grid_sync(P.sync);
  while (err > P.tol && it < max_iter && !isnan(err)) {
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
      phase1(P, s, cur, ccol, t);
    grid_sync(P.sync);
    const bool use_aa =
        ALGO == kAlgoAA && it >= P.m && mix_ctr == 0;
    float* dst = (ALGO == kAlgoAA) ? P.fring + slot * field : nxt;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
      phase2<ALGO>(P, s, cur, dst, t, slot, use_aa);
    if (ALGO == kAlgoApply) break;
    grid_sync(P.sync);
    err = block_max_of(s, P.errpart, n_tiles);
    ccol = P.colpart;
    if (ALGO == kAlgoSA) {
      cur = nxt;
      nxt = (nxt == P.out) ? P.buf : P.out;
    } else {
      cur = dst;                          // fx
      if (use_aa) {
        if (blockIdx.x == 0) solve_weights(P, s, n_tiles);
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

struct Layout {
  size_t logu, buf, rowpart, colpart, colpart2, errpart, grampart, flagpart,
      alpha, xring, fring, total;
};

Layout layout(int algo, int R, int C, int m) {
  const size_t field = (size_t)R * C;
  const size_t n_rt = (R + kBM - 1) / kBM, n_ct = (C + kBN - 1) / kBN;
  const size_t n_tiles = n_rt * n_ct;
  Layout L;
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 31) / 32 * 32;            // 128-byte aligned regions
    return at;
  };
  L.logu = take(field);
  L.buf = take(field);
  L.rowpart = take(n_ct * R);
  L.colpart = take(n_rt * C);
  L.colpart2 = take(n_rt * C);
  L.errpart = take(n_tiles);
  L.grampart = take(n_tiles * kMaxPairs);
  L.flagpart = take(n_tiles);
  L.alpha = take(kMaxHist);
  const size_t ring = (algo == kAlgoAA) ? (size_t)m * field : 0;
  L.xring = take(ring);
  L.fring = take(ring);
  L.total = o;
  return L;
}

template <int ALGO>
cudaError_t launch(Params& P, cudaStream_t st) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_solve_kernel<ALGO>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_tiles = P.n_rt * P.n_ct;
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)fused_solve_kernel<ALGO>,
                                    dim3(grid), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the scratch buffer sdfs_fused_solve takes for these shapes.
long long sdfs_fused_work_floats(int algo, int R, int C, int m) {
  return (long long)layout(algo, R, C, m).total;
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
  const Layout L = layout(algo, R, C, m);
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
  P.n_rt = (R + kBM - 1) / kBM;
  P.n_ct = (C + kBN - 1) / kBN;
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
    case kAlgoApply: return launch<kAlgoApply>(P, st);
    case kAlgoSA: return launch<kAlgoSA>(P, st);
    case kAlgoAA: return launch<kAlgoAA>(P, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* sdfs_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
