// The row phase of the two-phase operator for NVIDIA Hopper (sm_90a),
// shared by the strip tier (tiled_two_phase.cu, sdfs_strip_row) and the
// streamed tier's pass C with a shared c2 (streamed_two_phase.cu,
// sdfs_pass_c_row): one kernel template, strip_row_kernel<MODE, WIDE>,
// over the midway field mid (R = L*K rows (l, k), C columns):
//
//   kRowFast: row r scaled by scale[r] = exp(s_r - S), two linear
//     contractions, lh = S + log(z);
//   kRowLse (the strip tier's lse): m1[k, c] = max_l mid, y = m1 +
//     log(W_r1 exp(mid - m1)) over l', m2[l, c] = max_k y, lh = m2 +
//     log(W_r2 exp(y - m2)) over k';
//   kRowCarry (pass C's lse, the linear carry of the TPU kernel _c_kernel
//     and of pass_c_plain): m1[k, c] = max_l mid, m2[c] = max_k m1, y =
//     (W_r1 exp(mid - m1)) * exp(m1 - m2) linear, lh = m2 + log(W_r2 y);
//
// then + add_row[l, k] + add_col[c] and log1p(beta*exp(lh/theta));
//
//   kRowTangent (the row phase of Newton's tangent passes,
//     streamed_two_phase.cu's sdfs_tangent_chain): no shifts, y = F4 *
//     (W_r1 mid), out = F5 * (W_r2 y) (- v), with scale = F4 and add_row
//     = F5 field-sized (R, C) factors, S = v or null; each thread loads
//     its factors before its sums (v after them: both ahead spill).
// Replaces sdfs_via_autodiff_tpu/kernels/tiled_two_phase.py:195
// (_row_phase_kernel) and :259 (_row_phase_fast_kernel), and the row
// phase of streamed_two_phase.py:446 (_c_kernel) with a shared c2.
//
// What bounds the row phase on an H100: three terms of about the same
// size.  At the SSY cell (L, K, C) = (32, 32, 12288) it reads and writes
// one field (100.7 MB: 0.030 ms), does 2*C*R*(L + K) = 1.6 GFLOP (0.024
// ms of FP32 FMA) and 6 special functions per entry in lse mode (75M:
// 0.018 ms).  So the design overlaps the copies with the arithmetic: a
// persistent grid (one block of kRowThreads per SM) walks tiles of TC
// columns; W_r1 and W_r2 are staged once per block, transposed, in shared
// memory; the next tile's (R, TC) midway slab arrives by 16-byte cp.async
// in the second of two buffers while the current tile runs:
//
//   1. lse, carry: m1[k, c] = max over l and x = exp(x - m1), a thread
//      per (k, c) column; fast: x *= scale[r]; carry: m2[c] = max_k m1;
//   2. r1: y[l, (k, c)] = sum_m W_r1[l, m] x[m, (k, c)], 8 x 4 outputs per
//      thread (two float4 of W_r1^T, broadcast, and one of x per m),
//      computed into registers (lse: m1 + log; carry: times exp(m1 -
//      m2)), one barrier, stored back over x (columns in rounds when the
//      block has too few threads for them all);
//   3. lse: m2[l, c] = max over k and y = exp(y - m2), a thread per (l, c);
//   4. r2 + epilogue: z[(l, c), k] = sum_m W_r2[k, m] y[l, m, c], 8 x 4 per
//      thread, lh = (m2 or S) + log(z) + add_row + add_col, out =
//      log1p(beta * exp(lh / theta)), stored as float4.
//
// The slab of a row l is K*TC floats at a stride LS = K*TC + pad, LS = TC
// (mod 32), so that the r2 operand reads (float4 per thread, TC/4 threads
// per row l) and the shift passes hit distinct banks.  Each tile's index
// arithmetic is done per item, outside the loops over m.  The sums run in
// order of m, formulas and shifts as strip_row_plain has them.
//
// That "wide" layout needs two slabs at TC >= 4 beside W_r1^T and W_r2^T:
// R = L*K up to about 5,800, L and K up to about 230.  Past it the same
// kernel runs "narrow" (WIDE = false): items of 8 x 1 outputs, the
// widest TC up to kRowTcMax that fits (16-byte copies when TC and C are
// multiples of 4, else 4-byte ones), unpadded rows (LS = K*TC), W_r1 and
// W_r2 read through __ldg from global memory, and one slab when two do
// not fit (the next tile is then fetched after the current one is done).
// At TC = 1 two slabs take what the first row kernel's x and y took, so
// every set it ran has a layout.
//
// SDFS_STRIP_ROW_SPLIT (compile-time, bench/kernel_split.py; 6, the
// default, is the kernel): 1 stops after the load (fast: after the row
// scales), 2 after the lse shift and exp, 3 after r1, 4 after r2's shift
// and exp, each storing its stage's (R, TC) slab in place of the output;
// 5 stores r2's sums without the epilogue.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "occupancy.cuh"

#ifndef SDFS_STRIP_ROW_SPLIT
#define SDFS_STRIP_ROW_SPLIT 6
#endif

namespace {

constexpr int kRowThreads = 512;
constexpr int kRowFast = 0, kRowLse = 1, kRowCarry = 2, kRowTangent = 3;

constexpr int kRowTileFloats = 16384;   // R * TC the layout aims at
constexpr int kRowTcMax = 64;
constexpr size_t kRowSmemLimit = 232448;

struct RowLayout {
  int tc;       // columns per tile (wide: a multiple of 4)
  int ls;       // floats per row l of a slab: K*tc (+ wide's pad)
  int lp, kp;   // L and K rounded up to 8 (W_r1^T, W_r2^T rows)
  int slabs;    // 2 (the next tile in flight) or 1 (narrow only)
  int wide;     // 1: W^T in shared memory, float4 items; 0: narrow
  int smem;     // floats
};

__host__ __device__ inline int round8(int n) { return (n + 7) / 8 * 8; }

// Shared-memory floats of a row-phase block: the slabs, the shifts m1
// (K*TC) and m2 (L*TC), wide's W_r1^T (L x Lp) and W_r2^T (K x Kp).
inline void row_layout_at(int L, int K, int tc, int slabs, bool wide,
                          RowLayout* lay) {
  lay->tc = tc;
  lay->ls = K * tc + (wide ? ((tc - K * tc) % 32 + 32) % 32 : 0);
  lay->lp = round8(L);
  lay->kp = round8(K);
  lay->slabs = slabs;
  lay->wide = wide;
  lay->smem = slabs * L * lay->ls + (K + L) * tc +
              (wide ? L * lay->lp + K * lay->kp : 0);
}

// The row phase's layout at (L, K): wide with two slabs, TC a multiple
// of 4 from max(4, min(kRowTcMax, kRowTileFloats / R)) down; else narrow
// with two slabs, then one, TC from kRowTcMax down.  The first that fits
// shared memory; false when none does.
inline bool strip_row_layout(int L, int K, RowLayout* lay) {
  const int R = L * K;
  const int tc0 = kRowTileFloats / R < kRowTcMax ? kRowTileFloats / R
                                                  : kRowTcMax;
  auto fits = [&] {
    return sizeof(float) * (size_t)lay->smem <= kRowSmemLimit;
  };
  for (int tc = tc0 < 4 ? 4 : tc0 / 4 * 4; tc >= 4; tc -= 4) {
    row_layout_at(L, K, tc, 2, true, lay);
    if (fits()) return true;
  }
  for (int slabs = 2; slabs >= 1; --slabs)
    for (int tc = kRowTcMax; tc >= 1; --tc) {
      row_layout_at(L, K, tc, slabs, false, lay);
      if (fits()) return true;
    }
  return false;
}

template <int V>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// Rows a0..a0+7 of W (n x n, row-major: W_r1 or W_r2) at column m: wide
// from its transpose wt in shared memory (row stride np), narrow from
// global memory, rows past n as 0.
template <bool WIDE>
__device__ __forceinline__ void load_w8(const float* wt, const float* w,
                                        int n, int np, int a0, int m,
                                        float (&wv)[8]) {
  if constexpr (WIDE) {
    const float4 wa = *reinterpret_cast<const float4*>(wt + m * np + a0);
    const float4 wb = *reinterpret_cast<const float4*>(wt + m * np + a0 + 4);
    wv[0] = wa.x; wv[1] = wa.y; wv[2] = wa.z; wv[3] = wa.w;
    wv[4] = wb.x; wv[5] = wb.y; wv[6] = wb.z; wv[7] = wb.w;
  } else {
#pragma unroll
    for (int a = 0; a < 8; ++a)
      wv[a] = a0 + a < n ? __ldg(w + (a0 + a) * n + m) : 0.f;
  }
}

// V values of a field-sized factor f at row r, columns c0 + c..: a float4
// where vec4 (16-byte aligned, all V columns inside the tile), else one at
// a time, 0 past the tile's tcw columns.
template <int V>
__device__ __forceinline__ void load_factor(const float* f, int C, int r,
                                            int c0, int c, int tcw,
                                            bool vec4, float (&out)[V]) {
  const float* p = f + (size_t)r * C + c0 + c;
  if (V == 4 && vec4 && c + 4 <= tcw) {
    load_cols<V>(p, out);   // (global memory: read-only for the launch)
  } else {
#pragma unroll
    for (int b = 0; b < V; ++b) out[b] = c + b < tcw ? __ldg(p + b) : 0.f;
  }
}

template <int MODE, bool WIDE>
__global__ void __launch_bounds__(kRowThreads, 1)
strip_row_kernel(const float* __restrict__ mid,
                 const float* __restrict__ scale, const float* __restrict__ S,
                 const float* __restrict__ w_r1,
                 const float* __restrict__ w_r2,
                 const float* __restrict__ add_row,
                 const float* __restrict__ add_col, float* __restrict__ out,
                 int L, int K, int C, RowLayout lay, float theta,
                 float beta) {
  constexpr bool FAST = MODE == kRowFast, CARRY = MODE == kRowCarry;
  constexpr bool TAN = MODE == kRowTangent;
  constexpr int V = WIDE ? 4 : 1;     // columns per item
  extern __shared__ float smem[];     // 16-byte aligned base
  const int TC = lay.tc, LS = lay.ls, Lp = lay.lp, Kp = lay.kp;
  const int R = L * K, KT = K * TC, CG = TC / V;
  float* slabs = smem;                       // lay.slabs x (L, LS)
  float* m1 = slabs + lay.slabs * L * LS;    // (K*TC)
  float* m2 = m1 + KT;                       // (L*TC); carry: (TC)
  float* w1t = m2 + L * TC;                  // wide: (L, Lp): [m*Lp + l]
  float* w2t = w1t + L * Lp;                 // wide: (K, Kp): [m*Kp + k]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_tiles = (C + TC - 1) / TC;
  const bool vec = C % 4 == 0 && TC % 4 == 0;   // 16-byte copies

  if constexpr (WIDE) {
    for (int x = tid; x < L * Lp; x += nt) {
      const int m = x / Lp, l = x - m * Lp;
      w1t[x] = l < L ? __ldg(w_r1 + l * L + m) : 0.f;
    }
    for (int x = tid; x < K * Kp; x += nt) {
      const int m = x / Kp, k = x - m * Kp;
      w2t[x] = k < K ? __ldg(w_r2 + k * K + m) : 0.f;
    }
  }

  // Tile t's (R, TC) slab into buf: row r = (l, k) at l*LS + k*TC;
  // columns past C are zero.
  auto fetch = [&](int t, float* buf) {
    const int c0 = t * TC;
    if (vec) {
      const int Q = TC / 4;
      for (int x = tid; x < R * Q; x += nt) {
        const int r = x / Q, q = x - r * Q;
        const int l = r / K, k = r - l * K;
        const bool ok = c0 + 4 * q < C;
        cp_async16(buf + l * LS + k * TC + 4 * q,
                   ok ? mid + (size_t)r * C + c0 + 4 * q : mid, ok);
      }
    } else {
      for (int x = tid; x < R * TC; x += nt) {
        const int r = x / TC, c = x - r * TC;
        const int l = r / K, k = r - l * K;
        const bool ok = c0 + c < C;
        cp_async4(buf + l * LS + k * TC + c,
                  ok ? mid + (size_t)r * C + c0 + c : mid, ok);
      }
    }
    cp_async_commit();
  };
#if SDFS_STRIP_ROW_SPLIT < 5
  auto stage = [&](const float* x, int c0, int tcw) {
    for (int idx = tid; idx < R * TC; idx += nt) {
      const int r = idx / TC, c = idx - r * TC;
      const int l = r / K, k = r - l * K;
      if (c < tcw)
        out[(size_t)r * C + c0 + c] = x[l * LS + k * TC + c];
    }
  };
#endif

  if (blockIdx.x < n_tiles) fetch(blockIdx.x, slabs);
  const float s0 = FAST ? __ldg(S) : 0.f;
  // r1 runs in rounds of G column groups (all l-blocks of a column group
  // in one round, so that no thread reads a column another one has
  // overwritten).
  const int LB = Lp / 8, NG = KT / V;
  const int G = min(NG, max(1, nt / LB));
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    float* x = slabs + (it % lay.slabs) * L * LS;
    const int c0 = t * TC, tcw = min(TC, C - c0);
    if (lay.slabs == 1 && it > 0) {
      __syncthreads();               // the last tile's reads of x done
      fetch(t, x);
    }
    cp_async_wait<0>();
    __syncthreads();                 // slab t landed; the other one free
    if (lay.slabs == 2 && t + (int)gridDim.x < n_tiles)
      fetch(t + gridDim.x, slabs + ((it + 1) & 1) * L * LS);
#if SDFS_STRIP_ROW_SPLIT == 1
    if (!FAST) {
      stage(x, c0, tcw);
      continue;
    }
#endif

    if constexpr (!TAN) {
      // 1. lse: m1 and exp(x - m1) per (k, c); fast: the row scales.
      for (int n = tid; n < KT; n += nt) {
        if (FAST) {
          const int k = n / TC;
#pragma unroll 8
          for (int l = 0; l < L; ++l)
            x[l * LS + n] *= __ldg(scale + l * K + k);
        } else {
          float mx = -INFINITY;
#pragma unroll 8
          for (int l = 0; l < L; ++l) mx = fmaxf(mx, x[l * LS + n]);
#pragma unroll 8
          for (int l = 0; l < L; ++l)
            x[l * LS + n] = expf(x[l * LS + n] - mx);
          m1[n] = mx;
        }
      }
      __syncthreads();
    }
#if SDFS_STRIP_ROW_SPLIT == 1 || SDFS_STRIP_ROW_SPLIT == 2
    stage(x, c0, tcw);
    continue;
#endif
    // carry: m2[c] = max over k of m1 (read at r1's store, after its
    // barrier).
    if (CARRY)
      for (int c = tid; c < TC; c += nt) {
        float mx = -INFINITY;
        for (int k = 0; k < K; ++k) mx = fmaxf(mx, m1[k * TC + c]);
        m2[c] = mx;
      }

    // 2. r1 over x, into registers, then back over x.
    for (int g0 = 0; g0 < NG; g0 += G) {
      const int gw = min(G, NG - g0);
      const bool act = tid < gw * LB;
      const int lb = act ? tid / gw : 0, n0 = act ? V * (g0 + tid - lb * gw)
                                                  : 0;
      const int l0 = 8 * lb;
      float acc[8][V], f4[8][V];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < V; ++b) acc[a][b] = 0.f;
      if constexpr (TAN) {
        // F4 of the thread's outputs, in flight during the sums.
        const int k = n0 / TC, c = n0 - k * TC;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int b = 0; b < V; ++b) f4[a][b] = 0.f;
          if (act && l0 + a < L)
            load_factor<V>(scale, C, (l0 + a) * K + k, c0, c, tcw, vec,
                           f4[a]);
        }
      }
      if (act) {
        const float* xp = x + n0;
#pragma unroll 4
        for (int m = 0; m < L; ++m) {
          float w[8], v[V];
          load_w8<WIDE>(w1t, w_r1, L, Lp, l0, m, w);
          load_cols<V>(xp + m * LS, v);
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < V; ++b) acc[a][b] = fmaf(w[a], v[b], acc[a][b]);
        }
      }
      float sh[V] = {};
      if (!FAST && !TAN && act) load_cols<V>(m1 + n0, sh);
      __syncthreads();               // every read of these columns done
      if (act) {
        // carry: the rescale exp(m1 - m2) of each column.
        float cr[V];
#pragma unroll
        for (int b = 0; b < V; ++b)
          cr[b] = CARRY ? expf(sh[b] - m2[(n0 + b) % TC]) : 1.f;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          if (l0 + a >= L) break;
          float y[V];
#pragma unroll
          for (int b = 0; b < V; ++b)
            y[b] = FAST    ? acc[a][b]
                   : TAN   ? acc[a][b] * f4[a][b]
                   : CARRY ? acc[a][b] * cr[b]
                           : sh[b] + logf(acc[a][b]);
          store_cols<V>(x + (l0 + a) * LS + n0, y);
        }
      }
    }
    __syncthreads();
#if SDFS_STRIP_ROW_SPLIT == 3
    stage(x, c0, tcw);
    continue;
#endif

    // 3. lse: m2 and exp(y - m2) per (l, c).
    if (MODE == kRowLse) {
      for (int p = tid; p < L * TC; p += nt) {
        const int l = p / TC, c = p - l * TC;
        float* yp = x + l * LS + c;
        float mx = -INFINITY;
#pragma unroll 8
        for (int k = 0; k < K; ++k) mx = fmaxf(mx, yp[k * TC]);
#pragma unroll 8
        for (int k = 0; k < K; ++k) yp[k * TC] = expf(yp[k * TC] - mx);
        m2[p] = mx;
      }
      __syncthreads();
    }
#if SDFS_STRIP_ROW_SPLIT == 4
    stage(x, c0, tcw);
    continue;
#endif

    // 4. r2 + epilogue: item (k-block, l, column group), column groups
    // fastest.
    const int n_items = (Kp / 8) * L * CG;
    for (int item = tid; item < n_items; item += nt) {
      const int kb = item / (L * CG), rest = item - kb * (L * CG);
      const int l = rest / CG, cq = rest - l * CG;
      const int k0 = 8 * kb, c = V * cq;
      float acc[8][V], f5[8][V], vv[8][V];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < V; ++b) acc[a][b] = 0.f;
      if constexpr (TAN) {
        // F5 of the item's outputs, in flight during the sums.
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int b = 0; b < V; ++b) f5[a][b] = vv[a][b] = 0.f;
          if (k0 + a < K)
            load_factor<V>(add_row, C, l * K + k0 + a, c0, c, tcw, vec,
                           f5[a]);
        }
      }
      const float* yp = x + l * LS + c;
#pragma unroll 4
      for (int m = 0; m < K; ++m) {
        float w[8], v[V];
        load_w8<WIDE>(w2t, w_r2, K, Kp, k0, m, w);
        load_cols<V>(yp + m * TC, v);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < V; ++b) acc[a][b] = fmaf(w[a], v[b], acc[a][b]);
      }
      float sh[V], ac[V];
      if constexpr (TAN) {
        if (S != nullptr)             // v: J v - v
#pragma unroll
          for (int a = 0; a < 8; ++a)
            if (k0 + a < K)
              load_factor<V>(S, C, l * K + k0 + a, c0, c, tcw, vec, vv[a]);
      } else {
#pragma unroll
        for (int b = 0; b < V; ++b) {
          sh[b] = FAST ? s0 : m2[CARRY ? c + b : l * TC + c + b];
          ac[b] = c + b < tcw ? __ldg(add_col + c0 + c + b) : 0.f;
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int k = k0 + a;
        if (k >= K) break;
        const int r = l * K + k;
        const float ar = TAN ? 0.f : __ldg(add_row + r);
        float o[V];
#pragma unroll
        for (int b = 0; b < V; ++b) {
#if SDFS_STRIP_ROW_SPLIT == 5
          o[b] = acc[a][b];
#else
          if constexpr (TAN) {
            o[b] = acc[a][b] * f5[a][b] - vv[a][b];
          } else {
            const float lh = sh[b] + logf(acc[a][b]) + ar + ac[b];
            o[b] = log1pf(beta * expf(lh / theta));
          }
#endif
        }
        float* dst = out + (size_t)r * C + c0 + c;
        if (WIDE && vec && c + 4 <= tcw) {
          store_cols<V>(dst, o);
        } else {
#pragma unroll
          for (int b = 0; b < V; ++b)
            if (c + b < tcw) dst[b] = o[b];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// One launch of strip_row_kernel<MODE, .> over mid (R = L*K, C) in the
// layout lay (of strip_row_layout): a persistent grid of min(tiles,
// co-resident blocks).
template <int MODE>
cudaError_t launch_row(const RowLayout& lay, const float* mid,
                       const float* scale, const float* S, const float* w_r1,
                       const float* w_r2, const float* add_row,
                       const float* add_col, float* out, int L, int K, int C,
                       float theta, float beta, cudaStream_t st) {
  const auto fn = lay.wide ? &strip_row_kernel<MODE, true>
                           : &strip_row_kernel<MODE, false>;
  const size_t smem = sizeof(float) * (size_t)lay.smem;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = blocks_per_sm((const void*)fn, kRowThreads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (C + lay.tc - 1) / lay.tc;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  fn<<<grid, kRowThreads, smem, st>>>(mid, scale, S, w_r1, w_r2, add_row,
                                      add_col, out, L, K, C, lay, theta,
                                      beta);
  return cudaGetLastError();
}

// One launch of the row phase in ``mode`` (kRowFast, kRowLse or
// kRowCarry) over mid (R = L*K, C) in the layout of strip_row_layout.
// scale (R,) and S (1,) are read in fast mode only; add_row (L*K,),
// add_col (C,); out (R, C).
inline cudaError_t launch_row_phase(const float* mid, const float* scale,
                                    const float* S, const float* w_r1,
                                    const float* w_r2, const float* add_row,
                                    const float* add_col, float* out, int L,
                                    int K, int C, float theta, float beta,
                                    int mode, cudaStream_t st) {
  RowLayout lay;
  if (mode < kRowFast || mode > kRowCarry || L <= 0 || K <= 0 || C <= 0 ||
      !strip_row_layout(L, K, &lay))
    return cudaErrorInvalidValue;
  const auto launch = mode == kRowFast ? &launch_row<kRowFast>
                      : mode == kRowLse ? &launch_row<kRowLse>
                                        : &launch_row<kRowCarry>;
  return launch(lay, mid, scale, S, w_r1, w_r2, add_row, add_col, out, L, K,
                C, theta, beta, st);
}

}  // namespace

