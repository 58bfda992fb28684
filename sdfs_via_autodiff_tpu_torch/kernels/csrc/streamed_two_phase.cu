// Streamed two-phase operator kernels for NVIDIA Hopper (sm_90a).
//
// The two-phase operator log T(w) (discrete SSY; continuous SSY, whose c2
// factor P_z[i] is batched over the current c1 index, see pass_c_batched
// further down; discrete GCY through its Kronecker grouping, see
// pass_b_deferred; continuous GCY, see pass_c_pair at the end) on a field
// ell[r, c] with rows r = (h_lam, h_c) = (l, k) and columns
// c = (h_z, z) = (i, j) runs as two passes over the field:
//
//   pass B (column phase): a = theta * ell[r] (I, J), or with a folded
//     baseline a = fma(theta, ell, -sub_row[r]) - sub_col[i, j]; contract
//     i' with W_c1, add the conjugated-shared correction mid_col[i, j]
//     (lse mode only), then contract j' with a shared W_c2 or not at all
//     (a batched c2 contracts in pass_c_batched).  Replaces
//     sdfs_via_autodiff_tpu/kernels/streamed_two_phase.py:324 (_b_kernel):
//     c2_here, has_sub and has_mid both ways.  Two kernels, further down:
//     a c1 pass (pass_b_c1_kernel) and the c2 product on the tensor cores
//     (pass_b_mma_kernel<true, .>, the deferred pass B's product).
//   pass C (row phase) with a shared c2: contract l' with W_r1, then k'
//     with W_r2, add add_row[l, k] + add_col[c], epilogue
//     log1p(beta*exp(lh/theta)).  Replaces the shared-c2 branch of
//     streamed_two_phase.py:446 (_c_kernel): the row-phase kernel of
//     row_phase.cuh, one template with the strip tier's row phase
//     (sdfs_pass_c_row).  The deferred, batched and pair branches are
//     further down.
//
// mode 0 ("fast"): pass B takes one shift per field row, s_r = max a, and
// emits the linear midway field W_c1 exp(a - s_r) W_c2^T with s; pass C
// rescales row r by scale[r] = exp(s_r - S), S = max_r s_r, and adds S
// back after the last log.  mode 1 ("lse"): per-axis log-sum-exp shifts
// at every contraction; pass C carries its two row contractions linearly
// with low-rank rescales (the linear-carry LSE of the TPU kernel).
//
// Newton's tangent matvec of a set with shared column factors runs as
// three more passes over the stored factors (the tangent passes, near the
// end: sdfs_tangent_chain).
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError(); the Python wrappers validate every argument.
// Transcendentals are CUDA's expf/logf/log1pf, built without fast-math.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "occupancy.cuh"

// SDFS_PASSB_SPLIT / SDFS_PASSC_SPLIT (compile-time, for timing the
// phases; 4, the default, is the kernel).  Pass B: 1 stops after the
// load, fold, shift and exp (the c1 pass stores e), 2 after the c1 pass
// (c1, mid_col, the lse row shift and exp: the c2 product's operand U),
// 3 after the c2 product (its sums stored without the log).  Pass C: 1
// after the load and scale (lse: with the shifts and exp), 2 after r1,
// 3 after r2 (its sums stored without the epilogue): the row kernel's
// SDFS_STRIP_ROW_SPLIT 2, 3 and 5.
#ifndef SDFS_PASSB_SPLIT
#define SDFS_PASSB_SPLIT 4
#endif
#ifndef SDFS_PASSC_SPLIT
#define SDFS_PASSC_SPLIT 4
#endif

#if SDFS_PASSC_SPLIT < 4 && !defined(SDFS_STRIP_ROW_SPLIT)
#define SDFS_STRIP_ROW_SPLIT \
  (SDFS_PASSC_SPLIT == 1 ? 2 : SDFS_PASSC_SPLIT == 2 ? 3 : 5)
#endif

#include "row_phase.cuh"

namespace {

constexpr int kModeFast = 0;
constexpr int kModeLse = 1;
constexpr int kModeTangent = 2;   // the c1 pass of the tangent passes

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int round_up8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int round_up32(int n) { return (n + 31) & ~31; }

constexpr size_t kSmemLimit = 232448;  // a block's shared memory (227 KB)
constexpr int kBK = 16;  // W rows per K-tile of rows_times_w (pass_c_pair)

// out[i, j] = sum_m u[i, m] * w[m, j] for i < I, j < J (pass_c_pair's z'
// product).  W (J, J) streams from L2 through two shared K-tiles of kBK
// rows (`stage`, 2 * kBK * J floats), the next tile's cp.async copy
// overlapping the current tile's FMAs.  Each thread owns TI rows and TJ
// columns n = q0 + q * nq; u (row stride Jp = round_up4(J), zero-padded)
// is read as float4 broadcasts along m, W tiles as conflict-free rows.
// Tile rows past J are zero-filled so the padded m add exact zeros.  The
// sum runs in order of m.  VEC16 (J % 4 == 0 and w 16-byte aligned)
// copies the tiles in 16-byte pieces, else 4-byte ones.
template <int TI, int TJ, bool VEC16 = false, class Store>
__device__ __forceinline__ void rows_times_w(int I, int J, int Jp,
                                             const float* u,
                                             const float* __restrict__ w,
                                             float* stage, Store store) {
  const int nq = (J + TJ - 1) / TJ;
  const int n_items = nq * ((I + TI - 1) / TI);
  const int n_tiles = (J + kBK - 1) / kBK;
  auto load_tile = [&](int t) {
    float* dst = stage + (t & 1) * kBK * J;
    const int rows = min(kBK, J - t * kBK);
    const float* src = w + (size_t)t * kBK * J;
    if (VEC16) {
      for (int x = threadIdx.x; x < rows * J / 4; x += blockDim.x)
        cp_async16(dst + 4 * x, src + 4 * x);
    } else {
      for (int x = threadIdx.x; x < rows * J; x += blockDim.x)
        cp_async4(dst + x, src + x);
    }
    for (int x = rows * J + threadIdx.x; x < round_up4(rows) * J;
         x += blockDim.x)
      dst[x] = 0.f;
    cp_async_commit();
  };
  for (int base = 0; base < n_items; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool active = item < n_items;
    const int q0 = item % nq, i0 = (item / nq) * TI;
    int nn[TJ];
#pragma unroll
    for (int q = 0; q < TJ; ++q) nn[q] = min(q0 + q * nq, J - 1);
    float acc[TI][TJ];
#pragma unroll
    for (int t = 0; t < TI; ++t)
#pragma unroll
      for (int q = 0; q < TJ; ++q) acc[t][q] = 0.f;
    __syncthreads();                   // stage free (previous users done)
    load_tile(0);
    for (int tile = 0; tile < n_tiles; ++tile) {
      if (tile + 1 < n_tiles) {
        load_tile(tile + 1);
      } else {
        cp_async_commit();             // empty group keeps the count
      }
      cp_async_wait<1>();            // this thread's copies of `tile`
      __syncthreads();                 // everyone's copies of `tile`
      if (active) {
        const float* wt = stage + (tile & 1) * kBK * J;
        const int m0 = tile * kBK;
        const int kmax = round_up4(min(kBK, J - m0));
        for (int kk = 0; kk < kmax; kk += 4) {
          float b[4][TJ];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int q = 0; q < TJ; ++q) b[k][q] = wt[(kk + k) * J + nn[q]];
#pragma unroll
          for (int t = 0; t < TI; ++t) {
            const float4 v = *reinterpret_cast<const float4*>(
                u + min(i0 + t, I - 1) * Jp + m0 + kk);
#pragma unroll
            for (int q = 0; q < TJ; ++q) {
              acc[t][q] = fmaf(v.x, b[0][q], acc[t][q]);
              acc[t][q] = fmaf(v.y, b[1][q], acc[t][q]);
              acc[t][q] = fmaf(v.z, b[2][q], acc[t][q]);
              acc[t][q] = fmaf(v.w, b[3][q], acc[t][q]);
            }
          }
        }
      }
      __syncthreads();                 // done with `tile` before reuse
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < TI; ++t)
#pragma unroll
        for (int q = 0; q < TJ; ++q) {
          const int i = i0 + t, n = q0 + q * nq;
          if (i < I && n < J) store(i, n, acc[t][q]);
        }
    }
  }
}

// ------------------------------------------------ pass B, the c1 pass
//
// What bounds pass B with a shared c2 on an H100: its c2 contraction.  At
// the SSY cell (R, I, J) = (1024, 32, 384) that is 2*R*I*J*J = 9.66 of
// the pass's 10.5 GFLOP (0.144 ms of FP32 FMA), against 100.7 MB of field
// (0.030 ms).  The first design ran both contractions per field row in one
// block (W_c2^T, 576 KB, streamed from L2 in 4-byte copies by each of
// 1,024 blocks) at a third of the FP32 rate.  This one splits the pass:
//
//   1. pass_b_c1_kernel, a persistent grid over steps of RB field rows:
//      the next step's (RB, I, J) slab arrives by cp.async (16-byte where
//      J % 4 == 0) while the current one is processed, W_c1^T is resident
//      in shared memory (read through __ldg where it does not fit).  The
//      fold (one FMA then one subtraction, as the plain version), the
//      shift (per row in fast mode, per column in lse mode) and one exp
//      per entry, in place; c1 in FP32 register tiles of 8 rows i x 4
//      columns j per thread (two float4 of W_c1^T, broadcast, and one of
//      the slab per m: 32 FMA), RB chosen so that a step has ~256 tiles
//      (I = 32, J = 384: one row of 384 tiles; I = 56, J = 64: two rows
//      of 112); lse: + shift, log, + mid_col ((shift + log) + mid, as the
//      TPU kernel rounds it).  Then with a shared c2, lse mode takes the
//      row shift sh[r, i] = max_j and U = exp(u - sh); U (row stride Jp =
//      round_up4(J), zeros past J) and sh go to a workspace.  Without c2
//      the pass writes mid itself.
//   2. pass_b_mma_kernel<true, .>: mid (R*I, J) = U W_c2^T in split TF32 on
//      the tensor cores (the deferred pass B's product kernel, further
//      down, with the field rows as its M side and W_c2^T as its B
//      operand), tiles of 128 x 128 with the N tiles fastest, so that the
//      blocks running together share U's rows in L2; epilogue linear
//      (fast) or sh + log (lse).  Every term is non-negative (W_c2 >= 0,
//      U in [0, 1] or the linear field), so nothing cancels.
//
// The c1-only branch (a c2 batched over i, pass_c_batched) is the c1 pass
// alone (RB = 2 at (56, 56, 56, 64): 1.26 GFLOP against 90 MB, bytes
// bound).  Ragged I, J: rows past I are zero in W_c1^T, slab columns past
// J are zero after the exp, partial steps skip their missing rows.

constexpr int kC1MaxThreads = 384;
constexpr int kC1Items = 256;   // 8 x 4 tiles per step the layout aims at
constexpr int kC1MaxRows = 8;   // field rows per step
constexpr int kC1Pre = 8;       // tangent: F1 float4 a thread loads ahead

struct C1Layout {
  int rb;       // field rows per step
  int threads;
  int slabs;    // 2 (the next step's slab in flight) or 1
  int wres;     // 1: W_c1^T in shared memory; 0: W_c1 through __ldg
  int smem;     // floats
};

// Shared-memory floats of the c1 pass: the slabs (RB, I, Jp), W_c1^T (I
// rows of round_up8(I)), the column shifts (RB, Jp) and the row shifts
// (RB, round_up8(I)).
__host__ __device__ inline int c1_smem_floats(int I, int J, int rb,
                                              int slabs, int wres) {
  const int Jp = round_up4(J), Ip = round_up8(I);
  return slabs * rb * I * Jp + (wres ? I * Ip : 0) + rb * Jp + rb * Ip;
}

// The c1 pass's layout at (I, J): RB = kC1Items / tiles per row (1 to
// kC1MaxRows), threads = RB * tiles rounded up to a warp (at most
// kC1MaxThreads, tiles in rounds past that); two slabs with W_c1^T
// resident, then one slab, then W_c1 from global memory, RB from its
// target down, the first that fits; false when none does.
inline bool pass_b_c1_layout(int I, int J, C1Layout* lay) {
  const int tiles = (round_up8(I) / 8) * (round_up4(J) / 4);
  int rb0 = kC1Items / tiles;
  rb0 = rb0 < 1 ? 1 : rb0 > kC1MaxRows ? kC1MaxRows : rb0;
  for (int v = 0; v < 3; ++v) {
    const int slabs = v == 0 ? 2 : 1, wres = v < 2;
    for (int rb = rb0; rb >= 1; --rb) {
      const int smem = c1_smem_floats(I, J, rb, slabs, wres);
      if (sizeof(float) * (size_t)smem > kSmemLimit) continue;
      const int t = round_up32(rb * tiles);
      *lay = C1Layout{rb, t < kC1MaxThreads ? t : kC1MaxThreads, slabs,
                      wres, smem};
      return true;
    }
  }
  return false;
}

// C2: a shared c2 follows (out = the workspace U, row stride Jp; lse
// writes the row shifts to rshift_out); else out = mid (R, I, J).  WRES:
// W_c1^T resident.  sub_row/sub_col and mid_col may be null.
//
// kModeTangent (with C2; the tangent passes, further down): ell is the
// direction v and sub_row, sub_col the field-sized factors F1, F2 (R, I,
// J); the slab is scaled by F1 in place of the fold, shift and exp, and
// U = F2 * sum.  Each thread loads its first kC1Pre float4 of F1 during
// the slab's wait and its F2 before its sums; one block an SM by the
// launch bounds (with two, those registers spill: 0.13 ms against 0.072
// at SSY's (32, 32, 32, 384)).
template <int MODE, bool C2, bool WRES>
__global__ void __launch_bounds__(kC1MaxThreads,
                                  MODE == kModeTangent ? 1 : 2)
pass_b_c1_kernel(const float* __restrict__ ell,
                 const float* __restrict__ w_c1,
                 const float* __restrict__ sub_row,
                 const float* __restrict__ sub_col,
                 const float* __restrict__ mid_col, float* __restrict__ out,
                 float* __restrict__ s_out, float* __restrict__ rshift_out,
                 int R, int I, int J, C1Layout lay, float theta) {
  extern __shared__ float smem[];     // 16-byte aligned base
  const int Jp = round_up4(J), Ip = round_up8(I);
  const int IJ = I * J, IJp = I * Jp, RB = lay.rb;
  const int IB = Ip / 8, CG = Jp / 4;
  float* slabs = smem;                          // lay.slabs x (RB, I, Jp)
  float* wt = slabs + lay.slabs * RB * IJp;     // WRES: (I, Ip), [m*Ip + i]
  float* cshift = wt + (WRES ? I * Ip : 0);     // (RB, Jp): lse column shifts
  float* rshift = cshift + RB * Jp;  // (RB, Ip): lse row shifts; fast: s
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int n_steps = (R + RB - 1) / RB;
  const bool pad = Jp != J;           // else 16-byte copies, no padding
  const bool sub = sub_row != nullptr;
  constexpr bool TAN = MODE == kModeTangent;
  static_assert(!TAN || C2, "the tangent's c1 pass writes U");
  const float* f1 = sub_row;          // TAN: the factors
  const float* f2 = sub_col;

  if (WRES)
    for (int x = tid; x < I * Ip; x += nt) {
      const int m = x / Ip, i = x - m * Ip;
      wt[x] = i < I ? __ldg(w_c1 + i * I + m) : 0.f;
    }

  // Step q's rows r0.. into buf (rows past R and columns past J zero).
  auto fetch = [&](int q, float* buf) {
    const int r0 = q * RB;
    const float* src = ell + (size_t)r0 * IJ;
    if (!pad) {
      const long long avail = (long long)(R - r0) * IJ;
      for (int x = tid; x < RB * IJ / 4; x += nt) {
        const bool ok = 4LL * x < avail;
        cp_async16(buf + 4 * x, ok ? src + 4 * x : ell, ok);
      }
    } else {
      for (int x = tid; x < RB * IJp; x += nt) {
        const int rr = x / IJp, e = x - rr * IJp, i = e / Jp, j = e - i * Jp;
        const bool ok = j < J && r0 + rr < R;
        cp_async4(buf + x, ok ? src + (size_t)rr * IJ + i * J + j : ell, ok);
      }
    }
    cp_async_commit();
  };
  // theta * x less the folded baseline: one rounding of theta*x - sub_row
  // before the cancellation down to O(1), then the column part.
  auto fold = [&](float x, float sr, int i, int j) {
    return sub ? __fsub_rn(__fmaf_rn(theta, x, -sr),
                           __ldg(sub_col + i * J + j))
               : theta * x;
  };

  if (blockIdx.x < n_steps) fetch(blockIdx.x, slabs);
  const int NG = RB * CG;                       // column groups of a step
  const int G = min(NG, max(1, nt / IB));       // column groups per round
  int it = 0;
  for (int q = blockIdx.x; q < n_steps; q += gridDim.x, ++it) {
    float* x = slabs + (lay.slabs == 2 ? (it & 1) : 0) * RB * IJp;
    const int r0 = q * RB, rows = min(RB, R - r0);
    if (lay.slabs == 1 && it > 0) {
      __syncthreads();                 // the last step's reads of x done
      fetch(q, x);
    }
    // TAN: the thread's first kC1Pre float4 of F1, in flight during the
    // wait.
    const float4* fq4 = reinterpret_cast<const float4*>(f1 + (size_t)r0 * IJ);
    const int n4 = pad ? 0 : rows * IJ / 4;
    float4 fpre[kC1Pre];
    if constexpr (TAN) {
#pragma unroll
      for (int k = 0; k < kC1Pre; ++k)
        if (tid + k * nt < n4) fpre[k] = __ldg(fq4 + tid + k * nt);
    }
    cp_async_wait<0>();
    __syncthreads();                   // slab q landed; the other one free
    if (lay.slabs == 2 && q + (int)gridDim.x < n_steps)
      fetch(q + gridDim.x, slabs + ((it + 1) & 1) * RB * IJp);

    if constexpr (TAN) {
      // 1. x = v * F1 in place; columns past J stay zero.
      if (!pad) {
        auto scale4 = [&](int e4, float4 b) {
          float4 a = *reinterpret_cast<float4*>(x + 4 * e4);
          a.x *= b.x; a.y *= b.y; a.z *= b.z; a.w *= b.w;
          *reinterpret_cast<float4*>(x + 4 * e4) = a;
        };
#pragma unroll
        for (int k = 0; k < kC1Pre; ++k)
          if (tid + k * nt < n4) scale4(tid + k * nt, fpre[k]);
        for (int e4 = tid + kC1Pre * nt; e4 < n4; e4 += nt)
          scale4(e4, __ldg(fq4 + e4));
      } else {
        const float* fq = f1 + (size_t)r0 * IJ;
        for (int e = tid; e < rows * IJp; e += nt) {
          const int rr = e / IJp, rest = e - rr * IJp, i = rest / Jp;
          const int j = rest - i * Jp;
          if (j < J) x[e] *= __ldg(fq + (size_t)rr * IJ + i * J + j);
        }
      }
      __syncthreads();
    } else {
      // 1. Fold, shift and exp in place, a thread per column (rr, j): the
      // column maxima (lse: the shifts; fast: reduced to the row shifts
      // s[r], a warp per row); columns past J stay zero since the copy.
      for (int c = tid; c < rows * Jp; c += nt) {
        const int rr = c / Jp, j = c - rr * Jp;
        if (j >= J) continue;
        float* col = x + rr * IJp + j;
        const float sr = sub ? __ldg(sub_row + r0 + rr) : 0.f;
        float mx = -INFINITY;
#pragma unroll 8
        for (int i = 0; i < I; ++i) {
          const float v = fold(col[i * Jp], sr, i, j);
          col[i * Jp] = v;
          mx = fmaxf(mx, v);
        }
        if (MODE == kModeLse)
#pragma unroll 8
          for (int i = 0; i < I; ++i) col[i * Jp] = expf(col[i * Jp] - mx);
        cshift[c] = mx;
      }
      __syncthreads();
      if (MODE == kModeFast) {
        for (int rr = warp; rr < rows; rr += nw) {
          float mx = -INFINITY;
          for (int j = lane; j < J; j += 32)
            mx = fmaxf(mx, cshift[rr * Jp + j]);
          mx = warp_max(mx);
          if (lane == 0) {
            rshift[rr * Ip] = mx;
            s_out[r0 + rr] = mx;
          }
        }
        __syncthreads();
        for (int c = tid; c < rows * Jp; c += nt) {
          const int rr = c / Jp, j = c - rr * Jp;
          if (j >= J) continue;
          float* col = x + rr * IJp + j;
          const float s = rshift[rr * Ip];
#pragma unroll 8
          for (int i = 0; i < I; ++i) col[i * Jp] = expf(col[i * Jp] - s);
        }
        __syncthreads();
      }
    }
#if SDFS_PASSB_SPLIT == 1
    for (int c = tid; c < rows * Jp; c += nt) {
      const int rr = c / Jp, j = c - rr * Jp;
      if (j < J)
        for (int i = 0; i < I; ++i)
          out[((size_t)(r0 + rr) * I + i) * (C2 ? Jp : J) + j] =
              x[rr * IJp + i * Jp + j];
    }
    continue;
#endif

    // 2. c1 in rounds of G column groups (all i-blocks of a group in one
    // round, so that lse's store back over x overwrites only columns the
    // round has read); a warp's threads share an i-block.
    for (int g0 = 0; g0 < NG; g0 += G) {
      const int gw = min(G, NG - g0);
      const bool act = tid < gw * IB;
      const int ib = act ? tid / gw : 0;
      const int g = g0 + (act ? tid - ib * gw : 0);
      const int rr = g / CG, j0 = 4 * (g - rr * CG), i0 = 8 * ib;
      const bool live = act && rr < rows;
      float acc[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      // TAN: F2 of the thread's 8 x 4 outputs, in flight during the sums.
      const size_t row0 = (size_t)(r0 + rr) * I;
      float4 f2v[8];
      if constexpr (TAN) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
          if (live && !pad && i0 + a < I)
            f2v[a] = __ldg(reinterpret_cast<const float4*>(
                f2 + (row0 + i0 + a) * J + j0));
      }
      if (live) {
        const float* xp = x + rr * IJp + j0;
#pragma unroll 2
        for (int m = 0; m < I; ++m) {
          float w[8];
          if (WRES) {
            const float4 wa =
                *reinterpret_cast<const float4*>(wt + m * Ip + i0);
            const float4 wb =
                *reinterpret_cast<const float4*>(wt + m * Ip + i0 + 4);
            w[0] = wa.x; w[1] = wa.y; w[2] = wa.z; w[3] = wa.w;
            w[4] = wb.x; w[5] = wb.y; w[6] = wb.z; w[7] = wb.w;
          } else {
#pragma unroll
            for (int a = 0; a < 8; ++a)
              w[a] = i0 + a < I ? __ldg(w_c1 + (i0 + a) * I + m) : 0.f;
          }
          const float4 v = *reinterpret_cast<const float4*>(xp + m * Jp);
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            acc[a][0] = fmaf(w[a], v.x, acc[a][0]);
            acc[a][1] = fmaf(w[a], v.y, acc[a][1]);
            acc[a][2] = fmaf(w[a], v.z, acc[a][2]);
            acc[a][3] = fmaf(w[a], v.w, acc[a][3]);
          }
        }
      }
      if constexpr (TAN) {
        if (live)
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            if (i0 + a >= I) break;
            const float* fp = f2 + (row0 + i0 + a) * J + j0;
            if (!pad) {
              acc[a][0] *= f2v[a].x; acc[a][1] *= f2v[a].y;
              acc[a][2] *= f2v[a].z; acc[a][3] *= f2v[a].w;
            } else {
#pragma unroll
              for (int b = 0; b < 4; ++b)
                if (j0 + b < J) acc[a][b] *= __ldg(fp + b);
            }
          }
      }
      // lse: shift + log (+ mid_col), as the TPU kernel rounds it.
      if (MODE == kModeLse && live) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + b;
          const float sh = cshift[rr * Jp + j];
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            float o = sh + logf(acc[a][b]);
            if (mid_col != nullptr && i0 + a < I && j < J)
              o += __ldg(mid_col + (i0 + a) * J + j);
            acc[a][b] = o;
          }
        }
      }
      if (C2 && MODE == kModeLse) {
        __syncthreads();               // every read of these columns done
        if (live)
#pragma unroll
          for (int a = 0; a < 8; ++a)
            if (i0 + a < I)
              *reinterpret_cast<float4*>(x + rr * IJp + (i0 + a) * Jp + j0) =
                  make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      } else if (live) {
        // fast or TAN with c2: U (zeros past J: the slab's are); without
        // c2: mid.
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = i0 + a;
          if (i >= I) break;
          if (C2 || !pad) {
            *reinterpret_cast<float4*>(out + (row0 + i) * (C2 ? Jp : J) +
                                       j0) =
                make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (j0 + b < J) out[(row0 + i) * J + j0 + b] = acc[a][b];
          }
        }
      }
    }
    if (!(C2 && MODE == kModeLse)) continue;

    // 3. lse with c2: sh[r, i] = max_j, a warp per row; U = exp(u - sh)
    // (zeros past J) and sh to the workspace.
    __syncthreads();
    for (int p = warp; p < rows * I; p += nw) {
      const int rr = p / I, i = p - rr * I;
      const float* row = x + rr * IJp + i * Jp;
      float mx = -INFINITY;
      for (int j = lane; j < J; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      if (lane == 0) {
        rshift[rr * Ip + i] = mx;
        rshift_out[(size_t)(r0 + rr) * I + i] = mx;
      }
    }
    __syncthreads();
    float* U = out + (size_t)r0 * IJp;
    for (int e4 = tid; e4 < rows * IJp / 4; e4 += nt) {
      const int e = 4 * e4, rr = e / IJp, i = (e - rr * IJp) / Jp;
      const int j = e % Jp;
      const float sh = rshift[rr * Ip + i];
      const float4 v = *reinterpret_cast<const float4*>(x + e);
      const float in[4] = {v.x, v.y, v.z, v.w};
      float o[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        o[b] = j + b < J ? expf(in[b] - sh) : 0.f;
      *reinterpret_cast<float4*>(U + e) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------- deferred-c2 passes
//
// Column groups too large for one block's (I, J) row slice (the GCY
// Kronecker grouping's 512 x 256 at the 25.2M-point grid) split the
// column phase: pass B contracts c1 only, and the shared c2 contraction
// moves into pass C, in front of its row phase.
//
//   pass_b_deferred: a = theta * ell[r] (I, J), less the folded
//     baseline sub_row[r] + sub_col[i, j] when one is given, per-column
//     shift m[j] = max over all I rows, then
//     out[r, i, j] = m[j] + log(sum_m W_c1[i, m] exp(a[m, j] - m[j])):
//     the resident layout (pass_b_resident_kernel) where W_c1^T fits a
//     block beside the strips, else the tensor-core layout (a column-max
//     pass and pass_b_mma_kernel, split-TF32 products).  Replaces
//     streamed_two_phase.py:384 (_b_kernel_deferred), both branches of
//     has_sub.
//   pass_c_deferred: the c2 contraction with the shared W_c2^T, then
//     the linear-carry row phase and the epilogue (pass_c_slab_kernel,
//     further down).  Replaces the c2_deferred branch of
//     streamed_two_phase.py:446 (_c_kernel, lines 474-480 and 506-524).
//   pass_c_batched (continuous SSY): the same kernel with each slice i
//     contracted against its own factor P_z[i] (W_c2^T of slice i at
//     w_c2t + i * J * J, indexed directly: no block-diagonal maps), after
//     pass B's c1-only branch.  In lse mode exactly the deferred
//     recipe; in fast mode the input is pass B's linear c1 result, row r
//     scaled by scale[r] = exp(s_r - S), no shifts and no carries, and S
//     is added back after the log.  Replaces the c2_batched branch of
//     _c_kernel (lines 474-485, 525-539), which JAX feeds block-diagonal
//     (TC, TC) maps (blockdiag_z, :832) so that a block's TC/J slices
//     contract as one MXU dot.  Pass B's c1-only branch at (56, 56, 56,
//     64) is 1.26 GFLOP against 90 MB: HBM bounds that one.
//
// What bounds pass_b_deferred on an H100 at I = 512: the c1 product,
// 2*R*I*I*J = 25.8 GFLOP at (12, 16, 512, 256) against 100 MB of fields.
// In FP32 FMA that is 0.385 ms; W_c1 (I*I*4 = 1 MiB) does not fit a
// block, and the first design (one block per row and 32 columns, 8-row
// K-tiles of W_c1^T, FP32 FMA) ran at 36 TFLOP/s and read W_c1^T from L2
// 1,536 times (~1.6 GB) per launch.  This one (pass_b_mma_kernel,
// which pass B's c2 product shares) runs the
// product on the tensor cores in split TF32: each operand x becomes hi =
// tf32(x) (cvt.rna) and lo = tf32(x - hi), and three TF32 products per
// k-step, lo*hi + hi*lo + hi*hi, are summed in FP32 (|x - hi - lo| <=
// 2^-22 |x|; every term of the contraction is non-negative, W_c1 >= 0 and
// exp(a - m) in (0, 1], so nothing cancels and the sum keeps FP32's
// class of relative error).  The three products of one k-step go into a
// fresh accumulator that is then added to the running sum with one FP32
// add (round to nearest), so the tensor cores' own accumulation only ever
// adds 24 terms to a small partial sum.  The work:
//
//   1. pass_b_exp_kernel: m[r, j] = max over m of the folded a and e =
//      exp(a - m), each field entry folded and exponentiated once, into a
//      workspace (R*J + R*I*J floats from the wrapper);
//   2. pass_b_mma_kernel: a persistent grid over tiles of kMmaBM rows i x
//      kMmaBN columns j of one field row r (i-tiles fastest, so that the
//      blocks running together read the same columns of e from L2), its
//      warps specialized.  8 producer warps copy each K-chunk of kMmaBK
//      rows m, W_c1^T's (BK, BM) slab and e's (BK, BN) slab, by cp.async
//      into a ring of kMmaStages stages (kMmaStages - 1 chunks ahead,
//      across tile boundaries, so a tile's epilogue overlaps the next
//      tile's copies), then split both into hi and lo, stored k-contiguous
//      (rows of kMmaLdT floats: conflict-free ldmatrix) in one of
//      kMmaBufs operand buffers; 8 consumer warps (2 x 4, each 64 x 32
//      outputs in 4 x 4 mma.sync.m16n8k8 tiles) multiply from the others.
//      Named barriers hand each buffer over ("full") and back ("empty"),
//      so the copies and splits of the next chunks run beside the
//      products and a tile's epilogue.
//      Epilogue: out = m + log(sum).
//
// W_c1^T is read from L2 once per column tile (R * J / kMmaBN = 384
// times, ~403 MB at the GCY view), e once per i-tile (I / kMmaBM = 4
// times, ~403 MB).  Ragged I, J and partial tiles are zero-filled by the
// copies and masked at the store.  (Earlier versions at the GCY view: the
// fold and exp in the product kernel's split, once per i-tile, 1.1 ms;
// every warp splitting then multiplying, 0.85 ms; e and W_c1 split in
// global memory and copied as hi and lo, 0.99 ms, bound by the doubled
// copies.)

// SDFS_DEFB_SPLIT (compile-time, for timing the phases of the deferred
// pass B; 4, the default, is the kernel).  Tensor-core layout: 1 runs the
// exp pass only, 2 adds the product kernel's copies and splits with no
// products (its epilogue stores the zero sums), 3 adds the products and
// stores the sums without m + log.  Resident layout: 1
// stops after the fold and the column maxima, 2 after the exponentials,
// 3 after the c1 product; each stores that phase's result.
#ifndef SDFS_DEFB_SPLIT
#define SDFS_DEFB_SPLIT 4
#endif

constexpr int kMmaConsumers = 256;  // 8 warps: the products
constexpr int kMmaProducers = 256;  // 8 warps: copies and hi/lo splits
constexpr int kMmaThreads = kMmaConsumers + kMmaProducers;
constexpr int kMmaBM = 128;    // rows i per tile
constexpr int kMmaBN = 128;    // columns j per tile
constexpr int kMmaBK = 16;     // rows m per K-chunk
constexpr int kMmaStages = 4;  // raw K-chunk ring
constexpr int kMmaLdRaw = kMmaBM + 8;  // raw chunk row stride (= 8 mod 32)
constexpr int kMmaLdT = kMmaBK + 4;    // hi/lo rows (k contiguous): 8 rows
                                       // of 16 B at this stride hit 32
                                       // banks (ldmatrix)
constexpr int kMmaBufs = 2;    // hi/lo operand buffers
constexpr int kMmaRaw = kMmaBK * kMmaLdRaw;
constexpr int kMmaT = kMmaBM * kMmaLdT;
// A raw K-chunk of an A operand stored (M, K) (pass B's U): kMmaBM rows of
// kMmaBK values at the hi/lo rows' stride kMmaLdT.
constexpr int kMmaRawMK = kMmaBM * kMmaLdT;
// Shared-memory floats of pass_b_mma_kernel: the ring of raw chunks (A's
// and B's, with scale_b B's factor too) and kMmaBufs buffers of the hi
// and lo operands.
__host__ __device__ constexpr int mma_smem_floats(bool a_mk,
                                                  bool scale_b = false) {
  return kMmaStages * ((a_mk ? kMmaRawMK : kMmaRaw) +
                       (scale_b ? 2 : 1) * kMmaRaw) +
         kMmaBufs * 4 * kMmaT;
}
constexpr int kMmaSmemFloats = mma_smem_floats(false);
// Named barriers of pass_b_mma_kernel (0 is __syncthreads): the
// producers' own, and per operand buffer "full" and "empty".
constexpr int kBarProducers = 1, kBarFull = 2, kBarEmpty = 2 + kMmaBufs;
constexpr int kExpParts = 16;  // exp pass: threads per column
constexpr int kExpCache = 32;  // exp pass: values per thread kept in
                               // registers (I <= kExpParts * kExpCache)

// x rounded to TF32 (round to nearest, ties away from zero), as a float
// whose 13 low mantissa bits are 0.
__device__ __forceinline__ float tf32(float x) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += A (16 x 8, row) * B (8 x 8, col), TF32 operands, FP32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// m[r, j] = max over m of a[r, m, j] (a = theta*ell, or the fold
// fma(theta, ell, -sub_row[r]) - sub_col[m, j]) and e[r, m, j] = exp(a -
// m[r, j]): a block per (32 columns, field row), kExpParts threads per
// column, each thread's values kept in registers between the two sweeps
// when I <= kExpParts * kExpCache (else re-read, from L2).
template <bool HAS_SUB>
__global__ void __launch_bounds__(32 * kExpParts)
pass_b_exp_kernel(const float* __restrict__ ell,
                  const float* __restrict__ sub_row,
                  const float* __restrict__ sub_col,
                  float* __restrict__ colmax, float* __restrict__ e, int I,
                  int J, float theta) {
  __shared__ float part[kExpParts][33];
  const int jj = threadIdx.x & 31, p = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + jj, r = blockIdx.y;
  const size_t base = (size_t)r * I * J + j;
  const float sr = HAS_SUB ? __ldg(sub_row + r) : 0.f;
  const bool cached = I <= kExpParts * kExpCache;
  auto fold = [&](int m) {
    const float x = ell[base + (size_t)m * J];
    return HAS_SUB ? __fsub_rn(__fmaf_rn(theta, x, -sr),
                               __ldg(sub_col + (size_t)m * J + j))
                   : theta * x;
  };
  float v[kExpCache];
  float mx = -INFINITY;
  if (j < J) {
    if (cached) {
#pragma unroll
      for (int s = 0; s < kExpCache; ++s) {
        const int m = p + kExpParts * s;
        v[s] = m < I ? fold(m) : -INFINITY;
        mx = fmaxf(mx, v[s]);
      }
    } else {
#pragma unroll 8
      for (int m = p; m < I; m += kExpParts) mx = fmaxf(mx, fold(m));
    }
  }
  part[p][jj] = mx;
  __syncthreads();
  if (p == 0) {
#pragma unroll
    for (int q = 1; q < kExpParts; ++q) mx = fmaxf(mx, part[q][jj]);
    part[0][jj] = mx;
    if (j < J) colmax[(size_t)r * J + j] = mx;
  }
  __syncthreads();
  mx = part[0][jj];
  if (j < J) {
    if (cached) {
#pragma unroll
      for (int s = 0; s < kExpCache; ++s) {
        const int m = p + kExpParts * s;
        if (m < I) e[base + (size_t)m * J] = expf(v[s] - mx);
      }
    } else {
#pragma unroll 8
      for (int m = p; m < I; m += kExpParts)
        e[base + (size_t)m * J] = expf(fold(m) - mx);
    }
  }
}

// Epilogues of pass_b_mma_kernel: the sum itself, colmax[r, j] + log
// (the deferred pass B's column maxima), colmax[i] + log (pass B's row
// shifts) or the sum times colmax[r, i, j] (a field-sized factor: the
// tangent passes, further down).
constexpr int kEpiLinear = 0, kEpiColLog = 1, kEpiRowLog = 2, kEpiScale = 3;

// The tensor-core product of the deferred pass B and, with PASS_B, of
// pass B's c2: out (I, J) = A B, A = W_c1^T (I, I) stored (K, M) and B =
// e[r] (I, J) per field row r (the i-tiles fastest), or with PASS_B A =
// U (I rows of round_up4(J), zero past J) stored (M, K) and B = W_c2^T
// (J, J), one batch (R = 1), the j-tiles fastest (the blocks running
// together share U's rows in L2).  Epilogue EPI: the sum, colmax[r, j] +
// log or colmax[i] + log (pass B's row shifts).  SCALE_B (not with
// PASS_B): B = e[r] * e_scale[r] elementwise, e_scale's chunks copied
// beside e's and multiplied at the split (the tangent's c1 product).
template <bool PASS_B, int EPI, bool SCALE_B = false>
__global__ void __launch_bounds__(kMmaThreads, 1)
pass_b_mma_kernel(const float* __restrict__ e,
                  const float* __restrict__ w_c1t,
                  const float* __restrict__ colmax, float* __restrict__ out,
                  int R, int I, int J, const float* __restrict__ e_scale) {
  static_assert(!(PASS_B && SCALE_B), "B is W_c2^T in pass B");
  constexpr int kRawA = PASS_B ? kMmaRawMK : kMmaRaw;
  constexpr int kStage = kRawA + (SCALE_B ? 2 : 1) * kMmaRaw;
  extern __shared__ float smem[];     // 16-byte aligned base
  float* ring = smem;                       // stages x {A, B (, B's factor)}
  float* ops = smem + kMmaStages * kStage;  // bufs x {Ah Al Bh Bl}
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_it = (I + kMmaBM - 1) / kMmaBM;
  const int n_jt = (J + kMmaBN - 1) / kMmaBN;
  const int n_ch = ((PASS_B ? J : I) + kMmaBK - 1) / kMmaBK;
  const int n_tiles = n_it * n_jt * R;  // < 2^31: the launcher checks
  const int mine = (int)blockIdx.x < n_tiles
                       ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * n_ch;       // this block's chunks, in order
  const size_t IJ = (size_t)I * J;

  // A walk over this block's chunks g = q * n_ch + kc (tile q = blockIdx.x
  // + q * gridDim.x, K-chunk kc): the tile's i0, j0 and field row r are
  // decoded once per tile, not per chunk.
  struct Cursor {
    int g, kc, q, i0, j0, r;
  };
  auto set_tile = [&](Cursor& c) {
    const int t = (int)blockIdx.x + c.q * (int)gridDim.x;
    if constexpr (PASS_B) {           // one batch, the j-tiles fastest
      const int rest = t / n_jt;
      c.j0 = (t - rest * n_jt) * kMmaBN;
      c.i0 = rest * kMmaBM;
      c.r = 0;
    } else {
      const int rest = t / n_it;
      c.i0 = (t - rest * n_it) * kMmaBM;
      c.r = rest / n_jt;
      c.j0 = (rest - c.r * n_jt) * kMmaBN;
    }
  };
  auto advance = [&](Cursor& c) {
    ++c.g;
    if (++c.kc == n_ch) {
      c.kc = 0;
      ++c.q;
      set_tile(c);
    }
  };

  if (warp >= kMmaConsumers / 32) {
    // ---- Producers: copy each K-chunk into the raw ring (cp.async,
    // kMmaStages - 1 chunks ahead), then split it into hi and lo in the
    // operand buffer g % kMmaBufs once the consumers have released it.
    const int ptid = tid - kMmaConsumers, pw = ptid >> 5;
    const bool vec_i = I % 4 == 0, vec_j = J % 4 == 0;
    Cursor cis{0, 0, 0, 0, 0, 0};      // next chunk to copy
    set_tile(cis);
    auto copy_slab = [&](float* dst, const float* src, int m0, int c0,
                         int n, bool vec) {
      // Rows m0..m0+15 and columns c0..c0+127 of src (row stride n, n
      // columns) into dst (row stride kMmaLdRaw); zeros past the depth
      // (I, or J in pass B) and n.
      if (vec) {
        for (int x = ptid; x < kMmaBK * 32; x += kMmaProducers) {
          const int k = x >> 5, c = 4 * (x & 31);
          const bool ok = m0 + k < (PASS_B ? J : I) && c0 + c < n;
          cp_async16(dst + k * kMmaLdRaw + c,
                           ok ? src + (size_t)(m0 + k) * n + c0 + c : src,
                           ok);
        }
      } else {
        for (int x = ptid; x < kMmaBK * 128; x += kMmaProducers) {
          const int k = x >> 7, c = x & 127;
          const bool ok = m0 + k < (PASS_B ? J : I) && c0 + c < n;
          cp_async4(dst + k * kMmaLdRaw + c,
                          ok ? src + (size_t)(m0 + k) * n + c0 + c : src,
                          ok);
        }
      }
    };
    auto issue = [&]() {
      if (cis.g < total) {
        float* st = ring + (cis.g % kMmaStages) * kStage;
        const int m0 = cis.kc * kMmaBK;
        if constexpr (PASS_B) {
          // A = U: rows i0..i0+127, columns m0..m0+15 (rows of Jp =
          // round_up4(J) floats, zero past J); B = W_c2^T (J, J).
          const int Jp = round_up4(J);
          for (int x = ptid; x < kMmaBM * kMmaBK / 4; x += kMmaProducers) {
            const int row = x >> 2, c = 4 * (x & 3);
            const bool ok = cis.i0 + row < I && m0 + c < Jp;
            cp_async16(st + row * kMmaLdT + c,
                       ok ? w_c1t + (size_t)(cis.i0 + row) * Jp + m0 + c
                          : w_c1t,
                       ok);
          }
          copy_slab(st + kRawA, e, m0, cis.j0, J, vec_j);
        } else {
          copy_slab(st, w_c1t, m0, cis.i0, I, vec_i);
          copy_slab(st + kMmaRaw, e + (size_t)cis.r * IJ, m0, cis.j0, J,
                    vec_j);
          if constexpr (SCALE_B)
            copy_slab(st + 2 * kMmaRaw, e_scale + (size_t)cis.r * IJ, m0,
                      cis.j0, J, vec_j);
        }
        advance(cis);
      }
      cp_async_commit();               // empty groups keep the count
    };
#pragma unroll 1
    for (int s = 0; s < kMmaStages - 1; ++s) issue();
#pragma unroll 1
    for (int g = 0; g < total; ++g) {
      bar_sync(kBarProducers, kMmaProducers);  // chunk g - 1's stage free
      issue();                                 // chunk g + kMmaStages - 1
      cp_async_wait<kMmaStages - 1>();         // chunk g landed
      bar_sync(kBarProducers, kMmaProducers);  // ... for every producer
      const int buf = g % kMmaBufs;
      if (g >= kMmaBufs) bar_sync(kBarEmpty + buf, kMmaThreads);
      // A = W_c1 (rows i, k contiguous), B = e (rows j, k contiguous):
      // warp pw takes rows 16*pw.. of both, lane (rr, kk) = (lane / 4,
      // lane % 4) row rr of each 8-row half and k = 4*kb + kk (raw reads
      // at a stride = 8 mod 32, hi/lo stores at a stride of 20: 32 banks
      // each).
      const float* st = ring + (g % kMmaStages) * kStage;
      float* T = ops + buf * 4 * kMmaT;
      const int rr = lane >> 2, kk = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a[kMmaBK / 4], b[kMmaBK / 4];
#pragma unroll
        for (int kb = 0; kb < kMmaBK / 4; ++kb) {
          const int at = (4 * kb + kk) * kMmaLdRaw + 16 * pw + 8 * h + rr;
          a[kb] = PASS_B ? st[(16 * pw + 8 * h + rr) * kMmaLdT + 4 * kb + kk]
                         : st[at];
          b[kb] = SCALE_B ? st[kRawA + at] * st[kRawA + kMmaRaw + at]
                          : st[kRawA + at];
        }
#pragma unroll
        for (int kb = 0; kb < kMmaBK / 4; ++kb) {
          const int at = (16 * pw + 8 * h + rr) * kMmaLdT + 4 * kb + kk;
          const float ah = tf32(a[kb]), bh = tf32(b[kb]);
          T[at] = ah;
          T[kMmaT + at] = tf32(a[kb] - ah);
          T[2 * kMmaT + at] = bh;
          T[3 * kMmaT + at] = tf32(b[kb] - bh);
        }
      }
      bar_arrive(kBarFull + buf, kMmaThreads);
    }
    cp_async_wait<0>();
    return;
  }

  // ---- Consumers: warp tile rows wm*64.. (4 m16 tiles), columns wn*32..
  // (4 n8 tiles).
  Cursor cmm{0, 0, 0, 0, 0, 0};        // next chunk to multiply
  set_tile(cmm);
  const int wm = warp & 1, wn = warp >> 1;
  const int g8 = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: A matrices (rows 0-7 | 8-15) x (k 0-3 | 4-7),
  // B matrices (k 0-3 | 4-7) x (columns 0-7 | 8-15).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 4;
  const int b_row = (lane & 7) + ((lane >> 4) & 1) * 8,
            b_k = ((lane >> 3) & 1) * 4;
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;
#pragma unroll 1
  for (int g = 0; g < total; ++g) {
    const int buf = g % kMmaBufs;
    bar_sync(kBarFull + buf, kMmaThreads);       // chunk g's operands
#if SDFS_DEFB_SPLIT != 2
    const float* T = ops + buf * 4 * kMmaT;
#pragma unroll
    for (int k0 = 0; k0 < kMmaBK; k0 += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = (wn * 32 + np * 16 + b_row) * kMmaLdT + k0 + b_k;
        unsigned h[4], l[4];
        ldmatrix_x4(h, T + 2 * kMmaT + off);
        ldmatrix_x4(l, T + 3 * kMmaT + off);
        bh[2 * np][0] = h[0];
        bh[2 * np][1] = h[1];
        bh[2 * np + 1][0] = h[2];
        bh[2 * np + 1][1] = h[3];
        bl[2 * np][0] = l[0];
        bl[2 * np][1] = l[1];
        bl[2 * np + 1][0] = l[2];
        bl[2 * np + 1][1] = l[3];
      }
      // A fragments one m16 tile at a time (registers: 128 a thread).
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        unsigned ah[4], al[4];
        const int off = (wm * 64 + mt * 16 + a_row) * kMmaLdT + k0 + a_k;
        ldmatrix_x4(ah, T + off);
        ldmatrix_x4(al, T + kMmaT + off);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, al, bh[nt][0], bh[nt][1]);
          mma_tf32(t, ah, bl[nt][0], bl[nt][1]);
          mma_tf32(t, ah, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] += t[c];
        }
      }
    }
#endif
    // Release the buffer to the producers' chunk g + kMmaBufs.
    if (g + kMmaBufs < total) bar_arrive(kBarEmpty + buf, kMmaThreads);
    if (cmm.kc == n_ch - 1) {
      // Epilogue of the tile: rows i0 + wm*64 + mt*16 + g8 (+8), columns
      // j0 + wn*32 + nt*8 + 2*t4 (+1).
      const int i0 = cmm.i0, j0 = cmm.j0, r = cmm.r;
      float* out_r = out + (size_t)r * IJ;
      if constexpr (EPI == kEpiScale) {
        // The factor's 8 pairs of a column block loaded before any is
        // used (their latencies overlap), float2 where J is even.
        const float* f_r = colmax + (size_t)r * IJ;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int j = j0 + wn * 32 + nt * 8 + 2 * t4;
          float2 f[4][2];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = i0 + wm * 64 + mt * 16 + g8 + 8 * h;
              const float* fp = f_r + (size_t)i * J + j;
              f[mt][h] = make_float2(0.f, 0.f);
              if (i < I && j < J) {
                if (J % 2 == 0) {
                  f[mt][h] = __ldg(reinterpret_cast<const float2*>(fp));
                } else {
                  f[mt][h].x = __ldg(fp);
                  if (j + 1 < J) f[mt][h].y = __ldg(fp + 1);
                }
              }
            }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = i0 + wm * 64 + mt * 16 + g8 + 8 * h;
              if (i >= I || j >= J) continue;
              const float va = acc[mt][nt][2 * h] * f[mt][h].x;
              const float vb = acc[mt][nt][2 * h + 1] * f[mt][h].y;
              float* o = out_r + (size_t)i * J + j;
              if (j + 1 < J && J % 2 == 0) {
                *reinterpret_cast<float2*>(o) = make_float2(va, vb);
              } else {
                o[0] = va;
                if (j + 1 < J) o[1] = vb;
              }
            }
        }
      } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = j0 + wn * 32 + nt * 8 + 2 * t4;
        const float m_a = EPI == kEpiColLog && j < J
                              ? __ldg(colmax + (size_t)r * J + j) : 0.f;
        const float m_b = EPI == kEpiColLog && j + 1 < J
                              ? __ldg(colmax + (size_t)r * J + j + 1) : 0.f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + wm * 64 + mt * 16 + g8 + 8 * h;
            if (i >= I || j >= J) continue;
            float va = acc[mt][nt][2 * h], vb = acc[mt][nt][2 * h + 1];
            if constexpr (EPI == kEpiColLog) {
              va = m_a + logf(va);
              vb = m_b + logf(vb);
            } else if constexpr (EPI == kEpiRowLog) {
              const float sh = __ldg(colmax + i);
              va = sh + logf(va);
              vb = sh + logf(vb);
            }
            float* o = out_r + (size_t)i * J + j;
            if (j + 1 < J && J % 2 == 0) {
              *reinterpret_cast<float2*>(o) = make_float2(va, vb);
            } else {
              o[0] = va;
              if (j + 1 < J) o[1] = vb;
            }
          }
      }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;
    }
    advance(cmm);
  }
}


// The resident layout of the deferred pass B, for I small enough that
// W_c1^T stays in shared memory beside two (I, BN) strips (I <= 144 at BN
// = 128: the 18.9M-point continuous-GCY view (8,16,144,1024), 472
// launches per solve).  A block per (row, 32 columns) that streams W_c1^T
// in K-tiles leaves most of its threads idle there (72 thread tiles of 8
// x 8 for 256 threads) and reads the 83 KB W_c1^T in each of 4,096
// blocks.  Here a
// persistent grid (one block per SM at I = 144) loads W_c1^T once per
// block with cp.async and walks items (field row r, strip of BN
// columns): every thread owns an 8 x 8 output tile (rows 8*rg.., columns
// 4*cg.. and BN/2 + 4*cg.., so that a warp's strip loads are contiguous),
// (BN/8) * ceil(I/8) threads cover the (I, BN) item exactly (288 at I =
// 144, BN = 128), and the product runs over all of I with no barrier.
// The next item's raw strip is copied (cp.async) into the second buffer
// while the current one's maxima, exponentials and product run.  The
// sum runs in order of m.
constexpr int kResMaxThreads = 384;
constexpr int kResParts = 2;          // partial column maxima per column
constexpr int kFoldBatch = 32;        // sub_col loads in flight per thread
// Shared-memory floats of the resident layout: W_c1^T (I rows of
// round_up8(I), zero-padded), two (I, BN) strips, the partial column
// maxima and the shifts.
__host__ __device__ inline int pass_b_resident_smem_floats(int I, int BN) {
  return I * round_up8(I) + 2 * I * BN + kResParts * BN + BN;
}

__host__ __device__ inline int pass_b_resident_threads(int I, int BN) {
  return ((BN / 8) * (round_up8(I) / 8) + 31) / 32 * 32;
}

// Columns per item of the resident layout: the narrowest of 32, 64 and
// 128 that covers J, else the widest, among those whose footprint fits
// a block and whose threads are at most kResMaxThreads; 0 when none fits
// (the tensor-core layout).
inline int pass_b_resident_bn(int I, int J) {
  int best = 0;
  for (int bn = 32; bn <= 128; bn *= 2) {
    if (sizeof(float) * (size_t)pass_b_resident_smem_floats(I, bn) >
            kSmemLimit ||
        pass_b_resident_threads(I, bn) > kResMaxThreads)
      continue;
    best = bn;
    if (bn >= J) break;
  }
  return best;
}

// out[i, j] = shift[j] + log(sum_m W_c1t[m, i] e[m, j]) for one
// thread's 8 x 8 tile of a resident item (rows i0.., columns ca.. and
// cb..; out points at column 0 of the item, row stride J): per m, two
// float4 loads of W (a broadcast within each half-warp) and two of the
// strip (16 consecutive float4 per half-warp) feed 64 FMAs.  The sum runs
// in order of m.
__device__ __forceinline__ void resident_product(
    int I, int Ip, int lb, int jw, int i0, int ca, int cb, const float* w,
    const float* e, const float* shift, float* out, int J) {
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int m = 0; m < I; ++m) {
    const float* wa = w + m * Ip + i0;
    const float* eb = e + (m << lb);
    const float4 a0 = *reinterpret_cast<const float4*>(wa);
    const float4 a1 = *reinterpret_cast<const float4*>(wa + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(eb + ca);
    const float4 b1 = *reinterpret_cast<const float4*>(eb + cb);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + a;
    if (i >= I) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int jj = b < 4 ? ca + b : cb + b - 4;
      if (jj >= jw) continue;
#if SDFS_DEFB_SPLIT == 3
      out[(size_t)i * J + jj] = acc[a][b];
#else
      out[(size_t)i * J + jj] = shift[jj] + logf(acc[a][b]);
#endif
    }
  }
}

template <bool HAS_SUB>
__global__ void __launch_bounds__(kResMaxThreads)
pass_b_resident_kernel(const float* __restrict__ ell,
                       const float* __restrict__ w_c1t,
                       const float* __restrict__ sub_row,
                       const float* __restrict__ sub_col,
                       float* __restrict__ out, int R, int I, int J, int BN,
                       float theta) {
  extern __shared__ float smem[];     // 16-byte aligned base
  const int Ip = round_up8(I);
  const int lb = __ffs(BN) - 1;       // BN = 1 << lb
  float* w = smem;                    // (I, Ip)
  float* strips = w + I * Ip;         // 2 x (I, BN)
  float* part = strips + 2 * I * BN;  // (kResParts, BN)
  float* shift = part + kResParts * BN;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_strips = (J + BN - 1) / BN;
  const int n_items = R * n_strips;
  const size_t IJ = (size_t)I * J;

  // The raw (I, jw) strip of an item into dst (row stride BN); columns
  // past jw are never read raw (the fold writes 0 there).
  auto fetch = [&](int item, float* dst) {
    const int j0 = (item % n_strips) * BN, jw = min(BN, J - j0);
    const float* src = ell + (size_t)(item / n_strips) * IJ + j0;
    if (J % 4 == 0) {
      const int q = jw / 4;
      for (int x = tid; x < I * q; x += nt)
        cp_async16(dst + (x / q) * BN + 4 * (x % q),
                   src + (size_t)(x / q) * J + 4 * (x % q));
    } else {
      for (int x = tid; x < I * jw; x += nt)
        cp_async4(dst + (x / jw) * BN + x % jw,
                  src + (size_t)(x / jw) * J + x % jw);
    }
    cp_async_commit();
  };

  if (I % 4 == 0) {
    const int q = I / 4;
    for (int x = tid; x < I * q; x += nt)
      cp_async16(w + (x / q) * Ip + 4 * (x % q), w_c1t + 4 * x);
  } else {
    for (int x = tid; x < I * I; x += nt)
      cp_async4(w + (x / I) * Ip + x % I, w_c1t + x);
  }
  if (Ip > I)
    for (int x = tid; x < I * (Ip - I); x += nt)
      w[(x / (Ip - I)) * Ip + I + x % (Ip - I)] = 0.f;
  cp_async_commit();
  if (blockIdx.x < n_items) fetch(blockIdx.x, strips);

  const int n_cg = BN / 8, half = BN / 2;
  const int cg = tid % n_cg, rg = tid / n_cg;
  const bool active = rg < Ip / 8;
  const int i0 = 8 * rg, ca = 4 * cg, cb = half + 4 * cg;
  int t = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++t) {
    float* e = strips + (t & 1) * I * BN;
    cp_async_wait<0>();
    __syncthreads();                  // strip (and W) landed; other strip free
    const int r = item / n_strips, j0 = (item % n_strips) * BN;
    const int jw = min(BN, J - j0);
    float* out_r = out + (size_t)r * IJ;

    // a = theta * ell, or fma(theta, ell, -sub_row[r]) - sub_col[m, j]
    // (one rounding before the cancellation, as the plain version);
    // columns past jw hold 0 (never stored).
    // The sub_col values of kFoldBatch elements are loaded before any is
    // used (L2 latency, not the arithmetic, bounds this loop).
    const float sr = HAS_SUB ? __ldg(sub_row + r) : 0.f;
    for (int x0 = tid; x0 < I * BN; x0 += nt * kFoldBatch) {
      float sc[kFoldBatch];
#pragma unroll
      for (int b = 0; b < kFoldBatch; ++b) {
        const int x = x0 + b * nt, jj = x & (BN - 1);
        sc[b] = (HAS_SUB && x < I * BN && jj < jw)
                    ? __ldg(sub_col + (size_t)(x >> lb) * J + j0 + jj)
                    : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kFoldBatch; ++b) {
        const int x = x0 + b * nt, jj = x & (BN - 1);
        if (x >= I * BN) break;
        e[x] = jj >= jw ? 0.f
               : HAS_SUB ? __fsub_rn(__fmaf_rn(theta, e[x], -sr), sc[b])
                         : theta * e[x];
      }
    }
    // The next item's strip into the other buffer (free since the top
    // barrier), after the fold so that its copies do not queue ahead of
    // the fold's loads; they land during the maxima, exp and product.
    if (item + (int)gridDim.x < n_items)
      fetch(item + gridDim.x, strips + ((t + 1) & 1) * I * BN);
    __syncthreads();
    for (int x = tid; x < kResParts * BN; x += nt) {
      const int jj = x & (BN - 1);
      float mx = -INFINITY;
#pragma unroll 8
      for (int m = x >> lb; m < I; m += kResParts)
        mx = fmaxf(mx, e[(m << lb) + jj]);
      part[x] = mx;
    }
    __syncthreads();
    for (int jj = tid; jj < BN; jj += nt) {
      float mx = part[jj];
      for (int p = 1; p < kResParts; ++p) mx = fmaxf(mx, part[p * BN + jj]);
      shift[jj] = mx;
    }
    __syncthreads();
#if SDFS_DEFB_SPLIT == 1
    for (int x = tid; x < I * BN; x += nt)
      if ((x & (BN - 1)) < jw)
        out_r[(size_t)(x >> lb) * J + j0 + (x & (BN - 1))] =
            shift[x & (BN - 1)];
    continue;
#endif
#pragma unroll 8
    for (int x = tid; x < I * BN; x += nt)
      e[x] = expf(e[x] - shift[x & (BN - 1)]);
#if SDFS_DEFB_SPLIT == 2
    for (int x = tid; x < I * BN; x += nt)
      if ((x & (BN - 1)) < jw)
        out_r[(size_t)(x >> lb) * J + j0 + (x & (BN - 1))] = e[x];
    continue;
#endif
    __syncthreads();
    if (active) resident_product(I, Ip, lb, jw, i0, ca, cb, w, e, shift,
                                 out_r + j0, J);
  }
}

// ------------------------------------------- deferred and batched pass C
//
// pass_c_slab_kernel, one thread-block cluster of cs blocks per (slice i,
// tile of TC columns j of the slice), computes, with R = L*K rows
// (l, k):
//
//   1. acc[r, t] = sum_j' exp(mid[r, j'] - m1[r]) W_c2^T[j', j0 + t]
//      (fast mode: mid * scale[r]), m1[r] the max over the slice's J
//      values of mid[r], the sum in order of j';
//   2. M2[k] = max over l of m1[l, k]; M3 = max over k of M2; the linear
//      carry acc * exp(m1 - M2[k]); y = (W_r1 contracted over l) *
//      exp(M2[k] - M3);
//   3. z = W_r2 contracted over k; lh = log(z) + M3 (fast: + S) +
//      add_row + add_col; out = log1p(beta * exp(lh / theta)).
//
// Replaces the c2_deferred and c2_batched branches of
// streamed_two_phase.py:446 (_c_kernel, lines 474-485 and 506-539), with
// the same formulas and shifts; the sums run in order of j', l' and k'.
//
// What bounds it on an H100: FP32 FMA.  The GCY view (12, 16, 512, 256)
// is 2*R*I*J*J = 12.9 GFLOP of c2 and 1.4 of row phase against 100 MB of
// fields; the continuous-SSY cell (56, 56, 56, 64) 1.44 GFLOP of c2 and
// 2.52 of row phase against 90 MB.  Design:
//
// - Block rho of the cluster owns the rows of k-slab rho (all l, k in
//   [rho*nk, (rho+1)*nk)): M2[k] and the carry are local to the slab, and
//   so is the r1 contraction over l.  M3 is one cluster-wide maximum of
//   the blocks' slab maxima, read over distributed shared memory.  A set
//   whose rows fit one block runs a cluster of 1 (the GCY view: 192 rows
//   of 128 columns).
// - The c2 product: each thread owns a fixed 8 x 8 tile of the (slab rows,
//   TC) accumulator, in registers for the whole J loop, threads = tiles.
//   The slab's raw values and the W_c2^T chunk stream in chunks of JK
//   columns j' by cp.async (two raw buffers, three W buffers), each chunk
//   exponentiated once into a transposed buffer; one barrier per chunk:
//   after it, chunk c + 2's copy starts, chunk c + 1 is exponentiated
//   and chunk c's product runs, so the copies and the exponentials
//   overlap the products.  Per k: four float4 shared loads feed 64 FMAs.
// - The shift m1 is the running maximum of the row over the chunks read
//   so far (online, as in a streamed softmax): chunk c is exponentiated
//   against it, and the thread's rows of acc are rescaled by exp(m_old -
//   m_new) before chunk c's product.  After the last chunk m1 is the
//   slice's maximum and acc = sum exp(mid - m1) W_c2^T, so the slice is
//   read once, not once more for its maxima.
// - The row phase runs the same 8 x 8 register tiles on W_r1^T, W_r2^T
//   staged in shared memory (zero-padded to 8 rows).  After r1 (and
//   cluster.sync()), block rho takes l-slab rho and gathers y[l, all k,
//   t] from the k-slabs' owners over DSMEM (cluster.map_shared_rank);
//   after a second cluster.sync() (the peers' y is no longer read) it
//   runs r2 into shared memory, then the epilogue element by element with
//   float4 loads and stores.  Each slice is read from device memory by
//   J/TC clusters (1 at the continuous-SSY cell, TC = J = 64, cs = 8),
//   and exponentiated as often.
// - Ragged L, K, J: the last k- and l-slabs are short (an l-slab may be
//   empty), rows and columns past the set are zero-filled or masked;
//   J % 4 != 0 takes 4-byte copies.
//
// pass_c_slab_layout chooses (cs, TC, JK, threads): the widest TC (a
// multiple of 8, at most kSlabMaxTC, not wider than J rounds up to), then
// the smallest cluster whose block fits kSlabMaxThreads threads and a
// block's shared memory, with JK = 32 where that fits, else 16
// (streamed_two_phase.pass_c_deferred_layout mirrors it;
// sdfs_pass_c_deferred_layout reports it).

// SDFS_PASSC_DEF_SPLIT (compile-time, for timing the phases; 4, the
// default, is the kernel): 1 stops after the streamed pass without the
// c2 product (copies, exponentials, shifts; fast mode: the scaled copies)
// and the cluster maximum, 2 after the c2 product, 3 after the carries
// and the r1 contraction; 1-3 store that phase's result in place of the
// output.
#ifndef SDFS_PASSC_DEF_SPLIT
#define SDFS_PASSC_DEF_SPLIT 4
#endif

constexpr int kSlabMaxThreads = 512;
constexpr int kSlabMaxTC = 128;       // widest column tile
constexpr int kSlabMaxCluster = 8;    // the portable cluster size limit

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Row stride of the transposed chunk; the +4 spreads the transposing
// stores over banks.
__host__ __device__ inline int slab_rstride(int rows) {
  return round_up8(rows) + 4;
}

// Floats of region A (the accumulator of the slab's rows; with a cluster,
// later the l-slab's gathered y) and of the region A + B (B, as large:
// y of the slab's rows, later r2's result) that the streamed chunks alias
// during the J loop.
__host__ __device__ inline int slab_a_floats(int L, int K, int nk, int nl,
                                             int tc) {
  const int rows = L * nk;
  return (rows > nl * K ? rows : nl * K) * tc;
}
__host__ __device__ inline int slab_x_floats(int L, int K, int nk, int nl,
                                             int tc, int jk) {
  const int rows = L * nk;
  const int chunks =
      2 * rows * (jk + 4) + 2 * jk * slab_rstride(rows) + 3 * jk * tc;
  const int ab = 2 * slab_a_floats(L, K, nk, nl, tc);
  return chunks > ab ? chunks : ab;
}
// W_r1^T (L rows of round_up8(L)), later W_r2^T (K rows of round_up8(K)).
__host__ __device__ inline int slab_wt_floats(int L, int K) {
  const int a = L * round_up8(L), b = K * round_up8(K);
  return a > b ? a : b;
}
// The region, W^T, m1 (the slab's rows), two chunks' rescale factors,
// M2 (its k), the slab maximum and the rows' field-row table (ints).
__host__ __device__ inline int slab_smem_floats(int L, int K, int nk, int nl,
                                                int tc, int jk) {
  const int rows = L * nk;
  return slab_x_floats(L, K, nk, nl, tc, jk) + slab_wt_floats(L, K) +
         round_up4(rows) + 2 * round_up8(rows) + round_up4(nk) + 4 +
         round_up4(rows);
}

struct SlabLayout {
  int cs, nk, nl, tc, jk, threads, smem_floats;
};

__host__ inline bool pass_c_slab_layout(int L, int K, int J,
                                        SlabLayout* lay) {
  const int tc_max = round_up8(J) < kSlabMaxTC ? round_up8(J) : kSlabMaxTC;
  for (int tc = tc_max; tc >= 8; tc -= 8) {
    for (int cs = 1; cs <= kSlabMaxCluster && cs <= K; ++cs) {
      const int nk = cdiv(K, cs);
      if (cdiv(K, nk) != cs) continue;    // the slabs of a smaller cluster
      const int nl = cdiv(L, cs);
      const int threads = (cdiv(L * nk, 8) * (tc / 8) + 31) / 32 * 32;
      if (threads > kSlabMaxThreads) continue;
      for (int jk = 32; jk >= 16; jk -= 16) {   // 32-column chunks first
        const int floats = slab_smem_floats(L, K, nk, nl, tc, jk);
        if (sizeof(float) * (size_t)floats <= kSmemLimit) {
          *lay = SlabLayout{cs, nk, nl, tc, jk, threads, floats};
          return true;
        }
      }
    }
  }
  return false;
}

// acc[i][q] += sum_{k < kw} at[k * lda + i] * b[k * ldb + col(q)] with
// col(q) = q for q < 4 and half + q - 4 after: the 8 x 8 tile of rows
// at's 8 columns, the 4 + 4 columns of b at 0 and half; the sum in order
// of k.  at, b, lda, ldb and half keep every float4 16-byte aligned.
__device__ __forceinline__ void fma_tile(const float* at, int lda,
                                         const float* b, int ldb, int half,
                                         int kw, float (&acc)[8][8]) {
#pragma unroll 4
  for (int k = 0; k < kw; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(at + k * lda);
    const float4 a1 = *reinterpret_cast<const float4*>(at + k * lda + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * ldb);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * ldb + half);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
  }
}

// FAST (the batched pass C's fast mode): mid is linear, scaled per row by
// scale, no shifts; S is added back after the log.  c2_stride: floats
// between consecutive slices' factors in w_c2t (0: one shared W_c2^T).
// JK: columns j' per streamed chunk (16 or 32).  Grid (cs * ceil(J /
// TC), I), clusters of (cs, 1, 1).
template <bool FAST, int JK>
__global__ void __launch_bounds__(kSlabMaxThreads)
pass_c_slab_kernel(const float* __restrict__ mid,
                   const float* __restrict__ scale,
                   const float* __restrict__ S,
                   const float* __restrict__ w_c2t, size_t c2_stride,
                   const float* __restrict__ w_r1,
                   const float* __restrict__ w_r2,
                   const float* __restrict__ add_row,
                   const float* __restrict__ add_col,
                   float* __restrict__ out, int L, int K, int J, int cs,
                   int nk, int nl, int TC, float theta, float beta) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];     // 16-byte aligned base
  const int rank = blockIdx.x % cs, ct = blockIdx.x / cs;
  const int k0 = rank * nk, nko = min(nk, K - k0);          // own k-slab
  const int l0 = rank * nl, nlo = max(0, min(nl, L - l0));  // own l-slab
  const int rows = L * nk, Rs = slab_rstride(rows), Rp = round_up8(rows);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int j0 = ct * TC, tcw = min(TC, J - j0), half = TC / 2;
  const size_t C = (size_t)gridDim.y * J;
  const size_t col0 = (size_t)blockIdx.y * J;   // first column of slice i
  const float* in = mid + col0;
  const float* wz = w_c2t + blockIdx.y * c2_stride;   // slice i's W_c2^T
  const int a_floats = slab_a_floats(L, K, nk, nl, TC);
  float* A = smem;                    // acc; then (cluster) the l-slab's y
  float* B = A + a_floats;            // y; then r2's result
  constexpr int JKp = JK + 4;         // raw row stride: conflict-free rows
  float* raw = smem;                  // J loop: 2 x (rows, JKp)
  float* et = raw + 2 * rows * JKp;   //   2 x (JK, Rs)
  float* wc = et + 2 * JK * Rs;       //   3 x (JK, TC)
  float* wt = smem + slab_x_floats(L, K, nk, nl, TC, JK);
  float* m1 = wt + slab_wt_floats(L, K);            // (rows)
  float* fct = m1 + round_up4(rows);                // 2 x (Rp)
  float* M2 = fct + 2 * Rp;                         // (nk)
  float* Mx = M2 + round_up4(nk);                   // the slab's max of M2
  int* rtab = reinterpret_cast<int*>(Mx + 4);       // (rows) field rows
  auto sync = [&]() {
    if (cs > 1) cluster.sync(); else __syncthreads();
  };
  // Slab row q = l * nk + kk is field row (l, k0 + kk) when kk < nko; a
  // ragged last slab's other rows are -1 in rtab and hold 0 in both raw
  // buffers (their accumulators are never read).
  for (int q = tid; q < rows; q += nt) {
    const int kk = q % nk;
    rtab[q] = kk < nko ? (q / nk) * K + k0 + kk : -1;
    m1[q] = -INFINITY;
  }
  if (nko < nk)
    for (int x = tid; x < rows * JKp; x += nt)
      if ((x / JKp) % nk >= nko)
        raw[x] = raw[rows * JKp + x] = 0.f;
  __syncthreads();

  // Chunk c: the slab's raw values of columns [c0, c0 + kw) into raw[c %
  // 2], W_c2^T rows c0.. (TC columns, zero past the set) into wc[c % 3];
  // one commit group per call, empty past the last chunk.
  const int nch = cdiv(J, JK);
  const bool vec = (J % 4 == 0);      // every row and tile 16-byte aligned
  auto fetch = [&](int c) {
    if (c < nch) {
      const int c0 = c * JK, kw = min(JK, J - c0);
      float* rb = raw + (c & 1) * rows * JKp;
      float* wb = wc + (c % 3) * JK * TC;
      if (vec && kw == JK) {          // whole chunks: no division per copy
        constexpr int q4 = JK / 4;
        for (int x = tid; x < rows * q4; x += nt) {
          const int q = x / q4, k = 4 * (x % q4), r = rtab[q];
          if (r >= 0)
            cp_async16(rb + q * JKp + k, in + (size_t)r * C + c0 + k);
        }
      } else if (vec) {
        const int q4 = kw / 4;
        for (int x = tid; x < rows * q4; x += nt) {
          const int q = x / q4, k = 4 * (x % q4), r = rtab[q];
          if (r >= 0)
            cp_async16(rb + q * JKp + k, in + (size_t)r * C + c0 + k);
        }
      } else {
        for (int x = tid; x < rows * kw; x += nt) {
          const int q = x / kw, k = x % kw, r = rtab[q];
          if (r >= 0)
            cp_async4(rb + q * JKp + k, in + (size_t)r * C + c0 + k);
        }
      }
      if (vec) {
        const int t4 = TC / 4;
        for (int x = tid; x < kw * t4; x += nt) {
          const int k = x / t4, t = 4 * (x % t4);
          if (t < tcw)
            cp_async16(wb + k * TC + t, wz + (size_t)(c0 + k) * J + j0 + t);
          else
            *reinterpret_cast<float4*>(wb + k * TC + t) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int x = tid; x < kw * TC; x += nt) {
          const int k = x / TC, t = x % TC;
          if (t < tcw)
            cp_async4(wb + k * TC + t, wz + (size_t)(c0 + k) * J + j0 + t);
          else
            wb[k * TC + t] = 0.f;
        }
      }
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);

  // Fast mode: the row scales into m1.  W_r1^T into wt.  The padding rows
  // of the transposed chunks and of the rescale factors hold 0, set once.
  if constexpr (FAST)
    for (int q = tid; q < rows; q += nt)
      m1[q] = rtab[q] >= 0 ? __ldg(scale + rtab[q]) : 0.f;
  const int Lp = round_up8(L), Kp = round_up8(K);
  for (int x = tid; x < L * Lp; x += nt) {
    const int m = x / Lp, l = x % Lp;
    wt[x] = l < L ? __ldg(w_r1 + l * L + m) : 0.f;
  }
  for (int x = tid; x < 2 * (JK + 1) * 8; x += nt) {
    const int line = x / 8, q = rows + x % 8;
    if (q < Rp) {
      if (line < 2 * JK) et[line * Rs + q] = 0.f;
      else fct[(line - 2 * JK) * Rp + q] = 0.f;
    }
  }

  // 1. The c2 product: the thread's 8 x 8 tile of (slab rows, TC) in
  // registers.  exps(c): g lanes per row exponentiate chunk c against the
  // row's running maximum (two passes over their JK / g values, float4
  // reads of the padded raw row; the maximum combined by shuffles),
  // transposed into et[c % 2] (consecutive rows, consecutive banks), and
  // store the row's rescale factor exp(m_old - m_new) in fct[c % 2]; fast
  // mode scales instead.  Columns past a ragged last chunk take no part
  // (and are not read).
  const int ncg = TC / 8, nrg = cdiv(rows, 8);
  const int rg = tid / ncg, cgp = tid % ncg;
  const bool active = rg < nrg;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
  // g = 2^lg lanes per row share its columns (the most, up to JK / 4,
  // that the block's threads cover), float4 reads of per4 each.
  int lg = 0;
  while ((2 << lg) * rows <= nt && (2 << lg) <= JK / 4) ++lg;
  const int g = 1 << lg, per4 = (JK / 4) >> lg;
  auto exps = [&](int c) {
    const int kw = min(JK, J - c * JK);
    const float* rb = raw + (c & 1) * rows * JKp;
    float* eb = et + (c & 1) * JK * Rs;
    float* fb = fct + (c & 1) * Rp;
    const int n = (rows * g + 31) / 32 * 32;   // whole warps: the shuffles
    for (int x = tid; x < n; x += nt) {
      const int q = x >> lg, k0 = 4 * per4 * (x & (g - 1));
      const bool here = q < rows;
      const float4* row =
          reinterpret_cast<const float4*>(rb + (here ? q : 0) * JKp + k0);
      float mn = here ? m1[q] : 0.f;
      if constexpr (!FAST) {
        const float mo = mn;
        for (int k4 = 0; k4 < per4; ++k4) {
          const float4 a = row[k4];
          const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (k0 + 4 * k4 + u < kw) mn = fmaxf(mn, v[u]);
        }
        for (int o = g >> 1; o > 0; o >>= 1)
          mn = fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        if (here && k0 == 0) {
          m1[q] = mn;
          fb[q] = expf(mo - mn);
        }
      }
      if (!here) continue;
      for (int k4 = 0; k4 < per4; ++k4) {
        const float4 a = row[k4];
        const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          eb[(k0 + 4 * k4 + u) * Rs + q] = FAST ? v[u] * mn : expf(v[u] - mn);
      }
    }
  };
  cp_async_wait<1>();               // chunk 0 landed
  __syncthreads();
  exps(0);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();              // chunk c + 1 landed
    __syncthreads();                  // et[c], chunk c + 1 ready; c - 1 done
    fetch(c + 2);
    if (c + 1 < nch) exps(c + 1);
    if (SDFS_PASSC_DEF_SPLIT != 1 && active) {
      if constexpr (!FAST) {
        const float* fb = fct + (c & 1) * Rp + 8 * rg;
        const float4 f0 = *reinterpret_cast<const float4*>(fb);
        const float4 f1 = *reinterpret_cast<const float4*>(fb + 4);
        const float fv[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[i][q] *= fv[i];
      }
      fma_tile(et + (c & 1) * JK * Rs + 8 * rg, Rs,
               wc + (c % 3) * JK * TC + 4 * cgp, TC, half,
               min(JK, J - c * JK), acc);
    }
  }
  __syncthreads();                    // the chunks are read: A, B are free

  // 2. The shifts: M2 per own k, the slab's maximum, M3 over the cluster.
  float m3;
  if constexpr (FAST) {
    m3 = __ldg(S);
  } else {
    for (int kk = tid; kk < nko; kk += nt) {
      float m = -INFINITY;
      for (int l = 0; l < L; ++l) m = fmaxf(m, m1[l * nk + kk]);
      M2[kk] = m;
    }
    __syncthreads();
    if (tid == 0) {
      float m = -INFINITY;
      for (int kk = 0; kk < nko; ++kk) m = fmaxf(m, M2[kk]);
      Mx[0] = m;
    }
    sync();                           // every slab's maximum is written
    m3 = Mx[0];
    for (int p = 0; p < cs; ++p)
      if (p != rank) m3 = fmaxf(m3, *cluster.map_shared_rank(Mx, p));
  }
#if SDFS_PASSC_DEF_SPLIT == 1
  for (int x = tid; x < rows * tcw; x += nt) {
    const int q = x / tcw;
    if (rtab[q] >= 0)
      out[(size_t)rtab[q] * C + col0 + j0 + x % tcw] =
          FAST ? m1[q] : m1[q] + M2[q % nk] + m3;
  }
  if (cs > 1) cluster.sync();         // the peers have read Mx
  return;
#endif
#if SDFS_PASSC_DEF_SPLIT == 2
  if (active)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * rg + i;
      if (r >= rows || rtab[r] < 0) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t0 = 4 * cgp + h * half;
        if (t0 >= tcw) continue;
        float* dst = out + (size_t)rtab[r] * C + col0 + j0 + t0;
        if (vec)
          *reinterpret_cast<float4*>(dst) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
              acc[i][4 * h + 3]);
        else
          for (int u = 0; u < 4 && t0 + u < tcw; ++u)
            dst[u] = acc[i][4 * h + u];
      }
    }
  if (cs > 1) cluster.sync();
  return;
#endif

  // 3. The carry exp(m1 - M2[k]) per row into A, then r1 per own k:
  // y[l, k, t] = (sum_m W_r1[l, m] A[m, k, t]) * exp(M2[k] - M3) into B.
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = 8 * rg + i;
      if (q >= rows || rtab[q] < 0) continue;
      float cr = 1.f;
      if constexpr (!FAST) cr = expf(m1[q] - M2[q % nk]);
      *reinterpret_cast<float4*>(A + q * TC + 4 * cgp) = make_float4(
          acc[i][0] * cr, acc[i][1] * cr, acc[i][2] * cr, acc[i][3] * cr);
      *reinterpret_cast<float4*>(A + q * TC + half + 4 * cgp) = make_float4(
          acc[i][4] * cr, acc[i][5] * cr, acc[i][6] * cr, acc[i][7] * cr);
    }
  }
  __syncthreads();
  const int nlg = cdiv(L, 8);
  for (int item = tid; item < nko * nlg * ncg; item += nt) {
    const int cq = item % ncg, lg = (item / ncg) % nlg;
    const int kk = item / (ncg * nlg);
    float v[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) v[i][q] = 0.f;
    fma_tile(wt + 8 * lg, Lp, A + kk * TC + 4 * cq, nk * TC, half, L, v);
    float e2 = 1.f;
    if constexpr (!FAST) e2 = expf(M2[kk] - m3);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int l = 8 * lg + i;
      if (l >= L) continue;
      float* dst = B + (l * nk + kk) * TC + 4 * cq;
      *reinterpret_cast<float4*>(dst) = make_float4(
          v[i][0] * e2, v[i][1] * e2, v[i][2] * e2, v[i][3] * e2);
      *reinterpret_cast<float4*>(dst + half) = make_float4(
          v[i][4] * e2, v[i][5] * e2, v[i][6] * e2, v[i][7] * e2);
    }
  }
#if SDFS_PASSC_DEF_SPLIT == 3
  __syncthreads();
  for (int x = tid; x < rows * tcw; x += nt) {
    const int q = x / tcw;
    if (rtab[q] >= 0)
      out[(size_t)rtab[q] * C + col0 + j0 + x % tcw] = B[q * TC + x % tcw];
  }
  if (cs > 1) cluster.sync();
  return;
#endif
  sync();                             // every slab's y is written

  // 4. W_r2^T; with a cluster, the l-slab's y[l, all k, t] gathered from
  // the k-slabs' owners into A.
  for (int x = tid; x < K * Kp; x += nt) {
    const int m = x / Kp, k = x % Kp;
    wt[x] = k < K ? __ldg(w_r2 + k * K + m) : 0.f;
  }
  const float* y = B;                 // one block: y[l, k, t] in place
  if (cs > 1) {
    const int t4 = TC / 4;
    for (int x = tid; x < nlo * K * t4; x += nt) {
      const int t = 4 * (x % t4), m = (x / t4) % K, ll = x / (t4 * K);
      const int p = m / nk;
      const float* src = cluster.map_shared_rank(B, p) +
                         ((l0 + ll) * nk + m - p * nk) * TC + t;
      *reinterpret_cast<float4*>(A + (ll * K + m) * TC + t) =
          *reinterpret_cast<const float4*>(src);
    }
    y = A;
  }
  sync();                             // W_r2^T, y ready; the peers' B read

  // r2 per own l into the free region (l-slab rows [l][k][t]), then the
  // epilogue over it element by element: coalesced float4 loads and
  // stores, no register tile live across the transcendentals.
  float* z = cs > 1 ? B : A;
  const int nkg = cdiv(K, 8);
  for (int item = tid; item < nlo * nkg * ncg; item += nt) {
    const int cq = item % ncg, kg = (item / ncg) % nkg;
    const int ll = item / (ncg * nkg);
    float v[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) v[i][q] = 0.f;
    fma_tile(wt + 8 * kg, Kp, y + ll * K * TC + 4 * cq, TC, half, K, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = 8 * kg + i;
      if (k >= K) continue;
      float* dst = z + (ll * K + k) * TC + 4 * cq;
      *reinterpret_cast<float4*>(dst) =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      *reinterpret_cast<float4*>(dst + half) =
          make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
    }
  }
  __syncthreads();
  const int t4n = TC / 4;
  for (int x = tid; x < nlo * K * t4n; x += nt) {
    const int t = 4 * (x % t4n), lk = x / t4n;   // lk = ll * K + k
    if (t >= tcw) continue;
    const int r = l0 * K + lk;
    const float4 zv = *reinterpret_cast<const float4*>(z + lk * TC + t);
    const float zz[4] = {zv.x, zv.y, zv.z, zv.w};
    const float ar = __ldg(add_row + r);
    const size_t c = col0 + j0 + t;
    float* dst = out + (size_t)r * C + c;
    if (vec) {
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(add_col + c));
      const float ac[4] = {a4.x, a4.y, a4.z, a4.w};
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float lh = logf(zz[u]) + m3 + ar + ac[u];
        o[u] = log1pf(beta * expf(lh / theta));
      }
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      for (int u = 0; u < 4 && t + u < tcw; ++u) {
        const float lh = logf(zz[u]) + m3 + ar + __ldg(add_col + c + u);
        dst[u] = log1pf(beta * expf(lh / theta));
      }
    }
  }
}

// ------------------------------------------------------ pair pass C
//
// Continuous GCY: the column factor c2 = (z_pi, z) of a c1 slice
// q = (i, y) (current h_z, h_zpi) is the conditioned pair
// P_zpi[y, b, B'] * P_z[i, j, b, J'], contracted per axis.  Pass B is
// pass_b_deferred (with the folded baseline); pass_c_pair computes, per
// slice and per output group b (the current z_pi index, n_j columns
// (b, j)), with R = L*K rows:
//
//   1. m1[r] = max of mid[r] over the slice's whole (B', J') group;
//   2. acc_b[r, J'] = sum_B' P_zpi[y, b, B'] exp(mid[r, (B', J')] - m1
//      + 25);
//   3. u[r, j] = sum_J' acc_b[r, J'] P_z[i, j, b, J'] (one (R, n_j) by
//      (n_j, n_j) product; the port's layout pzt[i, b, J', j], see
//      pair_device_operands in streamed_two_phase.py, streams the
//      (i, b) block from L2 in 16-row K-tiles by cp.async);
//   4. the linear-carry row phase: u * exp(m1 - M2 + 25), M2 = max over
//      l of m1; contract l' with W_r1; * exp(M2 - M3 + 25), M3 = max
//      over k of M2; contract k' with W_r2;
//   5. lh = log(v) + M3 - 75 + add_row[r] + add_col[c]; out =
//      log1p(beta * exp(lh / theta)).
//
// Replaces streamed_two_phase.py:673 (_c_kernel_pair).  The e^25 bias
// per exp stage is float32 range arithmetic: the chain from the first
// exp to the last log runs un-logged, and without the bias a whole
// output group of the 18.9M-point SA solve underflowed to 0 (the field
// turned inf; the JAX docstring, streamed_two_phase.py:709-719).
//
// What bounds it on an H100: FP32 FMA.  At view (8, 16, 144, 1024) the
// z' products are 2 * R * IY * C2 * n_j = 4.83 GFLOP, the z_pi'
// contraction 0.30 and the row carry 0.91, with R * C = 18.9M
// exponentials, against 75.5 MB fields.  A slice's (R, C2) field (512
// KB) does not fit a block.  Design: the cs = min(n_b, 8) blocks of a
// slice run as one thread-block cluster (cudaLaunchKernelEx with a
// cluster dimension; 8 is the portable limit).  Steps 1-2 split the
// slice by rows: cluster rank rho owns rows [rho*R/cs, (rho+1)*R/cs),
// reads them once from device memory for their maxima (kept in L2 for
// the second read), exponentiates each entry once and forms acc_b for
// every group b of the round in registers, into its staging area in
// shared memory laid out [b - b0][row - row0][J'].  After a cluster
// barrier, the block that owns group b gathers acc_b's rows from its
// peers' staging areas over distributed shared memory (one (R, n_j)
// read per block: one field's worth per slice), and the full m1 from
// its peers likewise.  After a second barrier (the staging areas are
// then free, and alias the product's u and K-tiles) steps 3-5 run per
// block, one group each: the z' product as before; the row phase with
// W_r1 and W_r2 staged in the K-tile area, a thread taking one column and
// kRowTile output rows at a time (no divisions in the inner loops).  The
// phase split (bench/kernel_split.py) puts the maxima, the exponentials
// and the gather, the z' product, and the row phase with the epilogue
// at about a third of the kernel each.  Sets with n_b above the cluster
// size run
// in rounds of cs groups (group b belongs to rank b % cs in round
// b / cs), steps 1-2 again in each round: the kernel covers every n_b.
// Shared memory: 148 KB at R = n_j = 128 (one block of 512 threads per
// SM), independent of n_b.
//
// SDFS_PAIR_SPLIT (compile-time, for timing the phases; 4, the default,
// is the kernel): 1 stops after the slice maxima, 2 after the
// exponentials, the z_pi' sums and the gather, 3 after the z' product;
// 1-3 store that phase's result in place of the output.

#ifndef SDFS_PAIR_SPLIT
#define SDFS_PAIR_SPLIT 4
#endif

constexpr int kPairThreads = 512;
constexpr int kPairCluster = 8;       // the portable cluster size limit
constexpr int kRowTile = 8;           // row-phase outputs per thread and pass
constexpr float kPairBias = 25.f;

// Blocks per cluster (one slice) and the first row of cluster rank rank;
// the row's owner inverts it.
__host__ __device__ inline int pair_cluster_size(int n_b) {
  return n_b < kPairCluster ? n_b : kPairCluster;
}
__host__ __device__ inline int pair_row0(int rank, int R, int cs) {
  return (int)(((long long)rank * R) / cs);
}
__host__ __device__ inline int pair_row_owner(int r, int R, int cs) {
  return (int)(((long long)(r + 1) * cs - 1) / R);
}

// Shared-memory floats of pass_c_pair: acc (R rows of Jp =
// round_up4(n_j), later the l' result), u (R, n_j), the two K-tiles of
// P_z (u and the K-tiles first hold the round's staging area, cs *
// ceil(R / cs) rows of n_j <= (R + 7) * n_j), m1 (R), M2 (K) and M3.
__host__ __device__ inline int pass_c_pair_smem_floats(int R, int K,
                                                       int n_j) {
  return R * round_up4(n_j) + R * n_j + 2 * kBK * n_j + round_up4(R) +
         round_up4(K) + 4;
}

__global__ void __launch_bounds__(kPairThreads)
pass_c_pair_kernel(const float* __restrict__ mid,
                   const float* __restrict__ p_zpi,
                   const float* __restrict__ pzt,
                   const float* __restrict__ w_r1,
                   const float* __restrict__ w_r2,
                   const float* __restrict__ add_row,
                   const float* __restrict__ add_col,
                   float* __restrict__ out, int L, int K, int n_i, int n_y,
                   int n_b, int n_j, float theta, float beta) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];     // 16-byte aligned base
  const int R = L * K, Jp = round_up4(n_j), C2 = n_b * n_j;
  float* acc = smem;                  // (R, Jp); later z (L, K, n_j)
  float* u = acc + R * Jp;            // (R, n_j)
  float* stage = u + R * n_j;         // 2 x (kBK, n_j)
  float* m1 = stage + 2 * kBK * n_j;  // (R)
  float* M2 = m1 + round_up4(R);      // (K)
  float* M3 = M2 + round_up4(K);      // (1)
  float* staging = u;                 // (cs, chunk, n_j) over u and stage
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int cs = gridDim.x;           // the cluster is the grid's x
  const int rank = blockIdx.x;
  const int q = blockIdx.y, i = q / n_y, y = q % n_y;
  const size_t C = (size_t)n_i * n_y * C2;
  const size_t col0 = (size_t)q * C2;            // first column of slice q
  const float* in = mid + col0;
  const int r0 = pair_row0(rank, R, cs), r1 = pair_row0(rank + 1, R, cs);
  const int chunk = (R + cs - 1) / cs;
  const bool vec = (n_j % 4 == 0);    // then every slab row is 16-byte aligned
  const int rounds = (n_b + cs - 1) / cs;

  for (int t = 0; t < rounds; ++t) {
    const int b0 = t * cs, ng = min(cs, n_b - b0);

    // 1. m1[r] over the slice for the own rows, a warp per row.
    for (int r = r0 + warp; r < r1; r += nw) {
      const float* row = in + r * C;
      float m = -INFINITY;
      if (vec) {
#pragma unroll 4
        for (int x = lane; x < C2 / 4; x += 32) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(row) + x);
          m = fmaxf(m, fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
        }
      } else {
#pragma unroll 4
        for (int x = lane; x < C2; x += 32) m = fmaxf(m, __ldg(row + x));
      }
      m = warp_max(m);
      if (lane == 0) m1[r] = m;
    }
    cluster.sync();                   // every rank's maxima are written

    // The peers' maxima (for the row carry of step 4).
    for (int r = tid; r < R; r += nt)
      if (r < r0 || r >= r1)
        m1[r] = *cluster.map_shared_rank(m1 + r,
                                         pair_row_owner(r, R, cs));
#if SDFS_PAIR_SPLIT == 1
    cluster.sync();                   // the peers' maxima read
    __syncthreads();
    if (rank < ng) {
      for (int x = tid; x < R * n_j; x += nt)
        out[(x / n_j) * C + col0 + (size_t)(b0 + rank) * n_j + x % n_j] =
            m1[x / n_j];
    }
    continue;
#endif

    // 2. For the own rows: acc_{b0+g}[r, J'] = sum_B' P_zpi[y, b0+g, B']
    // exp(mid[r, (B', J')] - m1[r] + 25), each entry exponentiated once,
    // the sum in order of B'; into staging[g][r - r0][J'].
    const float* wz = p_zpi + ((size_t)y * n_b + b0) * n_b;  // [g][B']
    if (vec) {
      const int q4 = n_j / 4;
      for (int x = tid; x < (r1 - r0) * q4; x += nt) {
        const int rl = x / q4, j4 = 4 * (x % q4), r = r0 + rl;
        const float4* src = reinterpret_cast<const float4*>(in + r * C + j4);
        const float m = m1[r];
        float4 a[kPairCluster];
#pragma unroll
        for (int g = 0; g < kPairCluster; ++g)
          a[g] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int B = 0; B < n_b; ++B) {
          const float4 v = __ldg(src + B * q4);
          const float ex = expf(v.x - m + kPairBias);
          const float ey = expf(v.y - m + kPairBias);
          const float ez = expf(v.z - m + kPairBias);
          const float ew = expf(v.w - m + kPairBias);
#pragma unroll
          for (int g = 0; g < kPairCluster; ++g) {
            if (g < ng) {
              const float w = __ldg(wz + g * n_b + B);
              a[g].x = fmaf(w, ex, a[g].x);
              a[g].y = fmaf(w, ey, a[g].y);
              a[g].z = fmaf(w, ez, a[g].z);
              a[g].w = fmaf(w, ew, a[g].w);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kPairCluster; ++g)
          if (g < ng)
            *reinterpret_cast<float4*>(
                staging + ((size_t)g * chunk + rl) * n_j + j4) = a[g];
      }
    } else {
      for (int x = tid; x < (r1 - r0) * n_j; x += nt) {
        const int rl = x / n_j, jj = x % n_j, r = r0 + rl;
        const float* src = in + r * C + jj;
        const float m = m1[r];
        float a[kPairCluster];
#pragma unroll
        for (int g = 0; g < kPairCluster; ++g) a[g] = 0.f;
        for (int B = 0; B < n_b; ++B) {
          const float e = expf(__ldg(src + B * n_j) - m + kPairBias);
#pragma unroll
          for (int g = 0; g < kPairCluster; ++g)
            if (g < ng) a[g] = fmaf(__ldg(wz + g * n_b + B), e, a[g]);
        }
#pragma unroll
        for (int g = 0; g < kPairCluster; ++g)
          if (g < ng) staging[((size_t)g * chunk + rl) * n_j + jj] = a[g];
      }
    }
    cluster.sync();                   // every rank's staging area is full

    // Rank g < ng owns group b = b0 + g: gather acc_b[r, :] from the
    // owner of row r; padding columns J' >= n_j hold 0.
    const bool owns = rank < ng;
    if (owns) {
      if (vec) {
        const int q4 = n_j / 4;
        for (int x = tid; x < R * q4; x += nt) {
          const int r = x / q4, j4 = 4 * (x % q4);
          const int pi = pair_row_owner(r, R, cs);
          const float* src = cluster.map_shared_rank(staging, pi) +
                             ((size_t)rank * chunk + r - pair_row0(pi, R, cs)) *
                                 n_j + j4;
          *reinterpret_cast<float4*>(acc + r * Jp + j4) =
              *reinterpret_cast<const float4*>(src);
        }
      } else {
        for (int x = tid; x < R * Jp; x += nt) {
          const int r = x / Jp, jj = x % Jp;
          float v = 0.f;
          if (jj < n_j) {
            const int pi = pair_row_owner(r, R, cs);
            v = *cluster.map_shared_rank(
                staging + ((size_t)rank * chunk + r - pair_row0(pi, R, cs)) *
                              n_j + jj, pi);
          }
          acc[x] = v;
        }
      }
    }
    cluster.sync();                   // staging areas read: u may reuse them
    if (!owns) continue;
    const int b = b0 + rank;
    const size_t c0 = col0 + (size_t)b * n_j;
#if SDFS_PAIR_SPLIT == 2
    for (int x = tid; x < R * n_j; x += nt)
      out[(x / n_j) * C + c0 + x % n_j] = acc[(x / n_j) * Jp + x % n_j];
    continue;
#endif

    // 3. u[r, j] = sum_J' acc[r, J'] P_z[i, j, b, J'] with the (i, b)
    // block of pzt (J', j) streamed in K-tiles; the sum in order of J'.
    const float* w = pzt + ((size_t)i * n_b + b) * n_j * n_j;
    auto store_u = [&](int r, int j, float v) { u[r * n_j + j] = v; };
    if (vec) {
      rows_times_w<8, 4, true>(R, n_j, Jp, acc, w, stage, store_u);
    } else {
      rows_times_w<8, 4, false>(R, n_j, Jp, acc, w, stage, store_u);
    }
    __syncthreads();
#if SDFS_PAIR_SPLIT == 3
    for (int x = tid; x < R * n_j; x += nt)
      out[(x / n_j) * C + c0 + x % n_j] = u[x];
    continue;
#endif

    // 4. Linear carry.  Row r = (l, k) is rescaled by exp(m1 - M2[k] + 25)
    // (kept in m1), the l' result by exp(M2[k] - M3 + 25) (kept in M2).
    for (int k = tid; k < K; k += nt) {
      float m = -INFINITY;
      for (int l = 0; l < L; ++l) m = fmaxf(m, m1[l * K + k]);
      M2[k] = m;
    }
    __syncthreads();
    if (tid == 0) {
      float m = -INFINITY;
      for (int k = 0; k < K; ++k) m = fmaxf(m, M2[k]);
      M3[0] = m;
    }
    __syncthreads();
    const float m3 = M3[0];
    for (int r = tid; r < R; r += nt)
      m1[r] = expf(m1[r] - M2[r % K] + kPairBias);
    // W_r1 and W_r2 into the K-tile area (free after the z' product) when
    // they fit there, else read through L1.
    const float* wr1 = w_r1;
    const float* wr2 = w_r2;
    if (L * L + K * K <= 2 * kBK * n_j) {
      for (int x = tid; x < L * L; x += nt) stage[x] = __ldg(w_r1 + x);
      for (int x = tid; x < K * K; x += nt) stage[L * L + x] = __ldg(w_r2 + x);
      wr1 = stage;
      wr2 = stage + L * L;
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) M2[k] = expf(M2[k] - m3 + kPairBias);
    for (int r = warp; r < R; r += nw) {
      const float sr = m1[r];
      for (int j = lane; j < n_j; j += 32) u[r * n_j + j] *= sr;
    }
    __syncthreads();

    // l': z[l, k, j] = (sum_m W_r1[l, m] u[m, k, j]) * M2[k].  A thread
    // takes a column (k, j) and kRowTile output rows l at a time; the sum
    // runs in order of m.
    const int KJ = K * n_j;
    float* z = acc;
    for (int x = tid; x < KJ; x += nt) {
      const float s2 = M2[x / n_j];
      for (int l0 = 0; l0 < L; l0 += kRowTile) {
        float a[kRowTile];
#pragma unroll
        for (int t = 0; t < kRowTile; ++t) a[t] = 0.f;
        for (int m = 0; m < L; ++m) {
          const float v = u[m * KJ + x];
#pragma unroll
          for (int t = 0; t < kRowTile; ++t)
            if (l0 + t < L) a[t] = fmaf(wr1[(l0 + t) * L + m], v, a[t]);
        }
#pragma unroll
        for (int t = 0; t < kRowTile; ++t)
          if (l0 + t < L) z[(l0 + t) * KJ + x] = a[t] * s2;
      }
    }
    __syncthreads();

    // k' + epilogue: v[l, k, j] = sum_m W_r2[k, m] z[l, m, j], a thread
    // taking a column (l, j) and kRowTile output rows k at a time; lh =
    // log(v) + M3 - 75 + add_row + add_col, out = log1p(beta exp(lh /
    // theta)).
    const float bias3 = m3 - 3.f * kPairBias;
    for (int x = tid; x < L * n_j; x += nt) {
      const int l = x / n_j, j = x - l * n_j;
      const float* zc = z + l * KJ + j;          // z[l, m, j] at zc[m * n_j]
      const size_t c = c0 + j;
      const float ac = __ldg(add_col + c);
      for (int k0 = 0; k0 < K; k0 += kRowTile) {
        float a[kRowTile];
#pragma unroll
        for (int t = 0; t < kRowTile; ++t) a[t] = 0.f;
        for (int m = 0; m < K; ++m) {
          const float v = zc[m * n_j];
#pragma unroll
          for (int t = 0; t < kRowTile; ++t)
            if (k0 + t < K) a[t] = fmaf(wr2[(k0 + t) * K + m], v, a[t]);
        }
#pragma unroll
        for (int t = 0; t < kRowTile; ++t) {
          if (k0 + t < K) {
            const int r = l * K + k0 + t;
            const float lh = logf(a[t]) + bias3 + __ldg(add_row + r) + ac;
            out[r * C + c] = log1pf(beta * expf(lh / theta));
          }
        }
      }
    }
  }
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

// One launch of the resident deferred pass B: a persistent grid of
// min(items, co-resident blocks), BN columns per item.
template <bool HAS_SUB>
cudaError_t launch_pass_b_resident(const float* ell, const float* w_c1t,
                                   const float* sub_row, const float* sub_col,
                                   float* out, int R, int I, int J, int BN,
                                   float theta, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (size_t)pass_b_resident_smem_floats(I, BN);
  const int threads = pass_b_resident_threads(I, BN);
  cudaError_t err = prepare(pass_b_resident_kernel<HAS_SUB>, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = blocks_per_sm((const void*)pass_b_resident_kernel<HAS_SUB>, threads,
                      smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)R * ((J + BN - 1) / BN);
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(items < cap ? items : cap);
  pass_b_resident_kernel<HAS_SUB><<<grid, threads, smem, st>>>(
      ell, w_c1t, sub_row, sub_col, out, R, I, J, BN, theta);
  return cudaGetLastError();
}

// One launch of pass_b_mma_kernel<PASS_B, EPI, SCALE_B> on (e, w_c1t,
// colmax, out, R, I, J, e_scale): a persistent grid of min(tiles,
// co-resident blocks).
template <bool PASS_B, int EPI, bool SCALE_B = false>
cudaError_t launch_mma(const float* e, const float* w_c1t,
                       const float* colmax, float* out, int R, int I, int J,
                       cudaStream_t st, const float* e_scale = nullptr) {
  const auto kernel = pass_b_mma_kernel<PASS_B, EPI, SCALE_B>;
  const size_t smem =
      sizeof(float) * (size_t)mma_smem_floats(PASS_B, SCALE_B);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = blocks_per_sm((const void*)kernel, kMmaThreads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)((I + kMmaBM - 1) / kMmaBM) *
                          ((J + kMmaBN - 1) / kMmaBN) * R;
  if (tiles > INT_MAX / 2) return cudaErrorInvalidValue;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(tiles < cap ? tiles : cap);
  kernel<<<grid, kMmaThreads, smem, st>>>(e, w_c1t, colmax, out, R, I, J,
                                          e_scale);
  return cudaGetLastError();
}

// One launch of the tensor-core deferred pass B: the exp pass (the column
// maxima and e into the workspace), then the split-TF32 product.
template <bool HAS_SUB>
cudaError_t launch_pass_b_mma(const float* ell, const float* w_c1t,
                              const float* sub_row, const float* sub_col,
                              float* work, float* out, int R, int I, int J,
                              float theta, cudaStream_t st) {
  float* colmax = work;
  float* e = work + (size_t)R * J;     // 16-byte aligned when J % 4 == 0
  pass_b_exp_kernel<HAS_SUB><<<dim3((J + 31) / 32, R), 32 * kExpParts, 0,
                               st>>>(ell, sub_row, sub_col, colmax, e, I, J,
                                     theta);
  cudaError_t err = cudaGetLastError();
#if SDFS_DEFB_SPLIT == 1
  return err;
#endif
  if (err != cudaSuccess) return err;
  constexpr int kEpi = (SDFS_DEFB_SPLIT == 2 || SDFS_DEFB_SPLIT == 3)
                           ? kEpiLinear : kEpiColLog;
  return launch_mma<false, kEpi>(e, w_c1t, colmax, out, R, I, J, st);
}

// One launch of the c1 pass in its layout: a persistent grid of
// min(steps, co-resident blocks).
template <int MODE, bool C2, bool WRES>
cudaError_t launch_c1(const C1Layout& lay, const float* ell,
                      const float* w_c1, const float* sub_row,
                      const float* sub_col, const float* mid_col, float* out,
                      float* s, float* rshift, int R, int I, int J,
                      float theta, cudaStream_t st) {
  const auto kernel = pass_b_c1_kernel<MODE, C2, WRES>;
  const size_t smem = sizeof(float) * (size_t)lay.smem;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = blocks_per_sm((const void*)kernel, lay.threads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long steps = (R + lay.rb - 1) / lay.rb;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(steps < cap ? steps : cap);
  kernel<<<grid, lay.threads, smem, st>>>(ell, w_c1, sub_row, sub_col,
                                          mid_col, out, s, rshift, R, I, J,
                                          lay, theta);
  return cudaGetLastError();
}

template <int MODE, bool C2>
cudaError_t dispatch_c1(const C1Layout& lay, const float* ell,
                        const float* w_c1, const float* sub_row,
                        const float* sub_col, const float* mid_col,
                        float* out, float* s, float* rshift, int R, int I,
                        int J, float theta, cudaStream_t st) {
  return lay.wres ? launch_c1<MODE, C2, true>(lay, ell, w_c1, sub_row,
                                              sub_col, mid_col, out, s,
                                              rshift, R, I, J, theta, st)
                  : launch_c1<MODE, C2, false>(lay, ell, w_c1, sub_row,
                                               sub_col, mid_col, out, s,
                                               rshift, R, I, J, theta, st);
}

// One launch of the deferred or batched pass C: clusters of the layout's
// cs blocks, a grid of (cs * column tiles, slices).
template <bool FAST, int JK>
cudaError_t launch_slab(const SlabLayout& lay, const float* mid,
                        const float* scale, const float* S,
                        const float* w_c2t, size_t c2_stride,
                        const float* w_r1, const float* w_r2,
                        const float* add_row, const float* add_col,
                        float* out, int L, int K, int I, int J, float theta,
                        float beta, void* stream) {
  const size_t smem = sizeof(float) * (size_t)lay.smem_floats;
  cudaError_t err = prepare(pass_c_slab_kernel<FAST, JK>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lay.cs * cdiv(J, lay.tc), I);
  cfg.blockDim = dim3(lay.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lay.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pass_c_slab_kernel<FAST, JK>, mid, scale, S,
                           w_c2t, c2_stride, w_r1, w_r2, add_row, add_col,
                           out, L, K, J, lay.cs, lay.nk, lay.nl, lay.tc,
                           theta, beta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool FAST>
cudaError_t launch_pass_c_slab(const float* mid, const float* scale,
                               const float* S, const float* w_c2t,
                               size_t c2_stride, const float* w_r1,
                               const float* w_r2, const float* add_row,
                               const float* add_col, float* out, int L, int K,
                               int I, int J, float theta, float beta,
                               void* stream) {
  SlabLayout lay;
  if (!pass_c_slab_layout(L, K, J, &lay)) return cudaErrorInvalidValue;
  return lay.jk == 32
             ? launch_slab<FAST, 32>(lay, mid, scale, S, w_c2t, c2_stride,
                                     w_r1, w_r2, add_row, add_col, out, L, K,
                                     I, J, theta, beta, stream)
             : launch_slab<FAST, 16>(lay, mid, scale, S, w_c2t, c2_stride,
                                     w_r1, w_r2, add_row, add_col, out, L, K,
                                     I, J, theta, beta, stream);
}


}  // namespace

extern "C" {

// Pass B over R field rows of ell (R, I, J).  w_c1 (I, I); w_c2t (J, J)
// = W_c2 transposed, or null for c1 only; sub_row (R,) and sub_col (I, J)
// both given (the folded baseline) or both null; mid_col (I, J) or null
// (lse mode only); mid (R, I, J); s (R,) written in fast mode only; work
// holds sdfs_pass_b_work_floats(R, I, J, w_c2t != null) floats (null
// when that is 0).
int sdfs_pass_b(const float* ell, const float* w_c1, const float* w_c2t,
                const float* sub_row, const float* sub_col,
                const float* mid_col, float* mid, float* s, float* work,
                int R, int I, int J, float theta, int mode, void* stream) {
  C1Layout lay;
  if ((sub_row == nullptr) != (sub_col == nullptr) ||
      (mode != kModeFast && mode != kModeLse) ||
      (mode == kModeFast && mid_col != nullptr) || R <= 0 || I <= 0 ||
      J <= 0 || !pass_b_c1_layout(I, J, &lay))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fast = mode == kModeFast;
  if (w_c2t == nullptr)
    return fast ? dispatch_c1<kModeFast, false>(lay, ell, w_c1, sub_row,
                                                sub_col, nullptr, mid, s,
                                                nullptr, R, I, J, theta, st)
                : dispatch_c1<kModeLse, false>(lay, ell, w_c1, sub_row,
                                               sub_col, mid_col, mid, nullptr,
                                               nullptr, R, I, J, theta, st);
  if (work == nullptr) return cudaErrorInvalidValue;
  // The workspace: U (R*I, Jp), then the lse row shifts (R*I).
  float* U = work;
  float* rshift = work + (size_t)R * I * round_up4(J);
  cudaError_t err =
      fast ? dispatch_c1<kModeFast, true>(lay, ell, w_c1, sub_row, sub_col,
                                          nullptr, U, s, nullptr, R, I, J,
                                          theta, st)
           : dispatch_c1<kModeLse, true>(lay, ell, w_c1, sub_row, sub_col,
                                         mid_col, U, nullptr, rshift, R, I,
                                         J, theta, st);
#if SDFS_PASSB_SPLIT < 3
  return err;
#endif
  if (err != cudaSuccess) return err;
  if ((long long)R * I > INT_MAX) return cudaErrorInvalidValue;
  // mid (R*I, J) = U W_c2^T, the N tiles fastest.
  if (fast || SDFS_PASSB_SPLIT == 3)
    return launch_mma<true, kEpiLinear>(w_c2t, U, rshift, mid, 1, R * I, J,
                                        st);
  return launch_mma<true, kEpiRowLog>(w_c2t, U, rshift, mid, 1, R * I, J,
                                      st);
}

// Workspace floats of pass B at (R, I, J) with (c2 = 1) or without a
// shared c2: U (R*I rows of round_up4(J)) and the row shifts (R*I); 0
// without c2.
long long sdfs_pass_b_work_floats(int R, int I, int J, int c2) {
  if (!c2) return 0;
  return (long long)R * I * round_up4(J) + (long long)R * I;
}

// Pass B's layout at (I, J), as its launchers choose it (pass_b_layout
// mirrors it): lay = {rows per step, threads, slabs, W_c1^T resident,
// shared-memory bytes} of the c1 pass, then {rows, columns, K-chunk,
// ring stages, threads, shared-memory bytes} of the c2 product's tiles
// (11 ints).  Returns 0 when the c1 pass has no layout.
int sdfs_pass_b_layout(int I, int J, int* lay) {
  C1Layout c;
  if (!pass_b_c1_layout(I, J, &c)) return 0;
  const int v[11] = {c.rb, c.threads, c.slabs, c.wres,
                     (int)(sizeof(float) * (size_t)c.smem), kMmaBM, kMmaBN,
                     kMmaBK, kMmaStages, kMmaThreads,
                     (int)(sizeof(float) * (size_t)mma_smem_floats(true))};
  for (int k = 0; k < 11; ++k) lay[k] = v[k];
  return 1;
}

// Pass C with a shared c2 over mid (R = L*K, C) on the row-phase kernel
// (row_phase.cuh): mode 0 fast (scale (R,), S (1,)), mode 1 lse with the
// linear carry; add_row (L*K,), add_col (C,); out (R, C).
int sdfs_pass_c_row(const float* mid, const float* scale, const float* S,
                    const float* w_r1, const float* w_r2,
                    const float* add_row, const float* add_col, float* out,
                    int L, int K, int C, float theta, float beta, int mode,
                    void* stream) {
  if (mode != kModeFast && mode != kModeLse) return cudaErrorInvalidValue;
  return launch_row_phase(mid, scale, S, w_r1, w_r2, add_row, add_col, out,
                          L, K, C, theta, beta,
                          mode == kModeFast ? kRowFast : kRowCarry,
                          static_cast<cudaStream_t>(stream));
}

// Deferred-c2 pass B over R field rows of ell (R, I, J): c1 only.
// w_c1t (I, I) = W_c1 transposed; sub_row (R,) and sub_col (I, J) both
// given (a = theta*ell - sub_row[r] - sub_col[i, j]) or both null;
// work holds sdfs_pass_b_deferred_work_floats(R, I, J) floats (null when
// that is 0); out (R, I, J) log domain.
int sdfs_pass_b_deferred(const float* ell, const float* w_c1t,
                         const float* sub_row, const float* sub_col,
                         float* work, float* out, int R, int I, int J,
                         float theta, void* stream) {
  if ((sub_row == nullptr) != (sub_col == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bn = pass_b_resident_bn(I, J);
  if (bn > 0)
    return sub_row != nullptr
               ? launch_pass_b_resident<true>(ell, w_c1t, sub_row, sub_col,
                                              out, R, I, J, bn, theta, st)
               : launch_pass_b_resident<false>(ell, w_c1t, nullptr, nullptr,
                                               out, R, I, J, bn, theta, st);
  if (work == nullptr || R > 65535) return cudaErrorInvalidValue;
  return sub_row != nullptr
             ? launch_pass_b_mma<true>(ell, w_c1t, sub_row, sub_col, work,
                                       out, R, I, J, theta, st)
             : launch_pass_b_mma<false>(ell, w_c1t, nullptr, nullptr, work,
                                        out, R, I, J, theta, st);
}

// Workspace floats of the deferred pass B at (R, I, J): the tensor-core
// layout's column maxima (R*J) and exponentials (R*I*J); 0 for the
// resident layout.
long long sdfs_pass_b_deferred_work_floats(int R, int I, int J) {
  if (pass_b_resident_bn(I, J) > 0) return 0;
  return (long long)R * J + (long long)R * I * J;
}

// Deferred-c2 pass C over mid (R = L*K, I*J) log domain: c2 with
// w_c2t (J, J) = W_c2 transposed, then the row phase and the epilogue,
// in the layout of pass_c_slab_layout.  add_row (L*K,), add_col (I*J,);
// out (R, I*J).
int sdfs_pass_c_deferred(const float* mid, const float* w_c2t,
                         const float* w_r1, const float* w_r2,
                         const float* add_row, const float* add_col,
                         float* out, int L, int K, int I, int J, float theta,
                         float beta, void* stream) {
  return launch_pass_c_slab<false>(mid, nullptr, nullptr, w_c2t, 0, w_r1,
                                   w_r2, add_row, add_col, out, L, K, I, J,
                                   theta, beta, stream);
}

// Batched pass C over mid (R = L*K, I*J): linear (mode fast; scale (R,),
// S (1,)) or log domain (mode lse; scale and S unused).  w_c2t (I, J, J)
// = P_z[i] transposed per slice; otherwise as sdfs_pass_c_deferred.
int sdfs_pass_c_batched(const float* mid, const float* scale, const float* S,
                        const float* w_c2t, const float* w_r1,
                        const float* w_r2, const float* add_row,
                        const float* add_col, float* out, int L, int K,
                        int I, int J, float theta, float beta, int mode,
                        void* stream) {
  const size_t stride = (size_t)J * J;
  if (mode == kModeFast)
    return launch_pass_c_slab<true>(mid, scale, S, w_c2t, stride, w_r1,
                                    w_r2, add_row, add_col, out, L, K, I, J,
                                    theta, beta, stream);
  if (mode == kModeLse)
    return launch_pass_c_slab<false>(mid, nullptr, nullptr, w_c2t, stride,
                                     w_r1, w_r2, add_row, add_col, out, L, K,
                                     I, J, theta, beta, stream);
  return cudaErrorInvalidValue;
}

// The deferred and batched pass C's layout at (L, K, J), as its launcher
// chooses it (pass_c_deferred_layout mirrors it): lay = {cluster size,
// column tile, chunk columns, threads, shared-memory bytes}; 0 when no
// layout fits.
int sdfs_pass_c_deferred_layout(int L, int K, int J, int* lay) {
  SlabLayout s;
  if (!pass_c_slab_layout(L, K, J, &s)) return 0;
  lay[0] = s.cs;
  lay[1] = s.tc;
  lay[2] = s.jk;
  lay[3] = s.threads;
  lay[4] = (int)(sizeof(float) * (size_t)s.smem_floats);
  return 1;
}

// Pair pass C over mid (R = L*K, n_i*n_y*n_b*n_j) log domain: per c1
// slice, the conditioned (z_pi, z) contraction with p_zpi (n_y, n_b, n_b)
// and pzt (n_i, n_b, n_j, n_j) = P_z[i, j, b, J] as [i, b, J, j], then
// the row phase and the epilogue.  add_row (L*K,), add_col (C,);
// out (R, C).
int sdfs_pass_c_pair(const float* mid, const float* p_zpi, const float* pzt,
                     const float* w_r1, const float* w_r2,
                     const float* add_row, const float* add_col, float* out,
                     int L, int K, int n_i, int n_y, int n_b, int n_j,
                     float theta, float beta, void* stream) {
  const size_t smem =
      sizeof(float) * (size_t)pass_c_pair_smem_floats(L * K, K, n_j);
  const int cs = pair_cluster_size(n_b);
  cudaError_t err = prepare(pass_c_pair_kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, n_i * n_y);
  cfg.blockDim = dim3(kPairThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pass_c_pair_kernel, mid, p_zpi, pzt, w_r1,
                           w_r2, add_row, add_col, out, L, K, n_i, n_y, n_b,
                           n_j, theta, beta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The deferred pass B's layout at (I, J), as its launcher chooses it
// (pass_b_deferred_layout mirrors it): lay = {0 resident or 1 tensor
// cores, columns per item or tile, threads, shared-memory bytes, rows per
// tile, rows m per K-chunk, ring stages} (7 ints; the last three 0 for
// the resident layout).  Returns 1.
int sdfs_pass_b_deferred_layout(int I, int J, int* lay) {
  const int bn = pass_b_resident_bn(I, J);
  if (bn > 0) {
    const int v[7] = {0, bn, pass_b_resident_threads(I, bn),
                      (int)(sizeof(float) *
                            (size_t)pass_b_resident_smem_floats(I, bn)),
                      0, 0, 0};
    for (int k = 0; k < 7; ++k) lay[k] = v[k];
    return 1;
  }
  const int v[7] = {1, kMmaBN, kMmaThreads,
                    (int)(sizeof(float) * kMmaSmemFloats), kMmaBM, kMmaBK,
                    kMmaStages};
  for (int k = 0; k < 7; ++k) lay[k] = v[k];
  return 1;
}

// ------------------------------------------------------- tangent passes
//
// Newton's tangent of the operator with shared column factors is, per
// Krylov matvec, the chain (ops/tangent.py; F1..F5 the field-sized
// float32 factors its tape stores, v the direction, fields (R, I, J) =
// (R, C), R = L*K, C = I*J):
//
//   x2 = F2 * c1(F1 * v)      c1: contract i' with W_c1 per field row
//   x3 = F3 * c2(x2)          c2: contract j' with W_c2
//   out = F5 * r2(F4 * r1(x3))  (- v, Newton's J v - v, where asked)
//
// No exp, log or maximum: the stages' shifts are in the factors.  Three
// launches of the primal's kernels in tangent cases, each factor product
// in the prologue or epilogue of a contraction pass:
//
//   1. c1 and F2 (the c2 product's operand U, R*I rows of Jp =
//      round_up4(J), zeros past J), in the primal's pass-B split: "full"
//      (I small, the c1 pass's layout exists) pass_b_c1_kernel<
//      kModeTangent, true, .>, F1 applied in place after the copy and F2
//      at the store; "deferred" (I = 512 at the GCY view)
//      pass_b_mma_kernel<false, kEpiScale, true>, the deferred pass B's
//      split-TF32 product with F1 applied at the split and F2 at the
//      store (J % 4 == 0: U unpadded);
//   2. c2 and F3: pass_b_mma_kernel<true, kEpiScale>, pass B's product;
//   3. r1, F4, r2, F5 (- v): strip_row_kernel<kRowTangent, .>
//      (row_phase.cuh), F4 at r1's store back and F5 at r2's.
//
// Contractions stay FP32-accurate: FP32 FMA, or three-product split TF32
// (|x - hi - lo| <= 2^-22 |x|).  The tangent's terms take both signs, so a
// sum may cancel; its rounding is then that of an FP32 FMA sum of the
// same terms, a few ulps of sum |term|.  What bounds a matvec on an H100:
// c2's 2*R*I*J*J FLOP (9.66 G at SSY's (32,32,32,384): 0.059 ms in split
// TF32), the c1 product at the GCY view (25.8 G), and seven fields of
// bytes (0.105 ms at SSY, 0.21 at the GCY view).
//
// Arguments: v and the factors f1, f2 (R, I, J), f3, f4, f5 (R, C), all
// float32, contiguous and 16-byte aligned; w_c1 (I, I) for split 0
// ("full": the c1 pass) or w_c1t = W_c1 transposed for split 1
// ("deferred": the c1 product on the tensor cores, J % 4 == 0); w_c2t
// (J, J); w_r1 (L, L), w_r2 (K, K).  u holds R*I*round_up4(J) floats (the
// c2 product's operand), x3 R*C; out (R, C) may be u when J % 4 == 0 (u
// is read only by the c2 product).  minus: out = J v - v, else J v.
int sdfs_tangent_chain(const float* v, const float* f1, const float* f2,
                       const float* f3, const float* f4, const float* f5,
                       const float* w_c1, const float* w_c1t,
                       const float* w_c2t, const float* w_r1,
                       const float* w_r2, float* u, float* x3, float* out,
                       int L, int K, int I, int J, int split, int minus,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = L * K;
  const long long rows = (long long)R * I;
  RowLayout row;
  if (L <= 0 || K <= 0 || I <= 0 || J <= 0 || rows > INT_MAX ||
      rows * J > INT_MAX || !strip_row_layout(L, K, &row))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (split == 0) {
    C1Layout lay;
    if (w_c1 == nullptr || !pass_b_c1_layout(I, J, &lay))
      return cudaErrorInvalidValue;
    err = dispatch_c1<kModeTangent, true>(lay, v, w_c1, f1, f2, nullptr, u,
                                          nullptr, nullptr, R, I, J, 0.f,
                                          st);
  } else if (split == 1) {
    if (w_c1t == nullptr || J % 4 != 0) return cudaErrorInvalidValue;
    err = launch_mma<false, kEpiScale, true>(v, w_c1t, f2, u, R, I, J, st,
                                             f1);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  err = launch_mma<true, kEpiScale>(w_c2t, u, f3, x3, 1, R * I, J, st);
  if (err != cudaSuccess) return err;
  // The row kernel's tangent case: scale = F4, add_row = F5, S = v (J v -
  // v) or null.
  return launch_row<kRowTangent>(row, x3, f4, minus ? v : nullptr, w_r1,
                                 w_r2, f5, nullptr, out, L, K, I * J, 0.f,
                                 0.f, st);
}

const char* sdfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
