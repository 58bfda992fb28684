// Streamed two-phase operator kernels for NVIDIA Hopper (sm_90a).
//
// The two-phase operator log T(w) (discrete SSY; continuous SSY, whose c2
// factor P_z[i] is batched over the current c1 index, see pass_c_batched
// further down; discrete GCY through its Kronecker grouping, see
// pass_b_deferred; continuous GCY, see pass_c_pair at the end) on a field
// ell[r, c] with rows r = (h_lam, h_c) = (l, k) and columns
// c = (h_z, z) = (i, j) runs as two passes over the field:
//
//   pass B (column phase), one block per field row r:
//     a = theta * ell[r] (I, J), or with a folded baseline
//     a = fma(theta, ell, -sub_row[r]) - sub_col[i, j]; contract i' with
//     W_c1, add the conjugated-shared correction mid_col[i, j] (HAS_MID,
//     lse mode only), then contract j' with a shared W_c2 (C2_HERE) or
//     not at all (a batched c2 contracts in pass_c_batched).  Replaces
//     sdfs_via_autodiff_tpu/kernels/streamed_two_phase.py:324 (_b_kernel):
//     c2_here, has_sub and has_mid both ways.
//   pass C (row phase), one block per tile of TC consecutive columns
//     holding all R = L*K rows: contract l' with W_r1, then k' with W_r2,
//     add add_row[l, k] + add_col[c], epilogue log1p(beta*exp(lh/theta)).
//     Replaces streamed_two_phase.py:446 (_c_kernel) without batched or
//     deferred c2 (the deferred branch is pass_c_deferred, further down).
//
// mode 0 ("fast"): pass B takes one shift per field row, s_r = max a, and
// emits the linear midway field W_c1 exp(a - s_r) W_c2^T with s; pass C
// rescales row r by scale[r] = exp(s_r - S), S = max_r s_r, and adds S
// back after the last log.  mode 1 ("lse"): per-axis log-sum-exp shifts
// at every contraction; pass C carries its two row contractions linearly
// with low-rank rescales (the linear-carry LSE of the TPU kernel).
//
// What bounds these kernels on an H100: the contractions are FP32 FMA
// chains (no tensor cores: TF32's 10-bit mantissa misses the 1e-6-class
// one-application bar) at O(N * (I + J)) and O(N * (L + K)) FLOPs, about
// 12 GFLOP per application at 32x32x32x384, against 200 MB of field
// traffic: the FMA pipe and shared-memory load slots, not HBM, are the
// limit.  The design keeps every intermediate of a phase in shared memory
// (one read and one write of the field per pass) and register-tiles each
// contraction (several outputs per thread) so that each shared-memory
// load feeds several FMAs.  The small factors are read through L1.  W_c2
// is J*J*4 = 576 KB at J = 384, beyond the 227 KB a block may hold, so
// pass B's j' contraction (~90% of its FLOPs) streams it from L2, where
// it stays resident, in 16-row K-tiles through the pass's first buffer
// (free by then), the next tile's cp.async copy overlapping the current
// tile's FMAs.  Ragged shapes (I = 56, J not a multiple of 4, TC not
// dividing C) are clamped and masked.  Transcendentals are CUDA's
// expf/logf/log1pf, built without fast-math.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError(); the Python wrappers validate every argument.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "occupancy.cuh"

namespace {

constexpr int kModeFast = 0;
constexpr int kModeLse = 1;
constexpr int kPassBThreads = 256;
constexpr int kPassCThreads = 512;
constexpr int kTI = 8;   // output rows per thread in a contraction
constexpr int kTJ = 4;   // output columns per thread in a contraction

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the block; every thread gets the result.  scratch holds 32
// floats.
__device__ float block_max(float v, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? scratch[threadIdx.x] : -INFINITY;
  if (warp == 0) {
    v = warp_max(v);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  const float r = scratch[0];
  __syncthreads();
  return r;
}

// out[i, n] = sum_m A[i, m] * B[m, n] for i < I, n < N, by the whole
// block.  Each thread owns kTI rows and kTJ columns n = q0 + q * nq
// (nq = ceil(N / kTJ)), so neighbouring threads touch neighbouring
// columns (coalesced global loads, conflict-free shared loads) while the
// A loads are broadcasts.  Out-of-range rows and columns are clamped for
// the loads and skipped at the store.  The sum runs in order of m.
template <class LoadA, class LoadB, class Store>
__device__ __forceinline__ void block_matmul(int I, int N, int M,
                                             LoadA load_a, LoadB load_b,
                                             Store store) {
  const int nq = (N + kTJ - 1) / kTJ;
  const int n_items = nq * ((I + kTI - 1) / kTI);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int q0 = item % nq, i0 = (item / nq) * kTI;
    int ii[kTI], nn[kTJ];
#pragma unroll
    for (int t = 0; t < kTI; ++t) ii[t] = min(i0 + t, I - 1);
#pragma unroll
    for (int q = 0; q < kTJ; ++q) nn[q] = min(q0 + q * nq, N - 1);
    float acc[kTI][kTJ];
#pragma unroll
    for (int t = 0; t < kTI; ++t)
#pragma unroll
      for (int q = 0; q < kTJ; ++q) acc[t][q] = 0.f;
    for (int m = 0; m < M; ++m) {
      float b[kTJ];
#pragma unroll
      for (int q = 0; q < kTJ; ++q) b[q] = load_b(m, nn[q]);
#pragma unroll
      for (int t = 0; t < kTI; ++t) {
        const float a = load_a(ii[t], m);
#pragma unroll
        for (int q = 0; q < kTJ; ++q) acc[t][q] = fmaf(a, b[q], acc[t][q]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTI; ++t)
#pragma unroll
      for (int q = 0; q < kTJ; ++q) {
        const int i = i0 + t, n = q0 + q * nq;
        if (i < I && n < N) store(i, n, acc[t][q]);
      }
  }
}

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

constexpr int kBK = 16;  // W_c2 rows per K-tile of pass B's j' contraction

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// out[i, j] = sum_m u[i, m] * w[m, j] for one field row (i < I, j < J):
// pass B's j' contraction, ~90% of its FLOPs.  W (J, J) streams from L2
// through two shared K-tiles of kBK rows (`stage`, 2 * kBK * J floats),
// the next tile's cp.async copy overlapping the current tile's FMAs.
// Each thread owns TI rows and TJ columns n = q0 + q * nq; u (row stride
// Jp = round_up4(J), zero-padded) is read as float4 broadcasts along m,
// W tiles as conflict-free rows.  Tile rows past J are zero-filled so
// the padded m add exact zeros.  The sum runs in order of m.
//
// VEC16 (pass_c_pair, J % 4 == 0 and w 16-byte aligned) copies the tiles
// in 16-byte pieces; pass B keeps its 4-byte copies.
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
      cp_async_wait_prev();            // this thread's copies of `tile`
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

// Floats of pass B's first buffer: the (I, J) field slice, later the two
// K-tiles of W_c2 (rounded to a float4 boundary).
__host__ __device__ inline int pass_b_a_floats(int I, int J) {
  const int tiles = 2 * kBK * J;
  return round_up4(I * J > tiles ? I * J : tiles);
}

// Shared-memory floats of pass B: the first buffer, u (I rows of
// Jp = round_up4(J)), one shift vector, and the block-reduction scratch.
__host__ __device__ inline int pass_b_smem_floats(int I, int J) {
  return pass_b_a_floats(I, J) + I * round_up4(J) + (I > J ? I : J) + 32;
}

// Shared-memory floats of pass C: x and y (R*TC each), the per-(k, t)
// and per-t lse shifts.
__host__ __device__ inline int pass_c_smem_floats(int L, int K, int TC) {
  return 2 * L * K * TC + K * TC + TC;
}

// HAS_SUB: subtract the folded baseline first.  HAS_MID (lse mode): add
// mid_col[i, j] to the log-domain c1 result, (shift + log) + mid as the
// TPU kernel rounds it.  C2_HERE: contract j' with the shared W_c2 after
// i'; without it the block writes the c1 result (linear in fast mode,
// log domain in lse mode) and stops.
template <int MODE, bool HAS_SUB, bool C2_HERE, bool HAS_MID>
__global__ void __launch_bounds__(kPassBThreads)
pass_b_kernel(const float* __restrict__ ell, const float* __restrict__ w_c1,
              const float* __restrict__ w_c2t,
              const float* __restrict__ sub_row,
              const float* __restrict__ sub_col,
              const float* __restrict__ mid_col, float* __restrict__ mid,
              float* __restrict__ s_out, int I, int J, float theta) {
  static_assert(!HAS_MID || MODE == kModeLse, "mid_col needs lse mode");
  extern __shared__ float smem[];     // 16-byte aligned base
  const int IJ = I * J, Jp = round_up4(J);
  float* a = smem;                   // (I, J): theta*ell, then exp(a - shift)
  float* u = a + pass_b_a_floats(I, J);  // (I, Jp): after c1
  float* shift = u + I * Jp;         // (max(I, J)): per-column, then per-row
  float* scratch = shift + (I > J ? I : J);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t r = blockIdx.x;
  const float* ell_r = ell + r * IJ;
  float* mid_r = mid + r * IJ;

  // With a folded baseline, one rounding before the cancellation down to
  // O(1), as pass_b_deferred_kernel<true> and the plain version compute it.
  const float sr = HAS_SUB ? __ldg(sub_row + r) : 0.f;
  for (int x = tid; x < IJ; x += nt)
    a[x] = HAS_SUB ? __fsub_rn(__fmaf_rn(theta, ell_r[x], -sr),
                               __ldg(sub_col + x))
                   : theta * ell_r[x];
  if (C2_HERE)
    for (int x = tid; x < I * (Jp - J); x += nt)      // zero u's padding
      u[(x / (Jp - J)) * Jp + J + x % (Jp - J)] = 0.f;
  __syncthreads();

  if (MODE == kModeFast) {
    float m = -INFINITY;
    for (int x = tid; x < IJ; x += nt) m = fmaxf(m, a[x]);
    const float s = block_max(m, scratch);
    for (int x = tid; x < IJ; x += nt) a[x] = expf(a[x] - s);
    if (tid == 0) s_out[r] = s;
  } else {
    for (int j = tid; j < J; j += nt) {
      float m = -INFINITY;
      for (int i = 0; i < I; ++i) m = fmaxf(m, a[i * J + j]);
      shift[j] = m;
    }
    __syncthreads();
    for (int x = tid; x < IJ; x += nt) a[x] = expf(a[x] - shift[x % J]);
  }
  __syncthreads();

  // c1: u[i, j] = sum_m W_c1[i, m] a[m, j] (to mid without C2_HERE).
  block_matmul(
      I, J, I,
      [&](int i, int m) { return __ldg(w_c1 + i * I + m); },
      [&](int m, int j) { return a[m * J + j]; },
      [&](int i, int j, float v) {
        float o = (MODE == kModeFast) ? v : shift[j] + logf(v);
        if (HAS_MID) o += __ldg(mid_col + i * J + j);
        if (C2_HERE) {
          u[i * Jp + j] = o;
        } else {
          mid_r[i * J + j] = o;
        }
      });
  if constexpr (!C2_HERE) return;
  __syncthreads();

  if (MODE == kModeLse) {
    const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
    for (int i = warp; i < I; i += nw) {
      float m = -INFINITY;
      for (int j = lane; j < J; j += 32) m = fmaxf(m, u[i * Jp + j]);
      m = warp_max(m);
      if (lane == 0) shift[i] = m;
    }
    __syncthreads();
    for (int x = tid; x < IJ; x += nt) {
      const int i = x / J, j = x % J;
      u[i * Jp + j] = expf(u[i * Jp + j] - shift[i]);
    }
    __syncthreads();
  }

  // c2: mid[r, i, j] = sum_m W_c2[j, m] u[i, m] = sum_m u[i, m] W_c2t[m, j].
  auto store = [&](int i, int j, float v) {
    mid_r[i * J + j] = (MODE == kModeFast) ? v : shift[i] + logf(v);
  };
  // Tile shapes by J: one round of 256 items at J = 384 (16 x 3 outputs
  // per thread); 8 x 2 keeps ~200 items busy at J = 64.  `a` is free now
  // and holds the W_c2 K-tiles.
  if (J >= 256) {
    rows_times_w<16, 3>(I, J, Jp, u, w_c2t, a, store);
  } else {
    rows_times_w<8, 2>(I, J, Jp, u, w_c2t, a, store);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kPassCThreads)
pass_c_kernel(const float* __restrict__ mid, const float* __restrict__ scale,
              const float* __restrict__ S, const float* __restrict__ w_r1,
              const float* __restrict__ w_r2,
              const float* __restrict__ add_row,
              const float* __restrict__ add_col, float* __restrict__ out,
              int L, int K, int C, int TC, float theta, float beta) {
  extern __shared__ float smem[];
  const int R = L * K, KT = K * TC;
  float* x = smem;              // (L, K, TC): the midway tile
  float* y = x + R * TC;        // (L, K, TC): after the l' contraction
  float* m1 = y + R * TC;       // (K, TC): lse shift over l
  float* m2 = m1 + KT;          // (TC): lse shift over k
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c0 = blockIdx.x * TC;
  const int tcw = min(TC, C - c0);

  for (int idx = tid; idx < R * TC; idx += nt) {
    const int r = idx / TC, t = idx % TC;
    float v = (t < tcw) ? mid[(size_t)r * C + c0 + t] : 0.f;
    if (MODE == kModeFast) v *= __ldg(scale + r);
    x[idx] = v;
  }
  __syncthreads();

  if (MODE == kModeLse) {
    for (int col = tid; col < KT; col += nt) {
      float m = -INFINITY;
      for (int l = 0; l < L; ++l) m = fmaxf(m, x[l * KT + col]);
      m1[col] = m;
    }
    __syncthreads();
    for (int t = tid; t < TC; t += nt) {
      float m = -INFINITY;
      for (int k = 0; k < K; ++k) m = fmaxf(m, m1[k * TC + t]);
      m2[t] = m;
    }
    for (int idx = tid; idx < R * TC; idx += nt)
      x[idx] = expf(x[idx] - m1[idx % KT]);
    __syncthreads();
  }

  // r1: y[l, k, t] = sum_m W_r1[l, m] x[m, k, t]; in lse mode the carry
  // rescale exp(m1[k, t] - m2[t]) rides the store.
  block_matmul(
      L, KT, L,
      [&](int l, int m) { return __ldg(w_r1 + l * L + m); },
      [&](int m, int col) { return x[m * KT + col]; },
      [&](int l, int col, float v) {
        if (MODE == kModeLse) v *= expf(m1[col] - m2[col % TC]);
        y[l * KT + col] = v;
      });
  __syncthreads();

  // r2 + epilogue: z[l, k, t] = sum_m W_r2[k, m] y[l, m, t], columns
  // n = l * TC + t.
  const float shift0 = (MODE == kModeFast) ? __ldg(S) : 0.f;
  block_matmul(
      K, L * TC, K,
      [&](int k, int m) { return __ldg(w_r2 + k * K + m); },
      [&](int m, int n) { return y[(n / TC) * KT + m * TC + n % TC]; },
      [&](int k, int n, float v) {
        const int l = n / TC, t = n % TC;
        if (t >= tcw) return;
        const int r = l * K + k;
        const float lh = logf(v) + (MODE == kModeFast ? shift0 : m2[t]) +
                         __ldg(add_row + r) + __ldg(add_col + c0 + t);
        out[(size_t)r * C + c0 + t] = log1pf(beta * expf(lh / theta));
      });
}

// ------------------------------------------------- deferred-c2 passes
//
// Column groups too large for one block's (I, J) row slice (the GCY
// Kronecker grouping's 512 x 256 at the 25.2M-point grid) split the
// column phase: pass B contracts c1 only, and the shared c2 contraction
// moves into pass C, in front of its row phase.
//
//   pass_b_deferred, one block per (field row r, tile of kDefBN columns
//     j): a = theta * ell[r, :, j-tile] (I, kDefBN) in shared memory,
//     less the folded baseline sub_row[r] + sub_col[i, j] when one is
//     given, per-column shift m[j] = max over all I rows, then
//     out[r, i, j] = m[j] + log(sum_m W_c1[i, m] exp(a[m, j] - m[j])).
//     Replaces streamed_two_phase.py:384 (_b_kernel_deferred), both
//     branches of has_sub.
//   pass_c_deferred, one block per (c1 slice i, tile of TC columns j of
//     the slice) holding all R rows: per-(row, slice) shift m1 over the
//     slice's J values, the c2 contraction exp(w - m1) W_c2^T into an
//     (R, TC) accumulator, then the linear-carry row phase with the
//     shifts M2 = max_l m1 and M3 = max_k M2, log + M3, add_row + add_col
//     and the epilogue.  Replaces the c2_deferred branch of
//     streamed_two_phase.py:446 (_c_kernel, lines 474-480 and 506-524).
//   pass_c_batched (continuous SSY): the same kernel with each slice i
//     contracted against its own factor P_z[i] (W_c2^T of slice i at
//     w_c2t + i * J * J, indexed directly: no block-diagonal maps), after
//     pass_b_kernel's c1-only branch.  In lse mode exactly the deferred
//     recipe; in fast mode the input is pass B's linear c1 result, row r
//     scaled by scale[r] = exp(s_r - S), no shifts and no carries, and S
//     is added back after the log.  Replaces the c2_batched branch of
//     _c_kernel (lines 474-485, 525-539), which JAX feeds block-diagonal
//     (TC, TC) maps (blockdiag_z, :832) so that a block's TC/J slices
//     contract as one MXU dot.  At continuous SSY's (56, 56, 56, 64) one
//     slice's (R, J) field is 803 KB, 3.5x what a block may hold, and the
//     (R, TC) accumulator leaves room for TC = JK = 4 only: each slice is
//     streamed through 16 blocks (read once from HBM, 15 times from L2),
//     each block alone on its SM, so it runs 512 threads in the SPREAD
//     layout (below).
//     Its c2 products are 2*R*I*J*J = 1.44 GFLOP and the row phase 2.52
//     against 90 MB of fields: FP32 FMA bounds it, as the deferred pass.
//     Pass B's c1-only branch there is 1.26 GFLOP against the same 90 MB:
//     HBM bounds that one.
//
// What bounds them on an H100: FP32 FMA.  At (12, 16, 512, 256) pass B
// is 2*R*I*I*J = 25.8 GFLOP and pass C 2*R*I*J*J = 12.9 GFLOP against
// 100 MB fields.  W_c1 (I*I*4 = 1 MiB) does not fit a block, so pass B
// streams its transpose from L2 in kDefBK-row K-tiles (cp.async, double
// buffered) while the exponentiated (I, kDefBN) strip stays resident;
// each thread owns an 8 x 8 output tile, so four float4 shared-memory
// loads feed 64 FMAs (the balance point of the SM's shared-memory
// wavefronts and its FMA rate).  Pass C cannot hold
// a whole slice (R*J*4 = 196 KB) next to its accumulator, so it streams
// the slice in JK-column chunks (cp.async copies, the next chunk's
// overlapping the current chunk's FMAs; exponentiated into a transposed
// copy for float4 row loads) against JK x TC chunks of W_c2^T; the
// blocks of one slice are adjacent in the grid, so the slice is read
// from HBM once and from L2 by the others.  Ragged I, J
// and partial tiles are clamped and masked.

// SDFS_DEFB_SPLIT (compile-time, for timing the phases of
// pass_b_deferred; 4, the default, is the kernel): 1 stops after the fold
// and the column maxima, 2 after the exponentials, 3 after the c1
// product; 1-3 store that phase's result in place of the output.
#ifndef SDFS_DEFB_SPLIT
#define SDFS_DEFB_SPLIT 4
#endif

constexpr int kDefThreads = 256;
constexpr int kDefBN = 32;   // pass-B-deferred columns per block
constexpr int kDefBK = 8;    // W_c1^T rows per pass-B-deferred K-tile
constexpr int kDefParts = kDefThreads / kDefBN;  // partial column maxima
constexpr int kDefBT = 8;    // pass-B-deferred thread tile: 8 rows x 8 columns
constexpr int kDefTM = 8;    // pass-C-deferred c2 tile: rows per thread
constexpr int kDefTN = 4;    //   and columns per thread
constexpr int kSpreadThreads = 512;  // pass C, a block alone on its SM
// Shared memory above which a slice pass-C block is alone on its SM
// (228 KB per SM, 1 KB of it reserved per resident block).
constexpr size_t kHalfSmBytes = 233472 / 2 - 1024;

// Shared-memory floats of pass_b_deferred: the (I, kDefBN) strip, two
// K-tiles of kDefBK rows of Ip = round_up4(I), partial column maxima and
// the shifts.
__host__ __device__ inline int pass_b_deferred_smem_floats(int I) {
  return I * kDefBN + 2 * kDefBK * round_up4(I) + kDefParts * kDefBN +
         kDefBN;
}

// Row stride of pass_c_deferred's transposed chunk (rows r); the +4
// spreads the transposing stores over banks, the rounding keeps float4
// loads aligned.
__host__ __device__ inline int pass_c_deferred_rstride(int R) {
  return round_up4(R) + 4;
}

// Floats of pass_c_deferred's region that holds the transposed
// exponentiated chunk (JK rows) during the c2 contraction and the r1
// result (R, TC) after it.
__host__ __device__ inline int pass_c_deferred_et_floats(int R, int TC,
                                                         int JK) {
  const int et = JK * pass_c_deferred_rstride(R);
  return et > R * TC ? et : R * TC;
}

// Shared-memory floats of pass_c_deferred: the accumulator (R, TC), the
// et / r1 region, the raw input chunk (R, JK), the W_c2^T chunk
// (JK, TC), m1 (R), M2 (K) and M3.
__host__ __device__ inline int pass_c_deferred_smem_floats(int L, int K,
                                                           int TC, int JK) {
  const int R = L * K;
  return R * TC + pass_c_deferred_et_floats(R, TC, JK) + R * JK + JK * TC +
         round_up4(R) + round_up4(K) + 4;
}

template <bool HAS_SUB>
__global__ void __launch_bounds__(kDefThreads)
pass_b_deferred_kernel(const float* __restrict__ ell,
                       const float* __restrict__ w_c1t,
                       const float* __restrict__ sub_row,
                       const float* __restrict__ sub_col,
                       float* __restrict__ out, int I, int J, float theta) {
  extern __shared__ float smem[];     // 16-byte aligned base
  const int Ip = round_up4(I);
  float* e = smem;                        // (I, kDefBN)
  float* stage = e + I * kDefBN;          // 2 x (kDefBK, Ip)
  float* part = stage + 2 * kDefBK * Ip;  // (kDefParts, kDefBN)
  float* shift = part + kDefParts * kDefBN;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int j0 = blockIdx.x * kDefBN;
  const int jw = min(kDefBN, J - j0);
  const size_t IJ = (size_t)I * J;
  const float* ell_r = ell + blockIdx.y * IJ;
  float* out_r = out + blockIdx.y * IJ;

  // a = theta * ell, or fma(theta, ell, -sub_row[r]) - sub_col[m, j]
  // with a folded baseline (one rounding before the cancellation down to
  // O(1), as the plain version computes it), on the strip; columns past
  // J hold 0 (never stored).  Unrolled so that several loads are in
  // flight per thread.
  const float sr = HAS_SUB ? __ldg(sub_row + blockIdx.y) : 0.f;
#pragma unroll 8
  for (int x = tid; x < I * kDefBN; x += nt) {
    const int m = x / kDefBN, jj = x % kDefBN;
    float v = 0.f;
    if (jj < jw) {
      const size_t at = (size_t)m * J + j0 + jj;
      v = HAS_SUB ? __fsub_rn(__fmaf_rn(theta, ell_r[at], -sr),
                              __ldg(sub_col + at))
                  : theta * ell_r[at];
    }
    e[x] = v;
  }
  __syncthreads();
  {
    const int jj = tid % kDefBN, p = tid / kDefBN;
    float mx = -INFINITY;
#pragma unroll 8
    for (int m = p; m < I; m += kDefParts) mx = fmaxf(mx, e[m * kDefBN + jj]);
    part[p * kDefBN + jj] = mx;
  }
  __syncthreads();
  if (tid < kDefBN) {
    float mx = part[tid];
    for (int p = 1; p < kDefParts; ++p) mx = fmaxf(mx, part[p * kDefBN + tid]);
    shift[tid] = mx;
  }
  __syncthreads();
#if SDFS_DEFB_SPLIT == 1
  for (int x = tid; x < I * kDefBN; x += nt)
    if (x % kDefBN < jw)
      out_r[(size_t)(x / kDefBN) * J + j0 + x % kDefBN] = shift[x % kDefBN];
  return;
#endif
#pragma unroll 8
  for (int x = tid; x < I * kDefBN; x += nt)
    e[x] = expf(e[x] - shift[x % kDefBN]);
#if SDFS_DEFB_SPLIT == 2
  for (int x = tid; x < I * kDefBN; x += nt)
    if (x % kDefBN < jw)
      out_r[(size_t)(x / kDefBN) * J + j0 + x % kDefBN] = e[x];
  return;
#endif

  // c1: out[i, j] = shift[j] + log(sum_m W_c1t[m, i] e[m, j]).  Thread
  // (rg, cg) owns the kDefBT x kDefBT tile of rows kDefBT*rg.. and
  // columns kDefBT*cg..: per m, two float4 loads of the K-tile and two of
  // the strip feed 64 FMAs.  The sum runs in order of m.
  constexpr int kColGroups = kDefBN / kDefBT;
  const int n_items = ((I + kDefBT - 1) / kDefBT) * kColGroups;
  const int n_tiles = (I + kDefBK - 1) / kDefBK;
  // 16-byte copies when the rows of W_c1t are 16-byte aligned (measured
  // at (12, 16, 512, 256) on an H100: 4-byte copies 1.49 ms per launch,
  // 16-byte 0.98).
  auto load_tile = [&](int t) {
    float* dst = stage + (t & 1) * kDefBK * Ip;
    const int m0 = t * kDefBK, rows = min(kDefBK, I - m0);
    const float* src = w_c1t + (size_t)m0 * I;
    if (I % 4 == 0) {
      const int q = I / 4;
      for (int x = threadIdx.x; x < rows * q; x += blockDim.x)
        cp_async16(dst + (x / q) * Ip + 4 * (x % q), src + 4 * x);
    } else {
      for (int x = threadIdx.x; x < rows * I; x += blockDim.x)
        cp_async4(dst + (x / I) * Ip + x % I, src + x);
    }
    cp_async_commit();
  };
  for (int base = 0; base < n_items; base += nt) {
    const int item = base + tid;
    const bool active = item < n_items;
    const int c0 = (item % kColGroups) * kDefBT;
    const int i0 = (item / kColGroups) * kDefBT;
    float acc[kDefBT][kDefBT];
#pragma unroll
    for (int t = 0; t < kDefBT; ++t)
#pragma unroll
      for (int q = 0; q < kDefBT; ++q) acc[t][q] = 0.f;
    __syncthreads();                   // e ready; stage free
    load_tile(0);
    for (int tile = 0; tile < n_tiles; ++tile) {
      if (tile + 1 < n_tiles) {
        load_tile(tile + 1);
      } else {
        cp_async_commit();             // empty group keeps the count
      }
      cp_async_wait_prev();
      __syncthreads();
      if (active) {
        const float* wt = stage + (tile & 1) * kDefBK * Ip;
        const int m0 = tile * kDefBK;
        const int kmax = min(kDefBK, I - m0);
#pragma unroll 8
        for (int k = 0; k < kmax; ++k) {
          const float* eb = e + (m0 + k) * kDefBN + c0;
          const float* wa = wt + k * Ip + i0;
          const float4 b0 = *reinterpret_cast<const float4*>(eb);
          const float4 b1 = *reinterpret_cast<const float4*>(eb + 4);
          const float4 a0 = *reinterpret_cast<const float4*>(wa);
          const float4 a1 = *reinterpret_cast<const float4*>(wa + 4);
          const float bv[kDefBT] = {b0.x, b0.y, b0.z, b0.w,
                                    b1.x, b1.y, b1.z, b1.w};
          const float av[kDefBT] = {a0.x, a0.y, a0.z, a0.w,
                                    a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int t = 0; t < kDefBT; ++t)
#pragma unroll
            for (int q = 0; q < kDefBT; ++q)
              acc[t][q] = fmaf(av[t], bv[q], acc[t][q]);
        }
      }
      __syncthreads();                 // done with `tile` before reuse
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < kDefBT; ++t) {
        const int i = i0 + t;
        if (i >= I) continue;
#pragma unroll
        for (int q = 0; q < kDefBT; ++q) {
          const int jj = c0 + q;
#if SDFS_DEFB_SPLIT == 3
          if (jj < jw) out_r[(size_t)i * J + j0 + jj] = acc[t][q];
#else
          if (jj < jw)
            out_r[(size_t)i * J + j0 + jj] = shift[jj] + logf(acc[t][q]);
#endif
        }
      }
    }
  }
}

// The resident layout of the deferred pass B, for I small enough that
// W_c1^T stays in shared memory beside two (I, BN) strips (I <= 144 at BN
// = 128: the 18.9M-point continuous-GCY view (8,16,144,1024), 472
// launches per solve).  The K-tiled kernel above leaves most of its
// block idle there (72 thread tiles of 8 x 8 for 256 threads) and streams
// the 83 KB W_c1^T through 18 K-tiles in each of 4,096 blocks.  Here a
// persistent grid (one block per SM at I = 144) loads W_c1^T once per
// block with cp.async and walks items (field row r, strip of BN
// columns): every thread owns an 8 x 8 output tile (rows 8*rg.., columns
// 4*cg.. and BN/2 + 4*cg.., so that a warp's strip loads are contiguous),
// (BN/8) * ceil(I/8) threads cover the (I, BN) item exactly (288 at I =
// 144, BN = 128), and the product runs over all of I with no barrier.
// The next item's raw strip is copied (cp.async) into the second buffer
// while the current one's maxima, exponentials and product run.  The
// sum runs in order of m, as in the K-tiled kernel.
constexpr int kResMaxThreads = 384;
constexpr int kResParts = 2;          // partial column maxima per column
constexpr int kFoldBatch = 32;        // sub_col loads in flight per thread
constexpr size_t kSmemLimit = 232448;  // a block's shared memory (227 KB)

__host__ __device__ inline int round_up8(int n) { return (n + 7) & ~7; }

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
// (the K-tiled layout).
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
    cp_async_wait_all();
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

// FAST (the batched pass C's fast mode): mid is linear, scaled per row by
// scale, no shifts; S is added back after the log.  SPREAD: the layout
// of a block alone on its SM (the narrow tiles that shared memory leaves
// at thousands of rows, e.g. TC = 4 at R = 3,136): 512 threads, and the
// c2 items' rows spread so that neighbouring threads take neighbouring
// rows (see the c2 loop).  c2_stride: floats between consecutive slices'
// factors in w_c2t (0: one shared W_c2^T).
template <bool FAST, bool SPREAD>
__global__ void __launch_bounds__(SPREAD ? kSpreadThreads : kDefThreads)
pass_c_deferred_kernel(const float* __restrict__ mid,
                       const float* __restrict__ scale,
                       const float* __restrict__ S,
                       const float* __restrict__ w_c2t, size_t c2_stride,
                       const float* __restrict__ w_r1,
                       const float* __restrict__ w_r2,
                       const float* __restrict__ add_row,
                       const float* __restrict__ add_col,
                       float* __restrict__ out, int L, int K, int J, int TC,
                       int JK, float theta, float beta) {
  extern __shared__ float smem[];
  const int R = L * K, KT = K * TC, Rs = pass_c_deferred_rstride(R);
  float* acc = smem;                 // (R, TC): c2 result, then carried
  float* et = acc + R * TC;          // (JK, Rs): exp(w - m1), transposed
  float* y = et;                     // (R, TC): after the l' contraction
  float* raw = et + pass_c_deferred_et_floats(R, TC, JK);  // (R, JK) chunk
  float* wc = raw + R * JK;          // (JK, TC): W_c2^T chunk
  float* m1 = wc + JK * TC;          // (R): per-(row, slice) shift (fast: scale)
  float* M2 = m1 + round_up4(R);     // (K): max over l of m1
  float* M3 = M2 + round_up4(K);     // (1): max over k of M2
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int j0 = blockIdx.x * TC, tcw = min(TC, J - j0);
  const size_t C = (size_t)gridDim.y * J;
  const size_t col0 = (size_t)blockIdx.y * J;   // first column of slice i
  const float* in = mid + col0;
  const float* wz = w_c2t + blockIdx.y * c2_stride;   // slice i's W_c2^T

  // The first chunk's copy starts now and lands during the shifts.  A
  // chunk is R rows of kw <= JK contiguous values; 16-byte copies when J
  // % 4 == 0 keeps every row of every chunk 16-byte aligned.
  auto load_raw = [&](int c0) {
    const int kw = min(JK, J - c0);
    if (J % 4 == 0) {
      const int q = kw / 4;
      for (int x = tid; x < R * q; x += nt) {
        const int r = x / q, k = 4 * (x % q);
        cp_async16(raw + r * JK + k, in + r * C + c0 + k);
      }
    } else {
      for (int x = tid; x < R * kw; x += nt) {
        const int r = x / kw, k = x % kw;
        cp_async4(raw + r * JK + k, in + r * C + c0 + k);
      }
    }
    cp_async_commit();
  };
  load_raw(0);

  // Shifts: m1[r] over the slice's J values (a warp takes 4 rows at a
  // time and unrolls, so many independent loads are in flight per lane),
  // then M2[k], M3.  In fast mode m1 holds the row scales instead.
  if constexpr (FAST) {
    for (int r = tid; r < R; r += nt) m1[r] = __ldg(scale + r);
  } else {
    for (int r0 = 4 * warp; r0 < R; r0 += 4 * nw) {
      float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
      if (J % 4 == 0) {              // float4 loads: rows 16-byte aligned
#pragma unroll 4
        for (int x = lane; x < J / 4; x += 32)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r0 + u < R) {
              const float4 a = __ldg(
                  reinterpret_cast<const float4*>(in + (r0 + u) * C) + x);
              m[u] = fmaxf(m[u], fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
            }
      } else {
#pragma unroll 8
        for (int j = lane; j < J; j += 32)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r0 + u < R) m[u] = fmaxf(m[u], in[(r0 + u) * C + j]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float mu = warp_max(m[u]);
        if (lane == 0 && r0 + u < R) m1[r0 + u] = mu;
      }
    }
    __syncthreads();
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
  }

  // c2: acc[r, t] = sum_j' exp(w[r, j'] - m1[r]) W_c2t[j', j0 + t] (fast:
  // w[r, j'] * scale[r] in place of the exp), in
  // chunks of JK rows j'; the sum runs in order of j'.  The next chunk's
  // copy overlaps this chunk's contraction.  Item (tq, rb) owns columns
  // kDefTN*tq.. of kDefTM rows: rows kDefTM*rb + u, read from et as two
  // float4, or with SPREAD rows rb + u * n_rb, so that neighbouring
  // threads take neighbouring rows and the accumulator's float4 accesses
  // meet no bank conflicts at a narrow tile (the compact rows put threads
  // kDefTM*TC floats apart in one bank: 32-way at TC = 4; chip_smoke.py at
  // the continuous-SSY cell on an H100, fast mode: 2.57 ms compact with
  // 256 threads, 1.10 ms in the SPREAD layout).
  const int nq = TC / kDefTN;
  const int n_rb = (R + kDefTM - 1) / kDefTM;
  const int n_items = n_rb * nq;
  for (int c0 = 0; c0 < J; c0 += JK) {
    const int kw = min(JK, J - c0);
    cp_async_wait_all();
    __syncthreads();          // chunk landed; previous contraction done
    for (int x = tid; x < R * JK; x += nt) {
      const int r = x / JK, k = x % JK;
      et[k * Rs + r] = (k >= kw) ? 0.f
                       : FAST    ? raw[x] * m1[r]
                                 : expf(raw[x] - m1[r]);
    }
    for (int x = tid; x < JK * TC; x += nt) {
      const int k = x / TC, t = x % TC;
      wc[x] = (k < kw && t < tcw) ? __ldg(wz + (size_t)(c0 + k) * J + j0 + t)
                                  : 0.f;
    }
    __syncthreads();          // et, wc ready; raw free
    if (c0 + JK < J) load_raw(c0 + JK);
    for (int item = tid; item < n_items; item += nt) {
      const int tq = item % nq, rb = item / nq;
      int rr[kDefTM];
#pragma unroll
      for (int u = 0; u < kDefTM; ++u)
        rr[u] = SPREAD ? rb + u * n_rb : kDefTM * rb + u;
      float4 a4[kDefTM];
#pragma unroll
      for (int u = 0; u < kDefTM; ++u)
        a4[u] = (c0 == 0 || rr[u] >= R)
                    ? make_float4(0.f, 0.f, 0.f, 0.f)
                    : *reinterpret_cast<const float4*>(acc + rr[u] * TC +
                                                       kDefTN * tq);
      for (int k = 0; k < kw; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(
            wc + k * TC + kDefTN * tq);
        const float* ek = et + k * Rs;
        float ev[kDefTM];
        if constexpr (SPREAD) {
#pragma unroll
          for (int u = 0; u < kDefTM; ++u) ev[u] = ek[min(rr[u], R - 1)];
        } else {
          const float4 e0 = *reinterpret_cast<const float4*>(ek + rr[0]);
          const float4 e1 = *reinterpret_cast<const float4*>(ek + rr[0] + 4);
          ev[0] = e0.x; ev[1] = e0.y; ev[2] = e0.z; ev[3] = e0.w;
          ev[4] = e1.x; ev[5] = e1.y; ev[6] = e1.z; ev[7] = e1.w;
        }
#pragma unroll
        for (int u = 0; u < kDefTM; ++u) {
          a4[u].x = fmaf(ev[u], b.x, a4[u].x);
          a4[u].y = fmaf(ev[u], b.y, a4[u].y);
          a4[u].z = fmaf(ev[u], b.z, a4[u].z);
          a4[u].w = fmaf(ev[u], b.w, a4[u].w);
        }
      }
#pragma unroll
      for (int u = 0; u < kDefTM; ++u)
        if (rr[u] < R)
          *reinterpret_cast<float4*>(acc + rr[u] * TC + kDefTN * tq) = a4[u];
    }
  }
  __syncthreads();

  // Linear carry: rescale row r = (l, k) by exp(m1[r] - M2[k]) (one exp
  // per row, kept in m1), and the r1 result by exp(M2[k] - M3) (one per
  // k, kept in M2).  Fast mode carries unshifted and adds S back.
  const float m3 = FAST ? __ldg(S) : M3[0];
  if constexpr (!FAST) {
    for (int r = tid; r < R; r += nt) m1[r] = expf(m1[r] - M2[r % K]);
    __syncthreads();
    for (int k = tid; k < K; k += nt) M2[k] = expf(M2[k] - m3);
    for (int x = tid; x < R * TC; x += nt) acc[x] *= m1[x / TC];
    __syncthreads();
  }

  // r1: y[l, k, t] = sum_m W_r1[l, m] acc[m, k, t], rescaled.
  block_matmul(
      L, KT, L,
      [&](int l, int m) { return __ldg(w_r1 + l * L + m); },
      [&](int m, int col) { return acc[m * KT + col]; },
      [&](int l, int col, float v) {
        y[l * KT + col] = FAST ? v : v * M2[col / TC];
      });
  __syncthreads();

  // r2 + epilogue: z[l, k, t] = sum_m W_r2[k, m] y[l, m, t], columns
  // n = l * TC + t.
  block_matmul(
      K, L * TC, K,
      [&](int k, int m) { return __ldg(w_r2 + k * K + m); },
      [&](int m, int n) { return y[(n / TC) * KT + m * TC + n % TC]; },
      [&](int k, int n, float v) {
        const int l = n / TC, t = n % TC;
        if (t >= tcw) return;
        const int r = l * K + k;
        const size_t c = col0 + j0 + t;
        const float lh = logf(v) + m3 + __ldg(add_row + r) +
                         __ldg(add_col + c);
        out[r * C + c] = log1pf(beta * expf(lh / theta));
      });
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

// The arguments of one pass-B launch.
struct PassBArgs {
  const float *ell, *w_c1, *w_c2t, *sub_row, *sub_col, *mid_col;
  float *mid, *s;
  int R, I, J;
  float theta;
  cudaStream_t st;
};

template <int MODE, bool HAS_SUB, bool C2_HERE, bool HAS_MID>
cudaError_t launch_pass_b(const PassBArgs& a) {
  const size_t smem = sizeof(float) * (size_t)pass_b_smem_floats(a.I, a.J);
  const auto kernel = pass_b_kernel<MODE, HAS_SUB, C2_HERE, HAS_MID>;
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.R, kPassBThreads, smem, a.st>>>(a.ell, a.w_c1, a.w_c2t,
                                             a.sub_row, a.sub_col, a.mid_col,
                                             a.mid, a.s, a.I, a.J, a.theta);
  return cudaGetLastError();
}

template <int MODE, bool HAS_MID>
cudaError_t dispatch_pass_b(const PassBArgs& a) {
  const bool sub = a.sub_row != nullptr, c2 = a.w_c2t != nullptr;
  if (sub && c2) return launch_pass_b<MODE, true, true, HAS_MID>(a);
  if (sub) return launch_pass_b<MODE, true, false, HAS_MID>(a);
  if (c2) return launch_pass_b<MODE, false, true, HAS_MID>(a);
  return launch_pass_b<MODE, false, false, HAS_MID>(a);
}

template <bool FAST>
cudaError_t launch_pass_c_slices(const float* mid, const float* scale,
                                 const float* S, const float* w_c2t,
                                 size_t c2_stride, const float* w_r1,
                                 const float* w_r2, const float* add_row,
                                 const float* add_col, float* out, int L,
                                 int K, int I, int J, int TC, int JK,
                                 float theta, float beta, void* stream) {
  const size_t smem =
      sizeof(float) * (size_t)pass_c_deferred_smem_floats(L, K, TC, JK);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((J + TC - 1) / TC, I);
  const bool spread = smem > kHalfSmBytes;     // one block per SM
  const auto kernel = spread ? pass_c_deferred_kernel<FAST, true>
                             : pass_c_deferred_kernel<FAST, false>;
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, spread ? kSpreadThreads : kDefThreads, smem, st>>>(
      mid, scale, S, w_c2t, c2_stride, w_r1, w_r2, add_row, add_col, out, L,
      K, J, TC, JK, theta, beta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pass B over R field rows of ell (R, I, J).  w_c1 (I, I); w_c2t (J, J)
// = W_c2 transposed, or null for c1 only; sub_row (R,) and sub_col (I, J)
// both given (the folded baseline) or both null; mid_col (I, J) or null
// (lse mode only); mid (R, I, J); s (R,) written in fast mode only.
int sdfs_pass_b(const float* ell, const float* w_c1, const float* w_c2t,
                const float* sub_row, const float* sub_col,
                const float* mid_col, float* mid, float* s, int R, int I,
                int J, float theta, int mode, void* stream) {
  if ((sub_row == nullptr) != (sub_col == nullptr))
    return cudaErrorInvalidValue;
  const PassBArgs a{ell, w_c1, w_c2t, sub_row, sub_col, mid_col, mid, s,
                    R, I, J, theta, static_cast<cudaStream_t>(stream)};
  if (mode == kModeFast && mid_col == nullptr)
    return dispatch_pass_b<kModeFast, false>(a);
  if (mode == kModeLse)
    return mid_col == nullptr ? dispatch_pass_b<kModeLse, false>(a)
                              : dispatch_pass_b<kModeLse, true>(a);
  return cudaErrorInvalidValue;
}

// Pass C over mid (R = L*K, C) in tiles of TC columns.  scale (R,) and
// S (1,) are read in fast mode only; add_row (L*K,), add_col (C,);
// out (R, C).
int sdfs_pass_c(const float* mid, const float* scale, const float* S,
                const float* w_r1, const float* w_r2, const float* add_row,
                const float* add_col, float* out, int L, int K, int C,
                int TC, float theta, float beta, int mode, void* stream) {
  const size_t smem = sizeof(float) * (size_t)pass_c_smem_floats(L, K, TC);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (C + TC - 1) / TC;
  cudaError_t err;
  if (mode == kModeFast) {
    err = prepare(pass_c_kernel<kModeFast>, smem);
    if (err != cudaSuccess) return err;
    pass_c_kernel<kModeFast><<<blocks, kPassCThreads, smem, st>>>(
        mid, scale, S, w_r1, w_r2, add_row, add_col, out, L, K, C, TC,
        theta, beta);
  } else if (mode == kModeLse) {
    err = prepare(pass_c_kernel<kModeLse>, smem);
    if (err != cudaSuccess) return err;
    pass_c_kernel<kModeLse><<<blocks, kPassCThreads, smem, st>>>(
        mid, scale, S, w_r1, w_r2, add_row, add_col, out, L, K, C, TC,
        theta, beta);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Deferred-c2 pass B over R field rows of ell (R, I, J): c1 only.
// w_c1t (I, I) = W_c1 transposed; sub_row (R,) and sub_col (I, J) both
// given (a = theta*ell - sub_row[r] - sub_col[i, j]) or both null;
// out (R, I, J) log domain.
int sdfs_pass_b_deferred(const float* ell, const float* w_c1t,
                         const float* sub_row, const float* sub_col,
                         float* out, int R, int I, int J, float theta,
                         void* stream) {
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
  const size_t smem =
      sizeof(float) * (size_t)pass_b_deferred_smem_floats(I);
  const dim3 grid((J + kDefBN - 1) / kDefBN, R);
  cudaError_t err;
  if (sub_row != nullptr) {
    err = prepare(pass_b_deferred_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    pass_b_deferred_kernel<true><<<grid, kDefThreads, smem, st>>>(
        ell, w_c1t, sub_row, sub_col, out, I, J, theta);
  } else {
    err = prepare(pass_b_deferred_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    pass_b_deferred_kernel<false><<<grid, kDefThreads, smem, st>>>(
        ell, w_c1t, nullptr, nullptr, out, I, J, theta);
  }
  return cudaGetLastError();
}

// Deferred-c2 pass C over mid (R = L*K, I*J) log domain: c2 with
// w_c2t (J, J) = W_c2 transposed, then the row phase and the epilogue,
// in blocks of TC columns (TC % 4 == 0) of one slice, streaming the
// slice in chunks of JK columns.  add_row (L*K,), add_col (I*J,);
// out (R, I*J).
int sdfs_pass_c_deferred(const float* mid, const float* w_c2t,
                         const float* w_r1, const float* w_r2,
                         const float* add_row, const float* add_col,
                         float* out, int L, int K, int I, int J, int TC,
                         int JK, float theta, float beta, void* stream) {
  if (TC % kDefTN != 0 || TC <= 0 || JK <= 0) return cudaErrorInvalidValue;
  return launch_pass_c_slices<false>(mid, nullptr, nullptr, w_c2t, 0, w_r1,
                                     w_r2, add_row, add_col, out, L, K, I, J,
                                     TC, JK, theta, beta, stream);
}

// Batched pass C over mid (R = L*K, I*J): linear (mode fast; scale (R,),
// S (1,)) or log domain (mode lse; scale and S unused).  w_c2t (I, J, J)
// = P_z[i] transposed per slice; otherwise as sdfs_pass_c_deferred.
int sdfs_pass_c_batched(const float* mid, const float* scale, const float* S,
                        const float* w_c2t, const float* w_r1,
                        const float* w_r2, const float* add_row,
                        const float* add_col, float* out, int L, int K,
                        int I, int J, int TC, int JK, float theta,
                        float beta, int mode, void* stream) {
  if (TC % kDefTN != 0 || TC <= 0 || JK <= 0) return cudaErrorInvalidValue;
  const size_t stride = (size_t)J * J;
  if (mode == kModeFast)
    return launch_pass_c_slices<true>(mid, scale, S, w_c2t, stride, w_r1,
                                      w_r2, add_row, add_col, out, L, K, I,
                                      J, TC, JK, theta, beta, stream);
  if (mode == kModeLse)
    return launch_pass_c_slices<false>(mid, nullptr, nullptr, w_c2t, stride,
                                       w_r1, w_r2, add_row, add_col, out, L,
                                       K, I, J, TC, JK, theta, beta, stream);
  return cudaErrorInvalidValue;
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

// Columns per item of the deferred pass B's resident layout at (I, J),
// 0 for the K-tiled layout (pass_b_deferred_layout mirrors it).
int sdfs_pass_b_deferred_bn(int I, int J) { return pass_b_resident_bn(I, J); }

const char* sdfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
