// Streamed two-phase operator kernels for NVIDIA Hopper (sm_90a).
//
// The discrete SSY operator log T(w) on a field ell[r, c] with rows
// r = (h_lam, h_c) = (l, k) and columns c = (h_z, z) = (i, j) runs as two
// passes over the field:
//
//   pass B (column phase), one block per field row r:
//     a = theta * ell[r] (I, J); contract i' with W_c1, then j' with W_c2.
//     Replaces sdfs_via_autodiff_tpu/kernels/streamed_two_phase.py:324
//     (_b_kernel) for shared factors without sub/mid corrections.
//   pass C (row phase), one block per tile of TC consecutive columns
//     holding all R = L*K rows: contract l' with W_r1, then k' with W_r2,
//     add add_row[l, k] + add_col[c], epilogue log1p(beta*exp(lh/theta)).
//     Replaces streamed_two_phase.py:446 (_c_kernel) without batched or
//     deferred c2.
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

#include <cuda_runtime.h>
#include <math.h>

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
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// out[i, j] = sum_m u[i, m] * w[m, j] for one field row (i < I, j < J):
// pass B's j' contraction, ~90% of its FLOPs.  W (J, J) streams from L2
// through two shared K-tiles of kBK rows (`stage`, 2 * kBK * J floats),
// the next tile's cp.async copy overlapping the current tile's FMAs.
// Each thread owns TI rows and TJ columns n = q0 + q * nq; u (row stride
// Jp = round_up4(J), zero-padded) is read as float4 broadcasts along m,
// W tiles as conflict-free rows.  Tile rows past J are zero-filled so
// the padded m add exact zeros.  The sum runs in order of m.
template <int TI, int TJ, class Store>
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
    for (int x = threadIdx.x; x < rows * J; x += blockDim.x)
      cp_async4(dst + x, src + x);
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

template <int MODE>
__global__ void __launch_bounds__(kPassBThreads)
pass_b_kernel(const float* __restrict__ ell, const float* __restrict__ w_c1,
              const float* __restrict__ w_c2t, float* __restrict__ mid,
              float* __restrict__ s_out, int I, int J, float theta) {
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

  for (int x = tid; x < IJ; x += nt) a[x] = theta * ell_r[x];
  for (int x = tid; x < I * (Jp - J); x += nt)        // zero u's padding
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

  // c1: u[i, j] = sum_m W_c1[i, m] a[m, j].
  block_matmul(
      I, J, I,
      [&](int i, int m) { return __ldg(w_c1 + i * I + m); },
      [&](int m, int j) { return a[m * J + j]; },
      [&](int i, int j, float v) {
        u[i * Jp + j] = (MODE == kModeFast) ? v : shift[j] + logf(v);
      });
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

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

}  // namespace

extern "C" {

// Pass B over R field rows of ell (R, I, J).  w_c1 (I, I), w_c2t (J, J)
// = W_c2 transposed; mid (R, I, J); s (R,) written in fast mode only.
int sdfs_pass_b(const float* ell, const float* w_c1, const float* w_c2t,
                float* mid, float* s, int R, int I, int J, float theta,
                int mode, void* stream) {
  const size_t smem = sizeof(float) * (size_t)pass_b_smem_floats(I, J);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == kModeFast) {
    err = prepare(pass_b_kernel<kModeFast>, smem);
    if (err != cudaSuccess) return err;
    pass_b_kernel<kModeFast><<<R, kPassBThreads, smem, st>>>(
        ell, w_c1, w_c2t, mid, s, I, J, theta);
  } else if (mode == kModeLse) {
    err = prepare(pass_b_kernel<kModeLse>, smem);
    if (err != cudaSuccess) return err;
    pass_b_kernel<kModeLse><<<R, kPassBThreads, smem, st>>>(
        ell, w_c1, w_c2t, mid, s, I, J, theta);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

const char* sdfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
