// Post/loglin-interpolation SSY operator for NVIDIA Hopper (sm_90a).
//
// Replaces sdfs_via_autodiff_tpu/kernels/post_interp_kernel.py:58
// (_kernel).  The continuous SSY operator with the reference's post-power
// semantics, on the (R, C) = (n_l*n_k, n_i*n_j) view of the field F
// (F = exp(ell - max ell) for "post", F = ell for "loglin"), with the
// tensor-product Gauss-Hermite nodes grouped into d^2 row pairs p and d^2
// column pairs q (Kronecker stacks Wr[p] (R, R) and Wc[q] (C, C)):
//
//   G_p     = Wr[p] F                                   (phase 1)
//   V_pq    = G_p Wc[q]^T
//   part_p  = sum_q exp(theta * f(V_pq) + pay[p, r] + off[p, q])
//                                                       (phase 2)
//   out     = log1p(beta * exp((log sum_p part_p + s + lk_row[r]
//                               + lk_col[c]) / theta)) (phase 3)
//
// with f = log for "post" and the identity for "loglin".  off carries the
// node-pair log-weights and the single global shift s (the wrapper's
// theta*min(ell) + max(pay) + max(off) bound; every exponent is <= 0).
//
// What bounds it on an H100: phase 2 is d^4 products of an (R, C) by
// (C, C) matrix, 2 * P12 * P34 * R * C * C FLOP (83 GFLOP at 20^4, d = 5:
// 1.24 ms at the 67 TFLOP/s FP32 rate) against ~50 MB of operands: FP32
// FMAs, not memory.  FP32 FMA throughout (plain TF32 misses the
// 1e-6-class one-application bar).  The design is a simple SIMT SGEMM:
// 64x64 output tiles, 256 threads with 4x4 register tiles, 16-deep K
// tiles staged in shared memory; each block of phase 2 owns one output
// tile and one row pair p, loops over every column pair q and applies
// the pointwise power, payoff and exp-accumulate in registers, so no V
// ever reaches memory.  The cross-block sum over p is phase 3, in a fixed
// order (deterministic).  Ragged edges are masked.  Transcendentals are
// CUDA's expf/logf/log1pf, built without fast-math.
//
// The C entry point launches the three phases on the caller's stream,
// allocates nothing (the wrapper passes the G and partial-sum scratch)
// and returns cudaGetLastError(); the Python wrapper validates every
// argument.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;         // output rows per block
constexpr int kBN = 64;         // output columns per block
constexpr int kBK = 16;         // K per shared-memory tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kEpilogueThreads = 256;

// c[i][j] += sum_k A(m0 + 4*ty + i, k) * B(k, n0 + 4*tx + j) over K, with
// A(m, k) = a[m * lda + k] and B(k, n) = b[k * ldb + n] when kBNContig,
// else b[n * ldb + k].  Out-of-range rows, columns and k read as zero.
template <bool kBNContig>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a,
                                          int lda,
                                          const float* __restrict__ b,
                                          int ldb, int M, int N, int K,
                                          int m0, int n0, float (&c)[4][4],
                                          float* As, float* Bs) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int lm = t / 4, lk = (t % 4) * 4;     // K-contiguous loads
  const int bk = t / 16, bn = (t % 16) * 4;   // N-contiguous loads
  for (int k0 = 0; k0 < K; k0 += kBK) {
    {
      const int m = m0 + lm;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + lk + u;
        As[(lk + u) * kBM + lm] =
            (m < M && k < K) ? __ldg(a + (size_t)m * lda + k) : 0.f;
      }
    }
    if (kBNContig) {
      const int k = k0 + bk;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + bn + u;
        Bs[bk * kBN + bn + u] =
            (k < K && n < N) ? __ldg(b + (size_t)k * ldb + n) : 0.f;
      }
    } else {
      const int n = n0 + lm;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + lk + u;
        Bs[(lk + u) * kBN + lm] =
            (n < N && k < K) ? __ldg(b + (size_t)n * ldb + k) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av =
          *reinterpret_cast<const float4*>(As + kk * kBM + ty * 4);
      const float4 bv =
          *reinterpret_cast<const float4*>(Bs + kk * kBN + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(ar[i], br[j], c[i][j]);
      }
    }
    __syncthreads();
  }
}

// Phase 1: g[p] = wr[p] (R, R) @ field (R, C), one block per (column
// tile, row tile, p).
__global__ void __launch_bounds__(kThreads)
    post_g_kernel(const float* __restrict__ field,
                  const float* __restrict__ wr, float* __restrict__ g, int R,
                  int C) {
  __shared__ __align__(16) float As[kBK * kBM];
  __shared__ __align__(16) float Bs[kBK * kBN];
  const int p = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float c[4][4] = {};
  gemm_tile<true>(wr + (size_t)p * R * R, R, field, C, R, C, R, m0, n0, c,
                  As, Bs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* gp = g + (size_t)p * R * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < C) gp[(size_t)r * C + col] = c[i][j];
    }
  }
}

// Phase 2: part[p] = sum_q exp(theta * f(g[p] wc[q]^T) + pay[p, r] +
// off[p, q]), one block per (column tile, row tile, p).
template <bool kPost>
__global__ void __launch_bounds__(kThreads)
    post_acc_kernel(const float* __restrict__ g,
                    const float* __restrict__ wc,
                    const float* __restrict__ pay,
                    const float* __restrict__ off, float* __restrict__ part,
                    int R, int C, int P34, float theta) {
  __shared__ __align__(16) float As[kBK * kBM];
  __shared__ __align__(16) float Bs[kBK * kBN];
  const int p = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float pay_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    pay_r[i] = r < R ? __ldg(pay + (size_t)p * R + r) : 0.f;
  }
  const float* gp = g + (size_t)p * R * C;
  float acc[4][4] = {};
  for (int q = 0; q < P34; ++q) {
    float v[4][4] = {};
    gemm_tile<false>(gp, C, wc + (size_t)q * C * C, C, R, C, C, m0, n0, v,
                     As, Bs);
    const float o = __ldg(off + (size_t)p * P34 + q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = kPost ? theta * logf(v[i][j]) : theta * v[i][j];
        acc[i][j] += expf(e + pay_r[i] + o);
      }
    }
  }
  float* pp = part + (size_t)p * R * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < C) pp[(size_t)r * C + col] = acc[i][j];
    }
  }
}

// Phase 3: the sum over row pairs p = 0..P12-1 (in order), the log, the
// shift, log kappa and the epilogue, one thread per element.
__global__ void __launch_bounds__(kEpilogueThreads)
    post_epilogue_kernel(const float* __restrict__ part,
                         const float* __restrict__ s,
                         const float* __restrict__ lk_row,
                         const float* __restrict__ lk_col,
                         float* __restrict__ out, int R, int C, int P12,
                         float theta, float beta) {
  const size_t n = (size_t)R * C;
  const size_t idx = (size_t)blockIdx.x * kEpilogueThreads + threadIdx.x;
  if (idx >= n) return;
  const int r = (int)(idx / C), col = (int)(idx % C);
  float acc = 0.f;
  for (int p = 0; p < P12; ++p) acc += part[(size_t)p * n + idx];
  const float log_kg = logf(acc) + __ldg(s) + __ldg(lk_row + r) +
                       __ldg(lk_col + col);
  out[idx] = log1pf(beta * expf(log_kg / theta));
}

}  // namespace

extern "C" {

// One application on field (R, C): wr (P12, R, R), wc (P34, C, C),
// pay (P12, R), off (P12, P34), s (1,), lk_row (R,), lk_col (C,);
// scratch g and part (P12, R, C) each; out (R, C).  post = 1 for "post",
// 0 for "loglin".
int sdfs_post_interp(const float* field, const float* wr, const float* wc,
                     const float* pay, const float* off, const float* s,
                     const float* lk_row, const float* lk_col, float* g,
                     float* part, float* out, int R, int C, int P12, int P34,
                     float theta, float beta, int post, void* stream) {
  if (R <= 0 || C <= 0 || P12 <= 0 || P34 <= 0 || P12 > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kBN - 1) / kBN, (R + kBM - 1) / kBM, P12);
  post_g_kernel<<<grid, kThreads, 0, st>>>(field, wr, g, R, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (post) {
    post_acc_kernel<true><<<grid, kThreads, 0, st>>>(g, wc, pay, off, part,
                                                     R, C, P34, theta);
  } else {
    post_acc_kernel<false><<<grid, kThreads, 0, st>>>(g, wc, pay, off, part,
                                                      R, C, P34, theta);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)R * C;
  const unsigned blocks =
      (unsigned)((n + kEpilogueThreads - 1) / kEpilogueThreads);
  post_epilogue_kernel<<<blocks, kEpilogueThreads, 0, st>>>(
      part, s, lk_row, lk_col, out, R, C, P12, theta, beta);
  return cudaGetLastError();
}

const char* sdfs_post_interp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
