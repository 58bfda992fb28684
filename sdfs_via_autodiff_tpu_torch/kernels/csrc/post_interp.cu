// Post/loglin-interpolation SSY operator for NVIDIA Hopper (sm_90a).
//
// Replaces sdfs_via_autodiff_tpu/kernels/post_interp_kernel.py:58
// (_kernel).  The continuous SSY operator with the reference's post-power
// semantics, on the (R, C) = (n_l*n_k, n_i*n_j) view of the field F
// (F = exp(ell - max ell) for "post", F = ell for "loglin"):
//
//   V_pq[r, c] = interpolant of F at the successor of state (r, c) under
//                joint node (p, q), p = (q1, q2) the (h_lam, h_c) node
//                pair, q = (q3, q4) the (h_z, z) pair
//   out = log1p(beta * exp((log sum_{p,q} exp(theta * f(V_pq) + pay[p, r]
//                + off[p, q]) + s + lk_row[r] + lk_col[c]) / theta))
//
// with f = log for "post" and the identity for "loglin".  off carries the
// node pairs' log-weights and the single global shift s (the wrapper's
// theta*min(ell) + max(pay) + max(off) bound; every exponent is <= 0).
//
// The interpolation basis is a hat basis with at most two non-zeros per
// row on each axis, so V_pq is a 16-corner multilinear combination of F.
// The operands are per-axis corner tables: for each 1-D node and current
// index the lower corner index (int32) and the upper corner's weight
// (lo_l, t_l: (d, n_l); lo_c, t_c: (d, n_k); lo_h, t_h: (d, n_i); lo_z,
// t_z: (d, n_i, n_j), z conditioned on the current h_z index).  The
// combination is factored per axis:
//
//   G_p[r, :] = sum of the 2 x 2 (h_lam, h_c) corners of row r's
//               successors, weighted                      (4 FMA per entry)
//   V_pq[r, c] = sum of the 2 x 2 (h_z, z) corners of G_p[r, :]
//                                                         (4 FMA per entry)
//
// What bounds it on an H100: the special-function work, d^4 * N logs
// ("post") and d^4 * N exps (~48 us at 20^4, d = 5, at 16 per clock per SM
// and 1.98 GHz), with ~12 FP32 FLOP per (state, node) beside them (a
// dense Kronecker form spends 83 GFLOP at 20^4, over 99% of it on
// zeros).  The field (R*C f32) stays in L2.  Design: one block per
// (field row r, 256-column tile).  The block forms G_p[r, :] for every
// row pair p (all C columns: the column corners of its outputs can land
// anywhere) in shared memory as (C, P) with an odd stride, so that a
// warp's gathers hit distinct banks, then each thread owns one output
// (r, c): for every column pair q it loads its four column corners once
// and runs over the row pairs p, forming V from four shared-memory loads,
// applying the power, payoff and log-weight and accumulating exp in a
// register.  The sum runs over nodes in a fixed order (q, then p; p in
// chunks when G for all P row pairs would exceed kGBudget), so the result
// is deterministic.  No G, V or partial sum reaches device memory.
// Ragged tiles are masked.  Transcendentals are CUDA's expf/logf/log1pf,
// built without fast-math.
//
// SDFS_SPLIT (compile-time, for timing the phases; 4, the default, is the
// kernel): 1 forms G only, 2 adds the gathers and V, 3 adds the power
// and the exp-sum; 1-3 store the raw sum and skip the epilogue.
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError(); the Python wrapper validates every
// argument.

#include <cuda_runtime.h>
#include <math.h>

#ifndef SDFS_SPLIT
#define SDFS_SPLIT 4
#endif

namespace {

constexpr int kThreads = 256;            // output columns per block
constexpr int kGBudget = 48 * 1024;      // bytes of G a block aims for
constexpr int kSmemLimit = 232448;       // a block's shared memory (227 KB)

struct Hat {
  int lo, hi;
  float w0, w1;
};

// The two corners of entry idx of a corner table on an n-point axis.
__device__ __forceinline__ Hat hat(const int* __restrict__ lo,
                                   const float* __restrict__ t, int idx,
                                   int n) {
  Hat h;
  h.lo = __ldg(lo + idx);
  h.hi = min(h.lo + 1, n - 1);
  h.w1 = __ldg(t + idx);
  h.w0 = 1.f - h.w1;
  return h;
}

// Row-pair stride of G in shared memory: odd, so that the columns a warp
// gathers fall in distinct banks.
__host__ __device__ inline int g_stride(int pc) { return pc | 1; }

// Shared-memory floats of a block holding pc row pairs: G (C, stride),
// pay[p, r] (pc) and off[p, :] (pc, P).
__host__ __device__ inline size_t post_smem_floats(int C, int P, int pc) {
  return (size_t)C * g_stride(pc) + pc + (size_t)pc * P;
}

template <bool kPost>
__global__ void __launch_bounds__(kThreads)
    post_gather_kernel(const float* __restrict__ field,
                       const int* __restrict__ lo_l,
                       const float* __restrict__ t_l,
                       const int* __restrict__ lo_c,
                       const float* __restrict__ t_c,
                       const int* __restrict__ lo_h,
                       const float* __restrict__ t_h,
                       const int* __restrict__ lo_z,
                       const float* __restrict__ t_z,
                       const float* __restrict__ pay,
                       const float* __restrict__ off,
                       const float* __restrict__ s,
                       const float* __restrict__ lk_row,
                       const float* __restrict__ lk_col,
                       float* __restrict__ out, int n_l, int n_k, int n_i,
                       int n_j, int d, int pc, float theta, float beta) {
  extern __shared__ float smem[];
  const int R = n_l * n_k, C = n_i * n_j, P = d * d, S = g_stride(pc);
  float* g = smem;                   // G_{p0+pp}[r, col] at col * S + pp
  float* po = g + (size_t)C * S;     // pay[p0 + pp, r]
  float* oq = po + pc;               // off[p0 + pp, q] at pp * P + q
  const int r = blockIdx.y, l = r / n_k, k = r % n_k;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool active = c < C;
  const int ci = active ? c / n_j : 0, cj = active ? c % n_j : 0;
  float acc = 0.f;
  for (int p0 = 0; p0 < P; p0 += pc) {
    const int np = min(pc, P - p0);
    __syncthreads();                 // the previous chunk's readers done
    // G_p[r, col] for the chunk's row pairs: consecutive threads read
    // consecutive columns of the four corner rows of F.
    for (int x = threadIdx.x; x < np * C; x += kThreads) {
      const int pp = x / C, col = x - pp * C, p = p0 + pp;
      const Hat a = hat(lo_l, t_l, (p / d) * n_l + l, n_l);
      const Hat b = hat(lo_c, t_c, (p % d) * n_k + k, n_k);
      const float* f = field + col;
      float v = (a.w0 * b.w0) * __ldg(f + (size_t)(a.lo * n_k + b.lo) * C);
      v = fmaf(a.w0 * b.w1, __ldg(f + (size_t)(a.lo * n_k + b.hi) * C), v);
      v = fmaf(a.w1 * b.w0, __ldg(f + (size_t)(a.hi * n_k + b.lo) * C), v);
      v = fmaf(a.w1 * b.w1, __ldg(f + (size_t)(a.hi * n_k + b.hi) * C), v);
      g[(size_t)col * S + pp] = v;
    }
    for (int x = threadIdx.x; x < np; x += kThreads)
      po[x] = __ldg(pay + (size_t)(p0 + x) * R + r);
    for (int x = threadIdx.x; x < np * P; x += kThreads)
      oq[x] = __ldg(off + (size_t)p0 * P + x);
    __syncthreads();
#if SDFS_SPLIT == 1
    if (active) acc += g[(size_t)c * S];
#else
    if (active) {
      for (int q = 0; q < P; ++q) {
        const Hat hz = hat(lo_h, t_h, (q / d) * n_i + ci, n_i);
        const Hat z = hat(lo_z, t_z, ((q % d) * n_i + ci) * n_j + cj, n_j);
        const float w00 = hz.w0 * z.w0, w01 = hz.w0 * z.w1;
        const float w10 = hz.w1 * z.w0, w11 = hz.w1 * z.w1;
        const float* g00 = g + (size_t)(hz.lo * n_j + z.lo) * S;
        const float* g01 = g + (size_t)(hz.lo * n_j + z.hi) * S;
        const float* g10 = g + (size_t)(hz.hi * n_j + z.lo) * S;
        const float* g11 = g + (size_t)(hz.hi * n_j + z.hi) * S;
        const float* o = oq + q;
        auto term = [&](int pp) {
          float v = w00 * g00[pp];
          v = fmaf(w01, g01[pp], v);
          v = fmaf(w10, g10[pp], v);
          v = fmaf(w11, g11[pp], v);
#if SDFS_SPLIT == 2
          return v;
#else
          const float e = kPost ? theta * logf(v) : theta * v;
          return expf(e + po[pp] + o[pp * P]);
#endif
        };
        // Five independent terms in flight, summed in order of p.  (The
        // loop is unrolled by hand: nvcc 12.9's "#pragma unroll 5" on
        // this loop gave wrong sums when np was not a multiple of 5.)
        int pp = 0;
        for (; pp + 5 <= np; pp += 5) {
          const float t0 = term(pp), t1 = term(pp + 1), t2 = term(pp + 2);
          const float t3 = term(pp + 3), t4 = term(pp + 4);
          acc += t0;
          acc += t1;
          acc += t2;
          acc += t3;
          acc += t4;
        }
#pragma unroll 1
        for (; pp < np; ++pp) acc += term(pp);
      }
    }
#endif
  }
  if (!active) return;
#if SDFS_SPLIT >= 4
  const float log_kg = logf(acc) + __ldg(s) + __ldg(lk_row + r) +
                       __ldg(lk_col + c);
  out[(size_t)r * C + c] = log1pf(beta * expf(log_kg / theta));
#else
  out[(size_t)r * C + c] = acc;
#endif
}

}  // namespace

extern "C" {

// Row pairs per shared-memory chunk for C columns and P = d^2 row pairs:
// the most that keep a block within kGBudget, else the most that fit a
// block at all; 0 when not even one fits.
int sdfs_post_interp_chunk(int C, int P) {
  const size_t limits[2] = {(size_t)kGBudget, (size_t)kSmemLimit};
  for (size_t limit : limits) {
    for (int pc = P; pc >= 1; --pc)
      if (sizeof(float) * post_smem_floats(C, P, pc) <= limit) return pc;
  }
  return 0;
}

// One application on field (R, C) = (n_l*n_k, n_i*n_j): the corner tables
// lo_* (int32) and t_* (float32) of shapes (d, n_l), (d, n_k), (d, n_i),
// (d, n_i, n_j); pay (d^2, R), off (d^2, d^2), s (1,), lk_row (R,),
// lk_col (C,); out (R, C).  post = 1 for "post", 0 for "loglin".
int sdfs_post_interp(const float* field, const int* lo_l, const float* t_l,
                     const int* lo_c, const float* t_c, const int* lo_h,
                     const float* t_h, const int* lo_z, const float* t_z,
                     const float* pay, const float* off, const float* s,
                     const float* lk_row, const float* lk_col, float* out,
                     int n_l, int n_k, int n_i, int n_j, int d, float theta,
                     float beta, int post, void* stream) {
  if (n_l <= 0 || n_k <= 0 || n_i <= 0 || n_j <= 0 || d <= 0 ||
      n_l * n_k > 65535)
    return cudaErrorInvalidValue;
  const int R = n_l * n_k, C = n_i * n_j, P = d * d;
  const int pc = sdfs_post_interp_chunk(C, P);
  if (pc == 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * post_smem_floats(C, P, pc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kThreads - 1) / kThreads, R);
  const auto kernel =
      post ? post_gather_kernel<true> : post_gather_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(field, lo_l, t_l, lo_c, t_c, lo_h,
                                       t_h, lo_z, t_z, pay, off, s, lk_row,
                                       lk_col, out, n_l, n_k, n_i, n_j, d,
                                       pc, theta, beta);
  return cudaGetLastError();
}

const char* sdfs_post_interp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
