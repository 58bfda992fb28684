// BiCGStab's vector work in five fused passes for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's BiCGStab
// (sdfs_via_autodiff_tpu/solvers/krylov.py) is jnp code that XLA fuses
// into its while loop.  Eager PyTorch runs the same iteration as ~90
// launches: float64 casts of whole fields for each of six dot products,
// separate float32 updates and a torch.where freeze per state vector,
// ~6.8 GB of traffic per iteration at 12.6M entries.  Here one iteration
// is five passes around the two matvecs (solvers/krylov.bicgstab_fused):
//
//   P1  p <- r + beta (p - omega v)                      reads r, p, v
//   P2  <rhat, v>            -> alpha, bad_a              reads rhat, v
//   P3  s <- r - alpha v (over r); <s, s>                 reads r, v
//   P4  <t, t>, <t, s>       -> omega, half               reads t, s
//   P5  x <- pick(x + alpha p + omega s, x + alpha p, x);
//       r <- s - omega t; <rhat, r>, <r, r> -> next rho, stop
//                                                         reads x, p, s, t, rhat
//
// and P0 reduces <r, r> once at the start.  What bounds them is device
// memory: ~0.9 GB per iteration at 12.6M float32 entries, 0.27 ms at
// 3.35 TB/s.  Each pass reads its vectors once (16-byte loads where every
// pointer is 16-byte aligned), accumulates its dot products in float64
// inside the kernel (a float32 product is exact in float64) and writes
// each block's sums to `partials`; the block that finishes last (a
// counter, no floating-point atomics) sums the partials in a fixed order,
// so a solve repeats bitwise from run to run, and runs the scalar
// epilogue on the block of recurrence scalars S.  The host never reads S
// except for the solver's once-per-chunk stop read.  S's slots (kSlot*)
// are mirrored by kernels/krylov_fused.SLOTS.
//
// Semantics are those of the eager loop with a stop check after every
// iteration: S[kRun] is the eager loop's condition, evaluated once per
// iteration by the epilogue that decides it and sticky (the eager
// condition is monotone, because the state freezes), and every pass of a
// stopped solve returns at once.  Only x and the count obey the eager
// pick; p, v and r may hold anything once the stop is decided.  The
// float32 updates round each operation as eager PyTorch does
// (__fmul_rn/__fadd_rn/__fsub_rn, no contraction into FMAs), so the only
// difference from eager is the summation order of the float64 dots.
//
// A sharded iterate (`epilogue` = 0): the passes leave their reduced
// local sums in `sums`, the caller all-reduces those (one collective for
// a pass's two dots) and launches sdfs_krylov_epilogue.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError(); the Python wrapper validates every argument.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "occupancy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;

// Slots of the scalar block (float64; counts and flags as whole numbers).
enum Slot {
  kAtol2, kTiny, kMaxiter, kRho, kAlpha, kOmega, kRhoNew, kRr, kBeta, kRv,
  kAlphaNew, kBadA, kSs, kTt, kTs, kOmegaNew, kHalf, kIt, kOk, kRun,
  kSlots
};

// Rounded float32 / float64 operations: one rounding each, as eager.
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }

// A float64 recurrence scalar in the vector dtype (eager's `down`).
template <typename T>
__device__ __forceinline__ T down(double v) {
  if constexpr (std::is_same<T, float>::value) return __double2float_rn(v);
  else return v;
}

// acc + a b in float64, one rounding.
template <typename T>
__device__ __forceinline__ double dacc(T a, T b, double acc) {
  return __fma_rn(static_cast<double>(a), static_cast<double>(b), acc);
}

template <typename T, int W>
__device__ __forceinline__ void load(const T* p, long long i, T (&o)[W]) {
  if constexpr (W == 1) {
    o[0] = p[i];
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p + i);
    o[0] = q.x; o[1] = q.y;
  }
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, long long i, const T (&o)[W]) {
  if constexpr (W == 1) {
    p[i] = o[0];
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p + i) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    *reinterpret_cast<double2*>(p + i) = make_double2(o[0], o[1]);
  }
}

// The pass's scalars, read from S once per thread.
template <typename T>
struct Coef {
  T c0, c1;          // P1: beta, omega; P3: alpha; P5: alpha, omega_new
  bool bad, half;    // P5
};

// Pass PASS on the W entries from i.
template <typename T, int PASS, int W>
__device__ __forceinline__ void item(long long i, T* x, T* r, T* p,
                                     const T* w, const T* rhat,
                                     const Coef<T>& c, double& a0,
                                     double& a1) {
  T rv[W], wv[W];
  if constexpr (PASS == 0) {
    load<T, W>(r, i, rv);
#pragma unroll
    for (int j = 0; j < W; ++j) a0 = dacc(rv[j], rv[j], a0);
  } else if constexpr (PASS == 1) {
    T pv[W];
    load<T, W>(r, i, rv);
    load<T, W>(p, i, pv);
    load<T, W>(w, i, wv);
#pragma unroll
    for (int j = 0; j < W; ++j)
      pv[j] = radd(rv[j], rmul(c.c0, rsub(pv[j], rmul(c.c1, wv[j]))));
    store<T, W>(p, i, pv);
  } else if constexpr (PASS == 2) {
    T hv[W];
    load<T, W>(rhat, i, hv);
    load<T, W>(w, i, wv);
#pragma unroll
    for (int j = 0; j < W; ++j) a0 = dacc(hv[j], wv[j], a0);
  } else if constexpr (PASS == 3) {
    load<T, W>(r, i, rv);
    load<T, W>(w, i, wv);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      rv[j] = rsub(rv[j], rmul(c.c0, wv[j]));
      a0 = dacc(rv[j], rv[j], a0);
    }
    store<T, W>(r, i, rv);
  } else if constexpr (PASS == 4) {
    load<T, W>(r, i, rv);       // s
    load<T, W>(w, i, wv);       // t
#pragma unroll
    for (int j = 0; j < W; ++j) {
      a0 = dacc(wv[j], wv[j], a0);
      a1 = dacc(wv[j], rv[j], a1);
    }
  } else {
    T xv[W], pv[W], hv[W];
    load<T, W>(x, i, xv);
    load<T, W>(p, i, pv);
    load<T, W>(r, i, rv);       // s
    load<T, W>(w, i, wv);       // t
    load<T, W>(rhat, i, hv);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const T xh = radd(xv[j], rmul(c.c0, pv[j]));
      xv[j] = c.half ? xh : radd(xh, rmul(c.c1, rv[j]));
      rv[j] = rsub(rv[j], rmul(c.c1, wv[j]));
      a0 = dacc(hv[j], rv[j], a0);
      a1 = dacc(rv[j], rv[j], a1);
    }
    if (!c.bad) store<T, W>(x, i, xv);
    store<T, W>(r, i, rv);
  }
}

// Sum of a and b over the block, valid in thread 0; fixed order.
__device__ __forceinline__ void block_sum2(double& a, double& b,
                                          double (*sh)[kWarps]) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(full, a, off);
    b += __shfl_down_sync(full, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = a;
    sh[1][warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sh[0][lane] : 0.0;
    b = lane < kWarps ? sh[1][lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(full, a, off);
      b += __shfl_down_sync(full, b, off);
    }
  }
}

__device__ __forceinline__ double beta_of(const double* S) {
  return __dmul_rn(__ddiv_rn(S[kRhoNew], S[kRho]),
                   __ddiv_rn(S[kAlpha], S[kOmega]));
}

// The eager loop's condition on the state in S.
__device__ __forceinline__ double running(const double* S) {
  const double rr = S[kRr];
  return (rr > S[kAtol2] && S[kIt] < S[kMaxiter] && S[kOk] != 0.0 &&
          isfinite(rr)) ? 1.0 : 0.0;
}

// The recurrence scalars after pass `stage`'s sums (one thread).
__device__ void epilogue(int stage, double* S, const double* sums) {
  switch (stage) {
    case 0: {     // rho0 = <r, r>: the floors and the first condition
      const double rr = sums[0];
      S[kTiny] = __dmul_rn(rr < 1.0 ? 1.0 : rr, 1e-28);  // NaN stays
      S[kRho] = S[kAlpha] = S[kOmega] = 1.0;
      S[kRhoNew] = S[kRr] = rr;
      S[kIt] = 0.0;
      S[kOk] = 1.0;
      S[kBeta] = beta_of(S);
      S[kRun] = running(S);
      break;
    }
    case 2: {
      const double rv = sums[0];
      const double alpha = __ddiv_rn(S[kRhoNew], rv);
      S[kRv] = rv;
      S[kAlphaNew] = alpha;
      S[kBadA] = (fabs(S[kRhoNew]) <= S[kTiny] || fabs(rv) <= S[kTiny] ||
                  !isfinite(S[kBeta]) || !isfinite(alpha)) ? 1.0 : 0.0;
      break;
    }
    case 3:
      S[kSs] = sums[0];
      break;
    case 4: {
      const double tt = sums[0], ts = sums[1];
      const double omega = __ddiv_rn(ts, tt);
      S[kTt] = tt;
      S[kTs] = ts;
      S[kOmegaNew] = omega;
      S[kHalf] = (S[kSs] <= S[kAtol2] || tt <= S[kTiny] || !isfinite(omega))
                     ? 1.0 : 0.0;
      break;
    }
    case 5:
      S[kIt] += 1.0;
      if (S[kBadA] != 0.0 || S[kHalf] != 0.0) {
        S[kOk] = 0.0;
        S[kRun] = 0.0;
      } else {
        S[kRho] = S[kRhoNew];
        S[kAlpha] = S[kAlphaNew];
        S[kOmega] = S[kOmegaNew];
        S[kRhoNew] = sums[0];
        S[kRr] = sums[1];
        S[kBeta] = beta_of(S);
        S[kRun] = running(S);
      }
      break;
  }
}

template <typename T, int PASS, bool VEC>
__global__ void __launch_bounds__(kThreads)
krylov_pass_kernel(long long n, T* x, T* r, T* p, const T* w, const T* rhat,
                   double* S, double* partials, unsigned int* counter,
                   double* sums, int fused_epilogue) {
  if (PASS != 0 && S[kRun] == 0.0) return;     // a stopped solve
  constexpr int W = VEC ? 16 / sizeof(T) : 1;
  Coef<T> c{};
  if constexpr (PASS == 1) {
    c.c0 = down<T>(S[kBeta]);
    c.c1 = down<T>(S[kOmega]);
  } else if constexpr (PASS == 3) {
    c.c0 = down<T>(S[kAlphaNew]);
  } else if constexpr (PASS == 5) {
    c.c0 = down<T>(S[kAlphaNew]);
    c.c1 = down<T>(S[kOmegaNew]);
    c.bad = S[kBadA] != 0.0;
    c.half = S[kHalf] != 0.0;
  }
  double a0 = 0.0, a1 = 0.0;
  const long long nv = n / W;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long k = tid; k < nv; k += stride)
    item<T, PASS, W>(k * W, x, r, p, w, rhat, c, a0, a1);
  if (W > 1 && nv * W + tid < n)                // the ragged tail
    item<T, PASS, 1>(nv * W + tid, x, r, p, w, rhat, c, a0, a1);
  if constexpr (PASS == 1) return;              // no reduction

  __shared__ double sh[2][kWarps];
  __shared__ bool last;
  block_sum2(a0, a1, sh);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = a0;
    partials[2 * blockIdx.x + 1] = a1;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double b0 = 0.0, b1 = 0.0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    b0 += __ldcg(partials + 2 * j);
    b1 += __ldcg(partials + 2 * j + 1);
  }
  block_sum2(b0, b1, sh);
  if (threadIdx.x == 0) {
    sums[0] = b0;
    sums[1] = b1;
    *counter = 0u;
    if (fused_epilogue) epilogue(PASS, S, sums);
  }
}

__global__ void krylov_epilogue_kernel(int stage, double* S,
                                       const double* sums) {
  if (stage != 0 && S[kRun] == 0.0) return;
  epilogue(stage, S, sums);
}

template <typename T, int PASS, bool VEC>
cudaError_t launch(long long n, void* x, void* r, void* p, const void* w,
                   const void* rhat, double* S, double* partials,
                   unsigned int* counter, double* sums, int fused_epilogue,
                   cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = blocks_per_sm(
      (const void*)krylov_pass_kernel<T, PASS, VEC>, kThreads, 0, &per_sm,
      &sms);
  if (err != cudaSuccess) return err;
  constexpr int W = VEC ? 16 / sizeof(T) : 1;
  const long long items = (n / W + kThreads - 1) / kThreads;
  long long blocks = (long long)(per_sm < kMaxBlocksPerSm ? per_sm
                                                          : kMaxBlocksPerSm)
                     * sms;
  if (items < blocks) blocks = items;
  if (blocks < 1) blocks = 1;
  krylov_pass_kernel<T, PASS, VEC><<<(int)blocks, kThreads, 0, stream>>>(
      n, static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(p),
      static_cast<const T*>(w), static_cast<const T*>(rhat), S, partials,
      counter, sums, fused_epilogue);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_pass(int pass, long long n, void* x, void* r, void* p,
                        const void* w, const void* rhat, double* S,
                        double* partials, unsigned int* counter, double* sums,
                        int fused_epilogue, cudaStream_t st) {
#define SDFS_KRYLOV_PASS(k)                                                   \
  case k:                                                                     \
    return launch<T, k, VEC>(n, x, r, p, w, rhat, S, partials, counter, sums, \
                             fused_epilogue, st);
  switch (pass) {
    SDFS_KRYLOV_PASS(0)
    SDFS_KRYLOV_PASS(1)
    SDFS_KRYLOV_PASS(2)
    SDFS_KRYLOV_PASS(3)
    SDFS_KRYLOV_PASS(4)
    SDFS_KRYLOV_PASS(5)
  }
#undef SDFS_KRYLOV_PASS
  return cudaErrorInvalidValue;
}

bool aligned16(const void* q) {
  return q == nullptr || reinterpret_cast<unsigned long long>(q) % 16 == 0;
}

}  // namespace

extern "C" {

// Slots of the scalar block, for the wrapper's mirror.
int sdfs_krylov_slots(void) { return kSlots; }

// Rows of the partials buffer (two doubles a row) that every pass fits:
// the most blocks a pass launches on the current device.
int sdfs_krylov_max_blocks(void) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return kMaxBlocksPerSm * sms;
}

// Pass `pass` (0-5, the schedule above) over n entries of float32
// (f64 = 0) or float64 (f64 = 1) vectors; a pass ignores the pointers it
// does not use (pass null).  `w` is the matvec's output: v for passes
// 1-3, t for 4 and 5.  `fused_epilogue` = 1 runs the scalar epilogue in
// the last block; 0 leaves the block-reduced sums in `sums` for the
// caller's all-reduce and sdfs_krylov_epilogue.
int sdfs_krylov_pass(int pass, int f64, long long n, void* x, void* r,
                     void* p, const void* w, const void* rhat, double* S,
                     double* partials, unsigned int* counter, double* sums,
                     int fused_epilogue, void* stream) {
  if (pass < 0 || pass > 5 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(r) && aligned16(p) &&
                   aligned16(w) && aligned16(rhat);
  cudaError_t err;
  if (f64)
    err = vec ? launch_pass<double, true>(pass, n, x, r, p, w, rhat, S,
                                          partials, counter, sums,
                                          fused_epilogue, st)
              : launch_pass<double, false>(pass, n, x, r, p, w, rhat, S,
                                           partials, counter, sums,
                                           fused_epilogue, st);
  else
    err = vec ? launch_pass<float, true>(pass, n, x, r, p, w, rhat, S,
                                         partials, counter, sums,
                                         fused_epilogue, st)
              : launch_pass<float, false>(pass, n, x, r, p, w, rhat, S,
                                          partials, counter, sums,
                                          fused_epilogue, st);
  return (int)err;
}

// The scalar epilogue of pass `stage` (0, 2-5) on all-reduced `sums`.
int sdfs_krylov_epilogue(int stage, double* S, const double* sums,
                         void* stream) {
  krylov_epilogue_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      stage, S, sums);
  return (int)cudaGetLastError();
}

const char* sdfs_krylov_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
