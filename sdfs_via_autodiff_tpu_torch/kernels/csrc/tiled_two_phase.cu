// Strip-tier kernels of the two-phase operator for NVIDIA Hopper (sm_90a).
//
// The two-phase operator log T(w) on a field ell[t, i, j] (R rows t, a
// column group of n1 x n2 columns (i, j)) whose column factors may be
// batched: W_c1 shared (n1, n1) or batched over the NEXT c2 index j
// (n2, n1, n1), W_c2 shared (n2, n2) or batched over the CURRENT c1 index
// i (n1, n2, n2), each dense or in the lazy form
// W[b] = exp(logW0 + sum_k t[k, b] D[k]) (rank K = 1 for the normalized
// SSY set, 2 for the normalized GCY one), built here tile by tile.
//
//   column phase (strip_contract, with strip_midmax / strip_rowmax for
//   the shifts), mode "lse":
//     a = theta*ell [- sub_row[t] - sub_col[i, j], one FMA then one
//     subtraction, as the port's pass B]; m1[t, j] = max_i a;
//     a2[t, i, j] = m1 + log(sum_m W_c1(j)[i, m] exp(a[t, m, j] - m1));
//     m2[t, i] = max_j a2; mid[t, i, j] = m2 + log(sum_m W_c2(i)[j, m]
//     exp(a2[t, i, m] - m2)).
//   mode "fast": s[t] = max over the row of a, then the same two
//     contractions in the linear domain on exp(a - s), emitting (mid, s).
//     Replaces sdfs_via_autodiff_tpu/kernels/tiled_two_phase.py:170
//     (_col_phase_kernel) and :226 (_col_phase_fast_kernel).
//   row phase (strip_row_kernel), one block per tile of TC columns with
//     all R = L*K rows in shared memory; lse: m1[k, c] = max_l mid,
//     y = m1 + log(W_r1 exp(mid - m1)) over l', m2[l, c] = max_k y,
//     lh = m2 + log(W_r2 exp(y - m2)) over k'; fast: row r scaled by
//     scale[r] = exp(s_r - S), two linear contractions, lh = S + log(.);
//     then + add_row[l, k] + add_col[c] and log1p(beta*exp(lh/theta)).
//     Replaces tiled_two_phase.py:195 (_row_phase_kernel) and :259
//     (_row_phase_fast_kernel).
//
// What bounds them on an H100: the contractions are FP32 FMA chains (no
// tensor cores: TF32's 10-bit mantissa misses the 1e-6-class bar),
// 2*R*n1*n2*(n1 + n2) FLOP for the column phase (38.7 GFLOP at the
// normalized GCY view (192, 512, 256), 10.7 at the normalized SSY
// (1024, 32, 384)) against ~200 MB of field traffic: operations, not
// bytes.  The TPU kernel holds whole row strips and whole (B, n, n)
// factors in VMEM.  A Hopper block holds 227 KB, less than one GCY row
// (512 KB) or one lazy slice (1 MB), so each contraction here is a tiled
// batched matrix product, out[b][p, q] = sum_m F(b)[p, m] X[b][m, q],
// with the batch b the factor's batch index (j for c1, i for c2), q the
// field row t and m the contracted axis: one block per (8 batches,
// 32 outputs p, 32 rows q), K-tiles of 8 of m staged in shared memory.
// The field tile is transformed on load (fold, exp of the shifted value),
// the factor tile read densely or built from the lazy form (one expf per
// entry per block), and each thread keeps 4 x 8 sums in registers.  The
// shifts are separate reductions, so every exp sees its final shift.
// Threads are laid out so that neighbouring threads read and write
// neighbouring batch entries for c1 (b = j is the minor axis) and
// neighbouring p for c2 (p = j).  This first version does not stage the
// next tile while computing the current one.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError(); the Python wrappers validate every argument.
// Transcendentals are CUDA's expf/logf/log1pf, built without fast-math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBB = 8;    // batches per block
constexpr int kBP = 32;   // outputs p per block
constexpr int kBQ = 32;   // field rows q per block
constexpr int kBK = 8;    // contracted m per K-tile
constexpr int kPad = 4;   // keeps shared rows 16-byte aligned, spreads banks
constexpr int kRowThreads = 512;

enum InMode { kInFoldExp = 0, kInExp = 1, kInLinear = 2 };

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

// theta*x less the folded baseline: one rounding of theta*x - sub_row
// before the cancellation down to O(1), then the column part.
template <bool HAS_SUB>
__device__ __forceinline__ float fold(float x, float theta, float sr,
                                      const float* sub_col, size_t c) {
  return HAS_SUB ? __fsub_rn(__fmaf_rn(theta, x, -sr), __ldg(sub_col + c))
                 : theta * x;
}

// m1[t, j] = max_i a[t, i, j], a the folded ell (R, n1, n2): one thread
// per (t, j), neighbouring threads on neighbouring j.
template <bool HAS_SUB>
__global__ void __launch_bounds__(kThreads)
strip_midmax_kernel(const float* __restrict__ ell,
                    const float* __restrict__ sub_row,
                    const float* __restrict__ sub_col, float theta,
                    float* __restrict__ m1, int n1, int n2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t t = blockIdx.y;
  if (j >= n2) return;
  const float sr = HAS_SUB ? __ldg(sub_row + t) : 0.f;
  const float* row = ell + t * n1 * n2;
  float m = -INFINITY;
  for (int i = 0; i < n1; ++i)
    m = fmaxf(m, fold<HAS_SUB>(row[(size_t)i * n2 + j], theta, sr, sub_col,
                               (size_t)i * n2 + j));
  m1[t * n2 + j] = m;
}

// out[r] = max over the contiguous row r (length len) of src as it is
// (FOLD false) or folded, theta*x less sub_row[r] and sub_col[x] when
// HAS_SUB: one block per row.
template <bool FOLD, bool HAS_SUB>
__global__ void __launch_bounds__(kThreads)
strip_rowmax_kernel(const float* __restrict__ src,
                    const float* __restrict__ sub_row,
                    const float* __restrict__ sub_col, float theta,
                    float* __restrict__ out, int len) {
  __shared__ float scratch[32];
  const size_t r = blockIdx.x;
  const float* row = src + r * len;
  const float sr = HAS_SUB ? __ldg(sub_row + r) : 0.f;
  float m = -INFINITY;
  for (int x = threadIdx.x; x < len; x += blockDim.x)
    m = fmaxf(m, FOLD ? fold<HAS_SUB>(row[x], theta, sr, sub_col, x)
                      : row[x]);
  m = block_max(m, scratch);
  if (threadIdx.x == 0) out[r] = m;
}

// The operands of one batched contraction
//   out[b][p, q] = [sh(b, q) + log] sum_m F(b)[p, m] X(b, m, q)
// over batches b < B, outputs p < P, field rows q < Q, contracted m < M.
struct Contract {
  // Field: X(b, m, q) from src[q*sq + b*sb + m*sm]; kInFoldExp folds it
  // (sub_row[q], sub_col[b*sb + m*sm]) and takes exp(a - sh), kInExp
  // takes exp(x - sh), kInLinear reads it as it is.
  const float* src;
  long long sb, sm, sq;
  const float *sub_row, *sub_col;
  float theta;
  // Shift sh(b, q) = sh[q*shq + b*shb].
  const float* sh;
  long long shb, shq;
  // Factor: dense F[b*fb + p*M + m] (fb = 0 for a shared factor), or
  // lazy exp(logw0[p*M + m] + sum_k t[k*B + b] * D[k*P*M + p*M + m]).
  const float* F;
  long long fb;
  const float *logw0, *D, *t;
  int rank;
  // Output out[q*oq + b*ob + p*op].
  float* out;
  long long ob, op, oq;
  int B, P, M, Q;
};

template <int IN, bool HAS_SUB, bool LAZY, bool OUT_LOG>
__global__ void __launch_bounds__(kThreads)
strip_contract_kernel(const Contract c) {
  __shared__ __align__(16) float Fs[kBK][kBB][kBP + kPad];
  __shared__ __align__(16) float Xs[kBK][kBB][kBQ + kPad];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kBB, p0 = blockIdx.y * kBP,
            q0 = blockIdx.z * kBQ;
  // c1 (sb == 1): neighbouring threads on neighbouring batches; c2:
  // on neighbouring outputs p.
  const bool b_minor = c.sb == 1;
  const int bb = b_minor ? (tid & 7) : ((tid >> 3) & 7);
  const int pi = b_minor ? ((tid >> 3) & 7) : (tid & 7);
  const int qi = tid >> 6;                     // rows qi*8 .. qi*8 + 7
  const size_t PM = (size_t)c.P * c.M;

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[r][x] = 0.f;

  for (int m0 = 0; m0 < c.M; m0 += kBK) {
    __syncthreads();                           // previous tile consumed
    for (int x = tid; x < kBK * kBB * kBP; x += kThreads) {
      const int m = x % kBK, p = (x / kBK) % kBP, lb = x / (kBK * kBP);
      const int b = b0 + lb, pg = p0 + p, mg = m0 + m;
      float v = 0.f;
      if (b < c.B && pg < c.P && mg < c.M) {
        const size_t e = (size_t)pg * c.M + mg;
        if (LAZY) {
          float a = __ldg(c.logw0 + e);
          for (int k = 0; k < c.rank; ++k)
            a = __fadd_rn(a, __fmul_rn(__ldg(c.t + (size_t)k * c.B + b),
                                       __ldg(c.D + k * PM + e)));
          v = expf(a);
        } else {
          v = __ldg(c.F + b * c.fb + e);
        }
      }
      Fs[m][lb][p] = v;
    }
    for (int x = tid; x < kBK * kBB * kBQ; x += kThreads) {
      int m, lb;
      if (b_minor) {
        lb = x % kBB;
        m = (x / kBB) % kBK;
      } else {
        m = x % kBK;
        lb = (x / kBK) % kBB;
      }
      const int q = x / (kBK * kBB);
      const int b = b0 + lb, qg = q0 + q, mg = m0 + m;
      float v = 0.f;
      if (b < c.B && qg < c.Q && mg < c.M) {
        const size_t col = (size_t)b * c.sb + (size_t)mg * c.sm;
        const float raw = c.src[(size_t)qg * c.sq + col];
        if (IN == kInLinear) {
          v = raw;
        } else {
          const float sh = __ldg(c.sh + qg * c.shq + b * c.shb);
          const float a =
              (IN == kInFoldExp)
                  ? fold<HAS_SUB>(raw, c.theta,
                                  HAS_SUB ? __ldg(c.sub_row + qg) : 0.f,
                                  c.sub_col, col)
                  : raw;
          v = expf(a - sh);
        }
      }
      Xs[m][lb][q] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float f[4], xq[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) f[r] = Fs[k][bb][pi + 8 * r];
      const float4 x0 = *reinterpret_cast<const float4*>(&Xs[k][bb][qi * 8]);
      const float4 x1 =
          *reinterpret_cast<const float4*>(&Xs[k][bb][qi * 8 + 4]);
      xq[0] = x0.x; xq[1] = x0.y; xq[2] = x0.z; xq[3] = x0.w;
      xq[4] = x1.x; xq[5] = x1.y; xq[6] = x1.z; xq[7] = x1.w;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[r][x] = fmaf(f[r], xq[x], acc[r][x]);
    }
  }

  const int b = b0 + bb;
  if (b >= c.B) return;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int q = q0 + qi * 8 + x;
    if (q >= c.Q) continue;
    const float sh = OUT_LOG ? __ldg(c.sh + q * c.shq + b * c.shb) : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + pi + 8 * r;
      if (p < c.P)
        c.out[q * c.oq + b * c.ob + p * c.op] =
            OUT_LOG ? sh + logf(acc[r][x]) : acc[r][x];
    }
  }
}

// out[i, n] = sum_m A[i, m] * B[m, n] for i < I, n < N, by the whole
// block: each thread owns kTI rows and kTJ columns n = q0 + q * nq, so
// that neighbouring threads touch neighbouring columns.  The sum runs in
// order of m.
constexpr int kTI = 8, kTJ = 4;

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

// Shared-memory floats of a row-phase block: x and y (R*TC each) and the
// shifts m1 (K*TC) and m2 (L*TC).
__host__ __device__ inline size_t strip_row_smem_floats(int L, int K,
                                                        int TC) {
  return (size_t)TC * (2 * L * K + K + L);
}

template <bool FAST>
__global__ void __launch_bounds__(kRowThreads)
strip_row_kernel(const float* __restrict__ mid,
                 const float* __restrict__ scale, const float* __restrict__ S,
                 const float* __restrict__ w_r1,
                 const float* __restrict__ w_r2,
                 const float* __restrict__ add_row,
                 const float* __restrict__ add_col, float* __restrict__ out,
                 int L, int K, int C, int TC, float theta, float beta) {
  extern __shared__ float smem[];
  const int R = L * K, KT = K * TC;
  float* x = smem;            // (L, K, TC): the midway tile
  float* y = x + R * TC;      // (L, K, TC): after the l' contraction
  float* m1 = y + R * TC;     // (K, TC): lse shift over l
  float* m2 = m1 + KT;        // (L, TC): lse shift over k
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c0 = blockIdx.x * TC;
  const int tcw = min(TC, C - c0);

  for (int idx = tid; idx < R * TC; idx += nt) {
    const int r = idx / TC, t = idx % TC;
    float v = (t < tcw) ? mid[(size_t)r * C + c0 + t] : 0.f;
    if (FAST) v *= __ldg(scale + r);
    x[idx] = v;
  }
  __syncthreads();
  if (!FAST) {
    for (int col = tid; col < KT; col += nt) {
      float m = -INFINITY;
      for (int l = 0; l < L; ++l) m = fmaxf(m, x[l * KT + col]);
      m1[col] = m;
    }
    __syncthreads();
    for (int idx = tid; idx < R * TC; idx += nt)
      x[idx] = expf(x[idx] - m1[idx % KT]);
    __syncthreads();
  }

  // r1: y[l, k, t] = sum_m W_r1[l, m] x[m, k, t] (+ m1 + log in lse mode).
  block_matmul(
      L, KT, L,
      [&](int l, int m) { return __ldg(w_r1 + l * L + m); },
      [&](int m, int col) { return x[m * KT + col]; },
      [&](int l, int col, float v) {
        y[l * KT + col] = FAST ? v : m1[col] + logf(v);
      });
  __syncthreads();
  if (!FAST) {
    for (int lt = tid; lt < L * TC; lt += nt) {
      const int l = lt / TC, t = lt % TC;
      float m = -INFINITY;
      for (int k = 0; k < K; ++k) m = fmaxf(m, y[l * KT + k * TC + t]);
      m2[lt] = m;
    }
    __syncthreads();
    for (int idx = tid; idx < R * TC; idx += nt) {
      const int l = idx / KT, t = idx % TC;
      y[idx] = expf(y[idx] - m2[l * TC + t]);
    }
    __syncthreads();
  }

  // r2 + epilogue: z[l, k, t] = sum_m W_r2[k, m] y[l, m, t], columns
  // n = l * TC + t.
  const float s0 = FAST ? __ldg(S) : 0.f;
  block_matmul(
      K, L * TC, K,
      [&](int k, int m) { return __ldg(w_r2 + k * K + m); },
      [&](int m, int n) { return y[(n / TC) * KT + m * TC + n % TC]; },
      [&](int k, int n, float v) {
        const int l = n / TC, t = n % TC;
        if (t >= tcw) return;
        const int r = l * K + k;
        const float lh = (FAST ? s0 : m2[n]) + logf(v) +
                         __ldg(add_row + r) + __ldg(add_col + c0 + t);
        out[(size_t)r * C + c0 + t] = log1pf(beta * expf(lh / theta));
      });
}

template <int IN, bool HAS_SUB, bool LAZY, bool OUT_LOG>
cudaError_t launch_contract(const Contract& c, cudaStream_t st) {
  const dim3 grid((c.B + kBB - 1) / kBB, (c.P + kBP - 1) / kBP,
                  (c.Q + kBQ - 1) / kBQ);
  strip_contract_kernel<IN, HAS_SUB, LAZY, OUT_LOG>
      <<<grid, kThreads, 0, st>>>(c);
  return cudaGetLastError();
}

template <int IN, bool HAS_SUB, bool OUT_LOG>
cudaError_t dispatch_lazy(const Contract& c, cudaStream_t st) {
  return c.logw0 != nullptr
             ? launch_contract<IN, HAS_SUB, true, OUT_LOG>(c, st)
             : launch_contract<IN, HAS_SUB, false, OUT_LOG>(c, st);
}

}  // namespace

extern "C" {

// m1 (R, n2) = max over i of the folded ell (R, n1, n2); sub_row (R,) and
// sub_col (n1, n2) both given or both null.
int sdfs_strip_midmax(const float* ell, const float* sub_row,
                      const float* sub_col, float theta, float* m1, int R,
                      int n1, int n2, void* stream) {
  if ((sub_row == nullptr) != (sub_col == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n2 + kThreads - 1) / kThreads, R);
  if (sub_row != nullptr)
    strip_midmax_kernel<true><<<grid, kThreads, 0, st>>>(
        ell, sub_row, sub_col, theta, m1, n1, n2);
  else
    strip_midmax_kernel<false><<<grid, kThreads, 0, st>>>(
        ell, nullptr, nullptr, theta, m1, n1, n2);
  return cudaGetLastError();
}

// out (rows,) = max over each contiguous row of src (rows, len), as it
// is (fold 0) or folded (fold 1: theta*x, less sub_row (rows,) and
// sub_col (len,) when given, both or neither).
int sdfs_strip_rowmax(const float* src, const float* sub_row,
                      const float* sub_col, float theta, int fold,
                      float* out, int rows, int len, void* stream) {
  if ((sub_row == nullptr) != (sub_col == nullptr) ||
      (!fold && sub_row != nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sub_row != nullptr)
    strip_rowmax_kernel<true, true><<<rows, kThreads, 0, st>>>(
        src, sub_row, sub_col, theta, out, len);
  else if (fold)
    strip_rowmax_kernel<true, false><<<rows, kThreads, 0, st>>>(
        src, nullptr, nullptr, theta, out, len);
  else
    strip_rowmax_kernel<false, false><<<rows, kThreads, 0, st>>>(
        src, nullptr, nullptr, theta, out, len);
  return cudaGetLastError();
}

// One batched contraction (see struct Contract).  in_mode: 0 fold + exp
// (sub_row/sub_col optional, both or neither), 1 exp of the shifted
// field, 2 the field as it is; out_log: write sh + log(sum).  A lazy
// factor is given by logw0 (P, M), D (rank, P, M) and t (rank, B), a
// dense one by F with batch stride fb.
int sdfs_strip_contract(const float* src, long long sb, long long sm,
                        long long sq, const float* sub_row,
                        const float* sub_col, float theta, const float* sh,
                        long long shb, long long shq, const float* F,
                        long long fb, const float* logw0, const float* D,
                        const float* t, int rank, float* out, long long ob,
                        long long op, long long oq, int B, int P, int M,
                        int Q, int in_mode, int out_log, void* stream) {
  if ((sub_row == nullptr) != (sub_col == nullptr) ||
      (logw0 == nullptr) == (F == nullptr) || B <= 0 || P <= 0 || M <= 0 ||
      Q <= 0 || (P + kBP - 1) / kBP > 65535 || (Q + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  const Contract c{src,   sb,    sm, sq,  sub_row, sub_col, theta, sh,
                   shb,   shq,   F,  fb,  logw0,   D,       t,     rank,
                   out,   ob,    op, oq,  B,       P,       M,     Q};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sub = sub_row != nullptr;
  if (in_mode == kInFoldExp) {
    if (sub)
      return out_log ? dispatch_lazy<kInFoldExp, true, true>(c, st)
                     : dispatch_lazy<kInFoldExp, true, false>(c, st);
    return out_log ? dispatch_lazy<kInFoldExp, false, true>(c, st)
                   : dispatch_lazy<kInFoldExp, false, false>(c, st);
  }
  if (sub) return cudaErrorInvalidValue;
  if (in_mode == kInExp && out_log)
    return dispatch_lazy<kInExp, false, true>(c, st);
  if (in_mode == kInLinear && !out_log)
    return dispatch_lazy<kInLinear, false, false>(c, st);
  return cudaErrorInvalidValue;
}

// Row phase over mid (R = L*K, C) in tiles of TC columns: mode 0 fast
// (scale (R,), S (1,)), mode 1 lse; add_row (L*K,), add_col (C,);
// out (R, C).
int sdfs_strip_row(const float* mid, const float* scale, const float* S,
                   const float* w_r1, const float* w_r2,
                   const float* add_row, const float* add_col, float* out,
                   int L, int K, int C, int TC, float theta, float beta,
                   int mode, void* stream) {
  const size_t smem = sizeof(float) * strip_row_smem_floats(L, K, TC);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (C + TC - 1) / TC;
  cudaError_t err;
  if (mode == 0) {
    err = cudaFuncSetAttribute(strip_row_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    strip_row_kernel<true><<<blocks, kRowThreads, smem, st>>>(
        mid, scale, S, w_r1, w_r2, add_row, add_col, out, L, K, C, TC, theta,
        beta);
  } else if (mode == 1) {
    err = cudaFuncSetAttribute(strip_row_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    strip_row_kernel<false><<<blocks, kRowThreads, smem, st>>>(
        mid, scale, S, w_r1, w_r2, add_row, add_col, out, L, K, C, TC, theta,
        beta);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* sdfs_strip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
