// Strip-tier kernels of the two-phase operator for NVIDIA Hopper (sm_90a).
//
// The two-phase operator log T(w) on a field ell[t, i, j] (R rows t, a
// column group of n1 x n2 columns (i, j)) whose column factors may be
// batched: W_c1 shared (n1, n1) or batched over the NEXT c2 index j
// (n2, n1, n1), W_c2 shared (n2, n2) or batched over the CURRENT c1 index
// i (n1, n2, n2), each dense or in the lazy form
// W[b] = exp(logW0 + sum_k t[k, b] D[k]) (rank K = 1 for the normalized
// SSY set, 2 for the normalized GCY one).
//
//   column phase (sdfs_strip_col), mode "lse":
//     a = theta*ell [- sub_row[t] - sub_col[i, j], one FMA then one
//     subtraction, as the port's pass B]; m1[t, j] = max_i a;
//     a2[t, i, j] = m1 + log(sum_m W_c1(j)[i, m] exp(a[t, m, j] - m1));
//     m2[t, i] = max_j a2; mid[t, i, j] = m2 + log(sum_m W_c2(i)[j, m]
//     exp(a2[t, i, m] - m2)).
//   mode "fast": s[t] = max over the row of a, then the same two
//     contractions in the linear domain on exp(a - s), emitting (mid, s).
//     Replaces sdfs_via_autodiff_tpu/kernels/tiled_two_phase.py:170
//     (_col_phase_kernel) and :226 (_col_phase_fast_kernel).
//   row phase (strip_row_kernel in row_phase.cuh, shared with the
//     streamed tier's pass C), a persistent grid over tiles of TC
//     columns with all R = L*K rows in shared memory; lse: m1[k, c] =
//     max_l mid, y = m1 + log(W_r1 exp(mid - m1)) over l', m2[l, c] =
//     max_k y,
//     lh = m2 + log(W_r2 exp(y - m2)) over k'; fast: row r scaled by
//     scale[r] = exp(s_r - S), two linear contractions, lh = S + log(.);
//     then + add_row[l, k] + add_col[c] and log1p(beta*exp(lh/theta)).
//     Replaces tiled_two_phase.py:195 (_row_phase_kernel) and :259
//     (_row_phase_fast_kernel).
//
// What bounds the column phase on an H100: 2*R*n1*n2*(n1 + n2) FP32 FMA
// FLOP (10.5 GFLOP at the SSY cell (1024, 32, 384), 38.7 at the GCY view
// (192, 512, 256); no tensor cores: TF32's 10-bit mantissa misses the
// 1e-6-class bar) against ~100-200 MB of field traffic: operations.  The
// TPU kernel holds whole row strips and (B, n, n) factors in VMEM; a
// Hopper block holds 227 KB, so the phase is two tiled matrix products,
// each fed by one pass over the field:
//
//   1. a shift pass (strip_colmax_kernel: m1 per (t, j); fast:
//      strip_rowmax_kernel: s per row) and an exp pass (strip_exp_kernel)
//      that writes X1 = exp(a - shift) once, transposed through shared
//      memory into a workspace laid out for the c1 product (field rows t
//      contiguous): each field entry is exponentiated once per
//      contraction;
//   2. the c1 product (strip_gemm_kernel), whose epilogue (m1 + log, or
//      the linear sum) writes a2 straight into the layout of c2's
//      operand;
//   3. lse: strip_shift_kernel, m2 per (t, i) and exp(a2 - m2) in place
//      (each thread's values held in registers between the two);
//   4. the c2 product, whose epilogue writes mid (m2 + log, or linear).
//
// strip_gemm_kernel computes out[b][p, q] = sum_m F(b)[p, m] X(b)[m, n]:
// p the factor's output index, m the contracted one, n a field row t of
// batch b (a batched factor: one grid row per batch) or, for a shared
// factor, the pair (b, t) with the batch axis folded into N (one product
// (P x M) . (M x B*R)).  A block owns a TM x TN output tile, each thread
// an 8 x 8 tile in registers (rows ty*4 + {0..3} and TM/2 + ty*4 +
// {0..3}, columns likewise, so both operands are read as float4 from
// shared memory), each warp 4 x 8 threads' tiles (one shared-memory
// wavefront per float4 load); K-chunks of 16 are double-buffered: X's
// chunk arrives by cp.async while the current one is multiplied, F's
// chunk is loaded into registers first and stored transposed after, a
// lazy entry built there (logW0 + t[0,b] D[0] + t[1,b] D[1] in JAX's
// _slice_W order, then expf), one barrier per chunk.  A lazy factor's
// entries are built once
// per block: once per launch where one column tile spans all field rows
// (TN = 192 covers the GCY view's 192).  The tiles (gemm_tile, mirrored
// by tiled_two_phase.strip_col_layout): P <= 32: 32 x 256; a lazy factor
// or P <= 64: 64 x 192 (N <= 192) or 64 x 256; else 128 x 128.
//
// The C entry points launch on the caller's stream, allocate nothing (the
// caller passes sdfs_strip_col_work_floats floats of workspace) and
// return cudaGetLastError(); the Python wrappers validate every argument.
// Transcendentals are CUDA's expf/logf/log1pf, built without fast-math.
// SDFS_STRIP_SPLIT = 1 stops the column phase after its first shift and
// exp pass, 2 after the c1 product, 3 after the c2 shift (lse), each
// stage's result stored (bench/kernel_split.py).

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "occupancy.cuh"
#include "row_phase.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;           // contracted m per product chunk
constexpr int kExpI = 8;          // i per exp-pass block
constexpr int kGroups = 8;        // threads sharing one shift reduction

__host__ __device__ constexpr int up4(int x) { return (x + 3) / 4 * 4; }

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

// m1[j*Qp + t] = max_i a[t, i, j], a the folded ell (R, n1, n2): a block
// of 32 columns j x kGroups, each group of threads striding i.
template <bool HAS_SUB>
__global__ void __launch_bounds__(kThreads)
strip_colmax_kernel(const float* __restrict__ ell,
                    const float* __restrict__ sub_row,
                    const float* __restrict__ sub_col, float theta,
                    float* __restrict__ m1, int n1, int n2, int Qp) {
  __shared__ float part[kGroups][32];
  const int jl = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + jl;
  const size_t t = blockIdx.y;
  float m = -INFINITY;
  if (j < n2) {
    const float sr = HAS_SUB ? __ldg(sub_row + t) : 0.f;
    const float* row = ell + t * n1 * n2;
#pragma unroll 4
    for (int i = g; i < n1; i += kGroups) {
      const size_t c = (size_t)i * n2 + j;
      m = fmaxf(m, fold<HAS_SUB>(row[c], theta, sr, sub_col, c));
    }
  }
  part[g][jl] = m;
  __syncthreads();
  if (g == 0 && j < n2) {
#pragma unroll
    for (int x = 1; x < kGroups; ++x) m = fmaxf(m, part[x][jl]);
    m1[(size_t)j * Qp + t] = m;
  }
}

// out[r] = max over the contiguous row r (length len) of the folded src
// (theta*x, less sub_row[r] and sub_col[x] when HAS_SUB): one block per
// row.
template <bool HAS_SUB>
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
    m = fmaxf(m, fold<HAS_SUB>(row[x], theta, sr, sub_col, x));
  m = block_max(m, scratch);
  if (threadIdx.x == 0) out[r] = m;
}

// X[j*sj + i*si + t] = exp(a[t, i, j] - sh[j*shj + t*sht]): a block of
// 32 t x 32 j over kExpI values of i, read along j into a shared tile
// (all kExpI rounds of loads in flight), then written along t.
template <bool HAS_SUB>
__global__ void __launch_bounds__(kThreads)
strip_exp_kernel(const float* __restrict__ ell,
                 const float* __restrict__ sub_row,
                 const float* __restrict__ sub_col, float theta,
                 const float* __restrict__ sh, long long shj, long long sht,
                 float* __restrict__ X, long long sj, long long si, int R,
                 int n1, int n2) {
  __shared__ float tile[kExpI][32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j0 = blockIdx.x * 32, t0 = blockIdx.y * 32;
  const int i0 = blockIdx.z * kExpI, ni = min(kExpI, n1 - i0);
  const int j = j0 + tx;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty + 8 * r;
    if (t >= R || j >= n2) continue;
    const float s = __ldg(sh + j * shj + t * sht);
    const float sr = HAS_SUB ? __ldg(sub_row + t) : 0.f;
    const float* row = ell + (size_t)t * n1 * n2;
#pragma unroll
    for (int u = 0; u < kExpI; ++u) {
      if (u >= ni) break;
      const size_t c = (size_t)(i0 + u) * n2 + j;
      tile[u][ty + 8 * r][tx] =
          expf(fold<HAS_SUB>(row[c], theta, sr, sub_col, c) - s);
    }
  }
  __syncthreads();
  const int t = t0 + tx;
  if (t >= R) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int jj = j0 + ty + 8 * r;
    if (jj >= n2) continue;
#pragma unroll
    for (int u = 0; u < kExpI; ++u)
      if (u < ni) X[jj * sj + (i0 + u) * si + t] = tile[u][tx][ty + 8 * r];
  }
}

// In place on X (i, j, t) = X[i*xi + j*xj + t]: m2[i*Qp + t] = max_j X,
// then X = exp(X - m2).  A block of 32 t x kGroups, each group striding
// j; up to kShiftHeld values a thread stay in registers between the two
// loops, so X is read once (n2 <= kGroups * kShiftHeld).
constexpr int kShiftHeld = 64;

__global__ void __launch_bounds__(kThreads)
strip_shift_kernel(float* __restrict__ X, long long xi, long long xj,
                   float* __restrict__ m2, int R, int n2, int Qp) {
  __shared__ float part[kGroups][32];
  const int tl = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + tl;
  const size_t i = blockIdx.y;
  float* x = X + i * xi + t;
  float held[kShiftHeld];
  const bool in_regs = n2 <= kGroups * kShiftHeld;
  float m = -INFINITY;
  if (t < R) {
    if (in_regs) {
#pragma unroll
      for (int u = 0; u < kShiftHeld; ++u) {
        const int j = g + u * kGroups;
        held[u] = j < n2 ? x[j * xj] : -INFINITY;
        m = fmaxf(m, held[u]);
      }
    } else {
#pragma unroll 4
      for (int j = g; j < n2; j += kGroups) m = fmaxf(m, x[j * xj]);
    }
  }
  part[g][tl] = m;
  __syncthreads();
#pragma unroll
  for (int y = 0; y < kGroups; ++y) m = fmaxf(m, part[y][tl]);
  if (t >= R) return;
  if (g == 0) m2[i * Qp + t] = m;
  if (in_regs) {
#pragma unroll
    for (int u = 0; u < kShiftHeld; ++u) {
      const int j = g + u * kGroups;
      if (j < n2) x[j * xj] = expf(held[u] - m);
    }
  } else {
#pragma unroll 4
    for (int j = g; j < n2; j += kGroups) x[j * xj] = expf(x[j * xj] - m);
  }
}

// One tiled product of the column phase (see the header):
//   out[b*ob + p*op + q*oq] = [sh[b*shb + q*shq] + log] sum_m F(b)[p, m]
//   X[b*xb + m*xm + n]
// over p < P, m < M and columns n < N: q = n with b the grid's batch, or
// (fold) b = n / Qp, q = n % Qp; columns with q >= Q are not stored.
// X's rows are 16-byte aligned, N and Qp multiples of 4.
struct Gemm {
  const float* X;
  long long xb, xm;
  // Dense F[b*fb + p*M + m] (fb = 0: shared), or lazy
  // exp(logw0[p*M + m] + sum_k t[k*nb + b] * D[k*P*M + p*M + m]).
  const float* F;
  long long fb;
  const float *logw0, *D, *t;
  float* out;
  long long ob, op, oq;
  const float* sh;  // null: the linear sum
  long long shb, shq;
  int P, M, N, Q, Qp, nb, p_tiles;
  int fold;
  int vec;  // float4 stores: 1 along q (oq == 1), 2 along p (op == 1)
};

// Two blocks per SM are asked of the 192-thread tile only (at most 170
// registers, no spills); capping the others at 128 registers spilled and
// ran 1-12% slower (kernel_split, H100).
template <int TM, int TN, int RANK>
__global__ void __launch_bounds__((TM / 8) * (TN / 8),
                                  (TM / 8) * (TN / 8) == 192 ? 2 : 1)
strip_gemm_kernel(const Gemm g) {
  constexpr int NT = (TM / 8) * (TN / 8);
  constexpr int TX = TN / 8;
  constexpr int A_N = TM * kKC, B_N = TN / 4 * kKC;
  constexpr int A_PER = (A_N + NT - 1) / NT, B_PER = (B_N + NT - 1) / NT;
  __shared__ __align__(16) float As[2][kKC][TM + 4];
  __shared__ __align__(16) float Bs[2][kKC][TN + 4];
  const int tid = threadIdx.x;
  const int p0 = (blockIdx.x % g.p_tiles) * TM;
  const int n0 = (blockIdx.x / g.p_tiles) * TN;
  const int b = blockIdx.y;
  const float* X = g.X + (size_t)b * g.xb;
  const float* F = RANK == 0 ? g.F + (size_t)b * g.fb : g.logw0;
  const size_t PM = (size_t)g.P * g.M;
  float tk[RANK > 0 ? RANK : 1];
#pragma unroll
  for (int k = 0; k < RANK; ++k) tk[k] = __ldg(g.t + (size_t)k * g.nb + b);

  // F's chunk: entry e = (p, m) = (e / kKC, e % kKC), neighbouring threads
  // on neighbouring m; raw values held in registers across the product.
  float ra[A_PER][RANK + 1];
  auto load_a = [&](int m0) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int e = tid + r * NT;
      const int p = p0 + e / kKC, m = m0 + e % kKC;
      const bool ok = (A_N % NT == 0 || e < A_N) && p < g.P && m < g.M;
      const size_t x = (size_t)p * g.M + m;
      ra[r][0] = ok ? __ldg(F + x) : (RANK > 0 ? -INFINITY : 0.f);
#pragma unroll
      for (int k = 0; k < RANK; ++k)
        ra[r][k + 1] = ok ? __ldg(g.D + k * PM + x) : 0.f;
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int e = tid + r * NT;
      if (A_N % NT != 0 && e >= A_N) break;
      float v = ra[r][0];
      if (RANK > 0) {
#pragma unroll
        for (int k = 0; k < RANK; ++k)
          v = __fadd_rn(v, __fmul_rn(tk[k], ra[r][k + 1]));
        v = expf(v);
      }
      As[buf][e % kKC][e / kKC] = v;
    }
  };
  // X's chunk: 16-byte pieces, neighbouring threads on neighbouring
  // columns; rows beyond M and columns beyond N read zeros.
  auto load_b = [&](int m0, int buf) {
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      const int e = tid + r * NT;
      if (B_N % NT != 0 && e >= B_N) break;
      const int c4 = e % (TN / 4), row = e / (TN / 4);
      const int m = m0 + row, n = n0 + 4 * c4;
      const bool ok = m < g.M && n < g.N;
      cp_async16(&Bs[buf][row][4 * c4], ok ? X + (size_t)m * g.xm + n : g.X,
                 ok);
    }
    cp_async_commit();
  };

  // A warp owns 4 x 8 threads' tiles, so that its shared loads per k are
  // 4 distinct float4 of A and 8 of B, one wavefront each (a warp along
  // one row of 32 threads read 32 of B: 4 wavefronts, 14% slower at the
  // SSY cell).
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp / (TX / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (TX / 8)) * 8 + (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int chunks = (g.M + kKC - 1) / kKC;
  load_b(0, 0);
  load_a(0);
  store_a(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < chunks;
    if (more) {
      load_b((c + 1) * kKC, cur ^ 1);
      load_a((c + 1) * kKC);
    }
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][TM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][TN / 2 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_a(cur ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  // Epilogue: each of the thread's 2 x 2 groups of 4 rows x 4 columns.
#pragma unroll
  for (int jg = 0; jg < 2; ++jg) {
    const int n = n0 + jg * (TN / 2) + tx * 4;
    if (n >= g.N) continue;
    const int bb = g.fold ? n / g.Qp : b;
    const int q = g.fold ? n - bb * g.Qp : n;
    if (q >= g.Q) continue;
    const int nq = min(4, g.Q - q);
    float sh[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      sh[u] = (g.sh != nullptr && u < nq)
                  ? __ldg(g.sh + (size_t)bb * g.shb + (size_t)(q + u) * g.shq)
                  : 0.f;
#pragma unroll
    for (int ig = 0; ig < 2; ++ig) {
      const int pb = p0 + ig * (TM / 2) + ty * 4;
      if (pb >= g.P) continue;
      const int np = min(4, g.P - pb);
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float a = acc[ig * 4 + i][jg * 4 + u];
          v[i][u] = g.sh != nullptr ? sh[u] + logf(a) : a;
        }
      float* o = g.out + (size_t)bb * g.ob + (size_t)pb * g.op +
                 (size_t)q * g.oq;
      if (g.vec == 1 && nq == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < np)
            *reinterpret_cast<float4*>(o + i * g.op) =
                make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      } else if (g.vec == 2 && np == 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nq)
            *reinterpret_cast<float4*>(o + u * g.oq) =
                make_float4(v[0][u], v[1][u], v[2][u], v[3][u]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i < np && u < nq) o[i * g.op + u * g.oq] = v[i][u];
      }
    }
  }
}

// The factor of a contraction: 0 shared (dense, batch stride 0), 1 dense
// batched, 2 lazy (batched).
int factor_kind(const float* F, long long fb) {
  return F == nullptr ? 2 : (fb != 0 ? 1 : 0);
}

// A product's tile (TM x TN): P <= 32 -> 32 x 256; a lazy factor or P <=
// 64 -> 64 x 192 where N <= 192 (one column tile sweeps every field row)
// else 64 x 256; else 128 x 128.
void gemm_tile(int P, int N, int kind, int* tm, int* tn) {
  if (P <= 32) {
    *tm = 32, *tn = 256;
  } else if (kind == 2 || P <= 64) {
    *tm = 64, *tn = N <= 192 ? 192 : 256;
  } else {
    *tm = 128, *tn = 128;
  }
}

// (TM, TN, p_tiles, n_tiles, batches, threads) of one contraction with
// P outputs per batch, N columns, `batches` grid rows.
void gemm_layout(int P, long long N, int kind, int batches, int* out) {
  int tm, tn;
  gemm_tile(P, (int)min(N, (long long)INT_MAX), kind, &tm, &tn);
  out[0] = tm;
  out[1] = tn;
  out[2] = (P + tm - 1) / tm;
  out[3] = (int)min((N + tn - 1) / tn, (long long)INT_MAX);
  out[4] = batches;
  out[5] = (tm / 8) * (tn / 8);
}

template <int TM, int TN>
cudaError_t launch_gemm_tile(const Gemm& g, int rank, dim3 grid,
                             cudaStream_t st) {
  constexpr int NT = (TM / 8) * (TN / 8);
  switch (rank) {
    case 0:
      strip_gemm_kernel<TM, TN, 0><<<grid, NT, 0, st>>>(g);
      break;
    case 1:
      strip_gemm_kernel<TM, TN, 1><<<grid, NT, 0, st>>>(g);
      break;
    case 2:
      strip_gemm_kernel<TM, TN, 2><<<grid, NT, 0, st>>>(g);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_gemm(Gemm g, int kind, int rank, int batches,
                        cudaStream_t st) {
  int lay[6];
  gemm_layout(g.P, g.N, kind, batches, lay);
  const long long blocks = (long long)lay[2] * lay[3];
  if (blocks > INT_MAX || batches > 65535) return cudaErrorInvalidValue;
  g.p_tiles = lay[2];
  const dim3 grid((unsigned)blocks, batches);
  if (lay[0] == 32) return launch_gemm_tile<32, 256>(g, rank, grid, st);
  if (lay[0] == 64 && lay[1] == 192)
    return launch_gemm_tile<64, 192>(g, rank, grid, st);
  if (lay[0] == 64) return launch_gemm_tile<64, 256>(g, rank, grid, st);
  return launch_gemm_tile<128, 128>(g, rank, grid, st);
}

// Workspace of the column phase: X1 and X2 (n1 * n2 * Qp each), m1 (n2 *
// Qp), m2 (n1 * Qp), Qp = R rounded up to 4.
long long col_work_floats(int R, int n1, int n2) {
  const long long Qp = up4(R);
  return 2LL * n1 * n2 * Qp + (long long)(n1 + n2) * Qp;
}

}  // namespace

extern "C" {

// Workspace floats of sdfs_strip_col.
long long sdfs_strip_col_work_floats(int R, int n1, int n2) {
  return col_work_floats(R, n1, n2);
}

// The launcher's layout of the column phase's two products: out[0..5] for
// c1 and out[6..11] for c2, each (TM, TN, p_tiles, n_tiles, batches,
// threads); kind1 / kind2 are the factors' kinds (0 shared, 1 dense
// batched, 2 lazy).  Returns 1.
int sdfs_strip_col_layout(int R, int n1, int n2, int kind1, int kind2,
                          int* out) {
  const long long Qp = up4(R);
  gemm_layout(n1, kind1 ? Qp : n2 * Qp, kind1, kind1 ? n2 : 1, out);
  gemm_layout(n2, kind2 ? Qp : n1 * Qp, kind2, kind2 ? n1 : 1, out + 6);
  return 1;
}

// The column phase of ell (R, n1, n2) into out (R, n1, n2): mode 0 fast
// (s (R,) receives the row shifts), 1 lse.  Factor k is dense (Fk, batch
// stride fbk, 0 when shared) or lazy (logw0_k, Dk, tk of rank 1 or 2);
// sub_row (R,) and sub_col (n1, n2) both given or both null; work holds
// sdfs_strip_col_work_floats floats.
int sdfs_strip_col(const float* ell, const float* sub_row,
                   const float* sub_col, float theta, const float* F1,
                   long long fb1, const float* logw0_1, const float* D1,
                   const float* t1, int rank1, const float* F2,
                   long long fb2, const float* logw0_2, const float* D2,
                   const float* t2, int rank2, float* out, float* s,
                   float* work, int R, int n1, int n2, int mode,
                   void* stream) {
  const bool lazy1 = logw0_1 != nullptr, lazy2 = logw0_2 != nullptr;
  if ((mode != 0 && mode != 1) || (sub_row == nullptr) != (sub_col == nullptr)
      || (F1 == nullptr) != lazy1 || (F2 == nullptr) != lazy2
      || (lazy1 ? rank1 < 1 || rank1 > 2 || !D1 || !t1 : rank1 != 0)
      || (lazy2 ? rank2 < 1 || rank2 > 2 || !D2 || !t2 : rank2 != 0)
      || R <= 0 || n1 <= 0 || n2 <= 0 || R > 65535 || n1 > 65535
      || n2 > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fast = mode == 0, sub = sub_row != nullptr;
  const int Qp = up4(R);
  const long long field = (long long)n1 * n2 * Qp;
  float* X1 = work;
  float* X2 = work + field;
  float* m1 = X2 + field;
  float* m2 = m1 + (long long)n2 * Qp;
  const int k1 = factor_kind(F1, fb1), k2 = factor_kind(F2, fb2);
  // X1 (j, i, t) for c1: batched over j, or i-major with (j, t) folded.
  const long long sj = k1 ? (long long)n1 * Qp : Qp;
  const long long si = k1 ? Qp : (long long)n2 * Qp;
  // X2 (i, j, t) for c2: batched over i, or j-major with (i, t) folded.
  const long long x2i = k2 ? (long long)n2 * Qp : Qp;
  const long long x2j = k2 ? Qp : (long long)n1 * Qp;

  // 1. The first shift and X1 = exp(a - shift).
  const float* sh1 = fast ? s : m1;
  const long long shj = fast ? 0 : Qp;
  if (fast) {
    if (sub)
      strip_rowmax_kernel<true><<<R, kThreads, 0, st>>>(
          ell, sub_row, sub_col, theta, s, n1 * n2);
    else
      strip_rowmax_kernel<false><<<R, kThreads, 0, st>>>(
          ell, nullptr, nullptr, theta, s, n1 * n2);
  } else {
    const dim3 grid((n2 + 31) / 32, R);
    if (sub)
      strip_colmax_kernel<true><<<grid, kThreads, 0, st>>>(
          ell, sub_row, sub_col, theta, m1, n1, n2, Qp);
    else
      strip_colmax_kernel<false><<<grid, kThreads, 0, st>>>(
          ell, nullptr, nullptr, theta, m1, n1, n2, Qp);
  }
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  {
    const dim3 grid((n2 + 31) / 32, (R + 31) / 32,
                    (n1 + kExpI - 1) / kExpI);
    if (sub)
      strip_exp_kernel<true><<<grid, kThreads, 0, st>>>(
          ell, sub_row, sub_col, theta, sh1, shj, 1, X1, sj, si, R, n1, n2);
    else
      strip_exp_kernel<false><<<grid, kThreads, 0, st>>>(
          ell, nullptr, nullptr, theta, sh1, shj, 1, X1, sj, si, R, n1, n2);
  }
  rc = cudaGetLastError();
#if SDFS_STRIP_SPLIT == 1
  return rc;
#endif
  if (rc != cudaSuccess) return rc;

  // 2. c1: F = W_c1(j) (p = i, m = i'), columns t (or (j, t)); the
  // epilogue writes a2 (m1 + log) or the linear sum into X2's layout.
  Gemm g1{X1, k1 ? (long long)n1 * Qp : 0, k1 ? (long long)Qp : n2 * (long long)Qp,
          F1, fb1, logw0_1, D1, t1, X2, x2j, x2i, 1,
          fast ? nullptr : m1, Qp, 1,
          n1, n1, (int)(k1 ? Qp : (long long)n2 * Qp), R, Qp, n2, 0,
          !k1, 1};
  if ((long long)n2 * Qp > INT_MAX) return cudaErrorInvalidValue;
  rc = launch_gemm(g1, k1, rank1, k1 ? n2 : 1, st);
#if SDFS_STRIP_SPLIT == 2
  return rc;
#endif
  if (rc != cudaSuccess) return rc;

  // 3. lse: m2 per (t, i) and exp(a2 - m2) in place.
  if (!fast) {
    strip_shift_kernel<<<dim3((R + 31) / 32, n1), kThreads, 0, st>>>(
        X2, x2i, x2j, m2, R, n2, Qp);
    rc = cudaGetLastError();
  }
#if SDFS_STRIP_SPLIT == 3
  return rc;
#endif
  if (rc != cudaSuccess) return rc;

  // 4. c2: F = W_c2(i) (p = j, m = j'), columns t (or (i, t)); the
  // epilogue writes mid[t, i, j] (m2 + log, or the linear sum).
  if ((long long)n1 * Qp > INT_MAX) return cudaErrorInvalidValue;
  Gemm g2{X2, k2 ? (long long)n2 * Qp : 0, k2 ? (long long)Qp : n1 * (long long)Qp,
          F2, fb2, logw0_2, D2, t2, out, n2, 1, (long long)n1 * n2,
          fast ? nullptr : m2, Qp, 1,
          n2, n2, (int)(k2 ? Qp : (long long)n1 * Qp), R, Qp, n1, 0,
          !k2, n2 % 4 == 0 ? 2 : 0};
  return launch_gemm(g2, k2, rank2, k2 ? n1 : 1, st);
}

// The row phase's layout at (L, K), as sdfs_strip_row launches it
// (tiled_two_phase.strip_row_layout mirrors it): out = {TC, threads,
// shared-memory bytes, LS, slabs, wide}.  Returns 0 when no tile fits.
int sdfs_strip_row_layout(int L, int K, int* out) {
  RowLayout lay;
  if (!strip_row_layout(L, K, &lay)) return 0;
  out[0] = lay.tc;
  out[1] = kRowThreads;
  out[2] = (int)(sizeof(float) * (size_t)lay.smem);
  out[3] = lay.ls;
  out[4] = lay.slabs;
  out[5] = lay.wide;
  return 1;
}

// Row phase over mid (R = L*K, C): mode 0 fast (scale (R,), S (1,)),
// mode 1 lse; add_row (L*K,), add_col (C,); out (R, C).  A persistent
// grid of min(tiles, co-resident blocks) in the layout of
// sdfs_strip_row_layout.
int sdfs_strip_row(const float* mid, const float* scale, const float* S,
                   const float* w_r1, const float* w_r2,
                   const float* add_row, const float* add_col, float* out,
                   int L, int K, int C, float theta, float beta, int mode,
                   void* stream) {
  if (mode != kRowFast && mode != kRowLse) return cudaErrorInvalidValue;
  return launch_row_phase(mid, scale, S, w_r1, w_r2, add_row, add_col, out,
                          L, K, C, theta, beta, mode,
                          static_cast<cudaStream_t>(stream));
}

const char* sdfs_strip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
