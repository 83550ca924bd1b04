// Yardsticks: the first CUDA versions of kernels that later redesigns
// replaced, kept only so that a probe can time the old kernel beside the
// new one in the same run.  No path of the port calls them.
//
//   baseline_global_f32: blocked_chol_inverse.cu's first `global` variant
//     (one matrix a CTA worked on in place in device memory, tiles staged
//     synchronously through four 64 x 64 shared tiles, 4 x 4 register
//     tiles, diagonal blocks factored one column a barrier), with the same
//     -DBLOCKED_CHOL_PROFILE phase stamps as the current kernels;
//   baseline_fused_f32: sweep_variants.cu's first `fused` scheme (one
//     matrix a CTA in shared memory, a staging pass and two barriers a
//     pivot), its multiplies and adds written as __fmul_rn / __fadd_rn so
//     that, like its source's -fmad=false build, none is contracted;
//   baseline_pair_f32, baseline_blocked_f32: sweep_variants.cu's first
//     `pair` and `blocked` schemes (one matrix a CTA in shared memory; pair:
//     warp 0 rebuilds q's borders while the others wait, then a flat pass
//     with a five-way branch an element, two barriers a pair; blocked: an R
//     copy a panel, two barriers and a flat pass over the 32 x N slab a
//     pivot, a rank-32 update by 4 x 4 tiles from shared memory), written
//     with __fmul_rn / __fadd_rn / __fsub_rn as the fused one is.  Built
//     with -DSWEEP_PROFILE they stamp clock64() per warp at the end of each
//     phase, as sweep_variants.cu's current kernels do (pair: load and
//     store, border rebuild, update pass, barrier waits; blocked: load and
//     store, R copy, panel pivots, rank-32 update).
//   baseline_rbf_gram_f32, baseline_rbf_gram_f64: gram.cu's first kernel
//     (a 64 x 64 output tile a CTA of 256 threads, one CTA a tile, the
//     tile's scaled rows staged in shared memory 32 features a pass, 4 x 4
//     outputs a thread 16 columns apart, scalar stores).  Built with
//     -DGRAM_PROFILE every warp stamps clock64() at the end of each phase,
//     as gram.cu's current kernel does: staging, norms, cross term, exp and
//     store, and the waits at its barriers.
//   baseline_rank1_cholesky_f32, baseline_traversal_floor_f32:
//     probe_kernels.cu's first versions, in the select sweep kernel's
//     layout (N <= 32: CAP = 8, 16 or 32 lanes a matrix, lane j column j in
//     CAP registers, 128 / CAP matrices a CTA of 128 threads; N <= 128: a
//     CTA of 16 x 16 threads a matrix, thread (ty, tx) an R x R register
//     tile (R = 4 or 8) of rows ty + 16 r and columns tx + 16 c; one barrier
//     a step).  The factor's step k: s = rsqrt(A[k][k]), c = A[:, k] s,
//     r = A[k, :] s, the trailing block (i > k, j > k) loses c r (a
//     multiply, then a subtract), the other elements take the update with a
//     zero factor, column k from the diagonal down becomes c; its rows
//     equal its columns bit for bit, as A is symmetric.  The floor's step:
//     A = A * 0.9999999f + float(k) * 1e-12f over the whole block.  Each
//     multiply, add and subtract is written __fmul_rn / __fadd_rn /
//     __fsub_rn, so that none is contracted: the floor equals its plain
//     version (ops/probes.py::traversal_floor_reference) bit for bit.
//     baseline_probe_geometry reports their launch, select's
//     (ops/sweep.py::launch_geometry).
//
// Built by scamlgp_tpu_torch/ops/cuda_build.py like the other sources;
// scamlgp_tpu_torch/profile_kernels.py and chip_smoke.py time them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "gram_profile.h"

namespace {

constexpr int BS = 64;
constexpr int TILE = BS * BS;
constexpr int THREADS = 256;
constexpr int kThreads = 256;

enum Phase { PH_LOAD, PH_DIAG, PH_TRSM, PH_SYRK, PH_TRINV, PH_WTW, PH_COUNT };
#ifdef BLOCKED_CHOL_PROFILE
__device__ unsigned long long g_baseline_phase_cycles[PH_COUNT + 1];
#define PROF_DECL                       \
  long long prof_last = clock64();      \
  long long prof_acc[PH_COUNT] = {};
#define PROF_MARK(ph)                          \
  do {                                         \
    __syncthreads();                           \
    if (threadIdx.x == 0) {                    \
      const long long now = clock64();         \
      prof_acc[ph] += now - prof_last;         \
      prof_last = now;                         \
    }                                          \
  } while (0)
#define PROF_FLUSH()                                              \
  do {                                                            \
    if (threadIdx.x == 0) {                                       \
      for (int p = 0; p < PH_COUNT; ++p)                          \
        atomicAdd(&g_baseline_phase_cycles[p],                             \
                  static_cast<unsigned long long>(prof_acc[p]));  \
      atomicAdd(&g_baseline_phase_cycles[PH_COUNT], 1ull);                 \
    }                                                             \
  } while (0)
#else
#define PROF_DECL
#define PROF_MARK(ph) \
  do {                \
  } while (0)
#define PROF_FLUSH() \
  do {               \
  } while (0)
#endif

// Element (r, c) of a 64 x 64 tile in shared memory.  The XOR keeps each row
// a permutation of itself and puts the 32 rows of a column in 32 banks.
__device__ __forceinline__ int sw(int r, int c) {
  return r * BS + (c ^ (r & 31));
}

__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }
__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }
__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// Each thread owns a 4 x 4 register tile of a 64 x 64 result: rows
// ty + 16 i and columns tx + 16 j.
template <typename T>
struct Acc {
  T v[4][4];
};

template <typename T>
__device__ __forceinline__ void zero(Acc<T>& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.v[i][j] = T(0);
}

// acc (+|-)= op(A) op(B), op(X) = X or X^T, for tiles in shared memory.
template <typename T, bool TA, bool TB, bool SUB>
__device__ __forceinline__ void tile_mma(Acc<T>& acc, const T* A, const T* B) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < BS; ++k) {
    T a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      a[i] = TA ? A[sw(k, r)] : A[sw(r, k)];
      if (SUB) a[i] = -a[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      b[j] = TB ? B[sw(c, k)] : B[sw(k, c)];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[i][j] = fma(a[i], b[j], acc.v[i][j]);
  }
}

template <typename T>
__device__ __forceinline__ void acc_to_tile(const Acc<T>& acc, T* t) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[sw(ty + 16 * i, tx + 16 * j)] = acc.v[i][j];
}

// A tile of a row-major matrix in device memory with leading dimension ld.
template <typename T>
__device__ __forceinline__ void acc_from_global(Acc<T>& acc, const T* g,
                                                int ld) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc.v[i][j] = g[static_cast<size_t>(ty + 16 * i) * ld + tx + 16 * j];
}

// Writes the register tile to rows r0.., columns c0.. of an n x n matrix,
// dropping what falls past n.
template <typename T>
__device__ __forceinline__ void acc_to_global(const Acc<T>& acc, T* g, int n,
                                              int r0, int c0) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < n && c < n) g[static_cast<size_t>(r) * n + c] = acc.v[i][j];
    }
  }
}

template <typename T>
__device__ __forceinline__ void tile_from_global(T* t, const T* g, int ld) {
  for (int idx = threadIdx.x; idx < TILE; idx += THREADS) {
    const int r = idx >> 6, c = idx & 63;
    t[sw(r, c)] = g[static_cast<size_t>(r) * ld + c];
  }
}

template <typename T>
__device__ __forceinline__ void tile_to_global(const T* t, T* g, int ld) {
  for (int idx = threadIdx.x; idx < TILE; idx += THREADS) {
    const int r = idx >> 6, c = idx & 63;
    g[static_cast<size_t>(r) * ld + c] = t[sw(r, c)];
  }
}

// The transpose of tile t to rows r0.., columns c0.. of an n x n matrix,
// dropping what falls past n.  Reads columns of t, writes rows of g.
template <typename T>
__device__ __forceinline__ void tile_t_to_global(const T* t, T* g, int n,
                                                 int r0, int c0) {
  for (int idx = threadIdx.x; idx < TILE; idx += THREADS) {
    const int r = idx >> 6, c = idx & 63;
    if (r0 + r < n && c0 + c < n)
      g[static_cast<size_t>(r0 + r) * n + c0 + c] = t[sw(c, r)];
  }
}

// Element (R, C) of the n x n matrix a padded with the identity past n.
template <typename T>
__device__ __forceinline__ T padded(const T* a, int n, int R, int C) {
  return (R < n && C < n) ? a[static_cast<size_t>(R) * n + C]
                          : (R == C ? T(1) : T(0));
}

// In place: the lower triangle of P (SPD) becomes its Cholesky factor L
// (the upper triangle is never read), and X becomes L^{-1} (zero above the
// diagonal).  Step j downdates the trailing block with column j and applies
// the inverse of the j-th elementary factor to X; the scaling of column j
// of P and row j of X waits for step j + 1, which touches neither, so each
// step needs one barrier.  Returns the sum of log pivots (every thread).
template <typename T>
__device__ T chol_inv_tile(T* P, T* X) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < TILE; idx += THREADS) {
    const int r = idx >> 6, c = idx & 63;
    X[sw(r, c)] = (r == c) ? T(1) : T(0);
  }
  T logdet = T(0), prev_inv = T(0), prev_sqrt = T(0);
  for (int j = 0; j <= BS; ++j) {
    __syncthreads();
    if (j > 0 && tid < BS) {
      const int p = j - 1;
      if (tid > p) {
        P[sw(tid, p)] *= prev_inv;
      } else {
        if (tid == p) P[sw(p, p)] = prev_sqrt;
        X[sw(p, tid)] *= prev_inv;
      }
    }
    if (j == BS) break;
    const T d = P[sw(j, j)];
    const T s = sqrt_of(d);
    const T inv = T(1) / s;
    logdet += log_of(d);
    const int m = BS - 1 - j;
    for (int t = tid; t < m * m; t += THREADS) {
      const int i = j + 1 + t / m, k = j + 1 + t % m;
      if (k <= i) P[sw(i, k)] -= (P[sw(i, j)] * inv) * (P[sw(k, j)] * inv);
    }
    const int w = j + 1;
    for (int t = tid; t < m * w; t += THREADS) {
      const int i = j + 1 + t / w, c = t % w;
      X[sw(i, c)] -= (P[sw(i, j)] * inv) * (X[sw(j, c)] * inv);
    }
    prev_inv = inv;
    prev_sqrt = s;
  }
  __syncthreads();
  return logdet;
}

// work: (B, np, np), the padded copy the kernel works in; out: (B, n, n).
// They are one buffer when n == np: the last phase then overwrites each W
// block only after the last product that reads it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    baseline_global_kernel(const T* __restrict__ a, T* work, T* out,
                               T* __restrict__ logdet, int n, int nb) {
  extern __shared__ double smem_d[];
  T* s0 = reinterpret_cast<T*>(smem_d);
  T* s1 = s0 + TILE;
  T* s2 = s1 + TILE;
  T* s3 = s2 + TILE;
  const int np = nb * BS;
  const T* A = a + static_cast<size_t>(blockIdx.x) * n * n;
  T* G = work + static_cast<size_t>(blockIdx.x) * np * np;
  T* O = out + static_cast<size_t>(blockIdx.x) * n * n;
  auto g = [&](int i, int j) {
    return G + static_cast<size_t>(i * BS) * np + j * BS;
  };
  PROF_DECL

  for (int i = 0; i < nb; ++i)
    for (int j = 0; j <= i; ++j) {
      T* t = g(i, j);
      for (int idx = threadIdx.x; idx < TILE; idx += THREADS) {
        const int r = idx >> 6, c = idx & 63;
        t[static_cast<size_t>(r) * np + c] =
            padded(A, n, i * BS + r, j * BS + c);
      }
    }
  __syncthreads();
  PROF_MARK(PH_LOAD);

  T ld = T(0);
  for (int b = 0; b < nb; ++b) {
    tile_from_global(s0, g(b, b), np);
    ld += chol_inv_tile(s0, s1);  // s1 = Linv[b][b] until the next b
    tile_to_global(s1, g(b, b), np);
    PROF_MARK(PH_DIAG);
    for (int i = b + 1; i < nb; ++i) {
      tile_from_global(s0, g(i, b), np);
      __syncthreads();
      Acc<T> acc;
      zero(acc);
      tile_mma<T, false, true, false>(acc, s0, s1);
      acc_to_global(acc, g(i, b), np, 0, 0);
      __syncthreads();
    }
    PROF_MARK(PH_TRSM);
    for (int i = b + 1; i < nb; ++i) {
      tile_from_global(s0, g(i, b), np);
      for (int j = b + 1; j <= i; ++j) {
        const T* right = s0;
        if (j != i) {
          tile_from_global(s2, g(j, b), np);
          right = s2;
        }
        __syncthreads();
        Acc<T> acc;
        acc_from_global(acc, g(i, j), np);
        tile_mma<T, false, true, true>(acc, s0, right);
        acc_to_global(acc, g(i, j), np, 0, 0);
        __syncthreads();
      }
    }
    PROF_MARK(PH_SYRK);
  }

  for (int j = 0; j < nb; ++j)
    for (int i = j + 1; i < nb; ++i) {
      Acc<T> acc;
      zero(acc);
      for (int k = j; k < i; ++k) {
        tile_from_global(s0, g(i, k), np);
        tile_from_global(s2, g(k, j), np);
        __syncthreads();
        tile_mma<T, false, false, false>(acc, s0, s2);
        __syncthreads();
      }
      acc_to_tile(acc, s3);
      tile_from_global(s0, g(i, i), np);
      __syncthreads();
      zero(acc);
      tile_mma<T, false, false, true>(acc, s0, s3);
      acc_to_global(acc, g(i, j), np, 0, 0);
      __syncthreads();
    }
  PROF_MARK(PH_TRINV);

  for (int i = 0; i < nb; ++i)
    for (int j = 0; j <= i; ++j) {
      Acc<T> acc;
      zero(acc);
      for (int k = i; k < nb; ++k) {
        tile_from_global(s0, g(k, i), np);
        if (j != i) tile_from_global(s2, g(k, j), np);
        __syncthreads();
        tile_mma<T, true, false, false>(acc, s0, j != i ? s2 : s0);
        __syncthreads();
      }
      acc_to_global(acc, O, n, i * BS, j * BS);
      if (i != j) {
        acc_to_tile(acc, s3);
        __syncthreads();
        tile_t_to_global(s3, O, n, j * BS, i * BS);
      }
      __syncthreads();
    }
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
  PROF_MARK(PH_WTW);
  PROF_FLUSH();
}

// ---------------------------------------------------------------------------
// fused
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    baseline_fused_kernel(const float* __restrict__ a, float* __restrict__ inv,
                          float* __restrict__ logdet, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* A = reinterpret_cast<float*>(smem_raw);
  float* cd = A + n * n;
  float* u = cd + n;
  float* w = u + n;
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  // each thread updates column j of rows i0, i0 + rstep, ...
  const int j = threadIdx.x % n;
  const int i0 = threadIdx.x / n;
  const int rstep = blockDim.x / n;

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    A[idx] = a[base + idx];
  float ld = 0.0f;
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float d = A[k * n + k];
    const float inv_d = 1.0f / d;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float e = (i == k) ? 1.0f : 0.0f;
      const float r = A[k * n + i];
      cd[i] = __fmul_rn(A[i * n + k], inv_d);
      u[i] = e - r;
      w[i] = __fsub_rn(__fmul_rn(r, inv_d), __fmul_rn(e, inv_d + 2.0f));
    }
    if (threadIdx.x == 0) ld += logf(d);
    __syncthreads();
    if (i0 < rstep) {
      const float uj = u[j];
      const float wj = w[j];
      for (int i = i0; i < n; i += rstep) {
        const float e = (i == k) ? 1.0f : 0.0f;
        A[i * n + j] = __fadd_rn(__fadd_rn(A[i * n + j], __fmul_rn(cd[i], uj)),
                                 __fmul_rn(e, wj));
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    inv[base + idx] = -A[idx];
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// ---------------------------------------------------------------------------
// pair and blocked: phase stamps per warp under -DSWEEP_PROFILE
// ---------------------------------------------------------------------------

enum SweepPhase { SP_LOAD_STORE, SP_A, SP_B, SP_C, SP_COUNT };
#ifdef SWEEP_PROFILE
// [0: pair, 1: blocked][phase], the last slot the warps counted
__device__ unsigned long long g_baseline_sweep_cycles[2][SP_COUNT + 1];
#define SPROF_DECL                  \
  long long sp_last = clock64();    \
  long long sp_acc[SP_COUNT] = {};
#define SPROF_MARK(ph)                 \
  do {                                 \
    const long long now_ = clock64();  \
    sp_acc[ph] += now_ - sp_last;      \
    sp_last = now_;                    \
  } while (0)
#define SPROF_FLUSH(s)                                                    \
  do {                                                                    \
    if ((threadIdx.x & 31) == 0) {                                        \
      for (int p_ = 0; p_ < SP_COUNT; ++p_)                               \
        atomicAdd(&g_baseline_sweep_cycles[s][p_],                        \
                  static_cast<unsigned long long>(sp_acc[p_]));           \
      atomicAdd(&g_baseline_sweep_cycles[s][SP_COUNT], 1ull);             \
    }                                                                     \
  } while (0)
// A barrier that ends phase ph, its wait counted in SP_C: the stamp before
// it feeds the barrier's predicate, so that it is read before the wait (a
// plain stamp there was read after the release)
#define SPROF_SYNC(ph)                         \
  do {                                         \
    const long long at_ = clock64();           \
    sp_acc[ph] += at_ - sp_last;               \
    __syncthreads_or(at_ == 0);                \
    sp_last = clock64();                       \
    sp_acc[SP_C] += sp_last - at_;             \
  } while (0)
#else
#define SPROF_DECL
#define SPROF_MARK(ph) \
  do {                 \
  } while (0)
#define SPROF_SYNC(ph) __syncthreads()
#define SPROF_FLUSH(s) \
  do {                 \
  } while (0)
#endif

// ---------------------------------------------------------------------------
// pair
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    baseline_pair_kernel(const float* __restrict__ a, float* __restrict__ inv,
                         float* __restrict__ logdet, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* A = reinterpret_cast<float*>(smem_raw);
  float* cdp = A + n * n;     // col_p / d_p
  float* rowp = cdp + n;      // row p before the pair
  float* cdq = rowp + n;      // q's column after p, / d_q'
  float* rowq1 = cdq + n;     // row q after p
  float* colpf = rowq1 + n;   // column p after the pair
  float* rowpf = colpf + n;   // row p after the pair
  float* rowqf = rowpf + n;   // row q after the pair
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  const int j = threadIdx.x % n;
  const int i0 = threadIdx.x / n;
  const int rstep = blockDim.x / n;
  SPROF_DECL

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    A[idx] = a[base + idx];
  float ld = 0.0f;
  SPROF_SYNC(SP_LOAD_STORE);

  for (int p = 0; p < n; p += 2) {
    const int q = p + 1;
    if (threadIdx.x < 32) {
      const float dp = A[p * n + p];
      const float rpq = A[p * n + q];
      const float inv_dp = 1.0f / dp;
      const float cdpq = __fmul_rn(A[q * n + p], inv_dp);
      const float dq1 = __fsub_rn(A[q * n + q], __fmul_rn(cdpq, rpq));
      const float inv_dq = 1.0f / dq1;
      const float cdqp = __fmul_rn(
          __fadd_rn(__fsub_rn(A[p * n + q], __fmul_rn(__fmul_rn(dp, inv_dp),
                                                      rpq)),
                    __fmul_rn(rpq, inv_dp)),
          inv_dq);
      for (int i = threadIdx.x; i < n; i += 32) {
        const float ep = (i == p) ? 1.0f : 0.0f;
        const float eq = (i == q) ? 1.0f : 0.0f;
        const float c_p = __fmul_rn(A[i * n + p], inv_dp);
        const float colq1 =
            __fadd_rn(__fsub_rn(A[i * n + q], __fmul_rn(c_p, rpq)),
                      __fmul_rn(ep, __fmul_rn(rpq, inv_dp)));
        const float c_q = __fmul_rn(colq1, inv_dq);
        const float rp = A[p * n + i];
        const float rq1 = __fadd_rn(__fsub_rn(A[q * n + i],
                                              __fmul_rn(cdpq, rp)),
                                    __fmul_rn(ep, cdpq));
        const float rp_fix = __fsub_rn(__fmul_rn(rp, inv_dp),
                                       __fmul_rn(ep, inv_dp + 1.0f));
        cdp[i] = c_p;
        rowp[i] = rp;
        cdq[i] = c_q;
        rowq1[i] = rq1;
        colpf[i] = __fsub_rn(c_p, __fmul_rn(c_q, cdpq));
        rowpf[i] = __fadd_rn(__fsub_rn(rp_fix, __fmul_rn(cdqp, rq1)),
                             __fmul_rn(eq, cdqp));
        rowqf[i] = __fsub_rn(__fmul_rn(rq1, inv_dq),
                             __fmul_rn(eq, inv_dq + 1.0f));
      }
      if (threadIdx.x == 0) {
        ld += logf(dp);
        ld += logf(dq1);
      }
    }
    SPROF_SYNC(SP_A);
    if (i0 < rstep) {
      const float rpj = rowp[j];
      const float rq1j = rowq1[j];
      for (int i = i0; i < n; i += rstep) {
        float v;
        if (i == p) {
          v = rowpf[j];
        } else if (i == q) {
          v = rowqf[j];
        } else if (j == p) {
          v = colpf[i];
        } else if (j == q) {
          v = cdq[i];
        } else {
          v = __fsub_rn(__fsub_rn(A[i * n + j], __fmul_rn(cdp[i], rpj)),
                        __fmul_rn(cdq[i], rq1j));
        }
        A[i * n + j] = v;
      }
    }
    SPROF_SYNC(SP_B);
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    inv[base + idx] = -A[idx];
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
  SPROF_MARK(SP_LOAD_STORE);
  SPROF_FLUSH(0);
}

// ---------------------------------------------------------------------------
// blocked
// ---------------------------------------------------------------------------

constexpr int kBlock = 32;             // panel width of the blocked scheme
constexpr int kRbStride = kBlock + 1;  // padded row of the R scratch

__global__ void __launch_bounds__(kThreads)
    baseline_blocked_kernel(const float* __restrict__ a,
                            float* __restrict__ inv,
                            float* __restrict__ logdet, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* A = reinterpret_cast<float*>(smem_raw);
  float* rb = A + n * n;               // (n, kRbStride): the panel's columns
  float* col = rb + n * kRbStride;     // (kBlock): pivot column in the panel
  float* row = col + kBlock;           // (n): pivot row
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  const int n4 = n / 4;
  SPROF_DECL

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    A[idx] = a[base + idx];
  float ld = 0.0f;
  SPROF_MARK(SP_LOAD_STORE);
  __syncthreads();
  SPROF_MARK(SP_LOAD_STORE);

  for (int b0 = 0; b0 < n; b0 += kBlock) {
    float* P = A + b0 * n;  // the panel's rows
    for (int idx = threadIdx.x; idx < n * kBlock; idx += blockDim.x) {
      const int i = idx / kBlock;
      const int t = idx - i * kBlock;
      rb[i * kRbStride + t] = A[i * n + b0 + t];
    }
    SPROF_MARK(SP_A);

    for (int jj = 0; jj < kBlock; ++jj) {
      const int k = b0 + jj;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        row[i] = P[jj * n + i];
        if (i < kBlock) col[i] = P[i * n + k];
      }
      __syncthreads();
      const float d = row[k];
      const float inv_d = 1.0f / d;
      const float corner = -inv_d - 2.0f;
      for (int idx = threadIdx.x; idx < kBlock * n; idx += blockDim.x) {
        const int i = idx / n;
        const int jc = idx - i * n;
        const float cdi = __fmul_rn(col[i], inv_d);
        const float es = (i == jj) ? 1.0f : 0.0f;
        const float el = (jc == k) ? 1.0f : 0.0f;
        const float r = row[jc];
        P[idx] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fsub_rn(P[idx], __fmul_rn(cdi, r)),
                                __fmul_rn(es, __fmul_rn(r, inv_d))),
                      __fmul_rn(cdi, el)),
            __fmul_rn(corner, __fmul_rn(es, el)));
      }
      if (threadIdx.x == 0) ld += logf(d);
      __syncthreads();
    }
    SPROF_MARK(SP_B);

    const int row_groups = n4 - kBlock / 4;
    const int tiles = row_groups * n4;
    for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
      const int tr = tile / n4;
      const int tc = tile - tr * n4;
      const int rg = tr < b0 / 4 ? tr : tr + kBlock / 4;
      const int r0 = rg * 4;
      const int c0 = tc * 4;
      float acc[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
      for (int t = 0; t < kBlock; ++t) {
        float rv[4], wv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) rv[x] = rb[(r0 + x) * kRbStride + t];
#pragma unroll
        for (int y = 0; y < 4; ++y) wv[y] = P[t * n + c0 + y];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[x][y] = __fadd_rn(acc[x][y], __fmul_rn(rv[x], wv[y]));
      }
      const bool in_panel = c0 >= b0 && c0 < b0 + kBlock;
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          float* out = A + (r0 + x) * n + c0 + y;
          *out = __fsub_rn(in_panel ? 0.0f : *out, acc[x][y]);
        }
    }
    __syncthreads();
    SPROF_MARK(SP_C);
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    inv[base + idx] = -A[idx];
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
  SPROF_MARK(SP_LOAD_STORE);
  SPROF_FLUSH(1);
}

size_t baseline_pair_smem(int n) {
  return (static_cast<size_t>(n) * n + 7 * n) * sizeof(float);
}

size_t baseline_blocked_smem(int n) {
  return (static_cast<size_t>(n) * n + static_cast<size_t>(n) * kRbStride +
          kBlock + n) *
         sizeof(float);
}

// One matrix a CTA of at most 256 threads, as the first kernels launched.
int baseline_sweep_launch(bool pair, const void* a, void* inv, void* logdet,
                          long long batch, int n, void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > 128 || (pair && n % 2 != 0) ||
      (!pair && n % kBlock != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  void* kernel = pair ? reinterpret_cast<void*>(baseline_pair_kernel)
                      : reinterpret_cast<void*>(baseline_blocked_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pair ? baseline_pair_smem(128)
                            : baseline_blocked_smem(128)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nn = n * n;
  const int threads = nn >= kThreads ? kThreads : ((nn + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned int>(batch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  float* pinv = static_cast<float*>(inv);
  float* pld = static_cast<float*>(logdet);
  if (pair)
    baseline_pair_kernel<<<grid, threads, baseline_pair_smem(n), st>>>(
        pa, pinv, pld, n);
  else
    baseline_blocked_kernel<<<grid, threads, baseline_blocked_smem(n), st>>>(
        pa, pinv, pld, n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the RBF Gram tile: phase stamps per warp under -DGRAM_PROFILE
// ---------------------------------------------------------------------------

// GP_COPY (waits for asynchronous copies) stays 0: the first kernel loads
// synchronously, in GP_STAGE
#ifdef GRAM_PROFILE
// the phase totals, the last slot the warps counted
__device__ unsigned long long g_baseline_gram_cycles[GP_COUNT + 1];
#endif

constexpr int kGramTile = 64;   // output tile edge
constexpr int kGramChunk = 32;  // features staged per pass

template <typename T>
__global__ void baseline_gram_kernel(const T* __restrict__ x,
                                     const T* __restrict__ z,
                                     const T* __restrict__ ls,
                                     const T* __restrict__ os,
                                     T* __restrict__ out, int n, int m,
                                     int d) {
  __shared__ float xs[kGramTile][kGramChunk + 1];
  __shared__ float zs[kGramTile][kGramChunk + 1];
  __shared__ float xn[kGramTile];
  __shared__ float zn[kGramTile];
  GPROF_DECL

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kGramTile;
  const int col0 = blockIdx.x * kGramTile;

  if (threadIdx.x < kGramTile) {
    xn[threadIdx.x] = 0.0f;
  } else if (threadIdx.x < 2 * kGramTile) {
    zn[threadIdx.x - kGramTile] = 0.0f;
  }
  GPROF_SYNC(GP_STAGE);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kGramChunk) {
    const int kc = min(kGramChunk, d - k0);
    for (int idx = threadIdx.x; idx < kGramTile * kGramChunk;
         idx += kThreads) {
      const int r = idx / kGramChunk;
      const int k = idx - r * kGramChunk;
      float xv = 0.0f, zv = 0.0f;
      if (k < kc) {
        const T l = static_cast<T>(static_cast<float>(ls[k0 + k]));
        if (row0 + r < n) {
          xv = static_cast<float>(
              x[static_cast<size_t>(row0 + r) * d + k0 + k] / l);
        }
        if (col0 + r < m) {
          zv = static_cast<float>(
              z[static_cast<size_t>(col0 + r) * d + k0 + k] / l);
        }
      }
      xs[r][k] = xv;
      zs[r][k] = zv;
    }
    GPROF_SYNC(GP_STAGE);
    if (threadIdx.x < kGramTile) {
      float s = xn[threadIdx.x];
      for (int k = 0; k < kc; ++k) s += xs[threadIdx.x][k] * xs[threadIdx.x][k];
      xn[threadIdx.x] = s;
    } else if (threadIdx.x < 2 * kGramTile) {
      const int r = threadIdx.x - kGramTile;
      float s = zn[r];
      for (int k = 0; k < kc; ++k) s += zs[r][k] * zs[r][k];
      zn[r] = s;
    }
    GPROF_MARK(GP_NORMS);
    for (int k = 0; k < kc; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = zs[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
    }
    GPROF_SYNC(GP_CROSS);
  }

  const float scale = static_cast<float>(os[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = row0 + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = col0 + c;
      if (col >= m) continue;
      const float d2 = fmaxf(xn[r] - 2.0f * acc[i][j] + zn[c], 0.0f);
      out[static_cast<size_t>(row) * m + col] =
          static_cast<T>(scale * expf(-0.5f * d2));
    }
  }
  GPROF_MARK(GP_STORE);
  GPROF_FLUSH(g_baseline_gram_cycles);
}

template <typename T>
int baseline_gram_launch(const void* x, const void* z, const void* ls,
                         const void* os, void* out, int n, int m, int d,
                         void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kGramTile - 1) / kGramTile,
                  (n + kGramTile - 1) / kGramTile);
  baseline_gram_kernel<T><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(z),
      static_cast<const T*>(ls), static_cast<const T*>(os),
      static_cast<T*>(out), n, m, d);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The first probe kernels (probe_kernels.cu before its redesign)
// ---------------------------------------------------------------------------

namespace probe_v1 {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP_PATH_THREADS = 128;
constexpr int GRID = 16;
constexpr int CTA_PATH_THREADS = GRID * GRID;
constexpr float FLOOR_SCALE = 0.9999999f;
constexpr float FLOOR_STEP = 1e-12f;

template <int CAP>
__global__ void __launch_bounds__(WARP_PATH_THREADS)
    chol_warp_kernel(const float* __restrict__ a, float* __restrict__ l,
                     long long batch, int n) {
  const int j = threadIdx.x & (CAP - 1);
  const long long m =
      (static_cast<long long>(blockIdx.x) * WARP_PATH_THREADS + threadIdx.x) /
      CAP;
  // every lane takes part in the shuffles; only live lanes touch memory
  const bool live = m < batch && j < n;
  const size_t base = static_cast<size_t>(m) * n * n + j;

  float v[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    v[i] = (live && i < n) ? a[base + static_cast<size_t>(i) * n] : 0.0f;

#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < n) {
      const float d = __shfl_sync(FULL_MASK, v[k], k, CAP);
      const float s = rsqrtf(d);
      const bool pivot_column = j == k;
      // row k's element of this lane's column, in the trailing block only
      const float r = j > k ? __fmul_rn(v[k], s) : 0.0f;
#pragma unroll
      for (int i = k; i < CAP; ++i) {
        const float c = __fmul_rn(__shfl_sync(FULL_MASK, v[i], k, CAP), s);
        if (i == k)
          v[i] = pivot_column ? c : v[i];
        else
          v[i] = pivot_column ? c : __fsub_rn(v[i], __fmul_rn(c, r));
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < CAP; ++i)
      if (i < n) l[base + static_cast<size_t>(i) * n] = i >= j ? v[i] : 0.0f;
  }
}

template <int R>
__global__ void __launch_bounds__(CTA_PATH_THREADS, 2)
    chol_cta_kernel(const float* __restrict__ a, float* __restrict__ l,
                    int n) {
  constexpr int CAP = GRID * R;
  __shared__ float col_buf[2][CAP];
  const int tx = threadIdx.x % GRID;
  const int ty = threadIdx.x / GRID;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  float v[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + GRID * r, j = tx + GRID * c;
      v[r][c] = (i < n && j < n) ? a[base + static_cast<size_t>(i) * n + j]
                                 : 0.0f;
    }
  if (tx == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) col_buf[0][ty + GRID * r] = v[r][0];
  __syncthreads();

#pragma unroll
  for (int kc = 0; kc < R; ++kc) {
    const int kt_end = min(GRID, n - GRID * kc);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int buf = kt & 1;
      const int k = GRID * kc + kt;
      const float s = rsqrtf(col_buf[buf][k]);
      float c[R], cm[R], rm[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ty + GRID * r;
        c[r] = __fmul_rn(col_buf[buf][i], s);
        cm[r] = i > k ? c[r] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int j = tx + GRID * q;
        rm[q] = j > k ? __fmul_rn(col_buf[buf][j], s) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < R; ++q)
          v[r][q] = __fsub_rn(v[r][q], __fmul_rn(cm[r], rm[q]));
      if (tx == kt)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (ty + GRID * r >= k) v[r][kc] = c[r];

      // column k + 1 as it stands after step k
      float* col_next = col_buf[buf ^ 1];
      if (kt + 1 < GRID) {
        if (tx == kt + 1)
#pragma unroll
          for (int r = 0; r < R; ++r) col_next[ty + GRID * r] = v[r][kc];
      } else if (kc + 1 < R) {
        const int kn = kc + 1 < R ? kc + 1 : kc;  // a constant once unrolled
        if (tx == 0)
#pragma unroll
          for (int r = 0; r < R; ++r) col_next[ty + GRID * r] = v[r][kn];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + GRID * r, j = tx + GRID * c;
      if (i < n && j < n)
        l[base + static_cast<size_t>(i) * n + j] = i >= j ? v[r][c] : 0.0f;
    }
}

__device__ __forceinline__ float floor_step(float v, float add) {
  return __fadd_rn(__fmul_rn(v, FLOOR_SCALE), add);
}

template <int CAP>
__global__ void __launch_bounds__(WARP_PATH_THREADS)
    floor_warp_kernel(const float* __restrict__ a, float* __restrict__ out,
                      long long batch, int n) {
  const int j = threadIdx.x & (CAP - 1);
  const long long m =
      (static_cast<long long>(blockIdx.x) * WARP_PATH_THREADS + threadIdx.x) /
      CAP;
  const bool live = m < batch && j < n;
  const size_t base = static_cast<size_t>(m) * n * n + j;

  float v[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    v[i] = (live && i < n) ? a[base + static_cast<size_t>(i) * n] : 0.0f;
  for (int k = 0; k < n; ++k) {
    const float add = __fmul_rn(static_cast<float>(k), FLOOR_STEP);
#pragma unroll
    for (int i = 0; i < CAP; ++i) v[i] = floor_step(v[i], add);
    __syncwarp();
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < CAP; ++i)
      if (i < n) out[base + static_cast<size_t>(i) * n] = v[i];
  }
}

template <int R>
__global__ void __launch_bounds__(CTA_PATH_THREADS, 2)
    floor_cta_kernel(const float* __restrict__ a, float* __restrict__ out,
                     int n) {
  const int tx = threadIdx.x % GRID;
  const int ty = threadIdx.x / GRID;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  float v[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + GRID * r, j = tx + GRID * c;
      v[r][c] = (i < n && j < n) ? a[base + static_cast<size_t>(i) * n + j]
                                 : 0.0f;
    }
  for (int k = 0; k < n; ++k) {
    const float add = __fmul_rn(static_cast<float>(k), FLOOR_STEP);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) v[r][c] = floor_step(v[r][c], add);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + GRID * r, j = tx + GRID * c;
      if (i < n && j < n) out[base + static_cast<size_t>(i) * n + j] = v[r][c];
    }
}

// {capacity, threads a CTA, matrices a CTA} at n: the select sweep kernel's
// (csrc/sweep_inverse.cu::geometry, ops/sweep.py::launch_geometry)
void geometry(int n, int* out) {
  const int cap = n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  const bool warp_path = cap <= 32;
  out[0] = cap;
  out[1] = warp_path ? WARP_PATH_THREADS : CTA_PATH_THREADS;
  out[2] = warp_path ? WARP_PATH_THREADS / cap : 1;
}

template <bool CHOL>
int launch(const void* a, void* out, long long batch, int n, void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > 128) return static_cast<int>(cudaErrorInvalidValue);
  int g[3];
  geometry(n, g);
  const unsigned int ctas =
      static_cast<unsigned int>((batch + g[2] - 1) / g[2]);
  const float* A = static_cast<const float*>(a);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g[0]) {
    case 8:
      if (CHOL) chol_warp_kernel<8><<<ctas, g[1], 0, s>>>(A, O, batch, n);
      else floor_warp_kernel<8><<<ctas, g[1], 0, s>>>(A, O, batch, n);
      break;
    case 16:
      if (CHOL) chol_warp_kernel<16><<<ctas, g[1], 0, s>>>(A, O, batch, n);
      else floor_warp_kernel<16><<<ctas, g[1], 0, s>>>(A, O, batch, n);
      break;
    case 32:
      if (CHOL) chol_warp_kernel<32><<<ctas, g[1], 0, s>>>(A, O, batch, n);
      else floor_warp_kernel<32><<<ctas, g[1], 0, s>>>(A, O, batch, n);
      break;
    case 64:
      if (CHOL) chol_cta_kernel<4><<<ctas, g[1], 0, s>>>(A, O, n);
      else floor_cta_kernel<4><<<ctas, g[1], 0, s>>>(A, O, n);
      break;
    default:
      if (CHOL) chol_cta_kernel<8><<<ctas, g[1], 0, s>>>(A, O, n);
      else floor_cta_kernel<8><<<ctas, g[1], 0, s>>>(A, O, n);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probe_v1

}  // namespace

extern "C" {

// work: (batch, np, np), np = 64 ceil(n / 64); it may be inv when n == np.
int baseline_global_f32(const void* a, void* work, void* inv, void* logdet,
                        long long batch, int n, void* stream) {
  if (batch <= 0) return 0;
  const int nb = (n + BS - 1) / BS;
  const size_t smem = static_cast<size_t>(4) * TILE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      baseline_global_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  baseline_global_kernel<float>
      <<<static_cast<unsigned int>(batch), THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a), static_cast<float*>(work),
          static_cast<float*>(inv), static_cast<float*>(logdet), n, nb);
  return static_cast<int>(cudaGetLastError());
}

int baseline_fused_f32(const void* a, void* inv, void* logdet,
                       long long batch, int n, void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > 128) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(n) * n + 3 * n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      baseline_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((128 * 128 + 3 * 128) * sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nn = n * n;
  const int threads = nn >= kThreads ? kThreads : ((nn + 31) / 32) * 32;
  baseline_fused_kernel<<<static_cast<unsigned int>(batch), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(inv),
      static_cast<float*>(logdet), n);
  return static_cast<int>(cudaGetLastError());
}

int baseline_pair_f32(const void* a, void* inv, void* logdet,
                      long long batch, int n, void* stream) {
  return baseline_sweep_launch(true, a, inv, logdet, batch, n, stream);
}

int baseline_blocked_f32(const void* a, void* inv, void* logdet,
                         long long batch, int n, void* stream) {
  return baseline_sweep_launch(false, a, inv, logdet, batch, n, stream);
}

#ifdef SWEEP_PROFILE
// scheme 0 (pair) or 1 (blocked): SP_COUNT phase totals, then the warps
int baseline_sweep_profile_read(int scheme, unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_baseline_sweep_cycles,
      sizeof(unsigned long long) * (SP_COUNT + 1),
      sizeof(unsigned long long) * (SP_COUNT + 1) * scheme));
}

int baseline_sweep_profile_reset() {
  static const unsigned long long zeros[2][SP_COUNT + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_baseline_sweep_cycles, zeros, sizeof(zeros)));
}
#endif

#ifdef BLOCKED_CHOL_PROFILE
int baseline_profile_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_baseline_phase_cycles,
      sizeof(unsigned long long) * (PH_COUNT + 1)));
}

int baseline_profile_reset() {
  static const unsigned long long zeros[PH_COUNT + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_baseline_phase_cycles, zeros, sizeof(zeros)));
}
#endif

int baseline_rbf_gram_f32(const void* x, const void* z, const void* ls,
                          const void* os, void* out, int n, int m, int d,
                          void* stream) {
  return baseline_gram_launch<float>(x, z, ls, os, out, n, m, d, stream);
}

int baseline_rbf_gram_f64(const void* x, const void* z, const void* ls,
                          const void* os, void* out, int n, int m, int d,
                          void* stream) {
  return baseline_gram_launch<double>(x, z, ls, os, out, n, m, d, stream);
}

#ifdef GRAM_PROFILE
// GP_COUNT phase totals, then the warps counted
int baseline_gram_profile_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_baseline_gram_cycles,
      sizeof(unsigned long long) * (GP_COUNT + 1)));
}

int baseline_gram_profile_reset() {
  static const unsigned long long zeros[GP_COUNT + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_baseline_gram_cycles, zeros, sizeof(zeros)));
}
#endif

int baseline_rank1_cholesky_f32(const void* a, void* l, long long batch,
                                int n, void* stream) {
  return probe_v1::launch<true>(a, l, batch, n, stream);
}

int baseline_traversal_floor_f32(const void* a, void* out, long long batch,
                                 int n, void* stream) {
  return probe_v1::launch<false>(a, out, batch, n, stream);
}

// Writes {capacity, threads a CTA, matrices a CTA} of the first probe
// kernels' launch at n.
void baseline_probe_geometry(int n, int* out) { probe_v1::geometry(n, out); }

const char* baseline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
