// Three more step schemes of the batched sweep inverse, for Hopper.
//
// Each kernel maps a batch of SPD matrices A (B, N, N), N <= 128, to
// (A^{-1}, log|A|), as sweep_inverse.cu does, and replaces one Pallas TPU
// kernel of scamlgp_tpu/ops/pallas_sweep.py:
//
//   sweep_fused_*    <- _sweep_kernel_fused   (border writes folded into
//                       the bulk pass as a second rank-1 term)
//   sweep_pair_*     <- _sweep_kernel_pair    (two pivots per trip, N even)
//   sweep_blocked_*  <- _sweep_kernel_blocked (32-pivot panels and a
//                       rank-32 update of the rest, N % 32 == 0)
//
// Bound on the card: as for sweep_inverse.cu, one read and one write of the
// batch (8 N^2 bytes per matrix in float32) against at least N^3
// operations, N/8 operations per byte, below the H100's float32 ridge
// (about 20) for every N <= 128: the roofline bound is the bytes.  What
// limits the sweep in practice is its serial chain of pivots, each a pass
// over the matrix.  All three schemes take select's layout (sweep_inverse.cu):
// at N <= 32 a warp or part of one a matrix, lane j column j in registers,
// pivot columns by __shfl_sync, several matrices a CTA, no shared memory
// and no barrier; at 32 < N <= 128 a CTA of 16 x 16 threads with R x R
// register tiles (rows ty + 16 r, columns tx + 16 c), the next pivot's
// column and row written by their owners into double-buffered shared
// vectors, one barrier per serial step.  Device memory is touched once each
// way.  What each scheme changes is the chain:
//
// - fused: A' = (A + cd u) + e_k w with cd = col / d, u = e_k - row and
//   w = row / d - e_k (1/d + 2), the term e_k[i] w[j] kept for every row (it
//   is 0 w[j], whose sign a zero of A + cd u takes on), so every element
//   takes three operations, select's two plus one.  Each thread forms cd for
//   its rows and u, w, 0 w for its columns from the two vectors.  The first
//   version (one matrix in a CTA's shared memory, four shared-memory
//   accesses an element update, two barriers a pivot) took 1.513 ms at
//   (1024, 128, 128); this one 0.452 ms there (select 0.362), one H100
//   80GB HBM3, 700 W (PERF.md, section 6).
// - pair: two pivots p, q = p + 1 a step, both rank-1 terms in one pass,
//   (A - cd_p row_p) - cd_q row_q' with q's column and row after p rebuilt
//   from p's in O(N) (pallas_sweep.py:194-205).  The owners of columns and
//   rows p and q write them, before the pair, into the shared vectors; every
//   thread rebuilds the pair's scalars and q's borders for its own R rows
//   and R columns only (O(R) redundant work, in place of one warp
//   serialising O(N) while seven wait), so N/2 barriers a matrix, half of
//   select's.  The first version (one matrix in shared memory, warp 0
//   rebuilding six border vectors, a flat pass with a five-way branch and
//   three shared-memory reads an element, two barriers a pair) took
//   1.986 ms at (1024, 128, 128); this one 0.352 ms there (select 0.359),
//   1.332 ms at (4096, 128, 128) (first 7.428) and 0.0267 ms at
//   (1024, 32, 32) (first 0.0444), one H100 80GB HBM3, 700 W (PERF.md,
//   kernel table, row 3).
// - blocked: the matrix in registers as well.  Panel b (rows 32 b .. 32 b +
//   31) is register rows 2 b and 2 b + 1 of every thread, so its 32 pivots,
//   swept element by element over the panel's rows only, keep all 256
//   threads busy at one barrier a pivot; then R (the panel's columns of the
//   other rows) and W (the swept panel) are staged once in shared memory and
//   every thread accumulates its other rows x R columns, [R | S] ->
//   [0 - R W_P | S - R W_Q], with explicit fused multiply-adds (one rounding
//   a term, as the plain version's float32 matmul; TF32 tensor cores would
//   round far beyond it).  At N = 32, one panel, the warp path sweeps the
//   whole matrix.  The first version (one matrix in shared memory, an R copy
//   a panel, two barriers and a flat pass with an integer division a pivot,
//   a rank-32 update by 4 x 4 tiles waiting on shared memory) took 1.629 ms
//   at (1024, 128, 128); this one 0.472 ms there, 1.530 ms at
//   (4096, 128, 128) (first 5.737) and 0.0376 ms at (1024, 32, 32) (first
//   0.0858), same card.  Its pivots, a short chain of dependent steps a
//   barrier, take about 70% of its cycles, the rank-32 update about 26%
//   (PERF.md, kernel table, row 4): the tensor cores would shorten the
//   smaller part.
//
// No pivoting: the unswept part of an SPD matrix stays SPD, so every d is
// positive; a non-SPD input gives a non-positive d and a NaN log|A|.
//
// Built without FMA contraction (-fmad=false, cuda_build.SOURCE_FLAGS), so
// that each update rounds as the plain PyTorch version's does: with
// contraction the MLL of nearly singular float32 systems lay 5x farther
// from float64 than the plain version's (PERF.md, section 6).  fused and
// pair in float32 equal ops/sweep.py::_sweep_fused and _sweep_pair bit for
// bit: the same expressions in the same order, the zero terms of the
// borders kept.  blocked keeps _sweep_blocked's five-term expression on the
// pivot's row and column and drops its zero terms elsewhere (they change
// only the sign of a zero), and its rank-32 sums run in another order than
// the library matmul's: it agrees to the kernel-vs-plain tolerances.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an N it does not take), 0 on
// success.  sweep_{fused,pair,blocked}_geometry report the launch geometry
// that ops/sweep.py::launch_geometry mirrors, one rule for the three.  Built
// with -DSWEEP_PROFILE, the pair and blocked CTA paths stamp their phases
// (sweep_profile_read, scamlgp_tpu_torch/profile_kernels.py phases).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kBlock = 32;  // panel width of the blocked scheme

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// ---------------------------------------------------------------------------
// fused: select's two paths (sweep_inverse.cu), with fused's arithmetic
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpPathThreads = 128;
constexpr int kGrid = 16;
constexpr int kCtaPathThreads = kGrid * kGrid;

// The warp path's column j of one matrix (base: its element (0, j)) in CAP
// registers, zero past N and on dead lanes; and its store, negated.
template <typename T, int CAP>
__device__ __forceinline__ void load_column(const T* __restrict__ a,
                                            size_t base, int n, bool live,
                                            T (&v)[CAP]) {
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    v[i] = (live && i < n) ? a[base + static_cast<size_t>(i) * n] : T(0);
}

template <typename T, int CAP>
__device__ __forceinline__ void store_column(T* __restrict__ inv, size_t base,
                                             int n, const T (&v)[CAP]) {
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    if (i < n) inv[base + static_cast<size_t>(i) * n] = -v[i];
}

// The CTA path's R x R tile of thread (ty, tx): rows ty + 16 r, columns
// tx + 16 c of the matrix at base, zero past N; and its store, negated.
template <typename T, int R>
__device__ __forceinline__ void load_tile(const T* __restrict__ a,
                                          size_t base, int n, int tx, int ty,
                                          T (&v)[R][R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + kGrid * r, j = tx + kGrid * c;
      v[r][c] = (i < n && j < n) ? a[base + static_cast<size_t>(i) * n + j]
                                 : T(0);
    }
}

template <typename T, int R>
__device__ __forceinline__ void store_tile(T* __restrict__ inv, size_t base,
                                           int n, int tx, int ty,
                                           const T (&v)[R][R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + kGrid * r, j = tx + kGrid * c;
      if (i < n && j < n) inv[base + static_cast<size_t>(i) * n + j] = -v[r][c];
    }
}

// Pivot k's terms for column j, as the plain version forms them:
// u = e_k - row, w = row / d - e_k (1/d + 2), z = 0 w (the e_k[i] w[j] term
// of every row i != k).  e is e_k[j]; ip2 = 1/d + 2.
template <typename T>
__device__ __forceinline__ void fused_terms(T rw, T e, T inv_d, T ip2, T& u,
                                            T& w, T& z) {
  u = e - rw;
  w = rw * inv_d - e * ip2;
  z = T(0) * w;
}

// N <= 32: CAP lanes own one matrix, lane j column j in CAP registers.
template <typename T, int CAP>
__global__ void __launch_bounds__(kWarpPathThreads)
    sweep_fused_warp_kernel(const T* __restrict__ a, T* __restrict__ inv,
                            T* __restrict__ logdet, long long batch, int n) {
  const int j = threadIdx.x & (CAP - 1);
  const long long m =
      (static_cast<long long>(blockIdx.x) * kWarpPathThreads + threadIdx.x) /
      CAP;
  // every lane takes part in the shuffles; only live lanes touch memory
  const bool live = m < batch && j < n;
  const size_t base = static_cast<size_t>(m) * n * n + j;

  T v[CAP];
  load_column<T, CAP>(a, base, n, live, v);

  T ld = T(0);
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < n) {
      const T d = __shfl_sync(kFullMask, v[k], k, CAP);
      const T inv_d = T(1) / d;
      T u, w, z;
      fused_terms(v[k], j == k ? T(1) : T(0), inv_d, inv_d + T(2), u, w, z);
#pragma unroll
      for (int i = 0; i < CAP; ++i) {
        const T cd = __shfl_sync(kFullMask, v[i], k, CAP) * inv_d;
        v[i] = (v[i] + cd * u) + (i == k ? w : z);
      }
      ld += log_of(d);
    }
  }

  if (live) {
    store_column<T, CAP>(inv, base, n, v);
    if (j == 0) logdet[m] = ld;
  }
}

// 32 < N <= 128: 16 x 16 threads own one matrix, thread (ty, tx) the R x R
// elements at rows ty + 16 r and columns tx + 16 c.
template <typename T, int R>
__global__ void __launch_bounds__(kCtaPathThreads,
                                  (sizeof(T) == 4 || R < 8) ? 2 : 1)
    sweep_fused_cta_kernel(const T* __restrict__ a, T* __restrict__ inv,
                           T* __restrict__ logdet, int n) {
  constexpr int CAP = kGrid * R;
  __shared__ T col_buf[2][CAP];
  __shared__ T row_buf[2][CAP];
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  T v[R][R];
  load_tile<T, R>(a, base, n, tx, ty, v);
  if (tx == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) col_buf[0][ty + kGrid * r] = v[r][0];
  if (ty == 0)
#pragma unroll
    for (int c = 0; c < R; ++c) row_buf[0][tx + kGrid * c] = v[0][c];
  __syncthreads();

  T ld = T(0);
#pragma unroll
  for (int kc = 0; kc < R; ++kc) {
    const int kt_end = min(kGrid, n - kGrid * kc);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int buf = kt & 1;
      const T d = row_buf[buf][kGrid * kc + kt];
      const T inv_d = T(1) / d;
      const T ip2 = inv_d + T(2);
      T cd[R], u[R], z[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cd[r] = col_buf[buf][ty + kGrid * r] * inv_d;
      // row k (register row kc of the threads with ty == kt) adds w, every
      // other row z
      const bool row_k = ty == kt;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const T e = (c == kc && tx == kt) ? T(1) : T(0);
        T w;
        fused_terms(row_buf[buf][tx + kGrid * c], e, inv_d, ip2, u[c], w,
                    z[c]);
        v[kc][c] = (v[kc][c] + cd[kc] * u[c]) + (row_k ? w : z[c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r == kc) continue;
#pragma unroll
        for (int c = 0; c < R; ++c) v[r][c] = (v[r][c] + cd[r] * u[c]) + z[c];
      }
      if (threadIdx.x == 0) ld += log_of(d);

      // pivot k + 1's column and row, as they stand after pivot k
      T* col_next = col_buf[buf ^ 1];
      T* row_next = row_buf[buf ^ 1];
      if (kt + 1 < kGrid) {
        if (tx == kt + 1)
#pragma unroll
          for (int r = 0; r < R; ++r) col_next[ty + kGrid * r] = v[r][kc];
        if (ty == kt + 1)
#pragma unroll
          for (int c = 0; c < R; ++c) row_next[tx + kGrid * c] = v[kc][c];
      } else if (kc + 1 < R) {
        const int kn = kc + 1 < R ? kc + 1 : kc;  // a constant once unrolled
        if (tx == 0)
#pragma unroll
          for (int r = 0; r < R; ++r) col_next[ty + kGrid * r] = v[r][kn];
        if (ty == 0)
#pragma unroll
          for (int c = 0; c < R; ++c) row_next[tx + kGrid * c] = v[kn][c];
      }
      __syncthreads();
    }
  }

  store_tile<T, R>(inv, base, n, tx, ty, v);
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// The launch geometry of the three schemes at n: {capacity, threads a CTA,
// matrices a CTA}, select's rule (ops/sweep.py::launch_geometry).
void geometry(int n, int* out) {
  const int cap = n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  const bool warp_path = cap <= 32;
  out[0] = cap;
  out[1] = warp_path ? kWarpPathThreads : kCtaPathThreads;
  out[2] = warp_path ? kWarpPathThreads / cap : 1;
}

// ---------------------------------------------------------------------------
// Phase profile of the pair and blocked CTA paths, built only with
// -DSWEEP_PROFILE: every thread reads clock64() at the end of each phase and
// lane 0 of each warp adds its warp's totals to g_sweep_phase_cycles, read
// as a phase's mean cycles a warp.  pair's barrier waits have their own
// slot (SPROF_SYNC); blocked's fall in the phase each barrier ends.
// ---------------------------------------------------------------------------

// pair: load and store, border rebuild, update pass, barrier waits;
// blocked: load and store, R and W staging, panel pivots, rank-32 update
enum SweepPhase { SP_LOAD_STORE, SP_A, SP_B, SP_C, SP_COUNT };
#ifdef SWEEP_PROFILE
// [0: pair, 1: blocked][phase], the last slot the warps counted
__device__ unsigned long long g_sweep_phase_cycles[2][SP_COUNT + 1];
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
        atomicAdd(&g_sweep_phase_cycles[s][p_],                           \
                  static_cast<unsigned long long>(sp_acc[p_]));           \
      atomicAdd(&g_sweep_phase_cycles[s][SP_COUNT], 1ull);                \
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
// pair: select's two paths, two pivots a trip
// ---------------------------------------------------------------------------

// The pair's scalars from A before the pair, as _sweep_pair forms them:
// dp = A[p][p], rpq = A[p][q], aqp = A[q][p], aqq = A[q][q].
template <typename T>
struct PairScalars {
  T inv_dp, cdpq, dq1, inv_dq, rpq_dp, cdqp;
  __device__ __forceinline__ PairScalars(T dp, T rpq, T aqp, T aqq) {
    inv_dp = T(1) / dp;
    cdpq = aqp * inv_dp;                        // cd_p[q]
    dq1 = (aqq - cdpq * rpq) + T(0) * cdpq;     // row_q'[q]
    inv_dq = T(1) / dq1;
    rpq_dp = rpq * inv_dp;
    // cd_q[p] = col_q'[p] / d_q', col_q'[p] = A[p][q] - cd_p[p] rpq + rpq/d_p
    cdqp = ((rpq - (dp * inv_dp) * rpq) + rpq_dp) * inv_dq;
  }
};

// N <= 32, N even: CAP lanes own one matrix, lane j column j in CAP
// registers; columns p and q by __shfl_sync, rows p and q the lane's own.
template <typename T, int CAP>
__global__ void __launch_bounds__(kWarpPathThreads)
    sweep_pair_warp_kernel(const T* __restrict__ a, T* __restrict__ inv,
                           T* __restrict__ logdet, long long batch, int n) {
  const int j = threadIdx.x & (CAP - 1);
  const long long m =
      (static_cast<long long>(blockIdx.x) * kWarpPathThreads + threadIdx.x) /
      CAP;
  const bool live = m < batch && j < n;
  const size_t base = static_cast<size_t>(m) * n * n + j;

  T v[CAP];
  load_column<T, CAP>(a, base, n, live, v);

  T ld = T(0);
#pragma unroll
  for (int p = 0; p < CAP; p += 2) {
    if (p < n) {
      const int q = p + 1;
      const T dp = __shfl_sync(kFullMask, v[p], p, CAP);
      const T rpq = __shfl_sync(kFullMask, v[p], q, CAP);
      const PairScalars<T> s(dp, rpq, __shfl_sync(kFullMask, v[q], p, CAP),
                             __shfl_sync(kFullMask, v[q], q, CAP));
      const T ep = j == p ? T(1) : T(0);
      const T eq = j == q ? T(1) : T(0);
      const T rp = v[p];                                    // row_p[j]
      const T rq1 = (v[q] - s.cdpq * rp) + ep * s.cdpq;     // row_q'[j]
#pragma unroll
      for (int i = 0; i < CAP; ++i) {
        if (i == p || i == q) continue;  // rows p and q are written below
        const T cdp = __shfl_sync(kFullMask, v[i], p, CAP) * s.inv_dp;
        const T colq1 = (__shfl_sync(kFullMask, v[i], q, CAP) - cdp * rpq) +
                        T(0) * s.rpq_dp;
        const T cdq = colq1 * s.inv_dq;
        const T upd = (v[i] - cdp * rp) - cdq * rq1;
        v[i] = j == p ? cdp - cdq * s.cdpq : (j == q ? cdq : upd);
      }
      v[p] = ((rp * s.inv_dp - ep * (s.inv_dp + T(1))) - s.cdqp * rq1) +
             eq * s.cdqp;
      v[q] = rq1 * s.inv_dq - eq * (s.inv_dq + T(1));
      ld += log_of(dp);
      ld += log_of(s.dq1);
    }
  }

  if (live) {
    store_column<T, CAP>(inv, base, n, v);
    if (j == 0) logdet[m] = ld;
  }
}

// 32 < N <= 128, N even: 16 x 16 threads own one matrix, thread (ty, tx)
// the R x R elements at rows ty + 16 r and columns tx + 16 c.  Pair
// p = 16 kc + kt, q = p + 1 (kt even) lies in register column kc of the
// threads tx == kt and tx == kt + 1.
template <typename T, int R>
__global__ void __launch_bounds__(kCtaPathThreads,
                                  (sizeof(T) == 4 || R < 8) ? 2 : 1)
    sweep_pair_cta_kernel(const T* __restrict__ a, T* __restrict__ inv,
                          T* __restrict__ logdet, int n) {
  constexpr int CAP = kGrid * R;
  // [buffer][p, q][index]: columns and rows p and q before the pair
  __shared__ T col_buf[2][2][CAP];
  __shared__ T row_buf[2][2][CAP];
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  SPROF_DECL

  T v[R][R];
  load_tile<T, R>(a, base, n, tx, ty, v);
  if (tx < 2)
#pragma unroll
    for (int r = 0; r < R; ++r) col_buf[0][tx][ty + kGrid * r] = v[r][0];
  if (ty < 2)
#pragma unroll
    for (int c = 0; c < R; ++c) row_buf[0][ty][tx + kGrid * c] = v[0][c];
  SPROF_SYNC(SP_LOAD_STORE);

  T ld = T(0);
#pragma unroll
  for (int kc = 0; kc < R; ++kc) {
    const int kt_end = min(kGrid, n - kGrid * kc);
    for (int kt = 0; kt < kt_end; kt += 2) {
      const int buf = (kt >> 1) & 1;
      const T* colp = col_buf[buf][0];
      const T* colq = col_buf[buf][1];
      const T* rowp = row_buf[buf][0];
      const T* rowq = row_buf[buf][1];
      const int p = kGrid * kc + kt, q = p + 1;
      const T dp = rowp[p];
      const T rpq = rowp[q];
      const PairScalars<T> s(dp, rpq, rowq[p], rowq[q]);
      // this thread's R rows of cd_p and cd_q, and R columns of row_p and
      // row_q' (e_p is 1 only at register index kc of the thread kt)
      T cdp[R], cdq[R], rp[R], rq1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T ep = (r == kc && ty == kt) ? T(1) : T(0);
        cdp[r] = colp[ty + kGrid * r] * s.inv_dp;
        const T colq1 =
            (colq[ty + kGrid * r] - cdp[r] * rpq) + ep * s.rpq_dp;
        cdq[r] = colq1 * s.inv_dq;
      }
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const T ep = (c == kc && tx == kt) ? T(1) : T(0);
        rp[c] = rowp[tx + kGrid * c];
        rq1[c] = (rowq[tx + kGrid * c] - s.cdpq * rp[c]) + ep * s.cdpq;
      }
      SPROF_MARK(SP_A);

      // both rank-1 terms, then columns p and q, then rows p and q (last,
      // as the plain version writes them)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c)
          v[r][c] = (v[r][c] - cdp[r] * rp[c]) - cdq[r] * rq1[c];
      if (tx == kt)
#pragma unroll
        for (int r = 0; r < R; ++r) v[r][kc] = cdp[r] - cdq[r] * s.cdpq;
      if (tx == kt + 1)
#pragma unroll
        for (int r = 0; r < R; ++r) v[r][kc] = cdq[r];
      if (ty == kt)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const T ep = (c == kc && tx == kt) ? T(1) : T(0);
          const T eq = (c == kc && tx == kt + 1) ? T(1) : T(0);
          v[kc][c] = ((rp[c] * s.inv_dp - ep * (s.inv_dp + T(1))) -
                      s.cdqp * rq1[c]) +
                     eq * s.cdqp;
        }
      if (ty == kt + 1)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const T eq = (c == kc && tx == kt + 1) ? T(1) : T(0);
          v[kc][c] = rq1[c] * s.inv_dq - eq * (s.inv_dq + T(1));
        }
      if (threadIdx.x == 0) {
        ld += log_of(dp);
        ld += log_of(s.dq1);
      }

      // the next pair's columns and rows, as they stand after this pair
      T(*col_next)[CAP] = col_buf[buf ^ 1];
      T(*row_next)[CAP] = row_buf[buf ^ 1];
      if (kt + 2 < kGrid) {
        if (tx == kt + 2 || tx == kt + 3)
#pragma unroll
          for (int r = 0; r < R; ++r)
            col_next[tx - kt - 2][ty + kGrid * r] = v[r][kc];
        if (ty == kt + 2 || ty == kt + 3)
#pragma unroll
          for (int c = 0; c < R; ++c)
            row_next[ty - kt - 2][tx + kGrid * c] = v[kc][c];
      } else if (kc + 1 < R) {
        const int kn = kc + 1 < R ? kc + 1 : kc;  // a constant once unrolled
        if (tx < 2)
#pragma unroll
          for (int r = 0; r < R; ++r) col_next[tx][ty + kGrid * r] = v[r][kn];
        if (ty < 2)
#pragma unroll
          for (int c = 0; c < R; ++c) row_next[ty][tx + kGrid * c] = v[kn][c];
      }
      SPROF_SYNC(SP_B);
    }
  }

  store_tile<T, R>(inv, base, n, tx, ty, v);
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
  SPROF_MARK(SP_LOAD_STORE);
  SPROF_FLUSH(0);
}

// ---------------------------------------------------------------------------
// blocked: 32-pivot panels in registers, the rank-32 update from shared
// memory
// ---------------------------------------------------------------------------

// One pivot's step on an element of the panel, as _sweep_blocked writes it:
// (((P - cd row) + e_s (row / d)) + cd e_k) + (-1/d - 2) e_s e_k, where g is
// P - cd row and es, el are e_s and e_k at the element.  On elements off
// the pivot's row and column the three e terms are zeros, left out.
template <typename T>
__device__ __forceinline__ T blocked_border(T g, T rw, T cd, T inv_d,
                                            T corner, T es, T el) {
  return ((g + es * (rw * inv_d)) + cd * el) + corner * (es * el);
}

// N = 32, one panel: the whole matrix swept element by element.  CAP lanes
// own one matrix, lane j column j in CAP registers, as select's warp path.
template <typename T, int CAP>
__global__ void __launch_bounds__(kWarpPathThreads)
    sweep_blocked_warp_kernel(const T* __restrict__ a, T* __restrict__ inv,
                              T* __restrict__ logdet, long long batch,
                              int n) {
  const int j = threadIdx.x & (CAP - 1);
  const long long m =
      (static_cast<long long>(blockIdx.x) * kWarpPathThreads + threadIdx.x) /
      CAP;
  const bool live = m < batch && j < n;
  const size_t base = static_cast<size_t>(m) * n * n + j;

  T v[CAP];
  load_column<T, CAP>(a, base, n, live, v);

  T ld = T(0);
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < n) {
      const T d = __shfl_sync(kFullMask, v[k], k, CAP);
      const T inv_d = T(1) / d;
      const T corner = -inv_d - T(2);
      const T rw = v[k];
      const T el = j == k ? T(1) : T(0);
#pragma unroll
      for (int i = 0; i < CAP; ++i) {
        const T cd = __shfl_sync(kFullMask, v[i], k, CAP) * inv_d;
        const T g = v[i] - cd * rw;
        if (i == k)
          v[i] = blocked_border(g, rw, cd, inv_d, corner, T(1), el);
        else
          v[i] = j == k ? blocked_border(g, rw, cd, inv_d, corner, T(0), el)
                        : g;
      }
      ld += log_of(d);
    }
  }

  if (live) {
    store_column<T, CAP>(inv, base, n, v);
    if (j == 0) logdet[m] = ld;
  }
}

__device__ __forceinline__ float fma_of(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double fma_of(double x, double y, double z) {
  return fma(x, y, z);
}

// Dynamic shared memory of the blocked CTA path at capacity CAP: R^T, the
// panel's columns of every row (32 x (CAP + 1), padded so that the owners'
// stores fall in distinct banks), and W, the swept panel (32 x CAP).
template <typename T>
constexpr size_t blocked_smem_bytes(int cap) {
  return (static_cast<size_t>(kBlock) * (cap + 1) +
          static_cast<size_t>(kBlock) * cap) *
         sizeof(T);
}

// N = 64, 96, 128: 16 x 16 threads own one matrix, thread (ty, tx) the
// R x R elements at rows ty + 16 r and columns tx + 16 c, as select's CTA
// path.  Panel b is rows 32 b .. 32 b + 31, register rows 2 b and 2 b + 1
// of every thread: its 32 pivots keep all 256 threads busy, one barrier a
// pivot.  Then the other rows get [R | S] -> [-R W_P | S - R W_Q] (W the
// swept panel) from R and W staged in shared memory, accumulated with
// explicit fused multiply-adds into the registers.
template <typename T, int R>
__global__ void __launch_bounds__(kCtaPathThreads,
                                  (sizeof(T) == 4 || R < 8) ? 2 : 1)
    sweep_blocked_cta_kernel(const T* __restrict__ a, T* __restrict__ inv,
                             T* __restrict__ logdet, int n) {
  constexpr int CAP = kGrid * R;
  constexpr int RS = CAP + 1;  // row stride of R^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rs = reinterpret_cast<T*>(smem_raw);  // R^T: rs[t * RS + i] = A[i][32b + t]
  T* ws = rs + kBlock * RS;                // W: ws[t * CAP + j]
  __shared__ T col_buf[2][kBlock];  // the pivot's column, panel rows only
  __shared__ T row_buf[2][CAP];     // the pivot's row
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  SPROF_DECL

  T v[R][R];
  load_tile<T, R>(a, base, n, tx, ty, v);
  // pivot 0's column (panel rows) and row
  if (tx == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) col_buf[0][ty + kGrid * h] = v[h][0];
  if (ty == 0)
#pragma unroll
    for (int c = 0; c < R; ++c) row_buf[0][tx + kGrid * c] = v[0][c];
  SPROF_MARK(SP_LOAD_STORE);
  __syncthreads();
  SPROF_MARK(SP_LOAD_STORE);

  T ld = T(0);
#pragma unroll
  for (int b = 0; b < R / 2; ++b) {
    if (kBlock * b >= n) break;  // n % 32 == 0: the panels end together
    // --- the panel's 32 pivots, k = 32 b + 16 h + kt ----------------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kc = 2 * b + h;  // the pivot's register column and row
      for (int kt = 0; kt < kGrid; ++kt) {
        const int buf = kt & 1;
        const int k = kGrid * kc + kt;
        const T d = row_buf[buf][k];
        const T inv_d = T(1) / d;
        const T corner = -inv_d - T(2);
        T cd[2], rw[R];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          cd[hh] = col_buf[buf][ty + kGrid * hh] * inv_d;
#pragma unroll
        for (int c = 0; c < R; ++c) rw[c] = row_buf[buf][tx + kGrid * c];
        const bool row_owner = ty == kt;  // holds row k in register row kc
        const bool col_owner = tx == kt;  // holds column k in column kc
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int c = 0; c < R; ++c) {
            const T g = v[2 * b + hh][c] - cd[hh] * rw[c];
            const bool es = hh == h && row_owner;
            const bool el = c == kc && col_owner;
            v[2 * b + hh][c] =
                (es || el) ? blocked_border(g, rw[c], cd[hh], inv_d, corner,
                                            es ? T(1) : T(0),
                                            el ? T(1) : T(0))
                           : g;
          }
        if (threadIdx.x == 0) ld += log_of(d);

        // pivot k + 1's column and row within the panel, after pivot k
        T* col_next = col_buf[buf ^ 1];
        T* row_next = row_buf[buf ^ 1];
        if (kt + 1 < kGrid) {
          if (tx == kt + 1)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              col_next[ty + kGrid * hh] = v[2 * b + hh][kc];
          if (ty == kt + 1)
#pragma unroll
            for (int c = 0; c < R; ++c) row_next[tx + kGrid * c] = v[kc][c];
        } else if (h == 0) {
          if (tx == 0)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              col_next[ty + kGrid * hh] = v[2 * b + hh][kc + 1];
          if (ty == 0)
#pragma unroll
            for (int c = 0; c < R; ++c)
              row_next[tx + kGrid * c] = v[kc + 1][c];
        }
        __syncthreads();
      }
    }
    SPROF_MARK(SP_B);

    // --- stage R (the panel's columns of the other rows) and W -------------
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r == 2 * b || r == 2 * b + 1) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[(tx + kGrid * hh) * RS + ty + kGrid * r] = v[r][2 * b + hh];
        v[r][2 * b + hh] = T(0);  // [R | S] -> [0 - R W_P | S - R W_Q]
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < R; ++c)
        ws[(ty + kGrid * hh) * CAP + tx + kGrid * c] = v[2 * b + hh][c];
    __syncthreads();
    SPROF_MARK(SP_A);

    // --- the rank-32 update of the other rows ------------------------------
#pragma unroll 4
    for (int t = 0; t < kBlock; ++t) {
      T wv[R];
#pragma unroll
      for (int c = 0; c < R; ++c) wv[c] = ws[t * CAP + tx + kGrid * c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r == 2 * b || r == 2 * b + 1) continue;
        if (kGrid * r >= n) continue;  // rows past N stay zero
        const T rv = -rs[t * RS + ty + kGrid * r];
#pragma unroll
        for (int c = 0; c < R; ++c) v[r][c] = fma_of(rv, wv[c], v[r][c]);
      }
    }
    // the next panel's first column and row
    if (b + 1 < R / 2 && kBlock * (b + 1) < n) {
      const int kn = b + 1 < R / 2 ? 2 * b + 2 : 2 * b;  // constant unrolled
      if (tx == 0)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          col_buf[0][ty + kGrid * hh] = v[kn + hh][kn];
      if (ty == 0)
#pragma unroll
        for (int c = 0; c < R; ++c) row_buf[0][tx + kGrid * c] = v[kn][c];
    }
    __syncthreads();
    SPROF_MARK(SP_C);
  }

  store_tile<T, R>(inv, base, n, tx, ty, v);
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
  SPROF_MARK(SP_LOAD_STORE);
  SPROF_FLUSH(1);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum class Scheme { kFused, kPair, kBlocked };

// Lets the blocked float64 8 x 8 kernel use the shared memory it needs
// (above the 48 KiB a launch gets by default) on the current device.  The
// attribute is held per device, so it is set once for each device a launch
// meets; two threads racing here both set the same value.
cudaError_t allow_blocked_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(sweep_blocked_cta_kernel<double, 8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(blocked_smem_bytes<double>(128)));
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

// Launches on the calling thread's current device; the caller makes A's
// device current.
template <typename T>
int launch(Scheme s, const void* a, void* inv, void* logdet, long long batch,
           int n, void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > kMaxN || (s == Scheme::kPair && n % 2 != 0) ||
      (s == Scheme::kBlocked && n % kBlock != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  T* pinv = static_cast<T*>(inv);
  T* pld = static_cast<T*>(logdet);
  int g[3];
  geometry(n, g);
  const unsigned int ctas =
      static_cast<unsigned int>((batch + g[2] - 1) / g[2]);
  if (s == Scheme::kFused) {
    switch (g[0]) {
      case 8:
        sweep_fused_warp_kernel<T, 8><<<ctas, g[1], 0, st>>>(pa, pinv, pld,
                                                             batch, n);
        break;
      case 16:
        sweep_fused_warp_kernel<T, 16><<<ctas, g[1], 0, st>>>(pa, pinv, pld,
                                                              batch, n);
        break;
      case 32:
        sweep_fused_warp_kernel<T, 32><<<ctas, g[1], 0, st>>>(pa, pinv, pld,
                                                              batch, n);
        break;
      case 64:
        sweep_fused_cta_kernel<T, 4><<<ctas, g[1], 0, st>>>(pa, pinv, pld, n);
        break;
      default:
        sweep_fused_cta_kernel<T, 8><<<ctas, g[1], 0, st>>>(pa, pinv, pld, n);
        break;
    }
  } else if (s == Scheme::kPair) {
    switch (g[0]) {
      case 8:
        sweep_pair_warp_kernel<T, 8><<<ctas, g[1], 0, st>>>(pa, pinv, pld,
                                                            batch, n);
        break;
      case 16:
        sweep_pair_warp_kernel<T, 16><<<ctas, g[1], 0, st>>>(pa, pinv, pld,
                                                             batch, n);
        break;
      case 32:
        sweep_pair_warp_kernel<T, 32><<<ctas, g[1], 0, st>>>(pa, pinv, pld,
                                                             batch, n);
        break;
      case 64:
        sweep_pair_cta_kernel<T, 4><<<ctas, g[1], 0, st>>>(pa, pinv, pld, n);
        break;
      default:
        sweep_pair_cta_kernel<T, 8><<<ctas, g[1], 0, st>>>(pa, pinv, pld, n);
        break;
    }
  } else {
    switch (g[0]) {
      case 32:
        sweep_blocked_warp_kernel<T, 32><<<ctas, g[1], 0, st>>>(pa, pinv, pld,
                                                                batch, n);
        break;
      case 64:
        sweep_blocked_cta_kernel<T, 4>
            <<<ctas, g[1], blocked_smem_bytes<T>(64), st>>>(pa, pinv, pld, n);
        break;
      default: {
        if (sizeof(T) == 8) {
          const cudaError_t err = allow_blocked_smem();
          if (err != cudaSuccess) return static_cast<int>(err);
        }
        sweep_blocked_cta_kernel<T, 8>
            <<<ctas, g[1], blocked_smem_bytes<T>(128), st>>>(pa, pinv, pld, n);
        break;
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sweep_fused_f32(const void* a, void* inv, void* logdet, long long batch,
                    int n, void* stream) {
  return launch<float>(Scheme::kFused, a, inv, logdet, batch, n, stream);
}

int sweep_fused_f64(const void* a, void* inv, void* logdet, long long batch,
                    int n, void* stream) {
  return launch<double>(Scheme::kFused, a, inv, logdet, batch, n, stream);
}

int sweep_pair_f32(const void* a, void* inv, void* logdet, long long batch,
                   int n, void* stream) {
  return launch<float>(Scheme::kPair, a, inv, logdet, batch, n, stream);
}

int sweep_pair_f64(const void* a, void* inv, void* logdet, long long batch,
                   int n, void* stream) {
  return launch<double>(Scheme::kPair, a, inv, logdet, batch, n, stream);
}

int sweep_blocked_f32(const void* a, void* inv, void* logdet, long long batch,
                      int n, void* stream) {
  return launch<float>(Scheme::kBlocked, a, inv, logdet, batch, n, stream);
}

int sweep_blocked_f64(const void* a, void* inv, void* logdet, long long batch,
                      int n, void* stream) {
  return launch<double>(Scheme::kBlocked, a, inv, logdet, batch, n, stream);
}

// Write {capacity, threads a CTA, matrices a CTA} of each scheme's launch at
// n (pair: n even; blocked: n % 32 == 0).
void sweep_fused_geometry(int n, int* out) { geometry(n, out); }
void sweep_pair_geometry(int n, int* out) { geometry(n, out); }
void sweep_blocked_geometry(int n, int* out) { geometry(n, out); }

#ifdef SWEEP_PROFILE
// scheme 0 (pair) or 1 (blocked): SP_COUNT phase totals, then the warps
int sweep_profile_read(int scheme, unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_sweep_phase_cycles, sizeof(unsigned long long) * (SP_COUNT + 1),
      sizeof(unsigned long long) * (SP_COUNT + 1) * scheme));
}

int sweep_profile_reset() {
  static const unsigned long long zeros[2][SP_COUNT + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_sweep_phase_cycles, zeros, sizeof(zeros)));
}
#endif

const char* sweep_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
