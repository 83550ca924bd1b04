// Batched SPD inverse and log-determinant by the sweep operator, for Hopper.
//
// Replaces the Pallas TPU kernel scamlgp_tpu/ops/pallas_sweep.py::_sweep_kernel
// (the "select" step scheme).  For each matrix A of a batch (B, N, N),
// N <= 128, it runs N sweep pivots:
//
//     d = A[k][k];  inv_d = 1 / d;  logdet += log d
//     A[i][j] -= (A[i][k] * inv_d) * A[k][j]   for i != k, j != k
//     A[i][k]  =  A[i][k] * inv_d              for i != k
//     A[k][j]  =  A[k][j] * inv_d              for j != k
//     A[k][k]  = -inv_d
//
// after which A holds -A^{-1}.  There is no pivoting: the unswept block of
// an SPD matrix stays SPD, so every d is positive; a non-SPD input gives a
// non-positive d and a NaN log-determinant, as in the reference.  Each
// element sees exactly the operations of the plain version
// (ops/sweep.py::_sweep_select), a multiply and a separate subtract; the
// source is built without FMA contraction (-fmad=false,
// cuda_build.SOURCE_FLAGS), so the float32 result equals the plain
// version's bit for bit.
//
// Bound on the card: one read and one write of the batch, 8 N^2 bytes per
// matrix in float32 (0.040 ms at (1024, 128, 128) on an H100), is the
// roofline bound.  What limits the kernel is instruction issue: 2 N^3
// unfused multiplies and subtracts (about 0.15 ms of the CUDA cores at
// (1024, 128, 128)) plus, per pivot, the broadcast of the pivot column and
// row and the wait for it.  The first version (one CTA per matrix in shared
// memory, a flat loop with an integer division, a three-way branch and
// three shared-memory reads per element, two barriers a pivot) took
// 3.99 ms there, above the library Cholesky inverse.  This design takes
// the index arithmetic, the branches and the shared-memory traffic out of
// the element loop:
//
//   - N <= 32, the warp path: CAP (8, 16 or 32) lanes own one matrix, lane
//     j column j in CAP registers; the pivot loop is unrolled, so every
//     register index is a constant; the pivot column comes from lane k by
//     __shfl_sync, the pivot row is the lane's own register k; the borders
//     are selects.  No shared memory and no barrier; 128 / CAP matrices a
//     CTA of 128 threads.
//   - 32 < N <= 128, the CTA path: 16 x 16 threads own one matrix, thread
//     (ty, tx) an R x R register tile (R = 4 or 8, capacity 16 R) of rows
//     ty + 16 r and columns tx + 16 c, masked past N.  The owners of
//     column and row k + 1 write them, after pivot k's update, into the
//     other half of two double-buffered shared vectors, so one barrier a
//     pivot suffices; every thread reads its R + R values once per pivot
//     and does R^2 updates from registers.  The pivot loop is split as
//     k = 16 kc + kt with kc unrolled, so the owner's register column kc
//     is a constant and nothing is indexed at run time.
//
// Measured on one H100 80GB HBM3 (700 W), float32: 0.358 ms at
// (1024, 128, 128) against the 0.040 ms bound (the first version 3.99),
// 1.389 ms at (4096, 128, 128) against 0.160, 0.023 ms at (1024, 32, 32)
// against 0.0025, where the wrapper's host time dominates (PERF.md,
// kernel table, row 1).
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, 0 on success.  sweep_inverse_geometry reports the
// launch geometry that ops/sweep.py::launch_geometry mirrors.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP_PATH_THREADS = 128;
constexpr int GRID = 16;
constexpr int CTA_PATH_THREADS = GRID * GRID;

template <typename T, int CAP>
__global__ void __launch_bounds__(WARP_PATH_THREADS)
    sweep_warp_kernel(const T* __restrict__ a, T* __restrict__ inv,
                      T* __restrict__ logdet, long long batch, int n) {
  const int j = threadIdx.x & (CAP - 1);
  const long long m =
      (static_cast<long long>(blockIdx.x) * WARP_PATH_THREADS + threadIdx.x) /
      CAP;
  // every lane takes part in the shuffles; only live lanes touch memory
  const bool live = m < batch && j < n;
  const size_t base = static_cast<size_t>(m) * n * n + j;

  T v[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    v[i] = (live && i < n) ? a[base + static_cast<size_t>(i) * n] : T(0);

  T ld = T(0);
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < n) {
      const T d = __shfl_sync(FULL_MASK, v[k], k, CAP);
      const T inv_d = T(1) / d;
      const T row_j = v[k];
      const bool pivot_column = j == k;
#pragma unroll
      for (int i = 0; i < CAP; ++i) {
        const T cd = __shfl_sync(FULL_MASK, v[i], k, CAP) * inv_d;
        const T updated = v[i] - cd * row_j;
        v[i] = pivot_column ? cd : updated;
      }
      v[k] = pivot_column ? -inv_d : row_j * inv_d;
      ld += log_of(d);
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < CAP; ++i)
      if (i < n) inv[base + static_cast<size_t>(i) * n] = -v[i];
    if (j == 0) logdet[m] = ld;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(CTA_PATH_THREADS,
                                  (sizeof(T) == 4 || R < 8) ? 2 : 1)
    sweep_cta_kernel(const T* __restrict__ a, T* __restrict__ inv,
                     T* __restrict__ logdet, int n) {
  constexpr int CAP = GRID * R;
  __shared__ T col_buf[2][CAP];
  __shared__ T row_buf[2][CAP];
  const int tx = threadIdx.x % GRID;
  const int ty = threadIdx.x / GRID;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  T v[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + GRID * r, j = tx + GRID * c;
      v[r][c] = (i < n && j < n) ? a[base + static_cast<size_t>(i) * n + j]
                                 : T(0);
    }
  if (tx == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) col_buf[0][ty + GRID * r] = v[r][0];
  if (ty == 0)
#pragma unroll
    for (int c = 0; c < R; ++c) row_buf[0][tx + GRID * c] = v[0][c];
  __syncthreads();

  T ld = T(0);
#pragma unroll
  for (int kc = 0; kc < R; ++kc) {
    const int kt_end = min(GRID, n - GRID * kc);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int buf = kt & 1;
      const T d = row_buf[buf][GRID * kc + kt];
      const T inv_d = T(1) / d;
      T cd[R], rw[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cd[r] = col_buf[buf][ty + GRID * r] * inv_d;
#pragma unroll
      for (int c = 0; c < R; ++c) rw[c] = row_buf[buf][tx + GRID * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) v[r][c] = v[r][c] - cd[r] * rw[c];
      if (tx == kt)
#pragma unroll
        for (int r = 0; r < R; ++r) v[r][kc] = cd[r];
      if (ty == kt) {
#pragma unroll
        for (int c = 0; c < R; ++c) v[kc][c] = rw[c] * inv_d;
        if (tx == kt) v[kc][kc] = -inv_d;
      }
      if (threadIdx.x == 0) ld += log_of(d);

      // pivot k + 1's column and row, as they stand after pivot k
      T* col_next = col_buf[buf ^ 1];
      T* row_next = row_buf[buf ^ 1];
      if (kt + 1 < GRID) {
        if (tx == kt + 1)
#pragma unroll
          for (int r = 0; r < R; ++r) col_next[ty + GRID * r] = v[r][kc];
        if (ty == kt + 1)
#pragma unroll
          for (int c = 0; c < R; ++c) row_next[tx + GRID * c] = v[kc][c];
      } else if (kc + 1 < R) {
        const int kn = kc + 1 < R ? kc + 1 : kc;  // a constant once unrolled
        if (tx == 0)
#pragma unroll
          for (int r = 0; r < R; ++r) col_next[ty + GRID * r] = v[r][kn];
        if (ty == 0)
#pragma unroll
          for (int c = 0; c < R; ++c) row_next[tx + GRID * c] = v[kn][c];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + GRID * r, j = tx + GRID * c;
      if (i < n && j < n) inv[base + static_cast<size_t>(i) * n + j] = -v[r][c];
    }
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// The launch geometry at n: {capacity, threads a CTA, matrices a CTA}.
// ops/sweep.py::launch_geometry holds the same rule.
void geometry(int n, int* out) {
  const int cap = n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  const bool warp_path = cap <= 32;
  out[0] = cap;
  out[1] = warp_path ? WARP_PATH_THREADS : CTA_PATH_THREADS;
  out[2] = warp_path ? WARP_PATH_THREADS / cap : 1;
}

// Launches on the calling thread's current device; the caller makes A's
// device current.
template <typename T>
int launch(const void* a, void* inv, void* logdet, long long batch, int n,
           void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > 128) return static_cast<int>(cudaErrorInvalidValue);
  int g[3];
  geometry(n, g);
  const unsigned int ctas =
      static_cast<unsigned int>((batch + g[2] - 1) / g[2]);
  const T* A = static_cast<const T*>(a);
  T* I = static_cast<T*>(inv);
  T* L = static_cast<T*>(logdet);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g[0]) {
    case 8:
      sweep_warp_kernel<T, 8><<<ctas, g[1], 0, s>>>(A, I, L, batch, n);
      break;
    case 16:
      sweep_warp_kernel<T, 16><<<ctas, g[1], 0, s>>>(A, I, L, batch, n);
      break;
    case 32:
      sweep_warp_kernel<T, 32><<<ctas, g[1], 0, s>>>(A, I, L, batch, n);
      break;
    case 64:
      sweep_cta_kernel<T, 4><<<ctas, g[1], 0, s>>>(A, I, L, n);
      break;
    default:
      sweep_cta_kernel<T, 8><<<ctas, g[1], 0, s>>>(A, I, L, n);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sweep_inverse_f32(const void* a, void* inv, void* logdet, long long batch,
                      int n, void* stream) {
  return launch<float>(a, inv, logdet, batch, n, stream);
}

int sweep_inverse_f64(const void* a, void* inv, void* logdet, long long batch,
                      int n, void* stream) {
  return launch<double>(a, inv, logdet, batch, n, stream);
}

// Writes {capacity, threads a CTA, matrices a CTA} of a launch at n.
void sweep_inverse_geometry(int n, int* out) { geometry(n, out); }

const char* sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
