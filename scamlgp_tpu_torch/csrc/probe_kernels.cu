// Loop-shape probes of the sweep kernel, for Hopper: a rank-1 Cholesky and
// the traversal floor, float32, N <= 128.
//
// Replace the Pallas TPU kernels
//   scripts/bench_chol_fused_probe.py::_chol_kernel  (rank1_cholesky) and
//   scripts/bench_vpu_ceiling.py::_floor_kernel      (traversal_floor).
// Both are probes: they time a loop shape, and no path of the model runs
// them.  So each keeps the layout of the select sweep kernel
// (csrc/sweep_inverse.cu), and a ratio of their times to select's compares
// loop shapes, not the quality of two implementations:
//
//   - N <= 32, the warp path: CAP (8, 16 or 32) lanes own one matrix, lane
//     j column j in CAP registers, the step loop unrolled so that every
//     register index is a constant; 128 / CAP matrices a CTA of 128
//     threads.
//   - 32 < N <= 128, the CTA path: 16 x 16 threads own one matrix, thread
//     (ty, tx) an R x R register tile (R = 4 or 8) of rows ty + 16 r and
//     columns tx + 16 c, masked past N; one barrier a step.
//
// rank1_cholesky, step k (ops/probes.py::rank1_cholesky_reference):
//
//     d = A[k][k];  s = rsqrt(d);  c = A[:, k] s;  r = A[k, :] s
//     A[i][j] = A[i][j] - c[i] r[j]     for i > k, j > k (a multiply, then
//                                        a subtract)
//     A[i][k] = c[i]                    for i >= k
//
// and at the end the strict upper triangle is zeroed, giving L.  A is
// symmetric, as an SPD matrix is, and the trailing update keeps it so bit
// for bit, as in the TPU kernel; so row k equals column k.  On the warp
// path lane k's column reaches the others by __shfl_sync and r[j] is lane
// j's own register A[k][j]; on the CTA path r[j] = A[j][k] s, and the
// owners of column k + 1 write it, after step k's update, into the other
// half of a double-buffered shared vector, so one barrier a step suffices.
// Elements outside the trailing block take the update with a zero factor
// (c or r masked), A - 0 = A, as the TPU kernel's masked product leaves
// them.
//
// traversal_floor, step k: A = A * 0.9999999f + float(k) * 1e-12f over the
// whole block (each literal rounded to float32, as the TPU kernel's weakly
// typed ones), then the step's barrier (__syncwarp on the warp path).  One
// multiply and one add an element a step and nothing else: the floor of
// any N-step loop of this layout that touches every element once a step.
//
// Both are built without FMA contraction (-fmad=false,
// cuda_build.SOURCE_FLAGS), as the sweep kernels are: each multiply and
// each add or subtract rounds on its own, as in the plain versions, so
// traversal_floor equals its plain version bit for bit, and
// rank1_cholesky differs from it only where rsqrtf and torch.rsqrt round
// differently.
//
// Bound on an H100 (profile_kernels.py::probe_bound): one read and one
// write of the batch, 8 N^2 bytes a matrix, 0.160 ms at (4096, 128, 128);
// a Cholesky factor needs N^3 / 3 operations, 0.021 ms there at the
// float32 peak, so bytes bound rank1_cholesky; the floor does 2 N^3
// operations, 0.256 ms at 67 TFLOP/s, so operations bound it.  Without
// contraction the multiply and the add are two instructions, so
// instruction issue alone takes twice that, 0.513 ms, for the floor and
// for every sweep scheme.  Measured on one H100 80GB HBM3 (700 W) at
// (4096, 128, 128), in turns with select (1.385 ms): rank1_cholesky
// 1.308 ms, traversal_floor 0.646 ms (PERF.md, kernel table, rows 8, 9).
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, 0 on success; probe_geometry reports the launch
// geometry, which is the select kernel's (ops/sweep.py::launch_geometry).

#include <cuda_runtime.h>

namespace {

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
      const float r = j > k ? v[k] * s : 0.0f;
#pragma unroll
      for (int i = k; i < CAP; ++i) {
        const float c = __shfl_sync(FULL_MASK, v[i], k, CAP) * s;
        if (i == k)
          v[i] = pivot_column ? c : v[i];
        else
          v[i] = pivot_column ? c : v[i] - c * r;
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
        c[r] = col_buf[buf][i] * s;
        cm[r] = i > k ? c[r] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int j = tx + GRID * q;
        rm[q] = j > k ? col_buf[buf][j] * s : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < R; ++q) v[r][q] = v[r][q] - cm[r] * rm[q];
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
    const float add = static_cast<float>(k) * FLOOR_STEP;
#pragma unroll
    for (int i = 0; i < CAP; ++i) v[i] = v[i] * FLOOR_SCALE + add;
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
    const float add = static_cast<float>(k) * FLOOR_STEP;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) v[r][c] = v[r][c] * FLOOR_SCALE + add;
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

// The launch geometry at n: {capacity, threads a CTA, matrices a CTA},
// the select sweep kernel's (csrc/sweep_inverse.cu::geometry,
// ops/sweep.py::launch_geometry).
void geometry(int n, int* out) {
  const int cap = n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  const bool warp_path = cap <= 32;
  out[0] = cap;
  out[1] = warp_path ? WARP_PATH_THREADS : CTA_PATH_THREADS;
  out[2] = warp_path ? WARP_PATH_THREADS / cap : 1;
}

// Launches on the calling thread's current device; the caller makes A's
// device current.
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

}  // namespace

extern "C" {

int rank1_cholesky_f32(const void* a, void* l, long long batch, int n,
                       void* stream) {
  return launch<true>(a, l, batch, n, stream);
}

int traversal_floor_f32(const void* a, void* out, long long batch, int n,
                        void* stream) {
  return launch<false>(a, out, batch, n, stream);
}

// Writes {capacity, threads a CTA, matrices a CTA} of a launch at n.
void probe_geometry(int n, int* out) { geometry(n, out); }

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
