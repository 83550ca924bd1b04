// Batched SPD inverse and log-determinant by the sweep operator, for Hopper.
//
// Replaces the Pallas TPU kernel scamlgp_tpu/ops/pallas_sweep.py::_sweep_kernel.
// For each matrix A of a batch (B, N, N), N <= 128, it runs N sweep pivots:
//
//     d = A[k][k];  logdet += log d
//     A[i][j] -= (A[i][k] / d) * A[k][j]     for i != k, j != k
//     A[i][k]  =  A[i][k] / d                for i != k
//     A[k][j]  =  A[k][j] / d                for j != k
//     A[k][k]  = -1 / d
//
// after which A holds -A^{-1}.  There is no pivoting: the unswept block of
// an SPD matrix stays SPD, so every d is positive; a non-SPD input gives a
// non-positive d and a NaN log-determinant, as in the reference.
//
// Bound on the card: one read and one write of the batch (8 N^2 bytes per
// matrix in float32) against N^3 operations, i.e. N/8 operations per byte,
// below the float32 ridge of the H100 (67 TFLOP/s over 3.35 TB/s, about 20)
// for every N <= 128, so the roofline bound is the bytes.  What limits this
// kernel in practice is the serial chain of N pivots, each a pass over the
// matrix between two block-wide barriers.  The design keeps that chain on
// chip: one CTA owns one matrix for all N pivots in dynamic shared memory
// (64 KiB in float32, 128 KiB in float64 at N = 128), so device memory is
// touched once on the way in and once on the way out, and the batch fills
// the 132 SMs with independent CTAs.  Pivot row and column are staged into
// two shared vectors so every element update reads them without conflicts.
//
// Built without FMA contraction (-fmad=false, cuda_build.SOURCE_FLAGS), so
// that each update rounds as the plain PyTorch version's does: with
// contraction the MLL of nearly singular float32 systems lay 5x farther
// from float64 than the plain version's (PERF.md, section 6).
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

template <typename T>
__global__ void sweep_inverse_kernel(const T* __restrict__ a,
                                     T* __restrict__ inv,
                                     T* __restrict__ logdet, int n) {
  extern __shared__ unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* col = A + n * n;
  T* row = col + n;
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    A[idx] = a[base + idx];
  }
  T ld = T(0);
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      col[i] = A[i * n + k];
      row[i] = A[k * n + i];
    }
    __syncthreads();
    const T d = row[k];
    const T inv_d = T(1) / d;
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const int i = idx / n;
      const int j = idx - i * n;
      const T cd = col[i] * inv_d;
      T v;
      if (j == k) {
        v = (i == k) ? -inv_d : cd;
      } else if (i == k) {
        v = row[j] * inv_d;
      } else {
        v = A[idx] - cd * row[j];
      }
      A[idx] = v;
    }
    if (threadIdx.x == 0) ld += log_of(d);
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    inv[base + idx] = -A[idx];
  }
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// Lets the kernel use the shared memory of the largest N (128) on the
// current device.  The attribute is held per device, so it is set once for
// each device a launch meets; two threads racing here both set the same
// value.
template <typename T>
cudaError_t allow_max_smem() {
  constexpr int kMaxN = 128;
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(sweep_inverse_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>((kMaxN * kMaxN + 2 * kMaxN) *
                                              sizeof(T)));
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

// Launches on the calling thread's current device; the caller makes A's
// device current.
template <typename T>
int launch(const void* a, void* inv, void* logdet, long long batch, int n,
           void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = allow_max_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (static_cast<size_t>(n) * n + 2 * n) * sizeof(T);
  const int nn = n * n;
  const int threads = nn >= 256 ? 256 : ((nn + 31) / 32) * 32;
  sweep_inverse_kernel<T><<<static_cast<unsigned int>(batch), threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(inv),
      static_cast<T*>(logdet), n);
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

const char* sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
