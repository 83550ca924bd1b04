// Three more step schemes of the batched sweep inverse, for Hopper.
//
// Each kernel maps a batch of SPD matrices A (B, N, N), N <= 128, to
// (A^{-1}, log|A|), as sweep_inverse.cu does, and replaces one Pallas TPU
// kernel of scamlgp_tpu/ops/pallas_sweep.py:
//
//   sweep_fused_kernel    <- _sweep_kernel_fused   (border writes folded
//                            into the bulk pass as a second rank-1 term)
//   sweep_pair_kernel     <- _sweep_kernel_pair    (two pivots per trip,
//                            N even)
//   sweep_blocked_kernel  <- _sweep_kernel_blocked (32-pivot panels and a
//                            rank-32 update of the rest, N % 32 == 0)
//
// Bound on the card: as for sweep_inverse.cu, one read and one write of the
// batch (8 N^2 bytes per matrix in float32) against at least N^3
// operations, N/8 operations per byte, below the H100's float32 ridge
// (about 20) for every N <= 128: the roofline bound is the bytes.  What
// limits the sweep in practice is its serial chain of pivots, each a pass
// over the matrix between block-wide barriers.  So every kernel keeps one
// matrix in one CTA's dynamic shared memory for the whole chain (64 KiB in
// float32, 128 KiB in float64 at N = 128, plus the scheme's vectors), device
// memory is touched once each way, and the batch fills the 132 SMs with
// independent CTAs.  What each scheme changes is the chain:
//
// - fused: per pivot, one staging pass writes cd = col/d, u = e_k - row and
//   w = row/d - e_k (1/d + 2) into shared vectors; then one branch-free
//   pass A[i][j] += cd[i] u[j] + e_k[i] w[j].  Two barriers per pivot, as
//   in sweep_inverse.cu, with no selects in the bulk pass.
// - pair: per trip of two pivots p, q = p + 1, warp 0 alone rebuilds q's
//   column, row and pivot after p from p's borders in O(N)
//   (pallas_sweep.py:194-205) and writes the six border vectors; then the
//   whole CTA applies both rank-1 terms and the four border writes in one
//   pass.  Two barriers per trip: half as many per pivot.
// - blocked: per panel of 32 rows, the 32 pivots are swept element by
//   element over the 32 x N slab only (a quarter of the matrix at N = 128);
//   then the other rows get [R | S] -> [R P^-1 | S - R P^-1 Q] as one
//   rank-32 product, -R W with W = [-P^-1 | P^-1 Q] the swept panel, each
//   thread holding a 4 x 4 tile of outputs in registers.  R is copied to a
//   scratch (N, 33) array first, since the product overwrites it.  The
//   arithmetic stays on the CUDA cores: TF32 tensor cores would round the
//   float32 result beyond the plain version's.
//
// No pivoting: the unswept part of an SPD matrix stays SPD, so every d is
// positive; a non-SPD input gives a non-positive d and a NaN log|A|.
//
// Built without FMA contraction (-fmad=false, cuda_build.SOURCE_FLAGS), so
// that each update rounds as the plain PyTorch version's does: with
// contraction the MLL of nearly singular float32 systems lay 5x farther
// from float64 than the plain version's (PERF.md, section 6).
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an N it does not take), 0 on
// success.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 256;
constexpr int kBlock = 32;             // panel width of the blocked scheme
constexpr int kRbStride = kBlock + 1;  // padded row of the R scratch

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ void load_matrix(const T* __restrict__ a, T* A,
                                            int nn) {
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) A[idx] = a[idx];
}

template <typename T>
__device__ __forceinline__ void store_negated(const T* A, T* __restrict__ inv,
                                              int nn) {
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) inv[idx] = -A[idx];
}

// ---------------------------------------------------------------------------
// fused
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sweep_fused_kernel(const T* __restrict__ a, T* __restrict__ inv,
                       T* __restrict__ logdet, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* cd = A + n * n;
  T* u = cd + n;
  T* w = u + n;
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  // each thread updates column j of rows i0, i0 + rstep, ...
  const int j = threadIdx.x % n;
  const int i0 = threadIdx.x / n;
  const int rstep = blockDim.x / n;

  load_matrix(a + base, A, nn);
  T ld = T(0);
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const T d = A[k * n + k];
    const T inv_d = T(1) / d;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const T e = (i == k) ? T(1) : T(0);
      const T r = A[k * n + i];
      cd[i] = A[i * n + k] * inv_d;
      u[i] = e - r;
      w[i] = r * inv_d - e * (inv_d + T(2));
    }
    if (threadIdx.x == 0) ld += log_of(d);
    __syncthreads();
    if (i0 < rstep) {
      const T uj = u[j];
      const T wj = w[j];
      for (int i = i0; i < n; i += rstep) {
        const T e = (i == k) ? T(1) : T(0);
        A[i * n + j] = A[i * n + j] + cd[i] * uj + e * wj;
      }
    }
    __syncthreads();
  }

  store_negated(A, inv + base, nn);
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// ---------------------------------------------------------------------------
// pair
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sweep_pair_kernel(const T* __restrict__ a, T* __restrict__ inv,
                      T* __restrict__ logdet, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* cdp = A + n * n;     // col_p / d_p
  T* rowp = cdp + n;      // row p before the pair
  T* cdq = rowp + n;      // q's column after p, / d_q'
  T* rowq1 = cdq + n;     // row q after p
  T* colpf = rowq1 + n;   // column p after the pair
  T* rowpf = colpf + n;   // row p after the pair
  T* rowqf = rowpf + n;   // row q after the pair
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  const int j = threadIdx.x % n;
  const int i0 = threadIdx.x / n;
  const int rstep = blockDim.x / n;

  load_matrix(a + base, A, nn);
  T ld = T(0);
  __syncthreads();

  for (int p = 0; p < n; p += 2) {
    const int q = p + 1;
    if (threadIdx.x < 32) {
      // the pair's scalars, each lane for itself (the values of the
      // vectors below at the index that defines them)
      const T dp = A[p * n + p];
      const T rpq = A[p * n + q];
      const T inv_dp = T(1) / dp;
      const T cdpq = A[q * n + p] * inv_dp;  // cd_p[q]
      const T dq1 = A[q * n + q] - cdpq * rpq;
      const T inv_dq = T(1) / dq1;
      const T cdqp =                         // cd_q[p]
          (A[p * n + q] - (dp * inv_dp) * rpq + rpq * inv_dp) * inv_dq;
      for (int i = threadIdx.x; i < n; i += 32) {
        const T ep = (i == p) ? T(1) : T(0);
        const T eq = (i == q) ? T(1) : T(0);
        const T c_p = A[i * n + p] * inv_dp;
        const T colq1 = A[i * n + q] - c_p * rpq + ep * (rpq * inv_dp);
        const T c_q = colq1 * inv_dq;
        const T rp = A[p * n + i];
        const T rq1 = A[q * n + i] - cdpq * rp + ep * cdpq;
        const T rp_fix = rp * inv_dp - ep * (inv_dp + T(1));
        cdp[i] = c_p;
        rowp[i] = rp;
        cdq[i] = c_q;
        rowq1[i] = rq1;
        colpf[i] = c_p - c_q * cdpq;
        rowpf[i] = rp_fix - cdqp * rq1 + eq * cdqp;
        rowqf[i] = rq1 * inv_dq - eq * (inv_dq + T(1));
      }
      if (threadIdx.x == 0) {
        ld += log_of(dp);
        ld += log_of(dq1);
      }
    }
    __syncthreads();
    if (i0 < rstep) {
      const T rpj = rowp[j];
      const T rq1j = rowq1[j];
      for (int i = i0; i < n; i += rstep) {
        T v;
        if (i == p) {
          v = rowpf[j];
        } else if (i == q) {
          v = rowqf[j];
        } else if (j == p) {
          v = colpf[i];
        } else if (j == q) {
          v = cdq[i];
        } else {
          v = A[i * n + j] - cdp[i] * rpj - cdq[i] * rq1j;
        }
        A[i * n + j] = v;
      }
    }
    __syncthreads();
  }

  store_negated(A, inv + base, nn);
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// ---------------------------------------------------------------------------
// blocked
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sweep_blocked_kernel(const T* __restrict__ a, T* __restrict__ inv,
                         T* __restrict__ logdet, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* rb = A + n * n;               // (n, kRbStride): the panel's columns
  T* col = rb + n * kRbStride;     // (kBlock): pivot column within the panel
  T* row = col + kBlock;           // (n): pivot row
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  const int n4 = n / 4;

  load_matrix(a + base, A, nn);
  T ld = T(0);
  __syncthreads();

  for (int b0 = 0; b0 < n; b0 += kBlock) {
    T* P = A + b0 * n;  // the panel's rows
    // R: the panel's columns of every row, before the panel changes (the
    // rows outside the panel are read; the first barrier below orders
    // these reads before any write to the panel)
    for (int idx = threadIdx.x; idx < n * kBlock; idx += blockDim.x) {
      const int i = idx / kBlock;
      const int t = idx - i * kBlock;
      rb[i * kRbStride + t] = A[i * n + b0 + t];
    }

    // the panel's 32 pivots, element by element over the 32 x n slab:
    // P - cd row + e_jj (row/d) + cd e_k + (-1/d - 2) e_jj e_k
    // (pallas_sweep.py:315-316)
    for (int jj = 0; jj < kBlock; ++jj) {
      const int k = b0 + jj;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        row[i] = P[jj * n + i];
        if (i < kBlock) col[i] = P[i * n + k];
      }
      __syncthreads();
      const T d = row[k];
      const T inv_d = T(1) / d;
      const T corner = -inv_d - T(2);
      for (int idx = threadIdx.x; idx < kBlock * n; idx += blockDim.x) {
        const int i = idx / n;
        const int jc = idx - i * n;
        const T cdi = col[i] * inv_d;
        const T es = (i == jj) ? T(1) : T(0);
        const T el = (jc == k) ? T(1) : T(0);
        const T r = row[jc];
        P[idx] = P[idx] - cdi * r + es * (r * inv_d) + cdi * el +
                 corner * (es * el);
      }
      if (threadIdx.x == 0) ld += log_of(d);
      __syncthreads();
    }

    // the other rows: A[i][j] = (j in panel ? 0 : A[i][j]) - sum_t R[i][t]
    // W[t][j], by 4 x 4 register tiles; rows outside the panel only, so W
    // (the panel) and R (the scratch) are read-only here
    const int row_groups = n4 - kBlock / 4;
    const int tiles = row_groups * n4;
    for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
      const int tr = tile / n4;
      const int tc = tile - tr * n4;
      const int rg = tr < b0 / 4 ? tr : tr + kBlock / 4;
      const int r0 = rg * 4;
      const int c0 = tc * 4;
      T acc[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = T(0);
      for (int t = 0; t < kBlock; ++t) {
        T rv[4], wv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) rv[x] = rb[(r0 + x) * kRbStride + t];
#pragma unroll
        for (int y = 0; y < 4; ++y) wv[y] = P[t * n + c0 + y];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] += rv[x] * wv[y];
      }
      const bool in_panel = c0 >= b0 && c0 < b0 + kBlock;
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          T* out = A + (r0 + x) * n + c0 + y;
          *out = (in_panel ? T(0) : *out) - acc[x][y];
        }
    }
    __syncthreads();
  }

  store_negated(A, inv + base, nn);
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum class Scheme { kFused, kPair, kBlocked };

template <typename T>
size_t smem_bytes(Scheme s, int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  switch (s) {
    case Scheme::kFused:
      return (nn + 3 * n) * sizeof(T);
    case Scheme::kPair:
      return (nn + 7 * n) * sizeof(T);
    default:
      return (nn + static_cast<size_t>(n) * kRbStride + kBlock + n) *
             sizeof(T);
  }
}

template <typename T>
void* kernel_of(Scheme s) {
  switch (s) {
    case Scheme::kFused:
      return reinterpret_cast<void*>(sweep_fused_kernel<T>);
    case Scheme::kPair:
      return reinterpret_cast<void*>(sweep_pair_kernel<T>);
    default:
      return reinterpret_cast<void*>(sweep_blocked_kernel<T>);
  }
}

// Lets the scheme's kernel use the shared memory it needs at the largest N
// on the current device.  The attribute is held per device, so it is set
// once for each device a launch meets; two threads racing here both set the
// same value.
template <typename T>
cudaError_t allow_max_smem(Scheme s) {
  constexpr int kMaxDevices = 64;
  static bool done[3][kMaxDevices] = {};
  const int si = static_cast<int>(s);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[si][device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_of<T>(s),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<T>(s, kMaxN)));
  if (err == cudaSuccess && device < kMaxDevices) done[si][device] = true;
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
  cudaError_t err = allow_max_smem<T>(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nn = n * n;
  const int threads = nn >= kThreads ? kThreads : ((nn + 31) / 32) * 32;
  const size_t smem = smem_bytes<T>(s, n);
  const dim3 grid(static_cast<unsigned int>(batch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  T* pinv = static_cast<T*>(inv);
  T* pld = static_cast<T*>(logdet);
  switch (s) {
    case Scheme::kFused:
      sweep_fused_kernel<T><<<grid, threads, smem, st>>>(pa, pinv, pld, n);
      break;
    case Scheme::kPair:
      sweep_pair_kernel<T><<<grid, threads, smem, st>>>(pa, pinv, pld, n);
      break;
    default:
      sweep_blocked_kernel<T><<<grid, threads, smem, st>>>(pa, pinv, pld, n);
      break;
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

const char* sweep_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
