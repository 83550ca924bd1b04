// Batched SPD inverse and log-determinant by a blocked Cholesky, for Hopper.
//
// Replaces the two Pallas TPU kernels of
// scamlgp_tpu/ops/pallas_blocked_chol.py, which compute one function,
// (A^{-1}, log|A|) for a batch (B, N, N) of SPD matrices:
//
//   - blocked_chol_smem_kernel replaces _make_kernel (G matrices resident in
//     VMEM): one CTA holds the nb(nb+1)/2 lower 64 x 64 blocks of its
//     matrix in dynamic shared memory for the whole computation;
//   - blocked_chol_global_kernel replaces _make_hbm_kernel (one matrix in
//     HBM staged into one VMEM scratch): the matrix stays in device memory,
//     worked on in place, and the tiles of each block operation pass
//     through four 64 x 64 tiles of shared memory.
//
// Both run the reference's _inverse_body with block size 64.  N is padded to
// Np, a multiple of 64, with an identity block (its inverse is I and its
// log-determinant 0).  Then, on the lower blocks:
//
//   for b:  factor A[b][b] = L L^T column by column (log|A| += log pivot)
//           and form its inverse Linv alongside; A[b][b] <- Linv
//           L[i][b] = A[i][b] Linv^T                 (i > b)
//           A[i][j] -= L[i][b] L[j][b]^T             (b < j <= i)
//   W = L^{-1}, column block by column block, in place of L:
//           W[i][j] = -Linv[i][i] (L[i][j] W[j][j] + sum_{j<k<i} L[i][k] W[k][j])
//   A^{-1}[i][j] = sum_{k >= i} W[k][i]^T W[k][j], written to both halves.
//
// The diagonal block's inverse is built by applying each elementary step of
// the factorization to an identity tile in the same pass over the 64
// columns (the reference substitutes row by row afterwards); the two differ
// by rounding only.  There is no pivoting and no clamping: a non-positive
// pivot gives a NaN or infinite log-determinant and inverse, as the plain
// version does.  Products are true float32 or float64 FMAs, never TF32.
//
// Bound on the card: a Cholesky, a triangular inverse and W^T W cost about
// N^3 / 6 multiply-adds (N^3 / 3 operations) each, N^3 operations in all,
// against 2 N^2 words of device traffic (one read of A, one write of
// A^{-1}): N / 8 operations per byte in float32, above the H100's float32
// ridge (67 TFLOP/s over 3.35 TB/s, about 20) for N >= 160, so at the
// campaign's N = 256 and 512 the operations bound it.  The design keeps operands on chip: the smem
// variant touches device memory only on the way in and out; the global
// variant re-reads tiles (one 64 x 64 x 64 product per two tiles), which
// the 50 MB L2 absorbs in part.  Every tile is stored with an XOR swizzle
// so that the 4 x 4 register tile of each thread reads rows and columns
// of its operands without bank conflicts.  The serial part, 64 dependent
// column steps per diagonal block with one barrier each, is what a larger
// batch cannot hide; tensor-core products (wgmma) and TMA are later work.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, 0 on success.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BS = 64;
constexpr int TILE = BS * BS;
constexpr int THREADS = 256;

// Element (r, c) of a 64 x 64 tile in shared memory.  The XOR keeps each row
// a permutation of itself and puts the 32 rows of a column in 32 banks.
__device__ __forceinline__ int sw(int r, int c) {
  return r * BS + (c ^ (r & 31));
}

__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }
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

// ---------------------------------------------------------------------------
// smem variant: one matrix per CTA, its lower blocks resident on chip.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    blocked_chol_smem_kernel(const T* __restrict__ a, T* __restrict__ inv,
                             T* __restrict__ logdet, int n, int nb) {
  extern __shared__ double smem_d[];
  T* S = reinterpret_cast<T*>(smem_d);
  T* scratch = S + static_cast<size_t>(nb * (nb + 1) / 2) * TILE;
  auto blk = [&](int i, int j) { return S + (i * (i + 1) / 2 + j) * TILE; };
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const T* A = a + base;
  T* out = inv + base;

  for (int i = 0; i < nb; ++i)
    for (int j = 0; j <= i; ++j) {
      T* t = blk(i, j);
      for (int idx = threadIdx.x; idx < TILE; idx += THREADS) {
        const int r = idx >> 6, c = idx & 63;
        t[sw(r, c)] = padded(A, n, i * BS + r, j * BS + c);
      }
    }

  T ld = T(0);
  for (int b = 0; b < nb; ++b) {
    ld += chol_inv_tile(blk(b, b), scratch);
    T* diag = blk(b, b);
    for (int idx = threadIdx.x; idx < TILE; idx += THREADS)
      diag[idx] = scratch[idx];
    __syncthreads();
    for (int i = b + 1; i < nb; ++i) {
      Acc<T> acc;
      zero(acc);
      tile_mma<T, false, true, false>(acc, blk(i, b), diag);
      __syncthreads();
      acc_to_tile(acc, blk(i, b));
    }
    __syncthreads();
    for (int i = b + 1; i < nb; ++i)
      for (int j = b + 1; j <= i; ++j) {
        // each thread reads and writes only its own elements of A[i][j]
        Acc<T> acc;
        const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
        T* t = blk(i, j);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc.v[r][c] = t[sw(ty + 16 * r, tx + 16 * c)];
        tile_mma<T, false, true, true>(acc, blk(i, b), blk(j, b));
        acc_to_tile(acc, t);
      }
    __syncthreads();
  }

  for (int j = 0; j < nb; ++j)
    for (int i = j + 1; i < nb; ++i) {
      Acc<T> acc;
      zero(acc);
      tile_mma<T, false, false, false>(acc, blk(i, j), blk(j, j));
      for (int k = j + 1; k < i; ++k)
        tile_mma<T, false, false, false>(acc, blk(i, k), blk(k, j));
      acc_to_tile(acc, scratch);
      __syncthreads();
      zero(acc);
      tile_mma<T, false, false, true>(acc, blk(i, i), scratch);
      acc_to_tile(acc, blk(i, j));
      __syncthreads();
    }

  for (int i = 0; i < nb; ++i)
    for (int j = 0; j <= i; ++j) {
      Acc<T> acc;
      zero(acc);
      for (int k = i; k < nb; ++k)
        tile_mma<T, true, false, false>(acc, blk(k, i), blk(k, j));
      acc_to_global(acc, out, n, i * BS, j * BS);
      if (i != j) {
        acc_to_tile(acc, scratch);
        __syncthreads();
        tile_t_to_global(scratch, out, n, j * BS, i * BS);
        __syncthreads();
      }
    }
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// ---------------------------------------------------------------------------
// global variant: one matrix per CTA, worked on in place in device memory.
// ---------------------------------------------------------------------------

// work: (B, np, np), the padded copy the kernel works in; out: (B, n, n).
// They are one buffer when n == np: the last phase then overwrites each W
// block only after the last product that reads it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    blocked_chol_global_kernel(const T* __restrict__ a, T* work, T* out,
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

  T ld = T(0);
  for (int b = 0; b < nb; ++b) {
    tile_from_global(s0, g(b, b), np);
    ld += chol_inv_tile(s0, s1);  // s1 = Linv[b][b] until the next b
    tile_to_global(s1, g(b, b), np);
    for (int i = b + 1; i < nb; ++i) {
      tile_from_global(s0, g(i, b), np);
      __syncthreads();
      Acc<T> acc;
      zero(acc);
      tile_mma<T, false, true, false>(acc, s0, s1);
      acc_to_global(acc, g(i, b), np, 0, 0);
      __syncthreads();
    }
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
}

// Lets kernel use up to the device's opt-in shared memory per block.  The
// attribute is held per device, so it is set once for each device a launch
// meets; two threads racing here both set the same value.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool* done) {
  constexpr int kMaxDevices = 64;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

// Both launch on the calling thread's current device; the caller makes A's
// device current.
template <typename T>
int launch_smem(const void* a, void* inv, void* logdet, long long batch,
                int n, void* stream) {
  static bool done[64] = {};
  if (batch <= 0) return 0;
  cudaError_t err = allow_max_smem(blocked_chol_smem_kernel<T>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + BS - 1) / BS;
  const size_t smem = static_cast<size_t>(nb * (nb + 1) / 2 + 1) * TILE *
                      sizeof(T);
  blocked_chol_smem_kernel<T>
      <<<static_cast<unsigned int>(batch), THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<T*>(inv),
          static_cast<T*>(logdet), n, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_global(const void* a, void* work, void* inv, void* logdet,
                  long long batch, int n, void* stream) {
  static bool done[64] = {};
  if (batch <= 0) return 0;
  cudaError_t err = allow_max_smem(blocked_chol_global_kernel<T>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + BS - 1) / BS;
  const size_t smem = static_cast<size_t>(4) * TILE * sizeof(T);
  blocked_chol_global_kernel<T>
      <<<static_cast<unsigned int>(batch), THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<T*>(work),
          static_cast<T*>(inv), static_cast<T*>(logdet), n, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int blocked_chol_inverse_smem_f32(const void* a, void* inv, void* logdet,
                                  long long batch, int n, void* stream) {
  return launch_smem<float>(a, inv, logdet, batch, n, stream);
}

int blocked_chol_inverse_smem_f64(const void* a, void* inv, void* logdet,
                                  long long batch, int n, void* stream) {
  return launch_smem<double>(a, inv, logdet, batch, n, stream);
}

int blocked_chol_inverse_global_f32(const void* a, void* work, void* inv,
                                    void* logdet, long long batch, int n,
                                    void* stream) {
  return launch_global<float>(a, work, inv, logdet, batch, n, stream);
}

int blocked_chol_inverse_global_f64(const void* a, void* work, void* inv,
                                    void* logdet, long long batch, int n,
                                    void* stream) {
  return launch_global<double>(a, work, inv, logdet, batch, n, stream);
}

const char* blocked_chol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
