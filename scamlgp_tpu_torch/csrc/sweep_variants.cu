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
// over the matrix.  Device memory is touched once each way, and the batch
// fills the 132 SMs with independent CTAs.  What each scheme changes is
// the chain:
//
// - fused: A' = (A + cd u) + e_k w with cd = col / d, u = e_k - row and
//   w = row / d - e_k (1/d + 2), the term e_k[i] w[j] kept for every row (it
//   is 0 w[j], whose sign a zero of A + cd u takes on), so every element
//   takes three operations, select's two plus one.  The layout is
//   select's (sweep_inverse.cu): at N <= 32 a warp or part of one a
//   matrix, lane j column j in registers, the pivot column by __shfl_sync,
//   several matrices a CTA, no shared memory and no barrier; at
//   32 < N <= 128 a CTA of 16 x 16 threads with R x R register tiles, the
//   column and row of pivot k + 1 written by their owners into
//   double-buffered shared vectors, one barrier a pivot, the pivot loop
//   split as k = 16 kc + kt.  Each thread forms cd for its rows and u, w,
//   0 w for its columns from the two vectors.  The first version (one
//   matrix in a CTA's shared memory, thread t owning column t % n, four
//   shared-memory accesses an element update, a staging pass and two
//   barriers a pivot) took 1.513 ms at (1024, 128, 128); this one 0.452 ms
//   there (select 0.362), 1.757 ms at (4096, 128, 128) (first 5.783) and
//   0.0234 ms at (1024, 32, 32) (first 0.0410), one H100 80GB HBM3,
//   700 W (PERF.md, section 6);
// - pair: per trip of two pivots p, q = p + 1, warp 0 alone rebuilds q's
//   column, row and pivot after p from p's borders in O(N)
//   (pallas_sweep.py:194-205) and writes the six border vectors; then the
//   whole CTA applies both rank-1 terms and the four border writes in one
//   pass over one matrix in the CTA's shared memory.  Two barriers per
//   trip: half as many per pivot as the first fused kernel.
// - blocked: one matrix in the CTA's shared memory; per panel of 32 rows,
//   the 32 pivots are swept element by element over the 32 x N slab only
//   (a quarter of the matrix at N = 128); then the other rows get
//   [R | S] -> [R P^-1 | S - R P^-1 Q] as one rank-32 product, -R W with
//   W = [-P^-1 | P^-1 Q] the swept panel, each thread holding a 4 x 4 tile
//   of outputs in registers.  R is copied to a scratch (N, 33) array
//   first, since the product overwrites it.  The arithmetic stays on the
//   CUDA cores: TF32 tensor cores would round the float32 result beyond
//   the plain version's.
//
// No pivoting: the unswept part of an SPD matrix stays SPD, so every d is
// positive; a non-SPD input gives a non-positive d and a NaN log|A|.
//
// Built without FMA contraction (-fmad=false, cuda_build.SOURCE_FLAGS), so
// that each update rounds as the plain PyTorch version's does: with
// contraction the MLL of nearly singular float32 systems lay 5x farther
// from float64 than the plain version's (PERF.md, section 6); fused in
// float32 equals ops/sweep.py::_sweep_fused bit for bit.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an N it does not take), 0 on
// success.  sweep_fused_geometry reports the fused launch geometry that
// ops/sweep.py::launch_geometry mirrors.

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
// fused: select's two paths (sweep_inverse.cu), with fused's arithmetic
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpPathThreads = 128;
constexpr int kGrid = 16;
constexpr int kCtaPathThreads = kGrid * kGrid;

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
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    v[i] = (live && i < n) ? a[base + static_cast<size_t>(i) * n] : T(0);

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
#pragma unroll
    for (int i = 0; i < CAP; ++i)
      if (i < n) inv[base + static_cast<size_t>(i) * n] = -v[i];
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
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + kGrid * r, j = tx + kGrid * c;
      v[r][c] = (i < n && j < n) ? a[base + static_cast<size_t>(i) * n + j]
                                 : T(0);
    }
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

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + kGrid * r, j = tx + kGrid * c;
      if (i < n && j < n) inv[base + static_cast<size_t>(i) * n + j] = -v[r][c];
    }
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

// The fused kernel's launch geometry at n: {capacity, threads a CTA,
// matrices a CTA}, select's rule (ops/sweep.py::launch_geometry).
void fused_geometry(int n, int* out) {
  const int cap = n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  const bool warp_path = cap <= 32;
  out[0] = cap;
  out[1] = warp_path ? kWarpPathThreads : kCtaPathThreads;
  out[2] = warp_path ? kWarpPathThreads / cap : 1;
}

template <typename T>
void launch_fused(const T* a, T* inv, T* logdet, long long batch, int n,
                  cudaStream_t s) {
  int g[3];
  fused_geometry(n, g);
  const unsigned int ctas =
      static_cast<unsigned int>((batch + g[2] - 1) / g[2]);
  switch (g[0]) {
    case 8:
      sweep_fused_warp_kernel<T, 8><<<ctas, g[1], 0, s>>>(a, inv, logdet,
                                                          batch, n);
      break;
    case 16:
      sweep_fused_warp_kernel<T, 16><<<ctas, g[1], 0, s>>>(a, inv, logdet,
                                                           batch, n);
      break;
    case 32:
      sweep_fused_warp_kernel<T, 32><<<ctas, g[1], 0, s>>>(a, inv, logdet,
                                                           batch, n);
      break;
    case 64:
      sweep_fused_cta_kernel<T, 4><<<ctas, g[1], 0, s>>>(a, inv, logdet, n);
      break;
    default:
      sweep_fused_cta_kernel<T, 8><<<ctas, g[1], 0, s>>>(a, inv, logdet, n);
      break;
  }
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

// Dynamic shared memory of the pair and blocked schemes (fused needs none).
template <typename T>
size_t smem_bytes(Scheme s, int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  if (s == Scheme::kPair) return (nn + 7 * n) * sizeof(T);
  return (nn + static_cast<size_t>(n) * kRbStride + kBlock + n) * sizeof(T);
}

template <typename T>
void* kernel_of(Scheme s) {
  if (s == Scheme::kPair) return reinterpret_cast<void*>(sweep_pair_kernel<T>);
  return reinterpret_cast<void*>(sweep_blocked_kernel<T>);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  T* pinv = static_cast<T*>(inv);
  T* pld = static_cast<T*>(logdet);
  if (s == Scheme::kFused) {
    launch_fused<T>(pa, pinv, pld, batch, n, st);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = allow_max_smem<T>(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nn = n * n;
  const int threads = nn >= kThreads ? kThreads : ((nn + 31) / 32) * 32;
  const size_t smem = smem_bytes<T>(s, n);
  const dim3 grid(static_cast<unsigned int>(batch));
  if (s == Scheme::kPair)
    sweep_pair_kernel<T><<<grid, threads, smem, st>>>(pa, pinv, pld, n);
  else
    sweep_blocked_kernel<T><<<grid, threads, smem, st>>>(pa, pinv, pld, n);
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

// Writes {capacity, threads a CTA, matrices a CTA} of a fused launch at n.
void sweep_fused_geometry(int n, int* out) { fused_geometry(n, out); }

const char* sweep_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
