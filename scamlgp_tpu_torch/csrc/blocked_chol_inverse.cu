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
// campaign's N = 256 and 512 the operations bound it (0.256 ms at
// (1024, 256, 256) in float32).
//
// smem variant.  Its blocks and the diagonal factorization's vectors take
// 162 KiB at N = 256 in float32, so one CTA of 8 warps runs on an SM and
// nothing else fills its stalls.  The first version took 4.38 ms at
// (1024, 256, 256), 17x the bound and slower than the global variant: its
// 64 column steps per diagonal block each had a flat loop with a runtime
// division and half its threads idle on the triangle's test, and its
// products gave each thread a 4 x 4 tile, 8 shared-memory loads for 16
// FMAs, so shared memory, not the FMA units, set their pace.  This design:
//   - loads the blocks with cp.async, 16 bytes a copy, all in flight;
//   - factors a diagonal block in registers: thread (dy, dx) of a 16 x 16
//     grid holds a 4 x 4 tile of the block and of its inverse; columns
//     j, j + 1 of the block and rows j, j + 1 of the inverse are broadcast
//     through double-buffered 64-vectors, one barrier for two column
//     steps, no index arithmetic; elements above the diagonal or left of
//     the column are updated too, unread, so no test is needed but the
//     inverse's rows;
//   - runs every product as four independent 64 x 64 tiles, one per group
//     of 64 threads, each thread an 8 x 8 register tile: per k, 8 + 8
//     operand loads (two 16-byte vectors where the operand is read along a
//     row) for 64 FMAs.  Blocks are stored so that most operands are read
//     along rows: the panel as L[i][b]^T, the diagonal as Linv^T.  The
//     tiles use a swizzle of 4-element chunks that keeps both row vectors
//     and columns free of bank conflicts;
//   - skips the zero triangle of the lower-triangular left operands where a
//     warp's rows allow (k < 48 for half the warps);
//   - forms W column block by column block, right-looking: each sum grows
//     in its block's own slot as soon as a W block is known, up to three
//     blocks at once, and the columns overlap, so no scratch block is
//     needed and N = 256 takes 8 rounds of one product.
// Measured on one H100 80GB HBM3 (700 W): 1.514 ms at (1024, 256, 256) in
// float32 against the 0.256 ms operations bound (the first version 4.375,
// the global variant 3.524 there); of a CTA's cycles the diagonal blocks
// take 24%, the four product phases 72% (PERF.md, section 6).
//
// global variant.  The matrix stays in device memory, worked on in place;
// the tiles of each block operation pass through four 64 x 64 tiles of
// shared memory with the XOR swizzle sw(); the serial part, 64 dependent
// column steps per diagonal block with one barrier each, is what a larger
// batch cannot hide; it is the next kernel to redesign.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, 0 on success.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BS = 64;
constexpr int TILE = BS * BS;
constexpr int THREADS = 256;

// Phase profile of the smem kernel, built only with -DBLOCKED_CHOL_PROFILE
// (scamlgp_tpu_torch/profile_blocked_chol.py): after a CTA-wide barrier at
// each phase's end, thread 0 adds the phase's clock64() cycles to its
// total; at the end every CTA adds its totals, and a count of 1, to
// g_phase_cycles.  The default build has no barrier and no stamp.
enum Phase { PH_LOAD, PH_DIAG, PH_TRSM, PH_SYRK, PH_TRINV, PH_WTW, PH_COUNT };
#ifdef BLOCKED_CHOL_PROFILE
__device__ unsigned long long g_phase_cycles[PH_COUNT + 1];
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
        atomicAdd(&g_phase_cycles[p],                             \
                  static_cast<unsigned long long>(prof_acc[p]));  \
      atomicAdd(&g_phase_cycles[PH_COUNT], 1ull);                 \
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

// ---------------------------------------------------------------------------
// smem variant: one matrix per CTA, its lower blocks resident on chip.
// ---------------------------------------------------------------------------

// The 256 threads work as 4 groups of 64 on independent 64 x 64 tiles.
constexpr int GROUPS = THREADS / 64;

// Element (r, c) of a smem-variant tile.  Rows are kept whole, in 4-element
// chunks, chunk c / 4 of row r at chunk (c / 4) ^ ((r / 4) % 8): a row's
// chunks load as 16-byte vectors, and a column's elements from rows 4 apart
// fall in distinct banks.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BS + ((((c >> 2) ^ ((r >> 2) & 7)) << 2) | (c & 3));
}

// Row (or column) e < 8 of the eight that thread t < 8 of a group owns in a
// tile: 4t .. 4t + 3 and 32 + 4t .. 32 + 4t + 3.
__device__ __forceinline__ int own(int t, int e) {
  return 4 * t + (e < 4 ? e : 28 + e);
}

__device__ __forceinline__ void ld4(float* v, const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ld4(double* v, const double* p) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// 16 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// f = X[k][own(t, 0..7)] (two vector loads) or X[own(t, 0..7)][k].
template <typename T>
__device__ __forceinline__ void frag_row(T* f, const T* X, int k, int t) {
  ld4(f, X + swz(k, 4 * t));
  ld4(f + 4, X + swz(k, 32 + 4 * t));
}
template <typename T>
__device__ __forceinline__ void frag_col(T* f, const T* X, int k, int t) {
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = X[swz(own(t, e), k)];
}

// acc (+|-)= op(A) op(B) over k < k_end for the group's 8 x 8 elements of
// a 64 x 64 tile; op(X) = X^T where TA (TB) is set.  Each k takes 8 + 8
// operand loads for 64 FMAs.
template <typename T, bool TA, bool TB, bool SUB>
__device__ __forceinline__ void group_mma(T (&acc)[8][8], const T* A,
                                          const T* B, int ty, int tx,
                                          int k_end) {
  // in float64 the 8 x 8 doubles leave no room for a second k in flight
#pragma unroll (sizeof(T) == 4 ? 2 : 1)
  for (int k = 0; k < k_end; ++k) {
    T a[8], b[8];
    if (TA)
      frag_row(a, A, k, ty);
    else
      frag_col(a, A, k, ty);
    if (TB)
      frag_col(b, B, k, tx);
    else
      frag_row(b, B, k, tx);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const T ae = SUB ? -a[e] : a[e];
#pragma unroll
      for (int f = 0; f < 8; ++f) acc[e][f] = fma(ae, b[f], acc[e][f]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero8(T (&acc)[8][8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[e][f] = T(0);
}

template <typename T>
__device__ __forceinline__ void acc_load(T (&acc)[8][8], const T* X, int ty,
                                         int tx) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    ld4(acc[e], X + swz(own(ty, e), 4 * tx));
    ld4(acc[e] + 4, X + swz(own(ty, e), 32 + 4 * tx));
  }
}

template <typename T>
__device__ __forceinline__ void acc_store(const T (&acc)[8][8], T* X, int ty,
                                          int tx) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    st4(X + swz(own(ty, e), 4 * tx), acc[e]);
    st4(X + swz(own(ty, e), 32 + 4 * tx), acc[e] + 4);
  }
}

// The group's elements to rows r0.., columns c0.. of the n x n output
// (vector stores where vec), and their transpose to rows c0.., columns
// r0.., dropping what falls past n.
template <typename T>
__device__ __forceinline__ void acc_to_out(const T (&acc)[8][8], T* out,
                                           int n, int r0, int c0, int ty,
                                           int tx, bool vec) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = r0 + own(ty, e);
    if (r >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 32 * h + 4 * tx;
      T* p = out + static_cast<size_t>(r) * n + c;
      if (vec) {
        if (c < n) st4(p, acc[e] + 4 * h);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < n) p[q] = acc[e][4 * h + q];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void acc_t_to_out(const T (&acc)[8][8], T* out,
                                             int n, int r0, int c0, int ty,
                                             int tx) {
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int r = c0 + own(tx, f);
    if (r >= n) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = r0 + own(ty, e);
      if (c < n) out[static_cast<size_t>(r) * n + c] = acc[e][f];
    }
  }
}

// Factors the SPD tile in slot (its lower triangle) as L L^T and writes
// L^{-1}, transposed, over it; returns the sum of log pivots (every
// thread).  The 256 threads hold the tile in registers, thread (dy, dx)
// the 4 x 4 elements at rows dy + 16 r and columns dx + 16 c, P (the
// tile) and X (L^{-1}, from the identity).  Columns go two at a time:
// the owners of columns j, j + 1 of P and rows j, j + 1 of X wrote them,
// as they stood before step j, into one half of double-buffered vectors;
// every thread takes column j + 1 and row j + 1 through step j itself,
// then downdates all its P elements with both columns' l = P[:, k] /
// sqrt(d) (elements above the diagonal or left of the column are never
// read again), its X rows below each pivot, and scales rows j and j + 1
// of X; one barrier for two steps.  Each element's arithmetic is
// chol_inv_tile's, with the plain version's rsqrt for 1 / sqrt(d).
template <typename T>
__device__ T chol_inv_regs(T* slot, T* vec) {
  const int dx = threadIdx.x & 15, dy = threadIdx.x >> 4;
  T P[4][4], X[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      P[r][c] = slot[swz(dy + 16 * r, dx + 16 * c)];
      X[r][c] = (dy == dx && r == c) ? T(1) : T(0);
    }
  // half h of vec: columns j, j + 1 of P, rows j, j + 1 of X
  if (dx < 2)
#pragma unroll
    for (int r = 0; r < 4; ++r) vec[dx * BS + dy + 16 * r] = P[r][0];
  if (dy < 2)
#pragma unroll
    for (int c = 0; c < 4; ++c) vec[(2 + dy) * BS + dx + 16 * c] = X[0][c];
  __syncthreads();

  T logdet = T(0);
#pragma unroll
  for (int jc = 0; jc < 4; ++jc) {
    for (int jt = 0; jt < 16; jt += 2) {
      const int j = 16 * jc + jt;
      const T* ca = vec + ((jt >> 1) & 1) * 4 * BS;
      const T* cb = ca + BS;
      const T* xa = ca + 2 * BS;
      const T* xb = ca + 3 * BS;
      // step j
      const T d0 = ca[j];
      const T inv0 = rsqrt_of(d0);
      logdet += log_of(d0);
      const T a1 = ca[j + 1] * inv0;
      T ai[4], ak[4], xaj[4], bi[4], bk[4], xbj[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ai[r] = ca[dy + 16 * r] * inv0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ak[c] = ca[dx + 16 * c] * inv0;
        xaj[c] = xa[dx + 16 * c] * inv0;
      }
      // column j + 1 of P and row j + 1 of X after step j, then step j + 1
      const T d1 = cb[j + 1] - a1 * a1;
      const T inv1 = rsqrt_of(d1);
      logdet += log_of(d1);
#pragma unroll
      for (int r = 0; r < 4; ++r) bi[r] = (cb[dy + 16 * r] - ai[r] * a1) * inv1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bk[c] = (cb[dx + 16 * c] - ak[c] * a1) * inv1;
        xbj[c] = (xb[dx + 16 * c] - a1 * xaj[c]) * inv1;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          P[r][c] -= ai[r] * ak[c];
          P[r][c] -= bi[r] * bk[c];
        }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = dy + 16 * r;
        if (i > j)
#pragma unroll
          for (int c = 0; c < 4; ++c) X[r][c] -= ai[r] * xaj[c];
        if (i > j + 1)
#pragma unroll
          for (int c = 0; c < 4; ++c) X[r][c] -= bi[r] * xbj[c];
      }
      if (dy == jt)
#pragma unroll
        for (int c = 0; c < 4; ++c) X[jc][c] *= inv0;
      if (dy == jt + 1)
#pragma unroll
        for (int c = 0; c < 4; ++c) X[jc][c] *= inv1;

      // columns j + 2, j + 3 of P and rows j + 2, j + 3 of X, as they
      // stand after step j + 1, into the other half
      T* w = vec + (((jt >> 1) & 1) ^ 1) * 4 * BS;
      if (jt + 2 < 16) {
        if (dx == jt + 2 || dx == jt + 3)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            w[(dx - jt - 2) * BS + dy + 16 * r] = P[r][jc];
        if (dy == jt + 2 || dy == jt + 3)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            w[(dy - jt) * BS + dx + 16 * c] = X[jc][c];
      } else if (jc + 1 < 4) {
        const int jn = jc + 1 < 4 ? jc + 1 : jc;  // a constant once unrolled
        if (dx < 2)
#pragma unroll
          for (int r = 0; r < 4; ++r) w[dx * BS + dy + 16 * r] = P[r][jn];
        if (dy < 2)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            w[(2 + dy) * BS + dx + 16 * c] = X[jn][c];
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) slot[swz(dx + 16 * c, dy + 16 * r)] = X[r][c];
  return logdet;
}

// Slots hold, in turn: A[i][j] (row-major); after block b's panel, the
// panel's L[i][b]^T; the diagonal block's L^{-1} transposed; after the
// triangular inverse, W[i][j] (row-major).  vec: n % 4 == 0 and both
// matrices 16-byte aligned, so rows load and store as 16-byte vectors.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    blocked_chol_smem_kernel(const T* __restrict__ a, T* __restrict__ inv,
                             T* __restrict__ logdet, int n, int nb, int vec) {
  extern __shared__ __align__(16) unsigned char smem_tiles[];
  T* S = reinterpret_cast<T*>(smem_tiles);
  T* vecs = S + static_cast<size_t>(nb * (nb + 1) / 2) * TILE;
  auto blk = [&](int i, int j) { return S + (i * (i + 1) / 2 + j) * TILE; };
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const T* A = a + base;
  T* out = inv + base;
  const int g = threadIdx.x >> 6;
  const int ty = (threadIdx.x & 63) >> 3, tx = threadIdx.x & 7;
  // A lower-triangular left operand: the group's first warp holds rows
  // 0-15 and 32-47, whose sums end at k = 48.
  const int k_low = (threadIdx.x & 32) ? BS : 48;
  PROF_DECL

  for (int i = 0; i < nb; ++i)
    for (int j = 0; j <= i; ++j)
      for (int q = threadIdx.x; q < TILE / 4; q += THREADS) {
        const int r = q >> 4, c = (q & 15) << 2;
        const int R = i * BS + r, C = j * BS + c;
        T* dst = blk(i, j) + swz(r, c);
        if (vec && R < n && C < n) {
          const T* src = A + static_cast<size_t>(R) * n + C;
#pragma unroll
          for (int h = 0; h < static_cast<int>(sizeof(T)) / 4; ++h)
            cp_async16(dst + h * (16 / sizeof(T)), src + h * (16 / sizeof(T)));
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) dst[u] = padded(A, n, R, C + u);
        }
      }
  cp_async_wait_all();
  __syncthreads();
  PROF_MARK(PH_LOAD);

  T ld = T(0);
  for (int b = 0; b < nb; ++b) {
    ld += chol_inv_regs(blk(b, b), vecs);
    __syncthreads();
    PROF_MARK(PH_DIAG);

    // panel: L[i][b]^T = Linv A[i][b]^T, group g on row block b + 1 + g
    {
      const int i = b + 1 + g;
      T acc[8][8];
      if (i < nb) {
        zero8(acc);
        group_mma<T, true, true, false>(acc, blk(b, b), blk(i, b), ty, tx,
                                        k_low);
      }
      __syncthreads();
      if (i < nb) acc_store(acc, blk(i, b), ty, tx);
      __syncthreads();
    }
    PROF_MARK(PH_TRSM);

    // trailing update A[i][j] -= L[i][b] L[j][b]^T; the k-th block of the
    // lower triangle goes to group k % 4, each element updated in place by
    // its owner
    {
      int q = 0;
      for (int i = b + 1; i < nb; ++i)
        for (int j = b + 1; j <= i; ++j, ++q) {
          if (q % GROUPS != g) continue;
          T acc[8][8];
          acc_load(acc, blk(i, j), ty, tx);
          group_mma<T, true, false, true>(acc, blk(i, b), blk(j, b), ty, tx,
                                          BS);
          acc_store(acc, blk(i, j), ty, tx);
        }
      __syncthreads();
    }
    PROF_MARK(PH_SYRK);
  }

  // W = L^{-1}, column block j after column block j: the sums S[i][j] =
  // sum_{j<=k<i} L[i][k] W[k][j] are kept in the slots of L[i][j] and
  // grown right-looking, each as soon as W[k][j] is known: phase 2m of
  // column j adds L[i][k] W[k][j] (k = j + m, W[j][j] = Linv) to every
  // S[i][j], i > k, at once; phase 2m + 1 finishes W[k+1][j] =
  // -Linv[k+1][k+1] S[k+1][j].  Column j runs its phases in rounds 3j ..;
  // it reads L[i][k] in round 3j + 2(k - j), before column k, starting in
  // round 3k, overwrites it.  At N = 256 that is 8 rounds of one product
  // each, up to three blocks a round.
  {
    int rounds = 0;
    for (int j = 0; j + 1 < nb; ++j)
      rounds = max(rounds, 3 * j + 2 * (nb - 1 - j));
    for (int round = 0; round < rounds; ++round) {
      // this group's block of the round, if any
      int q = 0, type = -1, i = 0, j = 0, k = 0;
      for (int jj = 0; jj + 1 < nb; ++jj) {
        const int p = round - 3 * jj;
        if (p < 0 || p >= 2 * (nb - 1 - jj)) continue;
        const int kk = jj + p / 2;
        if (p % 2 == 0) {
          for (int ii = kk + 1; ii < nb; ++ii, ++q)
            if (q == g) {
              type = 0;
              i = ii;
              j = jj;
              k = kk;
            }
        } else {
          if (q == g) {
            type = 1;
            i = kk + 1;
            j = jj;
          }
          ++q;
        }
      }
      T acc[8][8];
      if (type == 0 && k == j) {
        zero8(acc);
        group_mma<T, true, true, false>(acc, blk(i, j), blk(j, j), ty, tx,
                                        BS);
      } else if (type == 0) {
        acc_load(acc, blk(i, j), ty, tx);
        group_mma<T, true, false, false>(acc, blk(i, k), blk(k, j), ty, tx,
                                         BS);
      } else if (type == 1) {
        zero8(acc);
        group_mma<T, true, false, true>(acc, blk(i, i), blk(i, j), ty, tx,
                                        k_low);
      }
      __syncthreads();
      if (type >= 0) acc_store(acc, blk(i, j), ty, tx);
      __syncthreads();
    }
  }
  PROF_MARK(PH_TRINV);

  // A^{-1}[i][j] = sum_{k >= i} W[k][i]^T W[k][j] to both halves; the
  // blocks, in order of falling cost, go to the groups back and forth
  {
    int q = 0;
    for (int i = 0; i < nb; ++i)
      for (int j = 0; j <= i; ++j, ++q) {
        const int round = q / GROUPS, pos = q % GROUPS;
        if ((round & 1 ? GROUPS - 1 - pos : pos) != g) continue;
        T acc[8][8];
        zero8(acc);
        if (j == i)
          group_mma<T, false, true, false>(acc, blk(i, i), blk(i, i), ty, tx,
                                           BS);
        else
          group_mma<T, false, false, false>(acc, blk(i, i), blk(i, j), ty,
                                            tx, BS);
        for (int k = i + 1; k < nb; ++k)
          group_mma<T, true, false, false>(acc, blk(k, i), blk(k, j), ty, tx,
                                           BS);
        acc_to_out(acc, out, n, i * BS, j * BS, ty, tx, vec != 0);
        if (i != j) acc_t_to_out(acc, out, n, i * BS, j * BS, ty, tx);
      }
  }
  if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
  PROF_MARK(PH_WTW);
  PROF_FLUSH();
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
  // the lower blocks, and the diagonal factorization's eight vectors
  const size_t smem =
      (static_cast<size_t>(nb * (nb + 1) / 2) * TILE + 8 * BS) * sizeof(T);
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(inv) % 16 == 0;
  blocked_chol_smem_kernel<T>
      <<<static_cast<unsigned int>(batch), THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<T*>(inv),
          static_cast<T*>(logdet), n, nb, vec);
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

#ifdef BLOCKED_CHOL_PROFILE
// The smem kernel's phase totals since the last reset: PH_COUNT cycle sums
// and the number of CTAs that added to them.
int blocked_chol_profile_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_phase_cycles, sizeof(unsigned long long) * (PH_COUNT + 1)));
}

int blocked_chol_profile_reset() {
  static const unsigned long long zeros[PH_COUNT + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros)));
}
#endif

const char* blocked_chol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
