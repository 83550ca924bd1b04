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
//     HBM staged into one VMEM scratch): one CTA a matrix, its blocks in a
//     device work buffer, streamed through shared memory.
//
// Both run the reference's _inverse_body with block size 64.  N is padded to
// Np, a multiple of 64, with an identity block (its inverse is I and its
// log-determinant 0).  Then, on the lower blocks:
//
//   for b:  factor A[b][b] = L L^T column by column (log|A| += log pivot)
//           and form its inverse Linv alongside; A[b][b] <- Linv
//           L[i][b] = A[i][b] Linv^T                 (i > b)
//           A[i][j] -= L[i][b] L[j][b]^T             (b < j <= i)
//   W = L^{-1}, column block by column block:
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
// global variant.  Where the blocks do not fit a CTA (N > 256 in float32,
// N > 192 in float64) they live in a work buffer in device memory, each
// 64 x 64 block contiguous in the swz order, and pass through shared memory
// (the first version staged every operand synchronously through four
// tiles, factored its diagonal blocks one column a barrier and ran 4 x 4
// register tiles: 5.04 ms at (256, 512, 512), 3.52 ms at (1024, 256, 256)
// on one H100 80GB HBM3, 700 W).  This design takes smem's diagonal
// factorization and products, and cuts the device traffic:
//   - a CTA holds as many tiles as its shared memory takes (14 in float32,
//     7 in float64): the diagonal block, panel slots, and a staging tile
//     per group; 1 CTA an SM;
//   - Cholesky, right-looking: the panel L[i][b]^T stays in the slots for
//     the whole trailing update (pairs of chunks of it where it does not
//     fit: N > 640 in float32, N > 192 in float64), so step b reads and
//     writes each tile it updates once; the first step reads a itself, so
//     there is no padded copy.  Each thread copies its own elements of its
//     group's next tile (cp.async) while the current product runs;
//   - W = L^{-1} left-looking, one block column per group down the column,
//     and W^T W, one output block per group: the groups run on their own
//     (named barriers), two staging tiles each, so one group's copies
//     overlap the others' products.
// Measured on one H100 80GB HBM3 (700 W), float32: 1.816 ms at
// (256, 512, 512) against the 0.513 ms operations bound (the first version
// 5.045 in the same run), 1.618 ms at (1024, 256, 256) (first 3.533, smem
// 1.542); of a CTA's 1.77M cycles at (256, 512, 512) the diagonal blocks
// take 11%, the panel 9%, the trailing update 22%, the triangular inverse
// 28%, W^T W 30%: a product round of four groups takes 14-17k cycles
// whether its operands stream (W, W^T W) or sit in the slots (the
// trailing update), so the products' issue, not the device traffic, now
// sets the pace (PERF.md, section 6).
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

// Phase profile of either kernel, built only with -DBLOCKED_CHOL_PROFILE
// (scamlgp_tpu_torch/profile_kernels.py phases): after a CTA-wide barrier at
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

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }
__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// Element (R, C) of the n x n matrix a padded with the identity past n.
template <typename T>
__device__ __forceinline__ T padded(const T* a, int n, int R, int C) {
  return (R < n && C < n) ? a[static_cast<size_t>(R) * n + C]
                          : (R == C ? T(1) : T(0));
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
// of X; one barrier for two steps.  Each element gets the plain version's
// rank-1 downdate, with its rsqrt for 1 / sqrt(d).
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
// global variant: one matrix per CTA, its blocks in device memory.
// ---------------------------------------------------------------------------

// The group's 64 threads wait for each other (named barrier 1 + g; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(g + 1) : "memory");
}

// One tile of the work buffer (contiguous, in swz order) to dst, 16 bytes a
// copy, copies t, t + nt, ... of it.
template <typename T>
__device__ __forceinline__ void tile_copy_async(T* dst, const T* src, int t,
                                                int nt) {
  constexpr int kChunks = TILE * static_cast<int>(sizeof(T)) / 16;
  for (int q = t; q < kChunks; q += nt)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * q,
               reinterpret_cast<const char*>(src) + 16 * q);
}

// Elements (r, c .. c + 3) of tile (i, j) of the n x n row-major a, padded
// with the identity, to their swz place in dst: one or two 16-byte copies
// where vec and the chunk lies inside a, else plain loads.
template <typename T>
__device__ __forceinline__ void chunk_from_a(T* dst, const T* a, int n,
                                             int vec, int i, int j, int r,
                                             int c) {
  const int R = i * BS + r, C = j * BS + c;
  T* d = dst + swz(r, c);
  if (vec && R < n && C < n) {
    const T* src = a + static_cast<size_t>(R) * n + C;
#pragma unroll
    for (int h = 0; h < static_cast<int>(sizeof(T)) / 4; ++h)
      cp_async16(d + h * (16 / sizeof(T)), src + h * (16 / sizeof(T)));
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) d[u] = padded(a, n, R, C + u);
  }
}

// Tile (i, j) of a, chunks t, t + nt, ...
template <typename T>
__device__ __forceinline__ void tile_from_a_async(T* dst, const T* a, int n,
                                                  int vec, int i, int j,
                                                  int t, int nt) {
  for (int q = t; q < TILE / 4; q += nt)
    chunk_from_a(dst, a, n, vec, i, j, q >> 4, (q & 15) << 2);
}

// The 16 chunks of a tile that acc_load reads for thread (ty, tx): from a
// work tile, or from tile (i, j) of a.
template <typename T>
__device__ __forceinline__ void own_copy_async(T* dst, const T* src, int ty,
                                               int tx) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = swz(own(ty, e), 32 * h + 4 * tx);
#pragma unroll
      for (int w = 0; w < static_cast<int>(sizeof(T)) / 4; ++w)
        cp_async16(dst + o + w * (16 / sizeof(T)),
                   src + o + w * (16 / sizeof(T)));
    }
}

template <typename T>
__device__ __forceinline__ void own_from_a_async(T* dst, const T* a, int n,
                                                 int vec, int i, int j,
                                                 int ty, int tx) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      chunk_from_a(dst, a, n, vec, i, j, own(ty, e), 32 * h + 4 * tx);
}

// The work buffer of a matrix: nb^2 tiles of 64 x 64, each in swz order;
// the lower blocks L(i, j) first, then the strictly lower blocks of W.
__device__ __forceinline__ int lower_tile(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// Picks, for each of cnt items of falling cost, the least loaded of ng
// groups (the first on a tie); returns the item's group.  Every thread
// runs it alike, so no group needs to tell another.
struct Balance {
  int load[GROUPS] = {};
  __device__ int take(int cost, int ng) {
    int best = 0;
    for (int q = 1; q < ng; ++q)
      if (load[q] < load[best]) best = q;
    load[best] += cost;
    return best;
  }
};

// work: (B, np, np) elements, np = 64 nb, laid out as nb^2 tiles (see
// lower_tile); out: (B, n, n).  Shared memory holds `tiles` 64 x 64 tiles:
// the diagonal block, `tiles - 5` panel slots, then one staging tile per
// group (the diagonal factorization's vectors share the last one).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    blocked_chol_global_kernel(const T* __restrict__ a, T* __restrict__ work,
                               T* __restrict__ out, T* __restrict__ logdet,
                               int n, int nb, int tiles, int vec) {
  extern __shared__ __align__(16) unsigned char smem_tiles[];
  T* const S = reinterpret_cast<T*>(smem_tiles);
  T* const D = S;
  T* const P = S + TILE;
  const int cap = tiles - 5;  // panel slots
  T* const stage = S + static_cast<size_t>(1 + cap) * TILE;
  T* const vecs = stage + 3 * TILE;
  const T* A = a + static_cast<size_t>(blockIdx.x) * n * n;
  T* G = work + static_cast<size_t>(blockIdx.x) * nb * nb * TILE;
  T* O = out + static_cast<size_t>(blockIdx.x) * n * n;
  const int tid = threadIdx.x;
  const int g = tid >> 6, gt = tid & 63;
  const int ty = gt >> 3, tx = gt & 7;
  const int k_low = (tid & 32) ? BS : 48;
  T* const mine = stage + g * TILE;
  auto L = [&](int i, int j) { return G + lower_tile(i, j) * TILE; };
  auto W = [&](int i, int j) {
    return G + (nb * (nb + 1) / 2 + i * (i - 1) / 2 + j) * TILE;
  };
  PROF_DECL
  PROF_MARK(PH_LOAD);

  // Right-looking blocked Cholesky.  Step b reads each tile it updates
  // once from the work buffer (from a at b = 0) and writes it once.
  T ld = T(0);
  for (int b = 0; b < nb; ++b) {
    const int m = nb - 1 - b;  // panel tiles
    if (b == 0)
      tile_from_a_async(D, A, n, vec, 0, 0, tid, THREADS);
    else
      tile_copy_async(D, L(b, b), tid, THREADS);
    cp_async_wait_all();
    __syncthreads();
    ld += chol_inv_regs(D, vecs);
    __syncthreads();
    for (int q = tid; q < TILE * static_cast<int>(sizeof(T)) / 16;
         q += THREADS)
      reinterpret_cast<int4*>(L(b, b))[q] = reinterpret_cast<const int4*>(D)[q];
    PROF_MARK(PH_DIAG);

    // panel L[i][b]^T = Linv A[i][b]^T, tile p = i - b - 1 by group p % 4:
    // in slot p where the panel fits the slots, else in the group's
    // staging tile; to the work buffer either way
    const bool resident = m <= cap;
    if (resident) {
      for (int p = g; p < m; p += GROUPS) {
        if (b == 0)
          tile_from_a_async(P + p * TILE, A, n, vec, b + 1 + p, b, gt, 64);
        else
          tile_copy_async(P + p * TILE, L(b + 1 + p, b), gt, 64);
      }
      cp_async_wait_all();
      group_sync(g);
    }
    for (int p = g; p < m; p += GROUPS) {
      const int i = b + 1 + p;
      T* X = resident ? P + p * TILE : mine;
      if (!resident) {
        if (b == 0)
          tile_from_a_async(X, A, n, vec, i, b, gt, 64);
        else
          tile_copy_async(X, L(i, b), gt, 64);
        cp_async_wait_all();
        group_sync(g);
      }
      T acc[8][8];
      zero8(acc);
      group_mma<T, true, true, false>(acc, D, X, ty, tx, k_low);
      group_sync(g);
      if (resident) acc_store(acc, X, ty, tx);
      acc_store(acc, L(i, b), ty, tx);
    }
    __syncthreads();
    PROF_MARK(PH_TRSM);

    // trailing update A[i][j] -= L[i][b] L[j][b]^T, b < j <= i, with both
    // panel tiles on chip: all of the panel where it fits the slots, else
    // pairs of chunks of h tiles, (ci, cj) in slots [0, h) and [h, 2h).
    // The updated tiles go to the groups in turn; each thread copies its
    // own elements of a group's next tile into the group's staging tile
    // while the current one's product runs.
    const int h = resident ? max(m, 1) : cap / 2;
    const int nc = (m + h - 1) / h;
    for (int ci = 0; ci < nc; ++ci)
      for (int cj = 0; cj <= ci; ++cj) {
        if (!resident) {
          __syncthreads();
          for (int p = ci * h; p < min(m, ci * h + h); ++p)
            tile_copy_async(P + (p - ci * h) * TILE, L(b + 1 + p, b), tid,
                            THREADS);
          if (cj != ci)
            for (int p = cj * h; p < min(m, cj * h + h); ++p)
              tile_copy_async(P + (h + p - cj * h) * TILE, L(b + 1 + p, b),
                              tid, THREADS);
          cp_async_wait_all();
          __syncthreads();
        }
        auto slot = [&](int p) {
          return P + ((p / h == ci ? 0 : h) + p % h) * TILE;
        };
        auto fetch = [&](int pi, int pj) {
          if (b == 0)
            own_from_a_async(mine, A, n, vec, b + 1 + pi, b + 1 + pj, ty, tx);
          else
            own_copy_async(mine, L(b + 1 + pi, b + 1 + pj), ty, tx);
        };
        int cur_i = -1, cur_j = -1, q = 0;
        auto update = [&](bool more, int ni, int nj) {
          T acc[8][8];
          cp_async_wait_all();
          acc_load(acc, mine, ty, tx);
          if (more) fetch(ni, nj);
          group_mma<T, true, false, true>(acc, slot(cur_i), slot(cur_j), ty,
                                          tx, BS);
          acc_store(acc, L(b + 1 + cur_i, b + 1 + cur_j), ty, tx);
        };
        for (int pi = ci * h; pi < min(m, ci * h + h); ++pi)
          for (int pj = cj * h; pj <= min(pi, cj * h + h - 1); ++pj, ++q) {
            if (q % GROUPS != g) continue;
            if (cur_i < 0)
              fetch(pi, pj);
            else
              update(true, pi, pj);
            cur_i = pi;
            cur_j = pj;
          }
        if (cur_i >= 0) update(false, 0, 0);
      }
    __syncthreads();
    PROF_MARK(PH_SYRK);
  }

  // W = L^{-1}: W[i][j] = -Linv_i sum_{j<=k<i} L[i][k] W[k][j] (W[j][j] =
  // Linv_j), column j by one group, down the column, the columns dealt
  // out by cost.  The work buffer holds L[i][k]^T, Linv_i^T, and W[i][j]
  // in its own tiles.  Groups run on their own (named barriers), two
  // staging tiles each; ng groups fit the shared memory.
  const int ng = min(GROUPS, tiles / 2);
  T* const X = S + (2 * g) * TILE;
  T* const Y = X + TILE;
  {
    Balance bal;
    for (int j = 0; j < nb; ++j) {
      const int mj = nb - 1 - j;
      if (bal.take(mj * (mj + 3) / 2, ng) != g || g >= ng) continue;
      for (int i = j + 1; i < nb; ++i) {
        T acc[8][8];
        zero8(acc);
        for (int k = j; k < i; ++k) {
          group_sync(g);
          tile_copy_async(X, L(i, k), gt, 64);
          tile_copy_async(Y, k == j ? L(j, j) : W(k, j), gt, 64);
          cp_async_wait_all();
          group_sync(g);
          if (k == j)
            group_mma<T, true, true, false>(acc, X, Y, ty, tx, BS);
          else
            group_mma<T, true, false, false>(acc, X, Y, ty, tx, BS);
        }
        group_sync(g);
        tile_copy_async(X, L(i, i), gt, 64);
        acc_store(acc, Y, ty, tx);
        cp_async_wait_all();
        group_sync(g);
        zero8(acc);
        group_mma<T, true, false, true>(acc, X, Y, ty, tx, k_low);
        acc_store(acc, W(i, j), ty, tx);
      }
    }
  }
  __syncthreads();
  PROF_MARK(PH_TRINV);

  // A^{-1}[i][j] = sum_{k >= i} W[k][i]^T W[k][j] to both halves, the
  // blocks dealt out by cost (nb - i products)
  {
    Balance bal;
    for (int i = 0; i < nb; ++i)
      for (int j = 0; j <= i; ++j) {
        if (bal.take(nb - i, ng) != g || g >= ng) continue;
        T acc[8][8];
        zero8(acc);
        for (int k = i; k < nb; ++k) {
          group_sync(g);
          const T* left = k == i ? L(i, i) : W(k, i);
          tile_copy_async(X, left, gt, 64);
          if (j != i) tile_copy_async(Y, k == i ? W(i, j) : W(k, j), gt, 64);
          cp_async_wait_all();
          group_sync(g);
          if (k == i && j == i)
            group_mma<T, false, true, false>(acc, X, X, ty, tx, BS);
          else if (k == i)
            group_mma<T, false, false, false>(acc, X, Y, ty, tx, BS);
          else
            group_mma<T, true, false, false>(acc, X, j == i ? X : Y, ty, tx,
                                             BS);
        }
        acc_to_out(acc, O, n, i * BS, j * BS, ty, tx, vec != 0);
        if (i != j) acc_t_to_out(acc, O, n, i * BS, j * BS, ty, tx);
      }
  }
  if (tid == 0) logdet[blockIdx.x] = ld;
  PROF_MARK(PH_WTW);
  PROF_FLUSH();
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

// work: (batch, np, np) elements, np = 64 ceil(n / 64), apart from a and
// inv.  The kernel takes all the shared memory a CTA may have: as many
// 64 x 64 tiles as fit, at least seven.
template <typename T>
int launch_global(const void* a, void* work, void* inv, void* logdet,
                  long long batch, int n, void* stream) {
  static bool done[64] = {};
  if (batch <= 0) return 0;
  cudaError_t err = allow_max_smem(blocked_chol_global_kernel<T>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = optin / static_cast<int>(TILE * sizeof(T));
  if (tiles < 7) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + BS - 1) / BS;
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(inv) % 16 == 0;
  blocked_chol_global_kernel<T>
      <<<static_cast<unsigned int>(batch), THREADS,
         static_cast<size_t>(tiles) * TILE * sizeof(T),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<T*>(work),
          static_cast<T*>(inv), static_cast<T*>(logdet), n, nb, tiles, vec);
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
// The phase totals since the last reset: PH_COUNT cycle sums
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
