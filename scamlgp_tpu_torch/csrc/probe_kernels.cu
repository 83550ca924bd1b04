// Loop-shape probes of the sweep kernel, for Hopper: a Cholesky factor and
// the traversal floor, float32, N <= 128.
//
// Replace the Pallas TPU kernels
//   scripts/bench_chol_fused_probe.py::_chol_kernel  (rank1_cholesky) and
//   scripts/bench_vpu_ceiling.py::_floor_kernel      (traversal_floor).
// Both are probes: no path of the model runs them.  The first versions kept
// the select sweep kernel's layout (a barrier a step; now
// baseline_kernels.cu, timed beside these).  These are designed for the
// card, so that the factor says whether a Cholesky-based inverse could
// replace select at N <= 128, and the floor is the card's own floor of an
// N-step pass over the block.
//
// rank1_cholesky: the lower Cholesky factor L of each SPD matrix, its strict
// upper triangle zero.  Only the lower triangle of A is read (the 16-byte
// granules at or below the diagonal); no pivoting, so a non-positive pivot
// gives NaN.  Bound on an H100 (profile_kernels.py::probe_bound): a read of
// the lower triangle and a write of the whole of L, 4 (N (N + 1) / 2 + N^2)
// bytes a matrix, 0.1205 ms at (4096, 128, 128); the N^3 / 6 multiply-adds
// of a factor take 0.021 ms at the float32 peak.  Bytes bound the work, but the factor's N pivots are a
// serial chain, so the design keeps many chains in flight beside the
// copies and takes as little else as it can onto the chain:
//
//   - N <= 32, the warp path: CAP (8, 16 or 32) lanes own one matrix, lane
//     j row j of its lower triangle in CAP registers, 128 / CAP matrices a
//     CTA of 128 threads, staged through shared memory so that the copies
//     are coalesced; no barrier in the steps (factor_rows below).
//   - 32 < N <= 128, the blocked path: one matrix a CTA of 6 warps, held in
//     dynamic shared memory as its lower 32 x 32 tiles only (rows 9 16-byte
//     granules apart, an odd count, so that eight consecutive rows fall in
//     eight bank groups; 46.6 KB at N = 128, four CTAs an SM, so that one
//     CTA's serial diagonal steps overlap the others' updates and copies).
//     It is loaded with 16-byte cp.async (4-byte where N % 4 != 0), the
//     padding zeroed.  Then a panel of 32 columns at a time:
//       (a) warp 0 factors the 32 x 32 diagonal tile in registers, lane j
//           row j (factor_rows), and writes L11 and, into the tile's upper
//           triangle, U = L11^T, with the pivots' s = rsqrt(d);
//       (b) each row below is solved against it, a thread a row in
//           registers: x_j = a_j s_j, then a_m -= x_j L11[m][j] for m > j
//           (U's row j, a broadcast): the rank-1 recurrence's order;
//       (c) the trailing block's lower tiles take A22 -= L21 L21^T, a warp
//           a tile, each lane 8 x 4 outputs (rows li + 4a, columns lj + 8b),
//           fed from shared memory by 16-byte reads, the panel's 32 columns
//           in order.
//     Warp 0 carries the chain: it solves the first 32 rows below, signals
//     them on a named barrier, updates the next diagonal tile with them and
//     factors it at once, while warps 1 to 5 solve the other rows, update
//     the other tiles and store the panel's columns of L (coalesced, from
//     shared memory; the zeros above the diagonal tiles when they have no
//     rows to solve).  One CTA barrier and one named barrier a panel, not one a
//     step; about N^3 / 6 multiply-adds in place of the rank-1 kernel's
//     masked 2 N^3.  A ragged last panel (N % 32 != 0) runs only its w < 32
//     steps; the zero padding keeps every other value finite.
//
//   Step k of the factor (factor_rows): d = A[k][k], s = rsqrt(d);
//   L[j][k] = A[j][k] s (L[k][k] = d s); A[j][i] -= L[j][k] L[i][k] for
//   i > k as one rounding (__fmaf_rn).  The blocked path applies the same
//   products to every element in the same order of k, only the trailing
//   block's 32 at a time: ops/probes.py::blocked_cholesky_mirror is that
//   recurrence in plain PyTorch.  FFMA, not tensor cores: TF32 keeps about
//   three digits.
//
// traversal_floor, step k: A = fma(A, 0.9999999f, float(k) * 1e-12f) over
// every element (each literal rounded to float32, as the TPU kernel's
// weakly typed ones; one rounding a step), N steps.  Its bound: the 2 N^3
// operations a matrix, N^3 FMAs, 0.256 ms at (4096, 128, 128) at 67
// TFLOP/s; its bytes take 0.160 ms.  No value crosses threads, so there is
// no barrier: each thread owns FLOOR_RUNS float4 runs of the flat B N^2
// elements (32 independent chains; scalars where a pointer is not 16-byte
// aligned), loaded once and stored once, and enough CTAs are resident that
// one warp's copies overlap the others' chains.  The step's addend is read
// from a table in shared memory, four steps a 16-byte read, so that the
// loop issues little besides the FMAs; a step-dependent addend and the
// single rounding keep the N steps from being folded.  It equals the FMA
// recurrence (ops/probes.py::traversal_floor_fma_reference) bit for bit.
//
// Multiply-adds are fused only where written (__fmaf_rn); the source is
// built without -fmad=false.
//
// Built with -DPROBE_PROFILE, every warp of the blocked path stamps
// clock64() at the end of each phase (load, diagonal tile, panel solve,
// trailing update, the waits at its barriers, store), summed into
// g_probe_phase_cycles (profile_kernels.py phases --variant rank1_cholesky).
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, 0 on success; probe_geometry reports a launch's
// geometry (ops/probes.py::launch_geometry).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_N = 128;
constexpr int WARP = 32;
constexpr int WARP_PATH_THREADS = 128;
constexpr int PANEL = 32;
constexpr int CHOL_THREADS = 192;
constexpr int CHOL_WARPS = CHOL_THREADS / WARP;
constexpr int CHOL_CTAS_PER_SM = 4;
constexpr int FLOOR_THREADS = 256;
constexpr int FLOOR_RUNS = 8;
constexpr float FLOOR_SCALE = 0.9999999f;
constexpr float FLOOR_STEP = 1e-12f;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// Phase stamps of the blocked path (-DPROBE_PROFILE)
// ---------------------------------------------------------------------------

enum ProbePhase {
  PP_LOAD, PP_DIAG, PP_SOLVE, PP_UPDATE, PP_BARRIER, PP_STORE, PP_COUNT
};
#ifdef PROBE_PROFILE
__device__ unsigned long long g_probe_phase_cycles[PP_COUNT + 1];
#define PPROF_DECL                  \
  long long pp_last = clock64();    \
  long long pp_acc[PP_COUNT] = {};
#define PPROF_MARK(ph)                 \
  do {                                 \
    const long long now_ = clock64();  \
    pp_acc[ph] += now_ - pp_last;      \
    pp_last = now_;                    \
  } while (0)
// a barrier that ends phase ph, its wait counted in PP_BARRIER: the stamp
// feeds the barrier's predicate, so that it is read before the wait
#define PPROF_SYNC(ph)                         \
  do {                                         \
    const long long at_ = clock64();           \
    pp_acc[ph] += at_ - pp_last;               \
    __syncthreads_or(at_ == 0);                \
    pp_last = clock64();                       \
    pp_acc[PP_BARRIER] += pp_last - at_;       \
  } while (0)
#define PPROF_FLUSH()                                                   \
  do {                                                                  \
    if ((threadIdx.x & 31) == 0) {                                      \
      for (int p_ = 0; p_ < PP_COUNT; ++p_)                             \
        atomicAdd(&g_probe_phase_cycles[p_],                            \
                  static_cast<unsigned long long>(pp_acc[p_]));         \
      atomicAdd(&g_probe_phase_cycles[PP_COUNT], 1ull);                 \
    }                                                                   \
  } while (0)
#else
#define PPROF_DECL
#define PPROF_MARK(ph) \
  do {                 \
  } while (0)
#define PPROF_SYNC(ph) __syncthreads()
#define PPROF_FLUSH() \
  do {                \
  } while (0)
#endif

// ---------------------------------------------------------------------------
// Copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The factor
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ld4(float* dst, const float* src) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  dst[0] = t.x;
  dst[1] = t.y;
  dst[2] = t.z;
  dst[3] = t.w;
}
__device__ __forceinline__ void st4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// Factors the w x w lower triangle that a group of CAP lanes holds, lane j
// row j (v[i] = A[j][i] for i <= j; what lies above the diagonal is never
// read and ends as garbage).  Leaves L's row j in v and returns, on lane j,
// s_j = rsqrt of the j-th pivot (0 on lanes j >= w).  Step k's column of L
// reaches the group through cb0 / cb1 (CAP floats each, by turns): a store
// a lane, then 16-byte broadcast reads, in place of a shuffle an element.
// Only what the next step needs at once is shuffled, as soon as c is
// known: lane k + 1's c (for column k + 1) and its own update of its
// diagonal, A[k+1][k+1] - c c (the next pivot), so that one shuffle lies
// on the chain from one step to the next.  Every lane of the warp takes
// part.
template <int CAP>
__device__ __forceinline__ float factor_rows(float (&v)[CAP], int w,
                                             float* cb0, float* cb1) {
  const int j = threadIdx.x & (CAP - 1);
  float s_j = 0.0f;
  float d = __shfl_sync(FULL_MASK, v[0], 0, CAP);
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < w) {
      const float s = rsqrtf(d);
      if (j == k) s_j = s;
      const float c = __fmul_rn(v[k], s);  // L[j][k]
      v[k] = c;
      if (k + 1 < CAP) {
        float* cb = (k & 1) ? cb1 : cb0;
        cb[j] = c;
        // the next column's update and the next pivot, both from lane k + 1
        const float c1 = __shfl_sync(FULL_MASK, c, k + 1, CAP);
        d = __shfl_sync(FULL_MASK, __fmaf_rn(-c, c, v[k + 1]), k + 1, CAP);
        v[k + 1] = __fmaf_rn(-c, c1, v[k + 1]);
        __syncwarp();
#pragma unroll
        for (int q = (k + 2) / 4; q < CAP / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(cb + 4 * q);
          const float ci[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e > k + 1)
              v[4 * q + e] = __fmaf_rn(-c, ci[e], v[4 * q + e]);
        }
      }
    }
  }
  return s_j;
}

// N <= 32: CAP lanes a matrix, lane j row j.  Where vec (N % 4 == 0 and
// 16-byte aligned pointers) each lane reads and writes its own row in
// 16-byte runs; otherwise each warp stages its own 32 / CAP matrices, which
// lie one after another, through shared memory (rows CAP + 1 apart), so
// that the copies are coalesced.  No warp waits for another.
template <int CAP>
__global__ void __launch_bounds__(WARP_PATH_THREADS)
    chol_warp_kernel(const float* __restrict__ a, float* __restrict__ l,
                     long long batch, int n, bool vec) {
  constexpr int MW = WARP / CAP;
  constexpr int S = CAP + 1;
  __shared__ float st[WARP_PATH_THREADS / CAP * CAP * S];
  __shared__ __align__(16) float cbuf[2][WARP_PATH_THREADS];
  const int lane = threadIdx.x & (WARP - 1), j = lane & (CAP - 1);
  const int warp = threadIdx.x / WARP, g = lane / CAP;
  const long long m0 =
      (static_cast<long long>(blockIdx.x) * WARP_PATH_THREADS +
       warp * WARP) / CAP;
  if (m0 >= batch) return;  // the whole warp
  const int count = static_cast<int>(min(static_cast<long long>(MW),
                                         batch - m0));
  const int nn = n * n;
  const size_t base = static_cast<size_t>(m0) * nn;
  // every lane takes part in the steps; only live lanes read and write
  const bool live = g < count && j < n;
  float v[CAP];
  float* row = st + (warp * MW * CAP + g * CAP + j) * S;
  if (vec) {
    const float* src = a + base + static_cast<size_t>(g * n + j) * n;
#pragma unroll
    for (int q = 0; q < CAP / 4; ++q) {
      if (live && 4 * q <= j) {
        ld4(v + 4 * q, src + 4 * q);
      } else {
        v[4 * q] = v[4 * q + 1] = v[4 * q + 2] = v[4 * q + 3] = 0.0f;
      }
    }
  } else {
    float* wst = st + warp * MW * CAP * S;
    for (int idx = lane; idx < count * nn; idx += WARP) {
      const int mm = idx / nn, rem = idx - mm * nn, r = rem / n;
      wst[(mm * CAP + r) * S + rem - r * n] = __ldg(a + base + idx);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < CAP; ++i) v[i] = (live && i <= j) ? row[i] : 0.0f;
  }
  const int group = threadIdx.x - j;
  factor_rows<CAP>(v, n, cbuf[0] + group, cbuf[1] + group);
  if (vec) {
    if (live) {
      float* dst = l + base + static_cast<size_t>(g * n + j) * n;
#pragma unroll
      for (int q = 0; q < CAP / 4; ++q) {
        if (4 * q < n) {
          float t[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) t[e] = 4 * q + e <= j ? v[4 * q + e] : 0.0f;
          __stcs(reinterpret_cast<float4*>(dst + 4 * q),
                 make_float4(t[0], t[1], t[2], t[3]));
        }
      }
    }
  } else {
    if (live) {
#pragma unroll
      for (int i = 0; i < CAP; ++i)
        if (i < n) row[i] = i <= j ? v[i] : 0.0f;
    }
    __syncwarp();
    const float* wst = st + warp * MW * CAP * S;
    for (int idx = lane; idx < count * nn; idx += WARP) {
      const int mm = idx / nn, rem = idx - mm * nn, r = rem / n;
      l[base + idx] = wst[(mm * CAP + r) * S + rem - r * n];
    }
  }
}

// The blocked path's shared memory: the lower triangle's 32 x 32 tiles,
// tile (ti, tj), tj <= ti, at ti (ti + 1) / 2 + tj, each row LDT floats
// (9 16-byte granules, an odd count, so that eight consecutive rows' granules
// fall in eight bank groups); then the pivots' s, two panels' worth, and the
// factor's two column buffers.  A diagonal tile's upper triangle, which L
// does not use, holds U = L11^T for the panel solve.
constexpr int LDT = PANEL + 4;
constexpr int TILE = PANEL * LDT;

struct CholLayout {
  int np, tiles, bytes;
};

__host__ __device__ inline CholLayout chol_layout(int n) {
  const int np = (n + PANEL - 1) / PANEL * PANEL;
  const int tiles = (np / PANEL) * (np / PANEL + 1) / 2;
  return {np, tiles,
          static_cast<int>((tiles * TILE + 4 * PANEL) * sizeof(float))};
}

// Element (r, c) of the lower tiles, c / 32 <= r / 32.
__device__ __forceinline__ float* at(float* sm, int r, int c) {
  const int ti = r / PANEL, tj = c / PANEL;
  return sm + (ti * (ti + 1) / 2 + tj) * TILE + (r % PANEL) * LDT +
         c % PANEL;
}

// Named barrier 1 of the blocked path: warp 0 arrives when its rows of the
// panel solve are in shared memory; the other warps wait for it and for
// each other.
__device__ __forceinline__ void panel_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"r"(CHOL_THREADS) : "memory");
}
__device__ __forceinline__ void panel_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(CHOL_THREADS) : "memory");
}

// A warp's copies of row r at or below the diagonal: its 16-byte granules
// 0 .. r / 4 (vec), or its elements 0 .. r.
__device__ __forceinline__ void load_row_lower(float* sm, const float* src,
                                               int r, bool vec, int lane) {
  if (vec) {
    for (int g = lane; g <= r / 4; g += WARP)
      cp_async16(at(sm, r, 4 * g), src + 4 * g);
  } else {
    for (int c = lane; c <= r; c += WARP) cp_async4(at(sm, r, c), src + c);
  }
}

// (a) A warp factors diagonal tile p (its first w rows real, the rest
// padding), lane j row j, and writes back L11 and, above the diagonal, U.
__device__ __noinline__ void diagonal_block(float* sm, float* rs,
                                               float* cb, int p, int w,
                                               int lane) {
  float* tile = sm + (p * (p + 1) / 2 + p) * TILE;
  float* row = tile + lane * LDT;
  float v[PANEL];
#pragma unroll
  for (int q = 0; q < PANEL / 4; ++q) ld4(v + 4 * q, row + 4 * q);
  rs[lane] = factor_rows<PANEL>(v, w, cb, cb + PANEL);
#pragma unroll
  for (int q = 0; q < PANEL / 4; ++q) st4(row + 4 * q, v + 4 * q);
  __syncwarp();
  // U[i][j] = L11[j][i] for i < j, at (i, j)
#pragma unroll
  for (int i = 0; i < PANEL; ++i)
    if (i < lane) tile[i * LDT + lane] = v[i];
}

// (b) One row below diagonal tile p solved against it in place: x_j = a_j
// s_j, then a_m -= x_j L11[m][j] for m > j (U's row j).
__device__ __noinline__ void solve_row(float* row, const float* tile,
                                          const float* rs) {
  float x[PANEL];
#pragma unroll
  for (int q = 0; q < PANEL / 4; ++q) ld4(x + 4 * q, row + 4 * q);
#pragma unroll
  for (int j = 0; j < PANEL; ++j) {
    const float xj = __fmul_rn(x[j], rs[j]);
    x[j] = xj;
#pragma unroll
    for (int q = (j + 1) / 4; q < PANEL / 4; ++q) {
      float u[4];
      ld4(u, tile + j * LDT + 4 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e > j) x[4 * q + e] = __fmaf_rn(-xj, u[e], x[4 * q + e]);
    }
  }
#pragma unroll
  for (int q = 0; q < PANEL / 4; ++q) st4(row + 4 * q, x + 4 * q);
}

// (c) A warp's tile (ti, tj) of the trailing block loses L21 L21^T over
// panel p's 32 columns, in their order: lane (li, lj) = (lane / 8, lane % 8)
// owns rows li + 4 a (a < 8) and columns lj + 8 b (b < 4) of the tile.
__device__ __noinline__ void update_tile(float* sm, int p, int ti, int tj,
                                            int lane) {
  const int li = lane / 8, lj = lane % 8;
  float* out = sm + (ti * (ti + 1) / 2 + tj) * TILE + li * LDT + lj;
  const float* irow = sm + (ti * (ti + 1) / 2 + p) * TILE + li * LDT;
  const float* jrow = sm + (tj * (tj + 1) / 2 + p) * TILE + lj * LDT;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = out[4 * r * LDT + 8 * c];
#pragma unroll 1
  for (int g = 0; g < PANEL / 4; ++g) {
    float jv[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) ld4(jv[c], jrow + 8 * c * LDT + 4 * g);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float iv[4];
      ld4(iv, irow + 4 * r * LDT + 4 * g);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = __fmaf_rn(-iv[e], jv[c][e], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[4 * r * LDT + 8 * c] = acc[r][c];
}

// Panel p's columns of L (fewer at the edge), rows 32 p .. n - 1, from
// shared memory, by warps w, w + nw, ... (w counted from the first warp
// that takes part): zeros above the diagonal; where vec, a warp stores 4
// rows' 16-byte granules an instruction (lane / 8 the row, lane % 8 the
// granule), coalesced, streamed past the caches.
__device__ __forceinline__ void store_block(float* sm, float* O, int n,
                                            int p, bool vec, int w, int nw,
                                            int lane) {
  const int c0 = p * PANEL, width = min(PANEL, n - c0);
  if (vec) {
    const int c = c0 + 4 * (lane % 8);
    for (int r = c0 + 4 * w + lane / 8; r < n; r += 4 * nw) {
      if (c < c0 + width) {
        float v[4];
        ld4(v, at(sm, r, c));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e > r) v[e] = 0.0f;
        __stcs(reinterpret_cast<float4*>(O + static_cast<size_t>(r) * n + c),
               make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  } else {
    for (int r = c0 + w; r < n; r += nw)
      for (int c = c0 + lane; c < c0 + width; c += WARP)
        O[static_cast<size_t>(r) * n + c] = c <= r ? *at(sm, r, c) : 0.0f;
  }
}

// L's zeros past the diagonal tiles (row r, columns from the next panel
// boundary to n - 1), by warps w, w + nw, ..., a row a warp.
__device__ __forceinline__ void store_upper_zeros(float* O, int n, bool vec,
                                                  int w, int nw, int lane) {
  for (int r = w; r < n; r += nw) {
    float* dst = O + static_cast<size_t>(r) * n;
    const int c0 = (r / PANEL + 1) * PANEL;
    if (vec) {
      for (int c = c0 + 4 * lane; c < n; c += 4 * WARP)
        __stcs(reinterpret_cast<float4*>(dst + c),
               make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    } else {
      for (int c = c0 + lane; c < n; c += WARP) dst[c] = 0.0f;
    }
  }
}

// 32 < N <= 128: one matrix a CTA of 6 warps, a panel of 32 columns at a
// time.  Warp 0 carries the serial chain: at each panel it solves the
// first 32 rows below the diagonal tile, signals them (panel_arrive),
// updates the next diagonal tile with them and factors it, while warps 1
// to 5 solve the other rows, wait for warp 0's, update the other tiles and
// store the panel's columns of L.  vec: N % 4 == 0 and both pointers
// 16-byte aligned.
__global__ void __launch_bounds__(CHOL_THREADS, CHOL_CTAS_PER_SM)
    chol_blocked_kernel(const float* __restrict__ a, float* __restrict__ l,
                        int n, bool vec) {
  extern __shared__ __align__(16) float sm[];
  const CholLayout lay = chol_layout(n);
  const int np = lay.np, panels = np / PANEL;
  float* rs = sm + lay.tiles * TILE;  // 2 x PANEL, by turns
  float* cb = rs + 2 * PANEL;         // 2 x PANEL
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const float* A = a + base;
  float* O = l + base;
  PPROF_DECL

  // load the lower triangle: warp 0 the first diagonal tile, which it
  // factors at once; the other warps the rows below, and zeros in the
  // padding rows
  if (warp == 0) {
#pragma unroll 1
    for (int r = 0; r < PANEL; ++r)
      load_row_lower(sm, A + static_cast<size_t>(r) * n, r, vec, lane);
  } else {
    for (int r = PANEL + warp - 1; r < n; r += CHOL_WARPS - 1)
      load_row_lower(sm, A + static_cast<size_t>(r) * n, r, vec, lane);
    for (int idx = tid - WARP; idx < (np - n) * np;
         idx += CHOL_THREADS - WARP) {
      const int r = n + idx / np, c = idx % np;
      if (c <= r) *at(sm, r, c) = 0.0f;
    }
  }
  cp_async_wait_all();
  PPROF_MARK(PP_LOAD);
  if (warp == 0) {
    __syncwarp();
    diagonal_block(sm, rs, cb, 0, PANEL, lane);
    PPROF_MARK(PP_DIAG);
  }
  PPROF_SYNC(PP_LOAD);

  for (int p = 0; p + 1 < panels; ++p) {
    const int c0 = p * PANEL;
    const float* diag = sm + (p * (p + 1) / 2 + p) * TILE;
    const float* s = rs + (p & 1) * PANEL;
    if (warp == 0) {
      solve_row(at(sm, c0 + PANEL + lane, c0), diag, s);
      PPROF_MARK(PP_SOLVE);
      panel_arrive();
      __syncwarp();
      update_tile(sm, p, p + 1, p + 1, lane);
      PPROF_MARK(PP_UPDATE);
      __syncwarp();
      diagonal_block(sm, rs + ((p + 1) & 1) * PANEL, cb, p + 1,
                     min(PANEL, n - c0 - PANEL), lane);
      PPROF_MARK(PP_DIAG);
    } else {
      // the other rows below, a thread a row (padding rows stay zero); at
      // the last of these panels, which has none, these warps store L's
      // zeros
      const int t = tid - WARP, rows = np - c0 - 2 * PANEL;
      if (t < rows) {
        solve_row(at(sm, c0 + 2 * PANEL + t, c0), diag, s);
        PPROF_MARK(PP_SOLVE);
      } else if (p + 2 == panels) {
        // whole warps: rows is a multiple of 32
        store_upper_zeros(O, n, vec, (t - rows) / WARP,
                          (CHOL_THREADS - WARP - rows) / WARP, lane);
        PPROF_MARK(PP_STORE);
      }
      panel_sync();
      PPROF_MARK(PP_BARRIER);
      // the trailing block's lower tiles but the next diagonal one
      const int below = panels - 1 - p;
      const int tiles = below * (below + 1) / 2;
      for (int k = warp; k < tiles; k += CHOL_WARPS - 1) {
        int ti = 0;
        while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
        update_tile(sm, p, p + 1 + ti, p + 1 + k - ti * (ti + 1) / 2, lane);
      }
      PPROF_MARK(PP_UPDATE);
      store_block(sm, O, n, p, vec, warp - 1, CHOL_WARPS - 1, lane);
      PPROF_MARK(PP_STORE);
    }
    PPROF_SYNC(PP_UPDATE);
  }

  store_block(sm, O, n, panels - 1, vec, warp, CHOL_WARPS, lane);
  PPROF_MARK(PP_STORE);
  PPROF_FLUSH();
}

// ---------------------------------------------------------------------------
// The floor
// ---------------------------------------------------------------------------

__device__ __forceinline__ float floor_step(float v, float add) {
  return __fmaf_rn(v, FLOOR_SCALE, add);
}
__device__ __forceinline__ float4 floor_step(float4 v, float add) {
  return make_float4(floor_step(v.x, add), floor_step(v.y, add),
                     floor_step(v.z, add), floor_step(v.w, add));
}

// V = float4: runs of 4 elements, the `tail` elements past them (at most 3)
// taken one each by the first threads of CTA 0; V = float: single elements.
template <typename V, int RUNS>
__global__ void __launch_bounds__(FLOOR_THREADS)
    floor_kernel(const V* __restrict__ a, V* __restrict__ out, long long count,
                 const float* __restrict__ a_tail, float* __restrict__ out_tail,
                 int tail, int n) {
  __shared__ __align__(16) float adds[MAX_N];
  for (int k = threadIdx.x; k < MAX_N; k += FLOOR_THREADS)
    adds[k] = __fmul_rn(static_cast<float>(k), FLOOR_STEP);
  __syncthreads();

  const long long first =
      static_cast<long long>(blockIdx.x) * RUNS * FLOOR_THREADS + threadIdx.x;
  V v[RUNS];
#pragma unroll
  for (int r = 0; r < RUNS; ++r) {
    const long long i = first + static_cast<long long>(r) * FLOOR_THREADS;
    v[r] = i < count ? a[i] : V{};
  }
  const int n4 = n & ~3;
  for (int k = 0; k < n4; k += 4) {
    const float4 add = *reinterpret_cast<const float4*>(adds + k);
#pragma unroll
    for (int r = 0; r < RUNS; ++r) v[r] = floor_step(v[r], add.x);
#pragma unroll
    for (int r = 0; r < RUNS; ++r) v[r] = floor_step(v[r], add.y);
#pragma unroll
    for (int r = 0; r < RUNS; ++r) v[r] = floor_step(v[r], add.z);
#pragma unroll
    for (int r = 0; r < RUNS; ++r) v[r] = floor_step(v[r], add.w);
  }
  for (int k = n4; k < n; ++k) {
    const float add = adds[k];
#pragma unroll
    for (int r = 0; r < RUNS; ++r) v[r] = floor_step(v[r], add);
  }
#pragma unroll
  for (int r = 0; r < RUNS; ++r) {
    const long long i = first + static_cast<long long>(r) * FLOOR_THREADS;
    if (i < count) out[i] = v[r];
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    float t = a_tail[threadIdx.x];
    for (int k = 0; k < n; ++k) t = floor_step(t, adds[k]);
    out_tail[threadIdx.x] = t;
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

int warp_capacity(int n) { return n <= 8 ? 8 : n <= 16 ? 16 : 32; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The launch at (batch, n): out = {capacity, threads, matrices a CTA,
// dynamic shared bytes, CTAs}.  rank1_cholesky: capacity is CAP on the warp
// path, NP on the blocked one; traversal_floor (vec: 16-byte runs): the
// elements a thread, 0 matrices a CTA, 0 bytes.
void cholesky_geometry(long long batch, int n, long long* out) {
  if (n <= WARP) {
    const int cap = warp_capacity(n);
    const int per_cta = WARP_PATH_THREADS / cap;
    out[0] = cap;
    out[1] = WARP_PATH_THREADS;
    out[2] = per_cta;
    out[3] = 0;
    out[4] = (batch + per_cta - 1) / per_cta;
  } else {
    const CholLayout lay = chol_layout(n);
    out[0] = lay.np;
    out[1] = CHOL_THREADS;
    out[2] = 1;
    out[3] = lay.bytes;
    out[4] = batch;
  }
}

void floor_geometry(long long batch, int n, bool vec, long long* out) {
  const long long total = batch * n * n;
  const long long per_cta =
      static_cast<long long>(FLOOR_THREADS) * FLOOR_RUNS * (vec ? 4 : 1);
  out[0] = FLOOR_RUNS * (vec ? 4 : 1);
  out[1] = FLOOR_THREADS;
  out[2] = 0;
  out[3] = 0;
  out[4] = (total + per_cta - 1) / per_cta;
}

// Lets chol_blocked_kernel take the largest layout's shared memory on the
// current device, once a device
cudaError_t allow_shared() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(chol_blocked_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             chol_layout(MAX_N).bytes);
  // all of the SM's unified memory as shared memory: three CTAs an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chol_blocked_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Launches on the calling thread's current device; the caller makes A's
// device current.
int launch_cholesky(const float* A, float* L, long long batch, int n,
                    cudaStream_t s) {
  long long g[5];
  cholesky_geometry(batch, n, g);
  const unsigned int ctas = static_cast<unsigned int>(g[4]);
  const bool vec = n % 4 == 0 && aligned16(A) && aligned16(L);
  switch (g[0]) {
    case 8:
      chol_warp_kernel<8><<<ctas, g[1], 0, s>>>(A, L, batch, n, vec);
      break;
    case 16:
      chol_warp_kernel<16><<<ctas, g[1], 0, s>>>(A, L, batch, n, vec);
      break;
    case 32:
      chol_warp_kernel<32><<<ctas, g[1], 0, s>>>(A, L, batch, n, vec);
      break;
    default: {
      const cudaError_t err = allow_shared();
      if (err != cudaSuccess) return static_cast<int>(err);
      chol_blocked_kernel<<<ctas, g[1], g[3], s>>>(A, L, n, vec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_floor(const float* A, float* O, long long batch, int n,
                 cudaStream_t s) {
  const long long total = batch * n * n;
  const bool vec = aligned16(A) && aligned16(O);
  long long g[5];
  floor_geometry(batch, n, vec, g);
  const unsigned int ctas = static_cast<unsigned int>(g[4]);
  if (vec) {
    const long long runs = total / 4;
    const int tail = static_cast<int>(total - 4 * runs);
    floor_kernel<float4, FLOOR_RUNS><<<ctas, FLOOR_THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(A), reinterpret_cast<float4*>(O),
        runs, A + 4 * runs, O + 4 * runs, tail, n);
  } else {
    floor_kernel<float, FLOOR_RUNS><<<ctas, FLOOR_THREADS, 0, s>>>(
        A, O, total, A, O, 0, n);
  }
  return static_cast<int>(cudaGetLastError());
}

int check(long long batch, int n) {
  if (n < 1 || n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  if (batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

int rank1_cholesky_f32(const void* a, void* l, long long batch, int n,
                       void* stream) {
  if (const int err = check(batch, n)) return err;
  if (batch == 0) return 0;
  return launch_cholesky(static_cast<const float*>(a), static_cast<float*>(l),
                         batch, n, static_cast<cudaStream_t>(stream));
}

int traversal_floor_f32(const void* a, void* out, long long batch, int n,
                        void* stream) {
  if (const int err = check(batch, n)) return err;
  if (batch == 0) return 0;
  return launch_floor(static_cast<const float*>(a), static_cast<float*>(out),
                      batch, n, static_cast<cudaStream_t>(stream));
}

// kernel 0: rank1_cholesky, 1: traversal_floor (16-byte runs); writes
// {capacity, threads, matrices a CTA, shared bytes, CTAs} of a launch at
// (batch, n)
void probe_geometry(int kernel, long long batch, int n, long long* out) {
  if (kernel == 0)
    cholesky_geometry(batch, n, out);
  else
    floor_geometry(batch, n, true, out);
}

#ifdef PROBE_PROFILE
// PP_COUNT phase totals, then the warps counted
int probe_profile_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_probe_phase_cycles, sizeof(unsigned long long) * (PP_COUNT + 1)));
}

int probe_profile_reset() {
  static const unsigned long long zeros[PP_COUNT + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_probe_phase_cycles, zeros, sizeof(zeros)));
}
#endif

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
