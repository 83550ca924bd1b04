// ARD-RBF Gram matrix, f32 inside, for Hopper.
//
// Replaces the Pallas TPU kernel scamlgp_tpu/ops/pallas_gram.py::_gram_kernel.
// For x (n, d), z (m, d), lengthscales l (d,) and an outputscale os it writes
//
//     K[i][j] = os * exp(-0.5 * max(|xs_i|^2 - 2 xs_i . zs_j + |zs_j|^2, 0))
//
// with xs = x / l and zs = z / l.  As on the TPU the arithmetic is float32
// whatever the input type: l is cast to float32 first, each scaled input is
// rounded to float32 (the division itself runs in the input's type, as the
// reference's wrapper divides before it casts), the cross term is a full
// float32 dot product (no TF32), exp is the accurate expf, and the result
// is stored in the input's type.  The expanded form and the clamp at 0 are
// the TPU kernel's.  The exponent is formed as
// min((-|xs_i|^2 / 2 + xs_i . zs_j) + -|zs_j|^2 / 2, 0): scaling by -1/2 is
// exact in binary floating point, so this is -0.5 * max(d2, 0) to the bit
// (outside subnormal norms) in three operations instead of five.
//
// Bound on the card: the function reads (n + m) d inputs and writes n m
// outputs against about (2 d + 8) n m operations, so at the d of the
// repository's benchmarks (d <= 10) it does a few operations per byte
// written, far below the float32 ridge of the H100 (about 20): the bound
// is the bytes of the output, and the design keeps the store stream busy.
//
//   - Persistent CTAs: about 4 CTAs an SM (kCtasPerSm, held by the launch
//     bounds' registers and at most 49 KiB of shared memory a CTA), each
//     walking a contiguous run of 32 x 128 output tiles in row-major order,
//     so a CTA keeps its scaled x rows across the tiles of one row and no
//     CTA's start leaves an SM without stores to issue.
//   - A pipeline two tiles deep, one barrier a tile: while a tile computes
//     and stores, the thread that owns each z row (and x row, where the
//     walk enters a new row of tiles) scales the next tile's chunk of it
//     into the other half of a double buffer, from raw rows that it copied
//     itself with cp.async one tile earlier, so waiting for its own copies
//     needs no barrier.  Each element is scaled (the division) once a tile,
//     never in the inner loop, and the owner sums the row's squared norm
//     as it scales.  The raw rows are padded to an odd stride, so the 32
//     lanes of a warp reading one feature of 32 rows hit 32 banks.
//   - The walk and the copies need no integer division: a CTA finds its
//     first tile with one division and then steps (chunk, column, row) as
//     counters.  The kernel is near the SM's instruction issue limit, and
//     a division (a subroutine in 64 bits) a tile or a copied element
//     costs more than the stores leave (PERF.md, section 6).
//   - Stores: warp w owns rows 4 w .. 4 w + 3 of a tile (their scaled x
//     values read as one 16-byte broadcast), and each lane 4 columns of
//     each, in runs of 16 bytes: 4 contiguous columns in float32, two runs
//     of 2 in float64, 64 columns apart.  A warp's store
//     instruction writes one 512-byte row segment, with the streaming
//     evict-first hint (st.global.cs): nothing re-reads the output.  Where
//     m % (16 bytes / element) != 0 the rows start unaligned, and there and
//     at a ragged tile edge the same outputs are stored one element each.
//   - d of any size: features are staged kChunk at a time (12: the
//     repository's d <= 10 take one chunk), the cross term and the norms
//     accumulate across chunks, and x is staged every chunk.
//   - No tensor cores: the cross term is 2 d of the (2 d + 8) operations of
//     an output, and TF32 would break the float32 product that the TPU
//     kernel computes at Precision.HIGHEST.
//
// Built with -DGRAM_PROFILE every warp stamps clock64() at the end of each
// phase (issuing the copies and staging with the norms, cross term, exp and
// store, the wait at the barrier, and the wait for this thread's copies);
// gram_profile_read returns the totals and the number of warps (the macros
// are gram_profile.h's).
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, 0 on success.  rbf_gram_geometry reports the launch
// geometry that ops/gram.py::launch_geometry mirrors.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "gram_profile.h"

namespace {

constexpr int kRows = 32;      // output rows of a tile
constexpr int kCols = 128;     // output columns of a tile: 32 lanes x 4
constexpr int kThreads = 256;  // 8 warps, 4 rows x 4 columns a thread
constexpr int kCtasPerSm = 4;  // resident CTAs an SM the launch assumes
constexpr int kChunk = 12;     // features staged per pass

constexpr int kMaxDevices = 64;

#ifdef GRAM_PROFILE
// the phase totals, the last slot the warps counted
__device__ unsigned long long g_gram_cycles[GP_COUNT + 1];
#endif

// Dynamic shared memory of a CTA, in bytes from its start, each part two
// buffers: the scaled float32 chunk of the tile's z rows, feature-major
// (kc x kCols), and of its x rows (kc x kRows), their squared norms, then
// the raw z and x rows of the chunk in the input's type, kCols (kRows) rows
// of an odd stride.
struct Layout {
  int kc, stride;
  size_t zs, xs, zn, xn, zraw, xraw, bytes;
};

__host__ __device__ inline Layout layout(int d, int elem) {
  Layout L;
  L.kc = d < kChunk ? d : kChunk;
  L.stride = L.kc | 1;
  L.zs = 0;
  L.xs = L.zs + 2 * sizeof(float) * L.kc * kCols;
  L.zn = L.xs + 2 * sizeof(float) * L.kc * kRows;
  L.xn = L.zn + 2 * sizeof(float) * kCols;
  L.zraw = L.xn + 2 * sizeof(float) * kRows;  // a multiple of 256 bytes
  L.xraw = L.zraw + static_cast<size_t>(2) * elem * kCols * L.stride;
  L.bytes = L.xraw + static_cast<size_t>(2) * elem * kRows * L.stride;
  return L;
}

struct Geometry {
  long long tiles;
  int tiles_n, chunks, tiles_per_cta, grid;
};

// sms CTAs x kCtasPerSm at most, each taking tiles_per_cta consecutive
// tiles; grid is the fewest CTAs that cover the tiles at that count.  The
// tiles of any output that fits in device memory number under 2^31, so the
// kernel counts them in int.
__host__ __device__ inline Geometry geometry(int n, int m, int d, int sms) {
  Geometry g;
  g.tiles_n = (m + kCols - 1) / kCols;
  g.tiles = static_cast<long long>((n + kRows - 1) / kRows) * g.tiles_n;
  g.chunks = d > kChunk ? (d + kChunk - 1) / kChunk : 1;
  const long long cap = static_cast<long long>(sms) * kCtasPerSm;
  g.tiles_per_cta = static_cast<int>((g.tiles + cap - 1) / cap);
  g.grid = static_cast<int>((g.tiles + g.tiles_per_cta - 1) / g.tiles_per_cta);
  return g;
}

// One element (4 or 8 bytes) from device memory to shared memory,
// asynchronously; a group of them is committed, then waited for.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits for all but the most recent group of this thread's copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16 bytes of outputs, streamed past the caches: 4 floats or 2 doubles
__device__ __forceinline__ void store_run(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_run(double* p, const float* v) {
  __stcs(reinterpret_cast<double2*>(p),
         make_double2(static_cast<double>(v[0]), static_cast<double>(v[1])));
}

// A unit of a CTA's walk: one feature chunk of one tile.  next() steps
// (chunk, column, row) as counters, row-major over the tiles.
struct Unit {
  int row_t, col_t, chunk, row0, col0, k0, kc;
  bool stage_x;

  __device__ void set(int d) {
    row0 = row_t * kRows;
    col0 = col_t * kCols;
    k0 = chunk * kChunk;
    kc = min(kChunk, d - k0);
  }
  // x is staged for every chunk when there are several, else only where
  // the walk enters a new row of tiles
  __device__ Unit next(int tiles_n, int chunks, int d) const {
    Unit w = *this;
    if (++w.chunk == chunks) {
      w.chunk = 0;
      if (++w.col_t == tiles_n) {
        w.col_t = 0;
        ++w.row_t;
      }
    }
    w.stage_x = chunks > 1 || w.col_t == 0;
    w.set(d);
    return w;
  }
};

// The thread that owns a z row (thread c < kCols: row col0 + c) or an x row
// (thread kCols + r < kCols + kRows: row row0 + r, where w stages x) copies
// unit w's chunk of it into raw buffer buf; the others copy nothing.
template <typename T>
__device__ inline void copy_own_row(const Unit& w, int buf, const T* x,
                                    const T* z, int n, int m, int d,
                                    int stride, T* zraw, T* xraw) {
  const T* src = nullptr;
  T* dst = nullptr;
  if (threadIdx.x < kCols) {
    const int c = threadIdx.x;
    if (w.col0 + c < m) {
      src = z + static_cast<size_t>(w.col0 + c) * d + w.k0;
      dst = zraw + (static_cast<size_t>(buf) * kCols + c) * stride;
    }
  } else if (w.stage_x && threadIdx.x < kCols + kRows) {
    const int r = threadIdx.x - kCols;
    if (w.row0 + r < n) {
      src = x + static_cast<size_t>(w.row0 + r) * d + w.k0;
      dst = xraw + (static_cast<size_t>(buf) * kRows + r) * stride;
    }
  }
  if (src != nullptr)
    for (int k = 0; k < w.kc; ++k) cp_async_elem(dst + k, src + k);
}

// Scale raw row `row` (kc features, in the input's type) into column `row`
// of a feature-major float32 chunk, and write its squared norm to
// norm[row]: the chunk's sum at the first chunk, else added to prev[row],
// the norm so far.  A row past the matrix is zero.
template <typename T, int kLen>
__device__ inline void stage_row(const T* raw, float* scaled, float* norm,
                                 const float* prev, int row, bool inside,
                                 const Unit& w, const T* __restrict__ ls) {
  float s = w.chunk == 0 ? 0.0f : prev[row];
  for (int k = 0; k < w.kc; ++k) {
    float v = 0.0f;
    if (inside) {
      const T l = static_cast<T>(static_cast<float>(__ldg(ls + w.k0 + k)));
      v = static_cast<float>(raw[k] / l);
    }
    scaled[k * kLen + row] = v;
    s += v * v;
  }
  norm[row] = s;
}

// Unit w's own rows, from raw buffer rb, into scaled buffers zb (z) and xb
// (x, where w stages it); pz and px are the buffers of the unit before.
template <typename T>
__device__ inline void stage_own_row(const Unit& w, int rb, int zb, int xb,
                                     int pz, int px, int n, int m,
                                     const Layout& L, unsigned char* smem,
                                     const T* __restrict__ ls) {
  float* zs = reinterpret_cast<float*>(smem + L.zs);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* zn = reinterpret_cast<float*>(smem + L.zn);
  float* xn = reinterpret_cast<float*>(smem + L.xn);
  const T* zraw = reinterpret_cast<const T*>(smem + L.zraw);
  const T* xraw = reinterpret_cast<const T*>(smem + L.xraw);
  if (threadIdx.x < kCols) {
    const int c = threadIdx.x;
    stage_row<T, kCols>(zraw + (static_cast<size_t>(rb) * kCols + c) *
                                   L.stride,
                        zs + zb * L.kc * kCols, zn + zb * kCols,
                        zn + pz * kCols, c, w.col0 + c < m, w, ls);
  } else if (w.stage_x && threadIdx.x < kCols + kRows) {
    const int r = threadIdx.x - kCols;
    stage_row<T, kRows>(xraw + (static_cast<size_t>(rb) * kRows + r) *
                                   L.stride,
                        xs + xb * L.kc * kRows, xn + xb * kRows,
                        xn + px * kRows, r, w.row0 + r < n, w, ls);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    rbf_gram_kernel(const T* __restrict__ x, const T* __restrict__ z,
                    const T* __restrict__ ls, const T* __restrict__ os,
                    T* __restrict__ out, int n, int m, int d, int tiles_n,
                    long long tiles, int tiles_per_cta, int chunks,
                    bool vector_stores) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(d, sizeof(T));
  const float* zs = reinterpret_cast<const float*>(smem + L.zs);
  const float* xs = reinterpret_cast<const float*>(smem + L.xs);
  const float* zn = reinterpret_cast<const float*>(smem + L.zn);
  const float* xn = reinterpret_cast<const float*>(smem + L.xn);
  T* zraw = reinterpret_cast<T*>(smem + L.zraw);
  T* xraw = reinterpret_cast<T*>(smem + L.xraw);
  GPROF_DECL

  constexpr int V = 16 / sizeof(T);  // outputs in a 16-byte run
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t_begin = blockIdx.x * tiles_per_cta;
  const int t_end = min(static_cast<int>(tiles), t_begin + tiles_per_cta);
  const int units = (t_end - t_begin) * chunks;
  const float scale = static_cast<float>(os[0]);

  // unit u's raw rows sit in raw buffer u % 2 and its scaled z chunk in
  // buffer u % 2; its x chunk in buffer xb, which flips where x is staged
  Unit w;
  w.row_t = t_begin / tiles_n;
  w.col_t = t_begin - w.row_t * tiles_n;
  w.chunk = 0;
  w.stage_x = true;
  w.set(d);
  Unit nx = w.next(tiles_n, chunks, d);
  copy_own_row(w, 0, x, z, n, m, d, L.stride, zraw, xraw);
  cp_async_commit();
  if (units > 1) copy_own_row(nx, 1, x, z, n, m, d, L.stride, zraw, xraw);
  cp_async_commit();
  GPROF_MARK(GP_STAGE);
  cp_async_wait_prior();
  GPROF_MARK(GP_COPY);
  stage_own_row(w, 0, 0, 0, 1, 1, n, m, L, smem, ls);
  GPROF_SYNC(GP_STAGE);

  int xb = 0;
  float acc[4][4];
  for (int u = 0; u < units; ++u) {
    const int zb = u & 1;
    // the unit after next: its copies go into the raw buffer that this
    // unit's rows have left (this thread scaled them one tile ago)
    const Unit nn = nx.next(tiles_n, chunks, d);
    if (u + 2 < units)
      copy_own_row(nn, zb, x, z, n, m, d, L.stride, zraw, xraw);
    cp_async_commit();
    const int xb_next = nx.stage_x ? xb ^ 1 : xb;
    if (u + 1 < units) {
      GPROF_MARK(GP_STAGE);
      cp_async_wait_prior();  // this thread's copies of the next unit
      GPROF_MARK(GP_COPY);
      stage_own_row(nx, zb ^ 1, zb ^ 1, xb_next, zb, xb, n, m, L, smem, ls);
    }
    GPROF_MARK(GP_STAGE);

    if (w.chunk == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
    }
    // the cross term: a[i] is row 4 warp + i (a broadcast), b[j] column
    // (j / V) 32 V + lane V + j % V, read as runs of V
    const float* xc = xs + xb * L.kc * kRows;
    const float* zc = zs + zb * L.kc * kCols;
    for (int k = 0; k < w.kc; ++k) {
      float b[4];
      const float4 a4 =
          *reinterpret_cast<const float4*>(xc + k * kRows + 4 * warp);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float* zk = zc + k * kCols + lane * V;
      if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(zk);
        b[0] = q.x;
        b[1] = q.y;
        b[2] = q.z;
        b[3] = q.w;
      } else {
        const float2 q0 = *reinterpret_cast<const float2*>(zk);
        const float2 q1 = *reinterpret_cast<const float2*>(zk + 32 * V);
        b[0] = q0.x;
        b[1] = q0.y;
        b[2] = q1.x;
        b[3] = q1.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
    }
    GPROF_MARK(GP_CROSS);

    if (w.chunk == chunks - 1) {
      // -|xs|^2 / 2 of this thread's rows and -|zs|^2 / 2 of its columns
      const float4 xq =
          *reinterpret_cast<const float4*>(xn + xb * kRows + 4 * warp);
      const float hx[4] = {-0.5f * xq.x, -0.5f * xq.y, -0.5f * xq.z,
                           -0.5f * xq.w};
      float hz[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hz[j] = -0.5f * zn[zb * kCols + (j / V) * 32 * V + lane * V + j % V];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = w.row0 + 4 * warp + i;
        if (row >= n) continue;
        T* orow = out + static_cast<size_t>(row) * m;
#pragma unroll
        for (int v = 0; v < 4 / V; ++v) {
          const int c0 = v * 32 * V + lane * V;
          const int col = w.col0 + c0;
          float vals[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int j = v * V + e;
            const float arg = fminf((hx[i] + acc[i][j]) + hz[j], 0.0f);
            vals[e] = scale * expf(arg);
          }
          if (vector_stores && col + V <= m) {
            store_run(orow + col, vals);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e)
              if (col + e < m) __stcs(orow + col + e, static_cast<T>(vals[e]));
          }
        }
      }
      GPROF_MARK(GP_STORE);
    }
    // the next unit's scaled rows are ready, and this one's buffers free
    GPROF_SYNC(GP_STORE);
    w = nx;
    nx = nn;
    xb = xb_next;
  }
  GPROF_FLUSH(g_gram_cycles);
}

// The SMs of device dev, read once a device
int sm_count(int dev) {
  static int cached[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return -1;
    cached[dev] = sms;
  }
  return cached[dev];
}

// Lets rbf_gram_kernel<T> take the largest layout's dynamic shared memory
// on device dev, once a device and type
template <typename T>
cudaError_t allow_shared(int dev) {
  static bool done[kMaxDevices] = {};
  if (done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      rbf_gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(layout(kChunk, sizeof(T)).bytes));
  done[dev] = err == cudaSuccess;
  return err;
}

// Launches on the calling thread's current device; the caller makes the
// inputs' device current.
template <typename T>
int launch(const void* x, const void* z, const void* ls, const void* os,
           void* out, int n, int m, int d, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int sms = sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const Geometry g = geometry(n, m, d, sms);
  const Layout L = layout(d, sizeof(T));
  if (L.bytes > 48 * 1024) {
    const cudaError_t err = allow_shared<T>(dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte runs need rows that start on 16 bytes
  const bool vector_stores =
      m % (16 / static_cast<int>(sizeof(T))) == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  rbf_gram_kernel<T><<<g.grid, kThreads, L.bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(z),
      static_cast<const T*>(ls), static_cast<const T*>(os),
      static_cast<T*>(out), n, m, d, g.tiles_n, g.tiles, g.tiles_per_cta,
      g.chunks, vector_stores);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rbf_gram_f32(const void* x, const void* z, const void* ls, const void* os,
                 void* out, int n, int m, int d, void* stream) {
  return launch<float>(x, z, ls, os, out, n, m, d, stream);
}

int rbf_gram_f64(const void* x, const void* z, const void* ls, const void* os,
                 void* out, int n, int m, int d, void* stream) {
  return launch<double>(x, z, ls, os, out, n, m, d, stream);
}

// {grid, tiles_per_cta, chunks, shared bytes} at (n, m, d) on `sms` SMs,
// elem = 4 (float32) or 8 (float64)
void rbf_gram_geometry(int n, int m, int d, int elem, int sms, long long* out) {
  const Geometry g = geometry(n, m, d, sms);
  out[0] = g.grid;
  out[1] = g.tiles_per_cta;
  out[2] = g.chunks;
  out[3] = static_cast<long long>(layout(d, elem).bytes);
}

#ifdef GRAM_PROFILE
// GP_COUNT phase totals, then the warps counted
int gram_profile_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_gram_cycles, sizeof(unsigned long long) * (GP_COUNT + 1)));
}

int gram_profile_reset() {
  static const unsigned long long zeros[GP_COUNT + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_gram_cycles, zeros, sizeof(zeros)));
}
#endif

const char* rbf_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
