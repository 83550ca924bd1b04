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
// float32 dot product (no TF32), and the result is stored in the input's
// type.  The expanded form and the clamp at 0 are the TPU kernel's.
//
// Bound on the card: the function reads (n + m) d inputs and writes n m
// outputs against about (2 d + 8) n m operations, so at the d of the
// repository's benchmarks (d <= 10) it does a few operations per byte
// written, far below the float32 ridge of the H100 (about 20): the bound
// is the bytes of the output.  The design therefore writes each output
// once and nothing else: no padding of rows to the TPU's 256-row tiles and
// no slice afterwards.  A CTA of 256 threads owns a 64 x 64 output tile;
// it stages the scaled float32 rows of x and z for that tile in shared
// memory, 32 features at a time (d of any size takes several chunks), and
// each thread accumulates 4 x 4 outputs on the CUDA cores.  A thread's
// outputs sit 16 columns apart, so the 16 threads of a half warp store 16
// neighbouring columns of a row together.  The rows of z are padded by one
// word in shared memory, so 16 threads reading 16 rows at one feature hit
// 16 banks.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kChunk = 32;    // features staged per pass
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void rbf_gram_kernel(const T* __restrict__ x,
                                const T* __restrict__ z,
                                const T* __restrict__ ls,
                                const T* __restrict__ os,
                                T* __restrict__ out, int n, int m, int d) {
  __shared__ float xs[kTile][kChunk + 1];
  __shared__ float zs[kTile][kChunk + 1];
  __shared__ float xn[kTile];
  __shared__ float zn[kTile];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  if (threadIdx.x < kTile) {
    xn[threadIdx.x] = 0.0f;
  } else if (threadIdx.x < 2 * kTile) {
    zn[threadIdx.x - kTile] = 0.0f;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    // stage the scaled float32 rows of this chunk; padded rows are zero
    for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int k = idx - r * kChunk;
      float xv = 0.0f, zv = 0.0f;
      if (k < kc) {
        const T l = static_cast<T>(static_cast<float>(ls[k0 + k]));
        if (row0 + r < n) {
          xv = static_cast<float>(
              x[static_cast<size_t>(row0 + r) * d + k0 + k] / l);
        }
        if (col0 + r < m) {
          zv = static_cast<float>(
              z[static_cast<size_t>(col0 + r) * d + k0 + k] / l);
        }
      }
      xs[r][k] = xv;
      zs[r][k] = zv;
    }
    __syncthreads();
    // squared norms of the scaled rows, feature by feature in order
    if (threadIdx.x < kTile) {
      float s = xn[threadIdx.x];
      for (int k = 0; k < kc; ++k) s += xs[threadIdx.x][k] * xs[threadIdx.x][k];
      xn[threadIdx.x] = s;
    } else if (threadIdx.x < 2 * kTile) {
      const int r = threadIdx.x - kTile;
      float s = zn[r];
      for (int k = 0; k < kc; ++k) s += zs[r][k] * zs[r][k];
      zn[r] = s;
    }
    // the cross term of this thread's 4 x 4 outputs
    for (int k = 0; k < kc; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = zs[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
    }
    __syncthreads();
  }

  const float scale = static_cast<float>(os[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = row0 + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = col0 + c;
      if (col >= m) continue;
      const float d2 = fmaxf(xn[r] - 2.0f * acc[i][j] + zn[c], 0.0f);
      out[static_cast<size_t>(row) * m + col] =
          static_cast<T>(scale * expf(-0.5f * d2));
    }
  }
}

// Launches on the calling thread's current device; the caller makes the
// inputs' device current.
template <typename T>
int launch(const void* x, const void* z, const void* ls, const void* os,
           void* out, int n, int m, int d, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  rbf_gram_kernel<T><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(z),
      static_cast<const T*>(ls), static_cast<const T*>(os),
      static_cast<T*>(out), n, m, d);
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

const char* rbf_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
