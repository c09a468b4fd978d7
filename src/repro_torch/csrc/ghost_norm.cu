// Per-example squared Frobenius norm of a dense layer's weight gradient,
//
//   n[b] = || X_b^T dY_b ||_F^2 = sum_{i,o} (sum_t x[b,t,i] * dy[b,t,o])^2,
//
// without writing the (din, dout) per-example gradient to device memory:
// the direct path of the Mixed-Ghost rule.
//
// Replaces the TPU kernel `ghost_norm_dense` (its pallas_call body _kernel)
// in the reference package's kernels/ghost_norm.py.  On the TPU the grid
// (b, i-tile, o-tile) ran in order and carried `out[b] += partial` from one
// grid step to the next.  Blocks on Hopper run in parallel, so that carry
// becomes a two-stage reduction with no atomics: each block writes the sum
// of squares of its (TI, TO) tile of X_b^T dY_b into a (B, n_tiles) partial
// buffer, and a second kernel sums each row of partials in a fixed order.
// Reruns are bit-identical.
//
// Bound on the H100: f32 operations at the block shapes of ViT-Base
// (2 B T din dout FMA-counted operations against 67 TFLOP/s outside the
// tensor cores; the bytes are only the inputs, read once), bytes at the
// head's T = 1.  The design is the simple one: one block of 256 threads per
// (b, 64x64 output tile); T is streamed in slabs of 32 rows through shared
// memory (upcast from bf16 there), each thread keeps a 4x4 register tile of
// the product in f32 (rows ty + 16 r, columns tx + 16 c, so a warp's reads
// of a slab row are conflict-free) and reduces its squares in a fixed order.
// The ragged edges in T, din and dout are masked to zero on load: zero rows
// and columns add exact zeros, so nothing is padded in memory.  nvcc may
// contract the products into FMAs; no caller needs these bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileI = 64;
constexpr int kTileO = 64;
constexpr int kTileT = 32;
constexpr int kThreads = 256;      // a 16 x 16 grid of 4 x 4 register tiles
constexpr int kSumThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// fixed-order block sum of one float per thread; the result is valid in
// thread 0
template <int kBlock>
__device__ __forceinline__ float block_sum(float s, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kBlock / 32; ++w) total += red[w];
  }
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ghost_norm_partials_kernel(const T* __restrict__ x,
                               const T* __restrict__ dy,
                               float* __restrict__ partials, int t_len,
                               int din, int dout, int n_tiles_o) {
  __shared__ float xs[kTileT][kTileI];
  __shared__ float ds[kTileT][kTileO];
  __shared__ float red[kThreads / 32];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int i0 = (tile / n_tiles_o) * kTileI;
  const int o0 = (tile % n_tiles_o) * kTileO;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* xb = x + static_cast<int64_t>(b) * t_len * din;
  const T* db = dy + static_cast<int64_t>(b) * t_len * dout;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }
  for (int t0 = 0; t0 < t_len; t0 += kTileT) {
    for (int e = tid; e < kTileT * kTileI; e += kThreads) {
      const int t = e / kTileI, i = e % kTileI;
      const int tg = t0 + t, ig = i0 + i;
      xs[t][i] = (tg < t_len && ig < din)
                     ? to_f32(xb[static_cast<int64_t>(tg) * din + ig])
                     : 0.0f;
    }
    for (int e = tid; e < kTileT * kTileO; e += kThreads) {
      const int t = e / kTileO, o = e % kTileO;
      const int tg = t0 + t, og = o0 + o;
      ds[t][o] = (tg < t_len && og < dout)
                     ? to_f32(db[static_cast<int64_t>(tg) * dout + og])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kTileT; ++t) {
      float xv[4], dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[t][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) dv[c] = ds[t][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += xv[r] * dv[c];
      }
    }
    __syncthreads();
  }
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s += acc[r][c] * acc[r][c];
  }
  const float total = block_sum<kThreads>(s, red);
  if (tid == 0) {
    partials[static_cast<int64_t>(b) * gridDim.x + tile] = total;
  }
}

// n[b] = the fixed-order sum of row b of the partials
__global__ void __launch_bounds__(kSumThreads)
    ghost_norm_sum_kernel(const float* __restrict__ partials,
                          float* __restrict__ out, int n_tiles) {
  __shared__ float red[kSumThreads / 32];
  const float* row = partials + static_cast<int64_t>(blockIdx.x) * n_tiles;
  float s = 0.0f;
  for (int k = threadIdx.x; k < n_tiles; k += kSumThreads) s += row[k];
  const float total = block_sum<kSumThreads>(s, red);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

}  // namespace

// x (B, T, din), dy (B, T, dout), both f32 or both bf16, contiguous;
// partials (B, n_tiles) f32 scratch with n_tiles = ceil(din/64) *
// ceil(dout/64); out (B,) f32.  Returns the CUDA error code of the launches.
extern "C" int ghost_norm_dense_launch(const void* x, const void* dy,
                                       int is_bf16, float* partials,
                                       float* out, int batch, int t_len,
                                       int din, int dout, void* stream) {
  if (batch <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles_i = (din + kTileI - 1) / kTileI;
  const int n_tiles_o = (dout + kTileO - 1) / kTileO;
  const int n_tiles = n_tiles_i * n_tiles_o;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
  if (is_bf16) {
    ghost_norm_partials_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), partials, t_len, din, dout,
        n_tiles_o);
  } else {
    ghost_norm_partials_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), partials,
        t_len, din, dout, n_tiles_o);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ghost_norm_sum_kernel<<<static_cast<unsigned>(batch), kSumThreads, 0, s>>>(
      partials, out, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
