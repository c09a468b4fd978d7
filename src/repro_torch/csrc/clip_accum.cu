// In-place clipped, masked accumulate of an m-row per-example tile into the
// flat f32 gradient accumulator (the streaming engine's inner step).
//
// Replaces the TPU kernel `clip_accum_inplace` (its pallas_call body
// _kernel_acc) in the reference package's kernels/clip_accum.py:
//
//   acc[d] += sum_b mask_b * min(1, C / max(norm_b, 1e-12)) * g[b, d]
//
// The sum is a STRICT LEFT FOLD over b starting from the carry acc[d], with
// w = __fmul_rn(g, coef) and acc = __fadd_rn(acc, w) (no FMA, no atomics,
// the coefficient by __fdiv_rn): that fold is what makes the result
// independent of the tile size m and equal, bit for bit, to the masked_pe
// oracle's fold and to the plain PyTorch version.
//
// Bound on the H100: bytes.  Each tile reads g once and reads and writes acc
// once: (4m + 8) B per parameter for f32 g, (2m + 8) for bf16.  The design:
// one thread owns one element d and loops over b in order, so each warp's
// loads of a row are contiguous (coalesced along d); the m coefficients are
// computed once per block into shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void clip_accum_inplace_kernel(float* __restrict__ acc,
                                          const T* __restrict__ g,
                                          const float* __restrict__ norms,
                                          const float* __restrict__ mask,
                                          float clip, int m, int64_t d_len) {
  extern __shared__ float coef[];
  for (int b = threadIdx.x; b < m; b += blockDim.x) {
    const float nb = norms[b];
    const float den = nb < 1e-12f ? 1e-12f : nb;  // NaN stays NaN
    const float q = __fdiv_rn(clip, den);
    coef[b] = __fmul_rn(mask[b], q > 1.0f ? 1.0f : q);
  }
  __syncthreads();
  const int64_t d = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (d >= d_len) return;
  float a = acc[d];
  for (int b = 0; b < m; ++b) {
    a = __fadd_rn(a, __fmul_rn(to_f32(g[static_cast<int64_t>(b) * d_len + d]),
                               coef[b]));
  }
  acc[d] = a;
}

}  // namespace

extern "C" int clip_accum_inplace_launch(float* acc, const void* g,
                                         int g_is_bf16, const float* norms,
                                         const float* mask, float clip, int m,
                                         int64_t d_len, void* stream) {
  if (d_len <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (d_len + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    clip_accum_inplace_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), threads, smem, s>>>(
            acc, static_cast<const __nv_bfloat16*>(g), norms, mask, clip, m,
            d_len);
  } else {
    clip_accum_inplace_kernel<float>
        <<<static_cast<unsigned>(blocks), threads, smem, s>>>(
            acc, static_cast<const float*>(g), norms, mask, clip, m, d_len);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
