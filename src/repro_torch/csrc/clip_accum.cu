// Clipped, masked sum of the rows of a per-example gradient matrix, in two
// forms that share one fold:
//
//   clip_accum_inplace: acc[d] += sum_b coef_b * g[b, d]   (the streaming
//       engine's inner step, into the flat f32 accumulator, in place);
//   clip_accum:         out[d]  = sum_b coef_b * g[b, d]   (the resident
//       (B, D) matrix of masked_fused, into a fresh (D,) output),
//
// with coef_b = mask_b * min(1, C / max(norm_b, 1e-12)).
//
// Replaces the TPU kernels `clip_accum_inplace` (pallas_call body
// _kernel_acc) and `clip_accum` (body _kernel) of the reference package's
// kernels/clip_accum.py.
//
// The sum is a STRICT LEFT FOLD over b, from the carry acc[d] or from +0,
// with w = __fmul_rn(g, coef) and a = __fadd_rn(a, w) (no FMA, no atomics,
// the coefficient by __fdiv_rn): that fold is what makes the result
// independent of the tile size m and equal, bit for bit, to the masked_pe
// oracle's fold and to the plain PyTorch versions.
//
// Bound on the H100: bytes.  A call reads g once and writes the output once
// (and reads acc once in place): (4m + 8) B per parameter for f32 g in place,
// (4B + 4) for the resident form; half the g bytes for bf16.  The design:
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

template <typename T, bool kFromZero>
__global__ void clip_accum_kernel(float* __restrict__ acc,
                                  const T* __restrict__ g,
                                  const float* __restrict__ norms,
                                  const float* __restrict__ mask, float clip,
                                  int m, int64_t d_len) {
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
  float a = kFromZero ? 0.0f : acc[d];
  for (int b = 0; b < m; ++b) {
    a = __fadd_rn(a, __fmul_rn(to_f32(g[static_cast<int64_t>(b) * d_len + d]),
                               coef[b]));
  }
  acc[d] = a;
}

template <bool kFromZero>
int launch(float* acc, const void* g, int g_is_bf16, const float* norms,
           const float* mask, float clip, int m, int64_t d_len, void* stream) {
  if (d_len <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (d_len + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    clip_accum_kernel<__nv_bfloat16, kFromZero>
        <<<static_cast<unsigned>(blocks), threads, smem, s>>>(
            acc, static_cast<const __nv_bfloat16*>(g), norms, mask, clip, m,
            d_len);
  } else {
    clip_accum_kernel<float, kFromZero>
        <<<static_cast<unsigned>(blocks), threads, smem, s>>>(
            acc, static_cast<const float*>(g), norms, mask, clip, m, d_len);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc (D,) f32 += the fold of the (m, D) tile g, in place
extern "C" int clip_accum_inplace_launch(float* acc, const void* g,
                                         int g_is_bf16, const float* norms,
                                         const float* mask, float clip, int m,
                                         int64_t d_len, void* stream) {
  return launch<false>(acc, g, g_is_bf16, norms, mask, clip, m, d_len,
                       stream);
}

// out (D,) f32 = the fold of the (B, D) matrix g from +0 (out is written,
// never read)
extern "C" int clip_accum_launch(float* out, const void* g, int g_is_bf16,
                                 const float* norms, const float* mask,
                                 float clip, int m, int64_t d_len,
                                 void* stream) {
  return launch<true>(out, g, g_is_bf16, norms, mask, clip, m, d_len, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
