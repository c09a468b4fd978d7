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
// Bound on the H100: bytes.  A call reads g once and writes the output once,
// and in place reads acc once: (4m + 8) B per parameter for f32 g in place,
// (4m + 4) B for the resident form; bf16 g halves the g bytes (2m).  One
// multiply and one add per byte pair: no tensor core, TMA or wgmma applies.
//
// The design keeps enough bytes in flight at one or two rows, where a
// thread that loads one 4-byte element at a time leaves HBM half idle (it
// reached 47% of the bound at one row on an H100 80GB HBM3):
//   - 16-byte accesses along d: a vector is 4 elements, a float4 of acc,
//     out and f32 g, 8 bytes of bf16 g upcast with __bfloat162float;
//   - each thread takes kVecs vectors and issues the loads of kRows rows of
//     them before it folds any (the fold itself stays in row order, element
//     by element): at m = 1 that is 32 B of g (and 32 B of acc in place) in
//     flight per thread, at m >= 4 128 B of g;
//   - one block per chunk of kThreads * kVecs vectors (2,048 elements), the
//     blocks issued in order, each computing the m coefficients into shared
//     memory once; int64 offsets throughout, the buffer may pass 2^31;
//   - g through the read-only path (ld.global.nc); the resident form's fresh
//     output with streaming stores (st.global.cs); acc is read, then written
//     back, by the same thread;
//   - the ragged edges in the same kernel: the wrapper's split
//     (kernels/clip_accum.py clip_split) gives the scalar head before the
//     first 16-byte aligned vector and the vector count; the tail after the
//     last vector is scalar too.  Vectors need every row of g in phase with
//     acc (m = 1, or a row length that is a multiple of 4); otherwise the
//     split is all head and every element goes one by one.
// Measured on an H100 80GB HBM3 against this design (clip_ab.py at the main
// path's shapes): a persistent grid-stride launch (SMs times resident
// blocks, each walking the buffer) ran 1.5-5.6% slower at every m, most at
// one row (its blocks drift apart over the buffer, where blocks issued in
// order stream through it together), and evict-first loads of g
// (ld.global.cs) 1.1-2.8% slower in place and no faster in the resident
// form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;   // vectors per thread
constexpr int kRows = 4;   // rows of g loaded before they are folded
constexpr int kVec = 4;    // elements per vector

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four elements of a row of g, upcast, through the read-only path
__device__ __forceinline__ float4 load_row(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_row(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__bfloat162float(lo.x), __bfloat162float(lo.y),
                     __bfloat162float(hi.x), __bfloat162float(hi.y));
}

__device__ __forceinline__ float fold(float a, float g, float c) {
  return __fadd_rn(a, __fmul_rn(g, c));
}

template <typename T, bool kFromZero>
__global__ void __launch_bounds__(kThreads)
    clip_accum_kernel(float* __restrict__ acc, const T* __restrict__ g,
                      const float* __restrict__ norms,
                      const float* __restrict__ mask, float clip, int m,
                      int64_t d_len, int64_t head, int64_t n_vec) {
  extern __shared__ float coef[];
  for (int b = threadIdx.x; b < m; b += kThreads) {
    const float nb = norms[b];
    const float den = nb < 1e-12f ? 1e-12f : nb;  // NaN stays NaN
    const float q = __fdiv_rn(clip, den);
    coef[b] = __fmul_rn(mask[b], q > 1.0f ? 1.0f : q);
  }
  __syncthreads();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;

  // the scalar head [0, head) and tail [vend, d_len), element by element,
  // on the first threads of the grid
  const int64_t vend = head + kVec * n_vec;
  if (tid < head + (d_len - vend)) {
    const int64_t d = tid < head ? tid : vend + (tid - head);
    float a = kFromZero ? 0.0f : acc[d];
    for (int b = 0; b < m; ++b) {
      a = fold(a, to_f32(g[static_cast<int64_t>(b) * d_len + d]), coef[b]);
    }
    acc[d] = a;
  }

  // the block's chunk of vectors: kVecs per thread, neighbouring threads on
  // neighbouring vectors
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kThreads * kVecs +
                     threadIdx.x;
  if (v0 >= n_vec) return;
  float* const av = acc + head;
  const T* const gv = g + head;
  float4 a[kVecs];
  bool in[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int64_t e = kVec * (v0 + u * kThreads);
    in[u] = v0 + u * kThreads < n_vec;
    a[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!kFromZero && in[u]) a[u] = *reinterpret_cast<const float4*>(av + e);
  }
  for (int b = 0; b < m; b += kRows) {
    float4 x[kRows][kVecs] = {};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        if (b + r < m && in[u]) {
          x[r][u] = load_row(gv + static_cast<int64_t>(b + r) * d_len +
                             kVec * (v0 + u * kThreads));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (b + r < m) {
        const float c = coef[b + r];
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          a[u].x = fold(a[u].x, x[r][u].x, c);
          a[u].y = fold(a[u].y, x[r][u].y, c);
          a[u].z = fold(a[u].z, x[r][u].z, c);
          a[u].w = fold(a[u].w, x[r][u].w, c);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    if (!in[u]) continue;
    float4* o = reinterpret_cast<float4*>(av + kVec * (v0 + u * kThreads));
    if (kFromZero) {
      __stcs(o, a[u]);
    } else {
      *o = a[u];
    }
  }
}

template <bool kFromZero>
int launch(float* acc, const void* g, int g_is_bf16, const float* norms,
           const float* mask, float clip, int m, int64_t d_len, int64_t head,
           int64_t n_vec, void* stream) {
  if (d_len <= 0) return 0;
  if (head < 0 || n_vec < 0 || head + kVec * n_vec > d_len || m < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one block per chunk of vectors, or per kThreads scalar elements where
  // those need more blocks (the all-scalar split)
  const int64_t n_scalar = d_len - kVec * n_vec;
  const int64_t by_vec = (n_vec + kThreads * kVecs - 1) / (kThreads * kVecs);
  const int64_t by_scalar = (n_scalar + kThreads - 1) / kThreads;
  const int64_t blocks = by_vec > by_scalar ? by_vec : by_scalar;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    clip_accum_kernel<__nv_bfloat16, kFromZero>
        <<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
            acc, static_cast<const __nv_bfloat16*>(g), norms, mask, clip, m,
            d_len, head, n_vec);
  } else {
    clip_accum_kernel<float, kFromZero>
        <<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
            acc, static_cast<const float*>(g), norms, mask, clip, m, d_len,
            head, n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc (D,) f32 += the fold of the (m, D) tile g, in place.  head and n_vec
// are the split: elements [head, head + 4 n_vec) go in vectors (acc and
// every row of g 16-byte aligned there, 8-byte for bf16 g), the rest one by
// one.
extern "C" int clip_accum_inplace_launch(float* acc, const void* g,
                                         int g_is_bf16, const float* norms,
                                         const float* mask, float clip, int m,
                                         int64_t d_len, int64_t head,
                                         int64_t n_vec, void* stream) {
  return launch<false>(acc, g, g_is_bf16, norms, mask, clip, m, d_len, head,
                       n_vec, stream);
}

// out (D,) f32 = the fold of the (B, D) matrix g from +0 (out is written,
// never read); the split as above
extern "C" int clip_accum_launch(float* out, const void* g, int g_is_bf16,
                                 const float* norms, const float* mask,
                                 float clip, int m, int64_t d_len,
                                 int64_t head, int64_t n_vec, void* stream) {
  return launch<true>(out, g, g_is_bf16, norms, mask, clip, m, d_len, head,
                      n_vec, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
