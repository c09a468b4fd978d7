// Fused DP noise + SGD(+momentum) update over one flat f32 parameter leaf.
//
// Replaces the TPU kernel `noisy_sgd_update` in the reference package's
// kernels/noisy_update.py (its pallas_call bodies _kernel, _kernel_mom,
// _kernel_plain, _kernel_mom_plain, _kernel_rng_tf, _kernel_mom_rng_tf).
// The TPU-only _kernel_rng/_kernel_mom_rng seed the TPU's hardware PRNG and
// have no counterpart here: the in-kernel Threefry-2x32 body replaces them.
//
//   g = (acc + sigma_c * z) * inv_l        (noise-free: g = acc * inv_l)
//   m = mu * m + g;  p = p - lr * m        (no momentum: p = p - lr * g)
//
// Noise source, chosen at launch: none, an f32 operand `z`, or in-kernel
// Threefry-2x32 (20 rounds; counter c0 = the element's index in its leaf,
// c1 = 0; key = the step's two seed words plus the leaf index) followed by
// the reference's Box-Muller `bits_to_normal`, written with logf/sqrtf/cosf
// (no fast-math intrinsics).  Every product and sum is __fmul_rn/__fadd_rn in
// the reference's order, so no FMA contraction changes the bits: the
// operand and noise-free variants equal the plain PyTorch version bitwise.
//
// Bound on the H100: bytes.  The momentum form reads p, acc, m and writes
// p, m: 20 B per parameter (24 with a noise operand), about 1.7 GB per step
// for ViT-Base, 0.51 ms at 3.35 TB/s.  The design keeps it one pass: one
// thread per element, coalesced loads, p and m updated in place, the
// in-kernel noise never touching device memory.  Threefry costs ~100
// integer ops per element, which stays under the memory time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNoiseNone = 0;
constexpr int kNoiseOperand = 1;
constexpr int kNoiseThreefry = 2;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t* o0, uint32_t* o1) {
  const int rots[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rots[(r % 2) * 4 + i]);
      x1 ^= x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + static_cast<uint32_t>(r + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

// u1 in (0, 1] from the 24 high bits (offset 2^-25), u2 in [0, 1)
__device__ __forceinline__ float bits_to_normal(uint32_t b1, uint32_t b2) {
  const float inv24 = 1.0f / 16777216.0f;
  const float u1 = __fadd_rn(__fmul_rn(static_cast<float>(b1 >> 8), inv24),
                             0.5f / 16777216.0f);
  const float u2 = __fmul_rn(static_cast<float>(b2 >> 8), inv24);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
}

template <int NOISE, bool MOM>
__global__ void noisy_sgd_update_kernel(float* __restrict__ p,
                                        const float* __restrict__ acc,
                                        const float* __restrict__ z,
                                        float* __restrict__ m, int64_t n,
                                        uint32_t k0, uint32_t k1, float sc,
                                        float inv_l, float lr, float mu) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float a = acc[i];
    if (NOISE == kNoiseOperand) {
      a = __fadd_rn(a, __fmul_rn(sc, z[i]));
    } else if (NOISE == kNoiseThreefry) {
      uint32_t b1, b2;
      threefry2x32(k0, k1, static_cast<uint32_t>(i), 0u, &b1, &b2);
      a = __fadd_rn(a, __fmul_rn(sc, bits_to_normal(b1, b2)));
    }
    const float g = __fmul_rn(a, inv_l);
    if (MOM) {
      const float mn = __fadd_rn(__fmul_rn(mu, m[i]), g);
      m[i] = mn;
      p[i] = __fsub_rn(p[i], __fmul_rn(lr, mn));
    } else {
      p[i] = __fsub_rn(p[i], __fmul_rn(lr, g));
    }
  }
}

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, int64_t n,
                                     uint32_t* __restrict__ o0,
                                     uint32_t* __restrict__ o1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) threefry2x32(k0, k1, static_cast<uint32_t>(i), 0u, &o0[i], &o1[i]);
}

template <int NOISE, bool MOM>
void launch(float* p, const float* acc, const float* z, float* m, int64_t n,
            uint32_t k0, uint32_t k1, float sc, float inv_l, float lr,
            float mu, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks/SM
  noisy_sgd_update_kernel<NOISE, MOM><<<static_cast<unsigned>(blocks),
                                        threads, 0, stream>>>(
      p, acc, z, m, n, k0, k1, sc, inv_l, lr, mu);
}

}  // namespace

extern "C" int noisy_sgd_update_launch(float* p, const float* acc,
                                       const float* z, float* m, int64_t n,
                                       int noise_kind, uint32_t k0,
                                       uint32_t k1, float sc, float inv_l,
                                       float lr, float mu, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mom = m != nullptr;
  switch (noise_kind) {
    case kNoiseNone:
      mom ? launch<kNoiseNone, true>(p, acc, z, m, n, k0, k1, sc, inv_l, lr, mu, s)
          : launch<kNoiseNone, false>(p, acc, z, m, n, k0, k1, sc, inv_l, lr, mu, s);
      break;
    case kNoiseOperand:
      mom ? launch<kNoiseOperand, true>(p, acc, z, m, n, k0, k1, sc, inv_l, lr, mu, s)
          : launch<kNoiseOperand, false>(p, acc, z, m, n, k0, k1, sc, inv_l, lr, mu, s);
      break;
    case kNoiseThreefry:
      mom ? launch<kNoiseThreefry, true>(p, acc, z, m, n, k0, k1, sc, inv_l, lr, mu, s)
          : launch<kNoiseThreefry, false>(p, acc, z, m, n, k0, k1, sc, inv_l, lr, mu, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_bits_launch(uint32_t k0, uint32_t k1, int64_t n,
                                    uint32_t* o0, uint32_t* o1, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  threefry_bits_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(k0, k1, n, o0, o1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
