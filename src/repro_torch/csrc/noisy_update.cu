// Fused DP noise + SGD(+momentum) update over every f32 parameter leaf of a
// step, in one launch.
//
// Replaces the TPU kernel `noisy_sgd_update` in the reference package's
// kernels/noisy_update.py (its pallas_call bodies _kernel, _kernel_mom,
// _kernel_plain, _kernel_mom_plain, _kernel_rng_tf, _kernel_mom_rng_tf) and
// the per-leaf loop of its kernels/ops.py:tree_noisy_update.  The TPU-only
// _kernel_rng/_kernel_mom_rng seed the TPU's hardware PRNG and have no
// counterpart here: the in-kernel Threefry-2x32 body replaces them.
//
//   g = (acc + sigma_c * z) * inv_l        (noise-free: g = acc * inv_l)
//   m = mu * m + g;  p = p - lr * m        (no momentum: p = p - lr * g)
//
// Noise source, chosen at launch: none, an f32 operand `z`, or in-kernel
// Threefry-2x32 (20 rounds; counter c0 = the element's index in its leaf,
// c1 = 0; key = the step's two seed words plus the leaf index) followed by
// the reference's Box-Muller `bits_to_normal`, written with logf/sqrtf/cosf
// (no fast-math intrinsics).  Every product and sum is __fmul_rn/__fadd_rn/
// __fsub_rn in the reference's order, so no FMA contraction changes the
// bits: the operand and noise-free forms equal the plain PyTorch version
// bitwise, leaf by leaf.
//
// A noise-only body (noise_kernel) writes the same in-kernel normals into a
// flat buffer for the unfused update path (AdamW, Nesterov, fuse=False), so
// both paths draw one stream.
//
// One launch per step.  The wrapper builds a leaf table once per view and
// per set of parameter tensors and keeps it on the device: per leaf its
// param address, its offset into the flat acc / m / z buffers, its size, its
// index (for the key), the elements before its first 16-byte aligned vector
// (-1: the param and the flat buffers are out of phase, no vectors) and its
// first work item.  A block is one work item, a chunk of kChunk elements of
// one leaf; it finds its leaf by binary search in the table.  The aligned
// head (< 4 elements) goes with a leaf's first chunk, the tail (< 4) with
// its last; both are part of the kernel, taken element by element.
//
// Bound on the H100: bytes.  The momentum form reads p, acc, m and writes
// p, m: 20 B per parameter (24 with a noise operand), 1.72 GB per step for
// ViT-Base's 85.9M parameters, 0.513 ms at 3.35 TB/s; the noise-free
// momentum step moves the same 20 B.  The Threefry body adds about 74 int32
// operations per element (20 rounds of add, funnel-shift rotate and xor, 5
// key injections, the counter and Box-Muller's shifts): 6.4 G operations,
// 0.38 ms at the int32 rate, under the bytes only if the two overlap.  The
// design: 16-byte loads and stores; each thread loads two vectors (8
// elements of p, acc and m) before it computes either, so eight independent
// Threefry chains hide its own loads and the other resident warps' traffic
// keeps HBM busy; rotations are funnel shifts (SHF); the key schedule
// depends only on the block's leaf and the launch's seed words, so it is
// uniform across the block.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kNoiseNone = 0;
constexpr int kNoiseOperand = 1;
constexpr int kNoiseThreefry = 2;
constexpr int kThreads = 256;
constexpr int kVecs = 2;                             // float4s per thread
constexpr int64_t kChunk = kThreads * kVecs * 4;     // elements per item

// one row of the leaf table, as the wrapper writes it (six int64 words)
struct LeafRow {
  int64_t p;        // param address
  int64_t offset;   // into acc, m and z
  int64_t size;
  int64_t leaf;     // leaf index, added to both seed words
  int64_t head;     // elements before the first aligned vector, or -1
  int64_t item0;    // the leaf's first work item
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
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

struct Scalars {
  uint32_t k0, k1;   // the leaf's key
  float sc, inv_l, lr, mu;
};

// element j of the leaf: the reference's arithmetic, one rounding per op
template <int NOISE, bool MOM>
__device__ __forceinline__ void update(float& p, float a, float z, float& m,
                                       uint32_t j, const Scalars& s) {
  if (NOISE == kNoiseOperand) {
    a = __fadd_rn(a, __fmul_rn(s.sc, z));
  } else if (NOISE == kNoiseThreefry) {
    uint32_t b1, b2;
    threefry2x32(s.k0, s.k1, j, 0u, &b1, &b2);
    a = __fadd_rn(a, __fmul_rn(s.sc, bits_to_normal(b1, b2)));
  }
  const float g = __fmul_rn(a, s.inv_l);
  if (MOM) {
    m = __fadd_rn(__fmul_rn(s.mu, m), g);
    p = __fsub_rn(p, __fmul_rn(s.lr, m));
  } else {
    p = __fsub_rn(p, __fmul_rn(s.lr, g));
  }
}

template <int NOISE, bool MOM>
__device__ __forceinline__ void update_scalar(float* p, const float* a,
                                              const float* z, float* m,
                                              int64_t j, const Scalars& s) {
  float pv = p[j];
  float mv = MOM ? m[j] : 0.0f;
  update<NOISE, MOM>(pv, a[j], NOISE == kNoiseOperand ? z[j] : 0.0f, mv,
                     static_cast<uint32_t>(j), s);
  p[j] = pv;
  if (MOM) m[j] = mv;
}

// Grid: one block per work item.  `table` null: the single leaf `single`.
template <int NOISE, bool MOM>
__global__ void __launch_bounds__(kThreads)
    noisy_update_kernel(const LeafRow* __restrict__ table, int n_leaves,
                        LeafRow single, const float* __restrict__ acc,
                        const float* __restrict__ z, float* __restrict__ m,
                        int vec_ok, uint32_t s0, uint32_t s1, float sc,
                        float inv_l, float lr, float mu) {
  const int64_t item = blockIdx.x;
  LeafRow row = single;
  if (table != nullptr) {
    int lo = 0, hi = n_leaves - 1;   // the last row with item0 <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid].item0 <= item) lo = mid; else hi = mid - 1;
    }
    row = table[lo];
  }
  const uint32_t leaf = static_cast<uint32_t>(row.leaf);
  const Scalars s{s0 + leaf, s1 + leaf, sc, inv_l, lr, mu};
  float* p = reinterpret_cast<float*>(row.p);
  const float* a = acc + row.offset;
  const float* zz = NOISE == kNoiseOperand ? z + row.offset : nullptr;
  float* mm = MOM ? m + row.offset : nullptr;
  const int64_t n = row.size;
  const int64_t c = item - row.item0;

  if (row.head < 0) {   // out of phase: the leaf goes element by element
    const int64_t end = (c + 1) * kChunk < n ? (c + 1) * kChunk : n;
    for (int64_t j = c * kChunk + threadIdx.x; j < end; j += kThreads) {
      update_scalar<NOISE, MOM>(p, a, zz, mm, j, s);
    }
    return;
  }
  const int64_t h = row.head;                   // the wrapper keeps h <= n
  const int64_t vend = h + ((n - h) & ~int64_t{3});
  const int64_t v0 = h + c * kChunk;
  if (!vec_ok) {        // a flat buffer off 16 bytes: the same span, scalar
    const int64_t end = v0 + kChunk < vend ? v0 + kChunk : vend;
    for (int64_t j = v0 + threadIdx.x; j < end; j += kThreads) {
      update_scalar<NOISE, MOM>(p, a, zz, mm, j, s);
    }
  } else {
    float4 pv[kVecs], av[kVecs], zv[kVecs] = {}, mv[kVecs] = {};
    int64_t j[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      j[u] = v0 + 4 * (threadIdx.x + u * kThreads);
      if (j[u] < vend) {
        pv[u] = *reinterpret_cast<const float4*>(p + j[u]);
        av[u] = __ldg(reinterpret_cast<const float4*>(a + j[u]));
        if (NOISE == kNoiseOperand) {
          zv[u] = __ldg(reinterpret_cast<const float4*>(zz + j[u]));
        }
        if (MOM) mv[u] = *reinterpret_cast<const float4*>(mm + j[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      if (j[u] < vend) {
        const uint32_t jj = static_cast<uint32_t>(j[u]);
        update<NOISE, MOM>(pv[u].x, av[u].x, zv[u].x, mv[u].x, jj, s);
        update<NOISE, MOM>(pv[u].y, av[u].y, zv[u].y, mv[u].y, jj + 1u, s);
        update<NOISE, MOM>(pv[u].z, av[u].z, zv[u].z, mv[u].z, jj + 2u, s);
        update<NOISE, MOM>(pv[u].w, av[u].w, zv[u].w, mv[u].w, jj + 3u, s);
        *reinterpret_cast<float4*>(p + j[u]) = pv[u];
        if (MOM) *reinterpret_cast<float4*>(mm + j[u]) = mv[u];
      }
    }
  }
  // the unaligned head with the first item, the tail with the last
  if (c == 0 && threadIdx.x < h) {
    update_scalar<NOISE, MOM>(p, a, zz, mm, threadIdx.x, s);
  }
  if (v0 + kChunk >= vend && threadIdx.x < n - vend) {
    update_scalar<NOISE, MOM>(p, a, zz, mm, vend + threadIdx.x, s);
  }
}

// The noise alone, for the unfused update: z[offset + j] <- the normal the
// update above draws for element j of the leaf (Threefry-2x32 at the leaf's
// key, counter (j, 0), then Box-Muller), over the same leaf table and work
// items (the param address is not read).  It replaces the flat
// FlatGradView.noise draw of the reference's generic update path
// (core/engine.py build_update_fn), which must be the fused path's stream.
// Bound on the H100: the same ~74 int32 operations per element as the
// Threefry update, against 4 B written: operations.
__device__ __forceinline__ float leaf_normal(uint32_t k0, uint32_t k1,
                                             uint32_t j) {
  uint32_t b1, b2;
  threefry2x32(k0, k1, j, 0u, &b1, &b2);
  return bits_to_normal(b1, b2);
}

__global__ void __launch_bounds__(kThreads)
    noise_kernel(const LeafRow* __restrict__ table, int n_leaves,
                 float* __restrict__ z, int vec_ok, uint32_t s0,
                 uint32_t s1, int64_t tail_begin, int64_t tail_end) {
  const int64_t item = blockIdx.x;
  if (item == 0) {      // the alignment tail past the last leaf is zero
    for (int64_t j = tail_begin + threadIdx.x; j < tail_end; j += kThreads) {
      z[j] = 0.0f;
    }
  }
  int lo = 0, hi = n_leaves - 1;     // the last row with item0 <= item
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].item0 <= item) lo = mid; else hi = mid - 1;
  }
  const LeafRow row = table[lo];
  const uint32_t k0 = s0 + static_cast<uint32_t>(row.leaf);
  const uint32_t k1 = s1 + static_cast<uint32_t>(row.leaf);
  float* zz = z + row.offset;
  const int64_t n = row.size;
  const int64_t c = item - row.item0;

  if (row.head < 0) {   // out of phase: the leaf goes element by element
    const int64_t end = (c + 1) * kChunk < n ? (c + 1) * kChunk : n;
    for (int64_t j = c * kChunk + threadIdx.x; j < end; j += kThreads) {
      zz[j] = leaf_normal(k0, k1, static_cast<uint32_t>(j));
    }
    return;
  }
  const int64_t h = row.head;
  const int64_t vend = h + ((n - h) & ~int64_t{3});
  const int64_t v0 = h + c * kChunk;
  if (!vec_ok) {
    const int64_t end = v0 + kChunk < vend ? v0 + kChunk : vend;
    for (int64_t j = v0 + threadIdx.x; j < end; j += kThreads) {
      zz[j] = leaf_normal(k0, k1, static_cast<uint32_t>(j));
    }
  } else {
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t j = v0 + 4 * (threadIdx.x + u * kThreads);
      if (j < vend) {
        const uint32_t jj = static_cast<uint32_t>(j);
        float4 o;
        o.x = leaf_normal(k0, k1, jj);
        o.y = leaf_normal(k0, k1, jj + 1u);
        o.z = leaf_normal(k0, k1, jj + 2u);
        o.w = leaf_normal(k0, k1, jj + 3u);
        *reinterpret_cast<float4*>(zz + j) = o;
      }
    }
  }
  if (c == 0 && threadIdx.x < h) {
    zz[threadIdx.x] = leaf_normal(k0, k1, threadIdx.x);
  }
  if (v0 + kChunk >= vend && threadIdx.x < n - vend) {
    const int64_t j = vend + threadIdx.x;
    zz[j] = leaf_normal(k0, k1, static_cast<uint32_t>(j));
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
void launch(int64_t items, const LeafRow* table, int n_leaves,
            const LeafRow& single, const float* acc, const float* z,
            float* m, int vec_ok, uint32_t k0, uint32_t k1, float sc,
            float inv_l, float lr, float mu, cudaStream_t stream) {
  noisy_update_kernel<NOISE, MOM>
      <<<static_cast<unsigned>(items), kThreads, 0, stream>>>(
          table, n_leaves, single, acc, z, m, vec_ok, k0, k1, sc, inv_l, lr,
          mu);
}

int dispatch(int64_t items, const LeafRow* table, int n_leaves,
             const LeafRow& single, const float* acc, const float* z,
             float* m, int vec_ok, int noise_kind, uint32_t k0, uint32_t k1,
             float sc, float inv_l, float lr, float mu, cudaStream_t s) {
  if (items <= 0) return 0;
  if (items > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const bool mom = m != nullptr;
#define NOISY_LAUNCH(KIND)                                                  \
  (mom ? launch<KIND, true>(items, table, n_leaves, single, acc, z, m,      \
                            vec_ok, k0, k1, sc, inv_l, lr, mu, s)           \
       : launch<KIND, false>(items, table, n_leaves, single, acc, z, m,     \
                             vec_ok, k0, k1, sc, inv_l, lr, mu, s))
  switch (noise_kind) {
    case kNoiseNone: NOISY_LAUNCH(kNoiseNone); break;
    case kNoiseOperand: NOISY_LAUNCH(kNoiseOperand); break;
    case kNoiseThreefry: NOISY_LAUNCH(kNoiseThreefry); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NOISY_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements per work item: the wrapper's chunking must agree.
extern "C" int64_t noisy_update_chunk() { return kChunk; }

// One step over every leaf.  `table` is a device array of `n_leaves` rows
// (LeafRow, non-empty leaves in order of item0), `items` the work items of
// all of them.  acc, z (or null) and m (or null) are the flat buffers;
// vec_ok says all three are 16-byte aligned (else the same items go element
// by element).  k0, k1: the step's seed words.
extern "C" int noisy_tree_update_launch(const void* table, int n_leaves,
                                        int64_t items, const float* acc,
                                        const float* z, float* m, int vec_ok,
                                        int noise_kind, uint32_t k0,
                                        uint32_t k1, float sc, float inv_l,
                                        float lr, float mu, void* stream) {
  if (n_leaves <= 0) return 0;
  const LeafRow none{0, 0, 0, 0, -1, 0};
  return dispatch(items, static_cast<const LeafRow*>(table), n_leaves, none,
                  acc, z, m, vec_ok, noise_kind, k0, k1, sc, inv_l, lr, mu,
                  static_cast<cudaStream_t>(stream));
}

// One flat leaf of n elements; the key is (k0, k1) itself.
extern "C" int noisy_sgd_update_launch(float* p, const float* acc,
                                       const float* z, float* m, int64_t n,
                                       int noise_kind, uint32_t k0,
                                       uint32_t k1, float sc, float inv_l,
                                       float lr, float mu, void* stream) {
  if (n <= 0) return 0;
  // vectors where every operand sits at the same phase of 16 bytes as acc
  const uintptr_t ua = reinterpret_cast<uintptr_t>(acc);
  auto in_phase = [ua](const void* q) {
    return q == nullptr || (reinterpret_cast<uintptr_t>(q) - ua) % 16 == 0;
  };
  const bool vec = ua % 4 == 0 && in_phase(p) && in_phase(z) && in_phase(m);
  const int64_t head =
      vec ? std::min<int64_t>(((16 - ua % 16) % 16) / 4, n) : -1;
  const int64_t span = vec ? ((n - head) & ~int64_t{3}) : n;
  const int64_t items = span > 0 ? (span + kChunk - 1) / kChunk : 1;
  const LeafRow single{static_cast<int64_t>(reinterpret_cast<uintptr_t>(p)),
                       0, n, 0, head, 0};
  return dispatch(items, nullptr, 1, single, acc, z, m, 1, noise_kind, k0,
                  k1, sc, inv_l, lr, mu, static_cast<cudaStream_t>(stream));
}

// The noise of one step over every leaf into the flat f32 buffer z, and
// zeros over z[tail_begin, tail_end) (the alignment tail): the table, items
// and seed words as for noisy_tree_update_launch; vec_ok says z is 16-byte
// aligned.
extern "C" int noise_tree_launch(const void* table, int n_leaves,
                                 int64_t items, float* z, int vec_ok,
                                 uint32_t k0, uint32_t k1,
                                 int64_t tail_begin, int64_t tail_end,
                                 void* stream) {
  if (n_leaves <= 0 || items <= 0) return 0;
  if (items > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  noise_kernel<<<static_cast<unsigned>(items), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LeafRow*>(table), n_leaves, z, vec_ok, k0, k1,
      tail_begin, tail_end);
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
