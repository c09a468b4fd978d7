// Per-example squared Frobenius norm of a dense layer's weight gradient,
//
//   n[b] = || X_b^T dY_b ||_F^2 = sum_{i,o} (sum_t x[b,t,i] * dy[b,t,o])^2,
//
// without writing the (din, dout) per-example gradient, or any part of it,
// to device memory: the direct path of the Mixed-Ghost rule.
//
// Replaces the TPU kernel `ghost_norm_dense`, its pallas_call body _kernel
// (src/repro/kernels/ghost_norm.py:27-50).  On the TPU the grid (b, i-tile,
// o-tile) ran in order and carried `out[b] += partial` from one grid step
// to the next.  Blocks on Hopper run in parallel, so each block writes the
// sum of squares of its output tile into a (B, n_tiles) partial buffer and
// takes an integer ticket for its example; the block that takes the last
// ticket of b sums that row of partials in tile order, writes n[b] and
// resets the ticket.  One launch per call, no float atomics: reruns are
// bit-identical.
//
// Bound on the H100.  The product's 2 B T din dout multiply-adds count at
// the tensor cores' bf16 rate (989 TFLOP/s): a product of two bf16 values
// is exact in f32, so bf16 operands with f32 accumulation compute the same
// function as the f32 product of the upcast records; the 2 B din dout
// square-and-adds count at f32's 67 TFLOP/s; the bytes are the inputs, read
// once.  At ViT-Base's block shapes (T = 197) that is 8-32 us, bound by
// operations; at the head (T = 1) it is below a microsecond and the launch
// itself is the cost.
//
// bf16 inputs (the tape's records): the product runs on the tensor cores,
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators in registers.
// Both operands have the reduction axis T as the slow axis in memory (X_b is
// (T, din), dY_b (T, dout), both MN-major); ldmatrix.trans turns their
// shared-memory tiles into the row-major A and column-major B fragments.
// mma.sync rather than wgmma: wgmma's shared-memory descriptors for
// MN-major operands need the canonical swizzled layouts, and the tile loop
// here is short (13 k-steps at T = 197), so the simpler instruction already
// sits far under the library yardstick.  A block owns a 128 x 128 output
// tile (8 warps of 64 x 32); T is streamed in slabs of 32 rows through a
// 3-stage cp.async ring (16-byte copies; rows padded by 16 bytes so that
// ldmatrix is conflict-free).  The ragged edges are zero-filled on load:
// T past its end by the copy's zero fill, din and dout by whole 16-byte
// chunks when they are multiples of 8, else element by element.  Zero rows
// and columns add exact zeros, so nothing is padded in memory.  A slab runs
// only the 16-row k-steps that hold data: at T = 1, one k-step.  The
// tensor cores' own f32 accumulation does not round to nearest: carried
// over all of T in the MMA's accumulators, n drifted low with T, to within
// reach of the 1e-5 tolerance at T = 4096.  So each k-step's MMA starts
// from zero and its 16-term sums are added to the f32 accumulators with
// round-to-nearest adds, which keeps n as close to an f64 product as
// cuBLAS's f32 product is (chip_smoke.py measures both).  The epilogue
// squares the accumulator fragment in registers and reduces it in a fixed
// order.
//
// f32 inputs (f32 activations): the CUDA-core body stays.  TF32 would round
// the inputs to 10 mantissa bits and so compute another function; the
// product counts at f32's rate.  One block of 256 threads per (b, 64 x 64
// tile), T in slabs of 32 rows through shared memory, a 4 x 4 register tile
// per thread (rows ty + 16 r, columns tx + 16 c, conflict-free), the same
// ticket epilogue.  nvcc may contract its products into FMAs; no caller
// needs these bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the f32 CUDA-core body
constexpr int kTileI = 64;
constexpr int kTileO = 64;
constexpr int kTileT = 32;

// the bf16 tensor-core body
constexpr int kMmaI = 128;            // output tile rows (din)
constexpr int kMmaO = 128;            // output tile columns (dout)
constexpr int kSlab = 32;             // T rows per stage
constexpr int kStages = 3;
constexpr int kPad = 8;               // bf16 per row of padding (16 bytes)
constexpr int kRowX = kMmaI + kPad;
constexpr int kRowD = kMmaO + kPad;
constexpr int kStageElems = kSlab * (kRowX + kRowD);
constexpr int kSmemBytes = kStages * kStageElems * 2;

// fixed-order block sum of one float per thread; the result is valid in
// thread 0
__device__ __forceinline__ float block_sum(float s, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  }
  return total;
}

// The block's partial into row b; the block with b's last ticket sums the
// row in tile order into out[b] and resets the ticket for the next call.
__device__ __forceinline__ void finish(float partial, int b, int tile,
                                       int n_tiles, float* partials,
                                       unsigned* tickets, float* out,
                                       float* red) {
  __shared__ int last;
  float* row = partials + static_cast<int64_t>(b) * n_tiles;
  if (threadIdx.x == 0) {
    row[tile] = partial;
    __threadfence();
    last = atomicAdd(&tickets[b], 1u) == static_cast<unsigned>(n_tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int k = threadIdx.x; k < n_tiles; k += kThreads) s += __ldcg(&row[k]);
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) {
    out[b] = total;
    tickets[b] = 0u;
  }
}

// ---------------------------------------------------------------- f32 ----

__global__ void __launch_bounds__(kThreads)
    ghost_norm_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ dy,
                          float* __restrict__ partials,
                          unsigned* __restrict__ tickets,
                          float* __restrict__ out, int t_len, int din,
                          int dout, int n_tiles_o) {
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
  const float* xb = x + static_cast<int64_t>(b) * t_len * din;
  const float* db = dy + static_cast<int64_t>(b) * t_len * dout;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }
  for (int t0 = 0; t0 < t_len; t0 += kTileT) {
    const int rows = min(kTileT, t_len - t0);   // no work on rows past T
    for (int e = tid; e < rows * kTileI; e += kThreads) {
      const int t = e / kTileI, i = e % kTileI;
      const int ig = i0 + i;
      xs[t][i] = ig < din ? xb[static_cast<int64_t>(t0 + t) * din + ig]
                          : 0.0f;
    }
    for (int e = tid; e < rows * kTileO; e += kThreads) {
      const int t = e / kTileO, o = e % kTileO;
      const int og = o0 + o;
      ds[t][o] = og < dout ? db[static_cast<int64_t>(t0 + t) * dout + og]
                           : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < rows; ++t) {
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
  finish(block_sum(s, red), b, tile, gridDim.x, partials, tickets, out, red);
}

// --------------------------------------------------------------- bf16 ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One T slab of one operand, rows [t0, t0 + kSlab) and columns [c0, c0 +
// width) of a (T, cols) matrix, into a (kSlab, width + kPad) stage; zeros
// past T and past cols.  `vec`: cols % 8 == 0 and a 16-byte aligned base,
// so a 16-byte chunk is wholly inside or wholly outside.
template <int kWidth>
__device__ __forceinline__ void load_slab(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int t0,
                                          int t_len, int c0, int cols,
                                          bool vec) {
  constexpr int kRow = kWidth + kPad;
  if (vec) {
    constexpr int kChunks = kSlab * kWidth / 8;
    static_assert(kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
    for (int k = 0; k < kChunks / kThreads; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int t = e / (kWidth / 8), c = (e % (kWidth / 8)) * 8;
      const bool ok = t0 + t < t_len && c0 + c < cols;
      const __nv_bfloat16* g =
          ok ? src + static_cast<int64_t>(t0 + t) * cols + c0 + c : src;
      cp_async16(smem_addr(dst + t * kRow + c), g, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int e = threadIdx.x; e < kSlab * kWidth; e += kThreads) {
      const int t = e / kWidth, c = e % kWidth;
      dst[t * kRow + c] =
          t0 + t < t_len && c0 + c < cols
              ? src[static_cast<int64_t>(t0 + t) * cols + c0 + c]
              : zero;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    ghost_norm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ dy,
                           float* __restrict__ partials,
                           unsigned* __restrict__ tickets,
                           float* __restrict__ out, int t_len, int din,
                           int dout, int n_tiles_o, int x_vec, int d_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float red[kThreads / 32];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int i0 = (tile / n_tiles_o) * kMmaI;
  const int o0 = (tile % n_tiles_o) * kMmaO;
  const __nv_bfloat16* xb = x + static_cast<int64_t>(b) * t_len * din;
  const __nv_bfloat16* db = dy + static_cast<int64_t>(b) * t_len * dout;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wi = (warp & 1) * 64;     // the warp's 64 rows of the tile
  const int wo = (warp >> 1) * 32;    // and its 32 columns
  // ldmatrix: lane l addresses row (l & 7) of 8 x 8 matrix l >> 3
  const int q = lane >> 3, r = lane & 7;
  const int a_k = r + ((q >> 1) << 3), a_i = (q & 1) << 3;
  const int b_k = r + ((q & 1) << 3), b_o = (q >> 1) << 3;

  auto xs = [&](int st) { return smem + st * kStageElems; };
  auto ds = [&](int st) { return smem + st * kStageElems + kSlab * kRowX; };
  auto load = [&](int slab, int st) {
    load_slab<kMmaI>(xs(st), xb, slab * kSlab, t_len, i0, din, x_vec);
    load_slab<kMmaO>(ds(st), db, slab * kSlab, t_len, o0, dout, d_vec);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    }
  }
  const int n_slabs = (t_len + kSlab - 1) / kSlab;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_slabs) load(st, st);
    cp_async_commit();
  }
  for (int slab = 0; slab < n_slabs; ++slab) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slab's stage is in; slab - 1's stage is free
    const int next = slab + kStages - 1;
    if (next < n_slabs) load(next, next % kStages);
    cp_async_commit();
    const __nv_bfloat16* xt = xs(slab % kStages);
    const __nv_bfloat16* dt = ds(slab % kStages);
    // only the 16-row k-steps that hold rows of T
    const int ksteps = min(kSlab / 16, (t_len - slab * kSlab + 15) / 16);
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4_trans(
            smem_addr(xt + (kk * 16 + a_k) * kRowX + wi + mi * 16 + a_i),
            af[mi]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        ldmatrix_x4_trans(
            smem_addr(dt + (kk * 16 + b_k) * kRowD + wo + nj * 16 + b_o),
            bf[nj]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          // this k-step's 16-term sums from zero, then one
          // round-to-nearest add into the f32 accumulators
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(d, af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], d[e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  float s = 0.0f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s += acc[mi][ni][e] * acc[mi][ni][e];
    }
  }
  finish(block_sum(s, red), b, tile, gridDim.x, partials, tickets, out, red);
}

}  // namespace

// Output tiles per example, the width of a row of partials.
extern "C" int ghost_norm_dense_tiles(int din, int dout, int is_bf16) {
  const int ti = is_bf16 ? kMmaI : kTileI, to = is_bf16 ? kMmaO : kTileO;
  return ((din + ti - 1) / ti) * ((dout + to - 1) / to);
}

// x (B, T, din), dy (B, T, dout), both f32 or both bf16, contiguous;
// partials: B * ghost_norm_dense_tiles(...) f32 scratch; tickets: B zeroed
// uint32 (left zeroed); out (B,) f32.  One launch.  Returns the CUDA error
// code of the launch.
extern "C" int ghost_norm_dense_launch(const void* x, const void* dy,
                                       int is_bf16, float* partials,
                                       unsigned* tickets, float* out,
                                       int batch, int t_len, int din,
                                       int dout, void* stream) {
  if (batch <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = ghost_norm_dense_tiles(din, dout, is_bf16);
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
  if (is_bf16) {
    const int n_tiles_o = (dout + kMmaO - 1) / kMmaO;
    const int x_vec = din % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int d_vec =
        dout % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    // above 48 KB of dynamic shared memory: allowed once per device
    static bool allowed[64] = {};
    int d = 0;
    cudaError_t err = cudaGetDevice(&d);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (d < 0 || d >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!allowed[d]) {
      err = cudaFuncSetAttribute(ghost_norm_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[d] = true;
    }
    ghost_norm_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), partials, tickets, out, t_len,
        din, dout, n_tiles_o, x_vec, d_vec);
  } else {
    const int n_tiles_o = (dout + kTileO - 1) / kTileO;
    ghost_norm_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        partials, tickets, out, t_len, din, dout, n_tiles_o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
