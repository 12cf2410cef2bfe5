// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * scale, statistics in
// float32, output in x's dtype, x flattened to [rows, D].
//
// Bound on the H100: bytes. It reads each row and the scale once and writes
// the row once, at about one operation per byte, far below the card's
// ~295 bf16 operations per byte of memory traffic.
//
// Design: one block per row. Each thread loads 16 bytes at a time (8 bf16 or
// 4 float), neighbouring threads on neighbouring addresses, and sums squares
// in float32; a warp shuffle reduction and one pass through shared memory
// give the row's sum. The second pass re-reads the row, which the first pass
// has just brought into L1/L2, so device memory sees the row once. A row
// that is not 16-byte aligned takes a scalar loop.
//
// The backward (rmsnorm_backward_*; the TPU kernel has none: XLA differentiates
// the jnp norm), the formula of kernels/rmsnorm.py:plain_backward: with
// r = rsqrt(mean(x^2) + eps), x^ = x * r and gs = g * scale,
// dx = r * (gs - x^ * mean(gs * x^)) and dscale = sum over rows of g * x^. Bound by
// bytes as the forward: x, g and dx once each, about eight operations an element.
// Two launches, no atomics, so a run repeats bitwise:
//   1. rmsnorm_bwd_rows<T>: a block of one warp group (128 threads) walks rows
//      blockIdx.x, blockIdx.x + gridDim.x, ...; for each it reads x, g and scale with
//      16-byte loads, sums x^2 and gs * x in float32 (one block reduction for both),
//      then re-reads the row (from L1/L2) to write dx and to add g * x^ into the
//      block's float32 column sums, which each thread keeps for its own columns in
//      shared memory. The block then writes them to the workspace row
//      partial[blockIdx.x, :]. The wrapper fixes the grid (kernels/rmsnorm.py:
//      backward_blocks), so the sums do not depend on the card.
//   2. rmsnorm_bwd_scale<T>: one thread a column sums the workspace over the blocks
//      in order into dscale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int d, float eps, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;

  float sq = 0.f;
  if (vec) {
    for (int i = threadIdx.x * kVec; i < d; i += kThreads * kVec) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_float(e[j]);
        sq += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_float(xr[i]);
      sq += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(sq) / d + eps);

  if (vec) {
    for (int i = threadIdx.x * kVec; i < d; i += kThreads * kVec) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      uint4 sraw = *reinterpret_cast<const uint4*>(scale + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) from_float(to_float(e[j]) * inv * to_float(s[j]), &o[j]);
      *reinterpret_cast<uint4*>(outr + i) = oraw;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      from_float(to_float(xr[i]) * inv * to_float(scale[i]), &outr[i]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
           void* stream) {
  // 16-byte loads need 16-byte aligned rows: aligned pointers and D a
  // multiple of the vector width
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(x) |
                              reinterpret_cast<uintptr_t>(scale) |
                              reinterpret_cast<uintptr_t>(out);
  const bool vec = (addr_bits % 16) == 0 && (d % (16 / sizeof(T))) == 0;
  if (rows > 0) {
    rmsnorm_kernel<T><<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), d, eps,
        vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 128;

// (sum of a, sum of b) over the block; every thread gets both, and the block may call it
// again at once.
__device__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[kBwdThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
  for (int w = 0; w < kBwdThreads / 32; ++w) {
    total.x += warp_sums[w].x;
    total.y += warp_sums[w].y;
  }
  __syncthreads();  // every thread has read warp_sums before the next call writes it
  return total;
}

// Calls f(i, n) for the runs of n elements from column i that this thread owns: 16 bytes
// a run where `vec`, one element otherwise. The same columns on every call.
template <typename T, typename F>
__device__ __forceinline__ void own_columns(int d, bool vec, F f) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    for (int i = threadIdx.x * kVec; i < d; i += kBwdThreads * kVec) f(i, kVec);
  } else {
    for (int i = threadIdx.x; i < d; i += kBwdThreads) f(i, 1);
  }
}

template <typename T>
__device__ __forceinline__ void load_run(const T* p, int n, float* out) {
  constexpr int kVec = 16 / sizeof(T);
  if (n == kVec) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = to_float(e[j]);
  } else {
    out[0] = to_float(p[0]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ g,
                 T* __restrict__ dx, float* __restrict__ partial, int rows, int d, float eps,
                 bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float col_sum[];  // [d]: this block's sum of g * x^, by column
  own_columns<T>(d, vec, [&](int i, int n) {
    for (int j = 0; j < n; ++j) col_sum[i + j] = 0.f;
  });
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<int64_t>(row) * d;
    const T* gr = g + static_cast<int64_t>(row) * d;
    T* dxr = dx + static_cast<int64_t>(row) * d;
    float sq = 0.f, dot = 0.f;  // sum of x^2, sum of gs * x
    own_columns<T>(d, vec, [&](int i, int n) {
      float xv[kVec], gv[kVec], sv[kVec];
      load_run(xr + i, n, xv);
      load_run(gr + i, n, gv);
      load_run(scale + i, n, sv);
      for (int j = 0; j < n; ++j) {
        sq += xv[j] * xv[j];
        dot += gv[j] * sv[j] * xv[j];
      }
    });
    const float2 sums = block_sum2(sq, dot);
    const float r = rsqrtf(sums.x / d + eps);
    const float mean = r * sums.y / d;  // mean(gs * x^)
    own_columns<T>(d, vec, [&](int i, int n) {
      float xv[kVec], gv[kVec], sv[kVec];
      load_run(xr + i, n, xv);
      load_run(gr + i, n, gv);
      load_run(scale + i, n, sv);
      __align__(16) T out[kVec];
      for (int j = 0; j < n; ++j) {
        const float xh = xv[j] * r;
        from_float(r * (gv[j] * sv[j] - xh * mean), &out[j]);
        col_sum[i + j] += gv[j] * xh;
      }
      if (n == kVec) {
        *reinterpret_cast<uint4*>(dxr + i) = *reinterpret_cast<const uint4*>(out);
      } else {
        dxr[i] = out[0];
      }
    });
  }
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  own_columns<T>(d, vec, [&](int i, int n) {
    for (int j = 0; j < n; ++j) prow[i + j] = col_sum[i + j];
  });
}

template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_bwd_scale(const float* __restrict__ partial, T* __restrict__ dscale, int blocks, int d) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= d) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += partial[static_cast<int64_t>(b) * d + col];
  from_float(sum, &dscale[col]);
}

template <typename T>
int launch_backward(const void* x, const void* scale, const void* g, void* dx, void* dscale,
                    void* partial, int rows, int d, int blocks, float eps, void* stream) {
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                              reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx);
  const bool vec = (addr_bits % 16) == 0 && (d % (16 / sizeof(T))) == 0;
  const int smem = d * static_cast<int>(sizeof(float));
  if (blocks <= 0 || (rows > 0 && blocks > rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(rmsnorm_bwd_rows<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0 && d > 0) {
    rmsnorm_bwd_rows<T><<<blocks, kBwdThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(g),
        static_cast<T*>(dx), static_cast<float*>(partial), rows, d, eps, vec);
  }
  if (d > 0) {
    rmsnorm_bwd_scale<T><<<(d + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<T*>(dscale), rows > 0 ? blocks : 0, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out, int rows, int d,
                           float eps, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out, int rows, int d,
                            float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}

// The backward: x, scale, g (the output's gradient) -> dx, dscale in x's dtype, with
// `partial` a float32 [blocks, d] workspace (0 < blocks <= rows). Two launches on `stream`.
extern "C" int rmsnorm_backward_f32(const void* x, const void* scale, const void* g, void* dx,
                                    void* dscale, void* partial, int rows, int d, int blocks,
                                    float eps, void* stream) {
  return launch_backward<float>(x, scale, g, dx, dscale, partial, rows, d, blocks, eps, stream);
}

extern "C" int rmsnorm_backward_bf16(const void* x, const void* scale, const void* g, void* dx,
                                     void* dscale, void* partial, int rows, int d, int blocks,
                                     float eps, void* stream) {
  return launch_backward<__nv_bfloat16>(x, scale, g, dx, dscale, partial, rows, d, blocks, eps,
                                        stream);
}
