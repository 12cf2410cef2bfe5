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

}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out, int rows, int d,
                           float eps, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out, int rows, int d,
                            float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}
