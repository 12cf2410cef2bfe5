// Grouped (per-expert) matrix product for Hopper (sm_90a): the MoE expert FFN.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:moe_gmm (_gmm_kernel):
// out[e] = xe[e] @ we[e] for every expert e, xe [E, C, D], we [E, D, F],
// out [E, C, F], accumulated in float32 and written in xe's dtype. The TPU
// kernel pads C, D and F to block multiples; this one masks the ragged edges
// itself (zeros in shared memory, stores guarded by C and F).
//
// Bound on the H100: bytes, at the serving path's shapes. The expert weights
// (E*D*F elements) dominate what a call moves: at decode (C = 8) a call does
// 2*C = 16 operations per weight element read, at prefill (C = 160) 320, near
// the card's ~295 bf16 operations per byte either way, so the design reads
// each weight element from device memory once per call.
//
// Design (simple; wgmma and TMA are left for a later change): one block of
// 4 warps per (64-column F tile, row tile of C, expert). A row tile holds up
// to 160 rows (MF = 1..10 fragments of 16), so for C <= 160 every weight
// tile is read by exactly one block; rows past C are zeros in shared memory
// (C = 8 fills half of one 16-row fragment). The block walks D in steps of
// BK: it stages xe[e, rows, k0:k0+BK] and we[e, k0:k0+BK, cols] in shared
// memory (16-byte loads where a row is 16-byte aligned, scalar loads where it
// is not; threads load along the contiguous axis, F for the weights), then
//   bf16:    each warp owns one 16-column fragment and MF row fragments and
//            multiplies on the tensor cores with nvcuda::wmma 16x16x16 into
//            float32 accumulators;
//   float32: each thread owns one column and MF*8 rows and multiplies on the
//            CUDA cores (there are no float32 tensor cores).
// Blocks of one expert are adjacent in launch order, so the xe rows they
// share come from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBN = 64;        // F columns per block: one 16-wide fragment per warp
constexpr int kMaxMF = 10;     // row fragments of 16 per block: up to 160 rows of C

__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, bf16* out) { *out = __float2bfloat16(v); }

// Stage rows [r0, r0 + NR) x cols [c0, c0 + NC) of a row-major [rows, cols]
// matrix into dst [NR][ld]; entries outside the matrix become zero. With
// `vec`, cols is a multiple of the 16-byte vector and src is 16-byte aligned,
// so a vector is either wholly inside the matrix or wholly outside.
template <typename T, int NR, int NC>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src, int rows,
                                          int cols, int r0, int c0, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(NC % kVec == 0, "tile width");
  if (vec) {
    for (int i = threadIdx.x; i < NR * NC / kVec; i += kThreads) {
      const int r = i / (NC / kVec), c = (i % (NC / kVec)) * kVec;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows && c0 + c < cols) {
        v = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r0 + r) * cols + c0 + c);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < NR * NC; i += kThreads) {
      const int r = i / NC, c = i % NC;
      T v;
      from_float(0.f, &v);
      if (r0 + r < rows && c0 + c < cols) v = src[static_cast<int64_t>(r0 + r) * cols + c0 + c];
      dst[r * ld + c] = v;
    }
  }
}

template <int MF>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const bf16* __restrict__ xe, const bf16* __restrict__ we, bf16* __restrict__ out,
                int c, int d, int f, bool vec_x, bool vec_w) {
  using namespace nvcuda;
  constexpr int kBM = 16 * MF, kBK = 64;
  constexpr int kLdA = kBK + 8, kLdB = kBN + 8;  // +8: rows start on other banks; wmma
                                                 // needs a multiple of 8 elements
  __shared__ __align__(32) bf16 as[kBM * kLdA];
  __shared__ __align__(32) bf16 bs[kBK * kLdB];
  __shared__ __align__(32) float cs[kThreads / 32][16 * 16];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* xb = xe + static_cast<int64_t>(e) * c * d;
  const bf16* wb = we + static_cast<int64_t>(e) * d * f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF];
#pragma unroll
  for (int i = 0; i < MF; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int k0 = 0; k0 < d; k0 += kBK) {
    load_tile<bf16, kBM, kBK>(as, kLdA, xb, c, d, m0, k0, vec_x);
    load_tile<bf16, kBK, kBN>(bs, kLdB, wb, d, f, k0, n0, vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b_frag;
      wmma::load_matrix_sync(b_frag, bs + kk * kLdB + warp * 16, kLdB);
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a_frag;
        wmma::load_matrix_sync(a_frag, as + i * 16 * kLdA + kk, kLdA);
        wmma::mma_sync(acc[i], a_frag, b_frag, acc[i]);
      }
    }
    __syncthreads();
  }

  // Each fragment goes through the warp's own 16x16 float scratch, so the
  // stores can be guarded against rows past C and columns past F.
  float* scratch = cs[warp];
  const int r = lane / 2, c8 = (lane % 2) * 8;
  const int col = n0 + warp * 16 + c8;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    wmma::store_matrix_sync(scratch, acc[i], 16, wmma::mem_row_major);
    __syncwarp();
    const int row = m0 + i * 16 + r;
    if (row < c) {
      bf16* o = out + (static_cast<int64_t>(e) * c + row) * f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col + j < f) o[col + j] = __float2bfloat16(scratch[r * 16 + c8 + j]);
      }
    }
    __syncwarp();
  }
}

template <int MF>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ xe, const float* __restrict__ we, float* __restrict__ out,
               int c, int d, int f, bool vec_x, bool vec_w) {
  constexpr int kBM = 16 * MF, kBK = 32;
  constexpr int kGroups = kThreads / kBN;  // row groups: thread rows g, g + 2, g + 4, ...
  constexpr int kRows = kBM / kGroups;
  __shared__ __align__(16) float as[kBM * kBK];
  __shared__ __align__(16) float bs[kBK * kBN];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int col = threadIdx.x % kBN, grp = threadIdx.x / kBN;
  const float* xb = xe + static_cast<int64_t>(e) * c * d;
  const float* wb = we + static_cast<int64_t>(e) * d * f;

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    load_tile<float, kBM, kBK>(as, kBK, xb, c, d, m0, k0, vec_x);
    load_tile<float, kBK, kBN>(bs, kBN, wb, d, f, k0, n0, vec_w);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float b = bs[k * kBN + col];  // a warp reads 32 neighbouring columns
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[i] = fmaf(as[(grp + kGroups * i) * kBK + k], b, acc[i]);  // one row: broadcast
      }
    }
    __syncthreads();
  }

  if (n0 + col < f) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = m0 + grp + kGroups * i;
      if (row < c) out[(static_cast<int64_t>(e) * c + row) * f + n0 + col] = acc[i];
    }
  }
}

// Row fragments per block for C rows: the fewest instantiated that hold C,
// else the largest (C > 160 then takes several row tiles).
int pick_mf(int c) {
  constexpr int kChoices[] = {1, 2, 4, 6, 8};
  const int frags = (c + 15) / 16;
  for (int mf : kChoices) {
    if (frags <= mf) return mf;
  }
  return kMaxMF;
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, int, int, int, bool, bool);

template <typename T>
KernelFn<T> kernel_for(int mf);

template <>
KernelFn<bf16> kernel_for<bf16>(int mf) {
  switch (mf) {
    case 1: return gmm_bf16_kernel<1>;
    case 2: return gmm_bf16_kernel<2>;
    case 4: return gmm_bf16_kernel<4>;
    case 6: return gmm_bf16_kernel<6>;
    case 8: return gmm_bf16_kernel<8>;
    default: return gmm_bf16_kernel<kMaxMF>;
  }
}

template <>
KernelFn<float> kernel_for<float>(int mf) {
  switch (mf) {
    case 1: return gmm_f32_kernel<1>;
    case 2: return gmm_f32_kernel<2>;
    case 4: return gmm_f32_kernel<4>;
    case 6: return gmm_f32_kernel<6>;
    case 8: return gmm_f32_kernel<8>;
    default: return gmm_f32_kernel<kMaxMF>;
  }
}

template <typename T>
int launch(const void* xe, const void* we, void* out, int e, int c, int d, int f, void* stream) {
  if (e < 0 || c < 0 || d < 0 || f < 0 || e > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0 || c == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_x = d % kVec == 0 && reinterpret_cast<uintptr_t>(xe) % 16 == 0;
  const bool vec_w = f % kVec == 0 && reinterpret_cast<uintptr_t>(we) % 16 == 0;
  const int mf = pick_mf(c);
  const int rows_per_block = 16 * mf;
  dim3 grid((f + kBN - 1) / kBN, (c + rows_per_block - 1) / rows_per_block, e);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel_for<T>(mf)<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xe), static_cast<const T*>(we), static_cast<T*>(out), c, d, f, vec_x,
      vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int moe_gmm_bf16(const void* xe, const void* we, void* out, int e, int c, int d, int f,
                            void* stream) {
  return launch<bf16>(xe, we, out, e, c, d, f, stream);
}

extern "C" int moe_gmm_f32(const void* xe, const void* we, void* out, int e, int c, int d, int f,
                           void* stream) {
  return launch<float>(xe, we, out, e, c, d, f, stream);
}
