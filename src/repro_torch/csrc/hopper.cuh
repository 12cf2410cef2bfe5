// Hopper (sm_90a) building blocks shared by the tensor-core kernels of this
// directory (flash_attention.cu, moe_gmm.cu, ssd.cu's backward): cp.async into
// 128-byte-swizzled shared-memory tiles, a bf16 tile loader for them, the wgmma
// shared-memory matrix descriptor, and the wgmma fences. kernels/_build.py hashes
// every *.cuh of this directory with each source, so an edit here rebuilds every
// library.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

// Byte offset of 16-byte chunk `c` of row `r` in a tile of `rows` rows: the
// columns in blocks of 64 bf16 (128 bytes), each block rows x 128 bytes, the
// chunk swizzled by the row (wgmma's 128-byte swizzle, on 1024-byte-aligned
// tiles).
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return static_cast<uint32_t>((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// 16 bytes from global to shared memory, bypassing L1; src_bytes < 16 zero-fills
// the rest (0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes from global to shared memory (through L1: a strided gather)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes generic-proxy writes to shared memory (cp.async, st.shared) visible to
// wgmma's async proxy; a barrier must follow before another thread's wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. For a K-major operand the
// leading byte offset is unused (16); for an MN-major one (transpose bit) it is
// the offset between 64-element MN blocks. The stride byte offset is 1024: the
// next 8-row group of the swizzle atom.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup's wgmmas are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 16-byte chunk (8 elements from column c0) of row `r` of a row-major [rows, cols] bf16
// matrix to shared address `dst` (generic `dst_ptr`); a chunk outside the matrix, or
// with `ok` false, is zero and reads nothing. `vec`: cols % 8 == 0 and a 16-byte
// aligned base, so a chunk is wholly in or out (cp.async); otherwise scalar loads and
// one 16-byte store, which the wgmma reader needs fence_proxy_async for as well.
__device__ __forceinline__ void load_chunk(uint32_t dst, uint8_t* dst_ptr,
                                           const __nv_bfloat16* src, int rows, int cols, int r,
                                           int c0, bool ok, bool vec) {
  ok = ok && r < rows && c0 < cols;
  if (vec) {
    cp_async16(dst, ok ? src + static_cast<int64_t>(r) * cols + c0 : src, ok ? 16 : 0);
    return;
  }
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = (ok && c0 + j < cols) ? src[static_cast<int64_t>(r) * cols + c0 + j]
                                 : __float2bfloat16(0.f);
  }
  *reinterpret_cast<uint4*>(dst_ptr) = *reinterpret_cast<const uint4*>(v);
}

}  // namespace hopper
