// Hopper (sm_90a) building blocks shared by the tensor-core kernels of this
// directory (flash_attention.cu, moe_gmm.cu): 16-byte cp.async into
// 128-byte-swizzled shared-memory tiles, the wgmma shared-memory matrix
// descriptor, and the wgmma fences. kernels/_build.py hashes every *.cuh of
// this directory with each source, so an edit here rebuilds both libraries.
#pragma once

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
// Keeps the compiler from moving accesses of accumulator registers across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace hopper
