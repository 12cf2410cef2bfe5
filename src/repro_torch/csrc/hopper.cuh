// Hopper (sm_90a) building blocks shared by the tensor-core kernels of this
// directory (flash_attention.cu, moe_gmm.cu, ssd.cu's backward): cp.async into
// 128-byte-swizzled shared-memory tiles, a bf16 tile loader for them, the wgmma
// shared-memory matrix descriptor, and the wgmma fences; for warp-specialised kernels,
// mbarriers, TMA and bulk copies, setmaxnreg, named barriers and the acquire/release
// flags of an ordered cross-block sum, every spin-wait bounded. kernels/_build.py hashes
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

// ----- warp specialisation: mbarriers, TMA and bulk copies, registers, flags -----

// The global timer in nanoseconds: every spin-wait below gives up after kSpinLimitNs and
// traps, so a protocol fault fails the launch instead of hanging the card.
__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
constexpr uint64_t kSpinLimitNs = 20000000000ull;  // 20 s

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// After every mbar_init, before any thread of the block uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival that also expects `bytes` of TMA or bulk-copy traffic before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits for the end of the barrier's phase of parity `parity` (a fresh barrier is in phase
// 0; a wait for parity 1 passes at once, as a producer's first wait for an empty slot).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(bar, parity)) {
    if (globaltimer() - t0 > kSpinLimitNs) __trap();
  }
}

// A box of a 4-d tensor map (coordinates innermost first) into shared memory at `dst`,
// its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to shared memory,
// counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Shared to global memory: a copy, or an add of float32 elements into what is there. Each
// is one bulk group (bulk_commit); bulk_wait_all waits until the writes are done.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_add_f32(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
// A box of shared memory out to a 4-d tensor map (elements past the tensor's edge are not
// written), one bulk group; bulk_wait_read_all waits until shared memory may be reused.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's global accesses through the async proxy (TMA, bulk copies) with
// its ordinary ones.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Register reallocation between warpgroups: all four warps of a warpgroup execute it, in a
// branch that never rejoins the other roles' code (or ptxas ignores it: C7508).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Barrier `id` (1..15; 0 is __syncthreads) of `count` threads, a multiple of 32.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The flags of a sum taken in a fixed order across blocks: a writer waits until the flag
// counts the writers before it (acquire), adds, and publishes the next count (release).
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void wait_flag(const int* p, int want) {
  if (ld_acquire(p) == want) return;
  const uint64_t t0 = globaltimer();
  while (ld_acquire(p) != want) {
    __nanosleep(64);
    if (globaltimer() - t0 > kSpinLimitNs) __trap();
  }
}

}  // namespace hopper
