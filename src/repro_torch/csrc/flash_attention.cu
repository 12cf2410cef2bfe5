// Flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (called through flash_attention): GQA attention with an online softmax in
// float32, a causal mask, a sliding window, padded KV columns masked through
// sk_valid, and fully masked KV tiles skipped. q [B, Sq, Hq, dh], k/v
// [B, Sk, Hkv, dh], out [B, Sq, Hq, dh] in q's dtype. Unlike the TPU kernel,
// `window` is a runtime argument (<= 0 means full attention), as the model's
// per-layer windows need. Masked scores take the finite sentinel -1e30, and
// they are masked before the exponential.
//
// Bound on the H100: operations. Causal prefill does ~2*Sq*Sk*dh*Hq flops
// over ~(Sq*Hq + 2*Sk*Hkv)*dh elements, thousands of operations per byte at
// Sq = Sk = 1024, far above the card's ~295 bf16 operations per byte. Only
// the tensor cores reach that rate, and on Hopper only through wgmma.
//
// Two kernels; the wrapper (kernels/flash_attention.py:kernel_for) chooses by
// (dtype, head_dim), never by catching a failure:
//
// 1. flash_kernel_wgmma<DH>, bf16 at head_dim 64 and 128 (every served model).
//    One block of two warpgroups (256 threads) per (query head, 128 query
//    positions, batch), the last positions' blocks (the most KV tiles under
//    the causal mask) scheduled first; each warpgroup owns 64 query rows of
//    the head, and the KV head is h / G. Tiling by query head keeps the causal and window masks on a
//    per-tile diagonal, so whole tiles skip, and serves any G without idle
//    rows; the G-fold re-read of a K/V tile comes from the L2. The Q tile is
//    staged once; K and V tiles of 64 positions stream through a two-stage
//    shared-memory ring with 16-byte cp.async.cg, written in the 128-byte
//    swizzled layout that wgmma's shared-memory descriptors read (each 64-wide
//    column block a region of rows x 128 bytes, 16-byte chunk c of row r at
//    c ^ (r % 8)); tile t+1 loads while tile t computes. S = Q K^T is
//    wgmma m64n64k16 with Q and K from shared memory (K stored [kb, dh] is
//    K-major for the B operand). The online softmax runs on the m64n64
//    accumulator fragments in registers: the four lanes that share a row
//    reduce its max with two shuffles, each thread keeps a partial row sum
//    that is reduced once at the end, and the mask is applied only on tiles
//    that cross the diagonal, the window's edge or Sk. O += P V is wgmma with
//    P from registers (the accumulator layout of S is the A-fragment layout
//    of P, two columns per 32-bit register) and V from shared memory as an
//    MN-major B operand (the transpose bit), one m64n64k16 per 64 columns of
//    dh. P is rounded to bf16 before PV, as every tensor-core flash kernel
//    does; the Pallas kernel keeps P in float32 (the bf16 tolerance, 3e-2,
//    covers it). The epilogue divides by max(l, 1e-30), rounds to bf16 and
//    writes through shared memory (the Q tile's space) with coalesced 16-byte
//    stores; rows past Sq are never written. No TMA and no warp
//    specialisation: loads are issued by the same threads between tiles.
//
// 2. flash_kernel_simt<T>, float32, and bf16 at other head dims (<= 128): the
//    CUDA-core kernel. One block of 128 threads per (q tile, kv_head, batch);
//    the block's 64 rows are the G query heads of the GQA group times 64/G
//    query positions, so each K/V tile is read once for the group. Q is
//    staged in shared memory once as float32; K and V tiles of 32 positions
//    stream through shared memory. Each thread owns a 4x4 micro-tile of the
//    64x32 score tile and a 4x16 micro-tile of the 64xdh accumulator; the 8
//    threads that share a row reduce its max and sum with warp shuffles. Rows
//    past Sq compute on zeros and are never written.
//
// Both forward kernels take an optional float32 `lse` [B, Hq, Sq]: where it is not
// null they write each row's logsumexp of its scaled scores (natural units), -inf
// for a row that allows no key (Sq > Sk + window - 1), for the backward. A null
// `lse` writes nothing, so serving launches exactly what it did without it.
//
// The backward (flash_attention_backward_*; the TPU kernel has none: XLA
// differentiates repro/models/attention.py:chunked_attention), the formula of
// kernels/flash_attention.py:plain_backward, FlashAttention-2's split without float
// atomics, so a run repeats bitwise. Three launches:
//   a. flash_bwd_delta<T>: D = rowsum(dO * O) in float32, one warp a row, into a
//      float32 workspace [B, Hq, Sq].
//   b. dK and dV: one block per (key block, KV head, batch) keeps its keys' dK and dV
//      in registers and walks, for each of the G query heads of its KV head in turn,
//      the query blocks its mask lets reach its keys (causal, windowed, Sq != Sk as
//      in kernels/flash_attention.py:allowed_pairs): it recomputes
//      P = exp(scale * Q K^T - lse), then dV += P^T dO, dP = dO V^T,
//      dS = P * (dP - D) * scale, dK += dS^T Q. The G heads sum in a fixed order.
//   c. dQ: one block per (query head, query block, batch) walks the key blocks its
//      mask allows: dQ += dS K with P and dS recomputed as in (b).
//   P and scale * dS round to q's dtype before their products (bf16: as
//   plain_backward rounds them); the products sum in float32.
// Bound on the H100: operations (8 * dh flops a head and allowed pair, the
// recompute aside). bf16 at head_dim 64 and 128 runs (b) and (c) on the tensor
// cores (flash_bwd_dkdv_wgmma<DH, NWG>, flash_bwd_dq_wgmma<DH, NWG>: the forward's
// tiles, swizzle, cp.async ring and wgmma forms; S^T and dP^T are m64n64 products
// with K (V) the A operand and Q (dO) the K-major B operand, dV and dK take P^T and
// dS^T from registers as the forward takes P, with dO and Q read MN-major under the
// transpose bit; dQ reads K MN-major the same way). Each product is a wgmma group of
// its own, waited for where its result is first read, so the softmax's arithmetic
// runs while the next product multiplies. A block is NWG warpgroups of 64 rows: two
// at head_dim 128, one at 64 (two blocks an SM). float32, and bf16 at other head
// dims (<= 128), run them on the CUDA cores (simt::flash_bwd_simt<T, KV>).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// A row's logsumexp as the backward reads it, in base 2 (exp2(x * scale2 - lse2) is P):
// a row that allows no key (lse -inf) gets +inf, so every P of it is 0.
__device__ __forceinline__ float lse_base2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * 1.4426950408889634f;
}

// ---------------------------------------------------------------------------
// 1. bf16 on the tensor cores (wgmma), head_dim 64 or 128
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;  // swz, cp_async16, desc, wgmma fences (hopper.cuh)

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kBM = 128;       // query positions per block, 64 per warpgroup
constexpr int kBN = 64;        // KV positions per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Layout {
  static constexpr int kQBytes = kBM * DH * 2;
  static constexpr int kTileBytes = kBN * DH * 2;                 // one K or V tile
  static constexpr int kSmemBytes = kQBytes + 4 * kTileBytes + 1024;  // + alignment slack
};

// Rows [row0, row0 + ROWS) of a [*, DH] matrix whose rows are `stride` elements
// apart, into a swizzled tile at `dst` by NT threads; rows at or past `nrows` are zero-filled.
template <int DH, int ROWS, int NT = kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int64_t stride,
                                          int row0, int nrows, int tid) {
  constexpr int kChunks = DH / 8;
  static_assert(ROWS * kChunks % NT == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / NT; ++j) {
    const int i = tid + j * NT, r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < nrows;
    const __nv_bfloat16* p = ok ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(dst + swz(r, c, ROWS), p, ok ? 16 : 0);
  }
}

// D[64x64] (+)= A[64x16] B[16x64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64x64] += A[64x16] B[16x64], A from registers (bf16 pairs), B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of m64nNk16 (per warp 16 rows): element i of a thread sits
// at row lane/4 + 8*((i/2)%2) and column 8*(i/4) + 2*(lane%4) + i%2.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int sq, int sk, int hq, int hkv, float scale, int causal,
                   int window) {
  using L = Layout<DH>;
  constexpr int kNB = DH / 64;  // 64-wide column blocks of dh
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQBytes;  // stage st: K at kv_s + 2*st*tile, V one tile on

  const int tid = threadIdx.x, lane = tid % 32;
  const int wgi = tid / 128, warp = (tid % 128) / 32;
  // the last query tiles (the most KV tiles under the causal mask) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM, h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int64_t q_stride = static_cast<int64_t>(hq) * DH, kv_stride = static_cast<int64_t>(hkv) * DH;
  const __nv_bfloat16* qg = q + (static_cast<int64_t>(b) * sq * hq + h) * DH;
  const __nv_bfloat16* kg = k + (static_cast<int64_t>(b) * sk * hkv + kvh) * DH;
  const __nv_bfloat16* vg = v + (static_cast<int64_t>(b) * sk * hkv + kvh) * DH;

  // KV tiles [t_begin, t_end): the band of the block's rows q0 .. q0 + kBM - 1
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBN : 0;
  int t_end = (sk + kBN - 1) / kBN;
  if (causal) t_end = min(t_end, (q0 + kBM - 1) / kBN + 1);

  load_tile<DH, kBM>(q_s, qg, q_stride, q0, sq, tid);
  if (t_begin < t_end) {
    load_tile<DH, kBN>(kv_s, kg, kv_stride, t_begin * kBN, sk, tid);
    load_tile<DH, kBN>(kv_s + L::kTileBytes, vg, kv_stride, t_begin * kBN, sk, tid);
  }
  cp_async_commit();

  const int wg_first = q0 + wgi * 64, wg_last = wg_first + 63;
  const int row0 = wg_first + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const float scale2 = scale * kLog2e;               // softmax in base 2
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kNB][32];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      const uint32_t nxt = kv_s + (st ^ 1) * 2 * L::kTileBytes;
      load_tile<DH, kBN>(nxt, kg, kv_stride, (t + 1) * kBN, sk, tid);
      load_tile<DH, kBN>(nxt + L::kTileBytes, vg, kv_stride, (t + 1) * kBN, sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int k0 = t * kBN;
    // skip a tile that every row of this warpgroup masks (warpgroup-uniform)
    const bool skip = (causal && k0 > wg_last) || (window > 0 && wg_first - (k0 + kBN - 1) >= window);
    if (!skip) {
      const uint32_t k_s = kv_s + st * 2 * L::kTileBytes, v_s = k_s + L::kTileBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the swizzled block
        wgmma_ss(s, desc(q_s + (kk / 4) * kBM * 128 + wgi * 64 * 128 + off, 16, 1024),
                 desc(k_s + (kk / 4) * kBN * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // mask (only where the tile crosses the diagonal, the window's edge or Sk), scale, row max
      const bool need_mask = (causal && k0 + kBN - 1 > wg_first) ||
                             (window > 0 && wg_last - k0 >= window) || k0 + kBN > sk;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale2;
        if (need_mask) {
          const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int qpos = row0 + 8 * ((i / 2) % 2);
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          x = ok ? x : kNegInf;
        }
        s[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(s[i] - m[(i / 2) % 2]);
        s[i] = p;
        l[(i / 2) % 2] += p;
      }
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[n][i] *= corr[(i / 2) % 2];

      // P as the A operand: k-slice kk covers the accumulator's columns 16kk .. 16kk+15
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
      for (int n = 0; n < kNB; ++n) fence_regs(o[n]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int n = 0; n < kNB; ++n)
          wgmma_rs(o[n], pa[kk], desc(v_s + n * kBN * 128 + kk * 16 * 128, kBN * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int n = 0; n < kNB; ++n) fence_regs(o[n]);
    }
    __syncthreads();  // every warpgroup is done with stage st before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: O / l in bf16 into the Q tile's space (same swizzle), then 16-byte rows out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && row < sq) {  // natural units; -inf: no key allowed
      lse[(static_cast<int64_t>(b) * hq + h) * sq + row] =
          m[r] == kNegInf ? -INFINITY : (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = wgi * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + 2 * (lane % 4);  // column within the 64-wide block n
      const float inv = l[(i / 2) % 2];
      *reinterpret_cast<uint32_t*>(smem + swz(r, n * 8 + c / 8, kBM) + (c % 8) * 2) =
          pack_bf16(o[n][i] * inv, o[n][i + 1] * inv);
    }
  __syncthreads();
  constexpr int kChunks = DH / 8;
  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    if (q0 + r < sq) {
      *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(b) * sq + q0 + r) * q_stride +
                                static_cast<int64_t>(h) * DH + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz(r, c, kBM));
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int b, int sq, int sk,
           int hq, int hkv, float scale, int causal, int window, void* stream) {
  const int bytes = Layout<DH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b > 0 && sq > 0 && sk > 0) {
    dim3 grid(hq, (sq + kBM - 1) / kBM, b);
    flash_kernel_wgmma<DH><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), sq, sk, hq, hkv, scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

// ----- the backward on the tensor cores (see the file's head, (b) and (c)) -----

// A backward block is NWG warpgroups (each owning 64 rows of every product's M).
// Shared memory of both backward kernels: two NWG * 64-row tiles (K and V, or Q and dO)
// and a two-stage ring of two 64-row tiles (Q and dO, or K and V), then (dK/dV only)
// two stages of the query block's lse and D, 64 float32 each.
template <int DH, int NWG>
struct BwdLayout {
  static constexpr int kRows = NWG * 64, kThreads = NWG * 128;
  static constexpr int kBigBytes = kRows * DH * 2;
  static constexpr int kTileBytes = kBN * DH * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStatsOff = 2 * kBigBytes + 2 * kStageBytes;
  static constexpr int kSmemBytes = kStatsOff + 2 * 2 * kBN * 4 + 1024;  // + alignment slack
};

// The float32 accumulators of a warpgroup's 64 rows x DH, in bf16, into the ROWS-row
// swizzled tile at `tile` (its rows wgi * 64 ..), for a coalesced write-out.
template <int DH, int ROWS>
__device__ __forceinline__ void stage_out(uint8_t* tile, const float (&acc)[DH / 64][32], int wgi,
                                          int warp, int lane) {
#pragma unroll
  for (int n = 0; n < DH / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = wgi * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(tile + swz(r, n * 8 + c / 8, ROWS) + (c % 8) * 2) =
          pack_bf16(acc[n][i], acc[n][i + 1]);
    }
}

// Rows [row0, row0 + ROWS) of a ROWS-row swizzled tile out to a [*, DH] matrix whose rows
// are `stride` elements apart, by NT threads; rows at or past `nrows` are not written.
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void write_rows(__nv_bfloat16* dst, int64_t stride, const uint8_t* tile,
                                           int row0, int nrows, int tid) {
  constexpr int kChunks = DH / 8;
  for (int i = tid; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    if (row0 + r < nrows) {
      *reinterpret_cast<uint4*>(dst + (row0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(r, c, ROWS));
    }
  }
}

// S (+)= A B^T over DH for a warpgroup's 64 rows: A rows wgi * 64 .. of a ROWS-row tile,
// B a 64-row tile, both K-major (the forward's S = Q K^T).
template <int DH, int ROWS>
__device__ __forceinline__ void product_abt(float (&d)[32], uint32_t a_s, uint32_t b_s, int wgi) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(d, desc(a_s + (kk / 4) * ROWS * 128 + wgi * 64 * 128 + off, 16, 1024),
             desc(b_s + (kk / 4) * kBN * 128 + off, 16, 1024), kk > 0);
  }
}

// D[n] += A B over 64 rows of a 64-row tile B (MN-major, the transpose bit: the forward's
// O += P V), A from registers, for every 64-column block n of DH.
template <int DH>
__device__ __forceinline__ void product_rb(float (&d)[DH / 64][32], const uint32_t (&a)[4][4],
                                           uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int n = 0; n < DH / 64; ++n)
      wgmma_rs(d[n], a[kk], desc(b_s + n * kBN * 128 + kk * 16 * 128, kBN * 128, 1024));
}

// Accumulator pairs (2j, 2j + 1) of k-slice kk as the A fragments of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// (b) dK and dV of keys [k0, k0 + NWG * 64) of KV head blockIdx.y, batch blockIdx.z:
// each warpgroup owns 64 keys (the M rows of every product); the query blocks of the G
// heads stream through the ring. S^T = K Q^T and dP^T = V dO^T come out with keys as
// rows and queries as columns, the layout of the A operand of dV += P^T dO and
// dK += dS^T Q.
template <int DH, int NWG>
__global__ void __launch_bounds__(NWG * 128, 2 / NWG)
flash_bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq, int sk,
                     int hq, int hkv, float scale, int causal, int window) {
  using L = BwdLayout<DH, NWG>;
  constexpr int kNB = DH / 64, kRows = L::kRows, kNT = L::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + L::kBigBytes;
  const uint32_t ring = base + 2 * L::kBigBytes;  // stage st: Q at ring + st * stage, dO a tile on
  float* stats = reinterpret_cast<float*>(smem + L::kStatsOff);  // stage st: lse, then D

  const int tid = threadIdx.x, lane = tid % 32, wgi = tid / 128, warp = (tid % 128) / 32;
  const int k0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int g = hq / hkv;
  const int64_t q_stride = static_cast<int64_t>(hq) * DH, kv_stride = static_cast<int64_t>(hkv) * DH;
  const __nv_bfloat16* kg = k + (static_cast<int64_t>(b) * sk * hkv + kvh) * DH;
  const __nv_bfloat16* vg = v + (static_cast<int64_t>(b) * sk * hkv + kvh) * DH;

  // the query blocks that can reach keys k0 .. k0 + kRows - 1, for each of the G heads
  const int n_qt = (sq + kBN - 1) / kBN;
  const int qt_begin = causal ? min(k0 / kBN, n_qt) : 0;
  const int qt_end = window > 0 ? min(n_qt, (k0 + kRows - 1 + window - 1) / kBN + 1) : n_qt;
  const int per_head = max(0, qt_end - qt_begin);
  const int n_it = g * per_head;

  auto load_stage = [&](int st, int it) {
    const int h = kvh * g + it / per_head, q0 = (qt_begin + it % per_head) * kBN;
    const int64_t off = static_cast<int64_t>(b) * sq * hq * DH + static_cast<int64_t>(h) * DH;
    const uint32_t q_s = ring + st * L::kStageBytes;
    load_tile<DH, kBN, kNT>(q_s, q + off, q_stride, q0, sq, tid);
    load_tile<DH, kBN, kNT>(q_s + L::kTileBytes, dout + off, q_stride, q0, sq, tid);
    if (tid < 2 * kBN) {
      const int row = q0 + tid % kBN;
      const float* src = (tid < kBN ? lse : delta) + (static_cast<int64_t>(b) * hq + h) * sq;
      const float x = row < sq ? src[row] : 0.f;
      stats[st * 2 * kBN + tid] = tid < kBN ? lse_base2(x) : x;
    }
  };

  load_tile<DH, kRows, kNT>(k_s, kg, kv_stride, k0, sk, tid);
  load_tile<DH, kRows, kNT>(v_s, vg, kv_stride, k0, sk, tid);
  if (n_it > 0) load_stage(0, 0);
  cp_async_commit();

  const int wg_first = k0 + wgi * 64, wg_last = wg_first + 63;
  const int key0 = wg_first + warp * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
  const float scale2 = scale * kLog2e;
  float dk_acc[kNB][32], dv_acc[kNB][32];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_stage(st ^ 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage it (and K, V) have landed
    fence_proxy_async();
    __syncthreads();

    const int qf = (qt_begin + it % per_head) * kBN, ql = qf + kBN - 1;
    // skip a block pair that every (key, query) of this warpgroup masks (warpgroup-uniform)
    const bool skip = wg_first >= sk || (causal && ql < wg_first) ||
                      (window > 0 && qf - wg_last >= window);
    if (!skip) {
      const uint32_t q_s = ring + st * L::kStageBytes, do_s = q_s + L::kTileBytes;
      const float* lse2 = stats + st * 2 * kBN;
      const float* dd = lse2 + kBN;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      // four wgmma groups, each waited for only where its result is read: P^T is
      // computed while dP^T multiplies, dS^T while dV does
      wgmma_fence();
      product_abt<DH, kRows>(s, k_s, q_s, wgi);    // S^T = K Q^T
      wgmma_commit();
      product_abt<DH, kRows>(dp, v_s, do_s, wgi);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();  // S^T has landed
      fence_regs(s);

      const bool need_mask = (causal && wg_last > qf) || (window > 0 && ql - wg_first >= window) ||
                             wg_last >= sk || ql >= sq;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);  // query qf + col
        float p = exp2f(s[i] * scale2 - lse2[col]);
        if (need_mask) {
          const int kpos = key0 + 8 * ((i / 2) % 2), qpos = qf + col;
          bool ok = kpos < sk && qpos < sq;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          p = ok ? p : 0.f;
        }
        s[i] = p;
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(pa, s);
#pragma unroll
      for (int n = 0; n < kNB; ++n) fence_regs(dv_acc[n]);
      wgmma_fence();
      product_rb<DH>(dv_acc, pa, do_s);  // dV += P^T dO
      wgmma_commit();
      wgmma_wait<1>();  // dP^T has landed
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        dp[i] = s[i] * (dp[i] - dd[col]) * scale;
      }
      pack_a(da, dp);
#pragma unroll
      for (int n = 0; n < kNB; ++n) fence_regs(dk_acc[n]);
      wgmma_fence();
      product_rb<DH>(dk_acc, da, q_s);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        fence_regs(dk_acc[n]);
        fence_regs(dv_acc[n]);
      }
    }
    __syncthreads();  // every warpgroup is done with stage st before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: dK into the K tile's space, dV into V's, then 16-byte rows out
  stage_out<DH, kRows>(smem, dk_acc, wgi, warp, lane);
  stage_out<DH, kRows>(smem + L::kBigBytes, dv_acc, wgi, warp, lane);
  __syncthreads();
  const int64_t off = (static_cast<int64_t>(b) * sk * hkv + kvh) * DH;
  write_rows<DH, kRows, kNT>(dk + off, kv_stride, smem, k0, sk, tid);
  write_rows<DH, kRows, kNT>(dv + off, kv_stride, smem + L::kBigBytes, k0, sk, tid);
}

// (c) dQ of query positions q0 .. q0 + NWG * 64 - 1 of head blockIdx.x, batch blockIdx.z
// (the last positions' blocks first, as the forward): each warpgroup owns 64 of them; K
// and V tiles of 64 keys stream through the ring.
template <int DH, int NWG>
__global__ void __launch_bounds__(NWG * 128, 2 / NWG)
flash_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int sq, int sk, int hq, int hkv, float scale,
                   int causal, int window) {
  using L = BwdLayout<DH, NWG>;
  constexpr int kNB = DH / 64, kRows = L::kRows, kNT = L::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + L::kBigBytes;
  const uint32_t ring = base + 2 * L::kBigBytes;  // stage st: K at ring + st * stage, V a tile on

  const int tid = threadIdx.x, lane = tid % 32, wgi = tid / 128, warp = (tid % 128) / 32;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows, h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int64_t q_stride = static_cast<int64_t>(hq) * DH, kv_stride = static_cast<int64_t>(hkv) * DH;
  const int64_t q_off = static_cast<int64_t>(b) * sq * hq * DH + static_cast<int64_t>(h) * DH;
  const __nv_bfloat16* kg = k + (static_cast<int64_t>(b) * sk * hkv + kvh) * DH;
  const __nv_bfloat16* vg = v + (static_cast<int64_t>(b) * sk * hkv + kvh) * DH;

  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBN : 0;
  int t_end = (sk + kBN - 1) / kBN;
  if (causal) t_end = min(t_end, (q0 + kRows - 1) / kBN + 1);

  load_tile<DH, kRows, kNT>(q_s, q + q_off, q_stride, q0, sq, tid);
  load_tile<DH, kRows, kNT>(do_s, dout + q_off, q_stride, q0, sq, tid);
  if (t_begin < t_end) {
    load_tile<DH, kBN, kNT>(ring, kg, kv_stride, t_begin * kBN, sk, tid);
    load_tile<DH, kBN, kNT>(ring + L::kTileBytes, vg, kv_stride, t_begin * kBN, sk, tid);
  }
  cp_async_commit();

  const int wg_first = q0 + wgi * 64, wg_last = wg_first + 63;
  const int row0 = wg_first + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const float scale2 = scale * kLog2e;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * hq + h) * sq + row;
    lse2[r] = row < sq ? lse_base2(lse[at]) : INFINITY;  // rows past Sq: P = 0
    dd[r] = row < sq ? delta[at] : 0.f;
  }
  float dq_acc[kNB][32];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[n][i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      const uint32_t nxt = ring + (st ^ 1) * L::kStageBytes;
      load_tile<DH, kBN, kNT>(nxt, kg, kv_stride, (t + 1) * kBN, sk, tid);
      load_tile<DH, kBN, kNT>(nxt + L::kTileBytes, vg, kv_stride, (t + 1) * kBN, sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q, dO) have landed
    fence_proxy_async();
    __syncthreads();

    const int k0 = t * kBN;
    const bool skip = (causal && k0 > wg_last) || (window > 0 && wg_first - (k0 + kBN - 1) >= window);
    if (!skip) {
      const uint32_t k_s = ring + st * L::kStageBytes, v_s = k_s + L::kTileBytes;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      product_abt<DH, kRows>(s, q_s, k_s, wgi);    // S = Q K^T
      wgmma_commit();
      product_abt<DH, kRows>(dp, do_s, v_s, wgi);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();  // S has landed; P is computed while dP multiplies
      fence_regs(s);

      const bool need_mask = (causal && k0 + kBN - 1 > wg_first) ||
                             (window > 0 && wg_last - k0 >= window) || k0 + kBN > sk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        float p = exp2f(s[i] * scale2 - lse2[r]);
        if (need_mask) {
          const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2), qpos = row0 + 8 * r;
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          p = ok ? p : 0.f;
        }
        s[i] = p;
      }
      wgmma_wait0();  // dP has landed
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dd[(i / 2) % 2]) * scale;
      uint32_t da[4][4];
      pack_a(da, dp);
#pragma unroll
      for (int n = 0; n < kNB; ++n) fence_regs(dq_acc[n]);
      wgmma_fence();
      product_rb<DH>(dq_acc, da, k_s);  // dQ += dS K
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int n = 0; n < kNB; ++n) fence_regs(dq_acc[n]);
    }
    __syncthreads();  // every warpgroup is done with stage st before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  stage_out<DH, kRows>(smem, dq_acc, wgi, warp, lane);  // into the Q tile's space
  __syncthreads();
  write_rows<DH, kRows, kNT>(dq + q_off, q_stride, smem, q0, sq, tid);
}

template <int DH, int NWG>
int launch_backward(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, void* dk, void* dv, int b, int sq, int sk, int hq,
                    int hkv, float scale, int causal, int window, cudaStream_t st) {
  using L = BwdLayout<DH, NWG>;
  const int bytes = L::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<DH, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DH, NWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  const bf *qp = static_cast<const bf*>(q), *kp = static_cast<const bf*>(k),
           *vp = static_cast<const bf*>(v), *dop = static_cast<const bf*>(dout);
  const float *lp = static_cast<const float*>(lse), *dp = static_cast<const float*>(delta);
  flash_bwd_dkdv_wgmma<DH, NWG><<<dim3((sk + L::kRows - 1) / L::kRows, hkv, b), L::kThreads, bytes,
                                 st>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf*>(dk), static_cast<bf*>(dv), sq, sk, hq, hkv, scale,
      causal, window);
  flash_bwd_dq_wgmma<DH, NWG><<<dim3(hq, (sq + L::kRows - 1) / L::kRows, b), L::kThreads, bytes,
                               st>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf*>(dq), sq, sk, hq, hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// 2. the CUDA-core kernel: float32, and bf16 at other head dims
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 128;
constexpr int kRows = 64;       // query rows per block (G heads x 64/G positions)
constexpr int kTile = 32;       // KV positions per tile
constexpr int kMaxDh = 128;
constexpr int kStride = kMaxDh + 1;  // padded row stride of Q and K in shared memory
constexpr int kPStride = kTile + 1;
constexpr int kColGroups = 8;   // threads per row group
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = kTile / kColGroups;      // 4 score columns
constexpr int kDhPerThread = kMaxDh / kColGroups;       // 16 accumulator columns
constexpr int kSmemFloats = kRows * kStride + kTile * kStride + kTile * kMaxDh + kRows * kPStride;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kThreads == (kRows / kRowsPerThread) * kColGroups, "thread layout");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// Max / sum over the 8 consecutive lanes that share a row group.
__device__ __forceinline__ float group_max(float v) {
  for (int off = 1; off < kColGroups; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
  for (int off = 1; off < kColGroups; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int hkv, int g,
                  int dh, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [kRows][kStride]
  float* ks = qs + kRows * kStride;       // [kTile][kStride]
  float* vs = ks + kTile * kStride;       // [kTile][kMaxDh]
  float* ps = vs + kTile * kMaxDh;        // [kRows][kPStride]

  const int qt = kRows / g;               // query positions per block
  const int q0 = blockIdx.x * qt;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hq = hkv * g;
  const int tid = threadIdx.x;
  const int ry = tid / kColGroups, cx = tid % kColGroups;

  // Stage the block's query rows: row r is head h*g + r/qt at position q0 + r%qt.
  for (int i = tid; i < kRows * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    const int gi = r / qt, qpos = q0 + r % qt;
    float val = 0.f;
    if (gi < g && qpos < sq) {
      val = to_float(q[((static_cast<int64_t>(b) * sq + qpos) * hq + h * g + gi) * dh + d]);
    }
    qs[r * kStride + d] = val;
  }

  int qpos_r[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kDhPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ry * kRowsPerThread + i;
    qpos_r[i] = q0 + r % qt;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDhPerThread; ++j) acc[i][j] = 0.f;
  }

  const int64_t kv_stride = static_cast<int64_t>(hkv) * dh;  // between positions
  const T* kb = k + static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(h) * dh;
  const T* vb = v + static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(h) * dh;
  const int q_last = q0 + qt - 1;

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    // skip tiles that every row of the block masks (uniform over the block)
    if (causal && k0 > q_last) break;
    if (window > 0 && q0 - (k0 + kTile - 1) >= window) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * dh; i += kThreads) {
      const int t = i / dh, d = i % dh;
      float kv = 0.f, vv = 0.f;
      if (k0 + t < sk) {
        kv = to_float(kb[(k0 + t) * kv_stride + d]);
        vv = to_float(vb[(k0 + t) * kv_stride + d]);
      }
      ks[t * kStride + d] = kv;
      vs[t * kMaxDh + d] = vv;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
    const float* qrow = qs + ry * kRowsPerThread * kStride;
    for (int d = 0; d < dh; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = qrow[i * kStride + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) kv[j] = ks[(cx + j * kColGroups) * kStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qpos = qpos_r[i];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kpos = k0 + cx + j * kColGroups;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ry * kRowsPerThread + i) * kPStride + cx + j * kColGroups] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDhPerThread; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int t = 0; t < kTile; ++t) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = ps[(ry * kRowsPerThread + i) * kPStride + t];
#pragma unroll
      for (int j = 0; j < kDhPerThread; ++j) {
        const int c = cx + j * kColGroups;
        const float vv = c < dh ? vs[t * kMaxDh + c] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ry * kRowsPerThread + i;
    const int gi = r / qt, qpos = qpos_r[i];
    if (gi >= g || qpos >= sq) continue;
    if (lse != nullptr && cx == 0) {  // natural units; -inf: the row allows no key
      lse[(static_cast<int64_t>(b) * hq + h * g + gi) * sq + qpos] =
          m[i] == kNegInf ? -INFINITY : m[i] + logf(l[i]);
    }
    T* orow = out + ((static_cast<int64_t>(b) * sq + qpos) * hq + h * g + gi) * dh;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDhPerThread; ++j) {
      const int c = cx + j * kColGroups;
      if (c < dh) from_float(acc[i][j] * inv, &orow[c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int b, int sq,
           int sk, int hq, int hkv, int dh, float scale, int causal, int window, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kRows || dh <= 0 || dh > kMaxDh) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_simt<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = hq / hkv;
  const int qt = kRows / g;
  if (b > 0 && sq > 0 && sk > 0) {
    dim3 grid((sq + qt - 1) / qt, hkv, b);
    flash_kernel_simt<T><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), static_cast<float*>(lse), sq, sk, hkv, g, dh, scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

// ----- the backward on the CUDA cores (see the file's head, (b) and (c)) -----
constexpr int kBwdThreads = 128;
constexpr int kBwdRows = 32;   // own rows a block (keys or queries), other rows a tile
constexpr int kBwdPStride = kBwdRows + 1;
constexpr int kBwdSmemFloats = 4 * kBwdRows * kStride + 2 * kBwdRows * kBwdPStride + 2 * kBwdRows;
constexpr size_t kBwdSmemBytes = kBwdSmemFloats * sizeof(float);

// v rounded to T and back: where plain_backward rounds P and dS before their products
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Rows [r0, r0 + kBwdRows) of the [*, dh] rows `stride` apart at `src`, as float32 into
// dst[r * kStride + d]; rows at or past `nrows` are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int64_t stride, int r0,
                                           int nrows, int dh) {
  for (int i = threadIdx.x; i < kBwdRows * dh; i += kBwdThreads) {
    const int r = i / dh, d = i % dh;
    dst[r * kStride + d] = r0 + r < nrows ? to_float(src[(r0 + r) * stride + d]) : 0.f;
  }
}

// KV: dK (d1) and dV (d2) of keys blockIdx.x * 32 .. of KV head blockIdx.y, over the G
// heads' query tiles. !KV: dQ (d1) of queries blockIdx.x * 32 .. of head blockIdx.y,
// over the key tiles. Thread t owns own row t / 4: its 8 score columns t % 4 + 4j and
// its accumulator columns t % 4 + 4c.
template <typename T, bool KV>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ d1, T* __restrict__ d2, int sq,
               int sk, int hkv, int g, int dh, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* own1 = smem;                          // K or Q  [kBwdRows][kStride]
  float* own2 = own1 + kBwdRows * kStride;     // V or dO
  float* oth1 = own2 + kBwdRows * kStride;     // Q or K
  float* oth2 = oth1 + kBwdRows * kStride;     // dO or V
  float* ps = oth2 + kBwdRows * kStride;       // P   [kBwdRows][kBwdPStride]
  float* dss = ps + kBwdRows * kBwdPStride;    // dS
  float* st_lse = dss + kBwdRows * kBwdPStride;  // lse and D of the tile's queries (KV) or
  float* st_d = st_lse + kBwdRows;               // of the block's own queries (!KV)

  const int hq = hkv * g, b = blockIdx.z, tid = threadIdx.x;
  const int ro = tid / 4, cq = tid % 4;
  const int own0 = blockIdx.x * kBwdRows;
  const int kvh = KV ? blockIdx.y : blockIdx.y / g;
  const int64_t q_stride = static_cast<int64_t>(hq) * dh, kv_stride = static_cast<int64_t>(hkv) * dh;
  const T* kb = k + static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(kvh) * dh;
  const T* vb = v + static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(kvh) * dh;
  auto q_rows = [&](const T* t, int h) {
    return t + static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * dh;
  };
  auto stats = [&](int h) { return (static_cast<int64_t>(b) * hq + h) * sq; };

  if (KV) {
    stage_rows(own1, kb, kv_stride, own0, sk, dh);
    stage_rows(own2, vb, kv_stride, own0, sk, dh);
  } else {
    const int h = blockIdx.y;
    stage_rows(own1, q_rows(q, h), q_stride, own0, sq, dh);
    stage_rows(own2, q_rows(dout, h), q_stride, own0, sq, dh);
    if (tid < kBwdRows) {
      const int row = own0 + tid;
      st_lse[tid] = row < sq ? lse[stats(h) + row] : -INFINITY;
      st_d[tid] = row < sq ? delta[stats(h) + row] : 0.f;
    }
  }

  // the other side's tiles: (KV) each head's query tiles that can reach the block's keys,
  // (!KV) the key tiles the block's queries can reach
  int t_begin, t_end;
  if (KV) {
    t_begin = causal ? own0 / kBwdRows : 0;
    t_end = (sq + kBwdRows - 1) / kBwdRows;
    if (window > 0) t_end = min(t_end, (own0 + kBwdRows - 1 + window - 1) / kBwdRows + 1);
  } else {
    t_begin = window > 0 ? max(0, own0 - window + 1) / kBwdRows : 0;
    t_end = (sk + kBwdRows - 1) / kBwdRows;
    if (causal) t_end = min(t_end, (own0 + kBwdRows - 1) / kBwdRows + 1);
  }
  const int per_head = max(0, t_end - t_begin);

  float acc1[kMaxDh / 4], acc2[kMaxDh / 4];  // acc2: dV (KV only)
#pragma unroll
  for (int c = 0; c < kMaxDh / 4; ++c) acc1[c] = acc2[c] = 0.f;

  for (int it = 0; it < (KV ? g : 1) * per_head; ++it) {
    const int oth0 = (t_begin + it % per_head) * kBwdRows;
    const int h = KV ? kvh * g + it / per_head : blockIdx.y;
    __syncthreads();  // the previous tile's readers are done
    if (KV) {
      stage_rows(oth1, q_rows(q, h), q_stride, oth0, sq, dh);
      stage_rows(oth2, q_rows(dout, h), q_stride, oth0, sq, dh);
      if (tid < kBwdRows) {
        const int row = oth0 + tid;
        st_lse[tid] = row < sq ? lse[stats(h) + row] : -INFINITY;
        st_d[tid] = row < sq ? delta[stats(h) + row] : 0.f;
      }
    } else {
      stage_rows(oth1, kb, kv_stride, oth0, sk, dh);
      stage_rows(oth2, vb, kv_stride, oth0, sk, dh);
    }
    __syncthreads();

    float s1[kBwdRows / 4], s2[kBwdRows / 4];
#pragma unroll
    for (int j = 0; j < kBwdRows / 4; ++j) s1[j] = s2[j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float a1 = own1[ro * kStride + d], a2 = own2[ro * kStride + d];
#pragma unroll
      for (int j = 0; j < kBwdRows / 4; ++j) {
        s1[j] += a1 * oth1[(cq + 4 * j) * kStride + d];
        s2[j] += a2 * oth2[(cq + 4 * j) * kStride + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kBwdRows / 4; ++j) {
      const int col = cq + 4 * j;
      const int qpos = KV ? oth0 + col : own0 + ro, kpos = KV ? own0 + ro : oth0 + col;
      const int si = KV ? col : ro;  // the query's lse and D
      bool ok = qpos < sq && kpos < sk && st_lse[si] != -INFINITY;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      const float p = ok ? expf(s1[j] * scale - st_lse[si]) : 0.f;
      ps[ro * kBwdPStride + col] = round_as(p, q);
      dss[ro * kBwdPStride + col] = round_as(p * (s2[j] - st_d[si]) * scale, q);
    }
    __syncwarp();  // row ro's four threads are one warp's lanes 4(ro % 8) ..

    for (int o = 0; o < kBwdRows; ++o) {
      const float m1 = dss[ro * kBwdPStride + o], m2 = ps[ro * kBwdPStride + o];
#pragma unroll
      for (int c = 0; c < kMaxDh / 4; ++c) {
        const int col = cq + 4 * c;
        if (col < dh) {
          acc1[c] += m1 * oth1[o * kStride + col];                // dS^T Q or dS K
          if constexpr (KV) acc2[c] += m2 * oth2[o * kStride + col];  // P^T dO
        }
      }
    }
  }

  const int row = own0 + ro;
  if (row >= (KV ? sk : sq)) return;
  T* o1 = KV ? d1 + static_cast<int64_t>(b) * sk * kv_stride + row * kv_stride + kvh * dh
             : d1 + static_cast<int64_t>(b) * sq * q_stride + row * q_stride + blockIdx.y * dh;
#pragma unroll
  for (int c = 0; c < kMaxDh / 4; ++c) {
    const int col = cq + 4 * c;
    if (col < dh) {
      from_float(acc1[c], &o1[col]);
      if constexpr (KV) {
        from_float(acc2[c], &d2[static_cast<int64_t>(b) * sk * kv_stride + row * kv_stride +
                                kvh * dh + col]);
      }
    }
  }
}

template <typename T>
int launch_backward(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, void* dk, void* dv, int b, int sq, int sk, int hq,
                    int hkv, int dh, float scale, int causal, int window, cudaStream_t st) {
  if (dh <= 0 || dh > kMaxDh) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_simt<T, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBwdSmemBytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_simt<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBwdSmemBytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = hq / hkv;
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *dop = static_cast<const T*>(dout);
  const float *lp = static_cast<const float*>(lse), *dp = static_cast<const float*>(delta);
  flash_bwd_simt<T, true><<<dim3((sk + kBwdRows - 1) / kBwdRows, hkv, b), kBwdThreads,
                            kBwdSmemBytes, st>>>(qp, kp, vp, dop, lp, dp, static_cast<T*>(dk),
                                                 static_cast<T*>(dv), sq, sk, hkv, g, dh, scale,
                                                 causal, window);
  flash_bwd_simt<T, false><<<dim3((sq + kBwdRows - 1) / kBwdRows, hq, b), kBwdThreads,
                             kBwdSmemBytes, st>>>(qp, kp, vp, dop, lp, dp, static_cast<T*>(dq),
                                                  nullptr, sq, sk, hkv, g, dh, scale, causal,
                                                  window);
  return static_cast<int>(cudaGetLastError());
}

// (a) D = rowsum(dO * O) in float32 into delta [B, Hq, Sq]: one warp a (batch, position,
// head) row of dh elements.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                int64_t rows, int sq, int hq, int dh) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float sum = 0.f;
  for (int d = lane; d < dh; d += 32) sum += to_float(o[row * dh + d]) * to_float(dout[row * dh + d]);
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int64_t h = row % hq, pos = (row / hq) % sq, bb = row / (static_cast<int64_t>(hq) * sq);
    delta[(bb * hq + h) * sq + pos] = sum;
  }
}

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, int b, int sq, int hq, int dh,
                 cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(b) * sq * hq;
  if (rows > 0) {
    flash_bwd_delta<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), rows, sq,
        hq, dh);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

}  // namespace

// The forward entries: `lse` (float32 [B, Hq, Sq]) may be null, and then nothing is written
// but `out`.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int b, int sq, int sk, int hq, int hkv, int dh,
                                   float scale, int causal, int window, void* stream) {
  return simt::launch<float>(q, k, v, out, lse, b, sq, sk, hq, hkv, dh, scale, causal, window,
                             stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int b, int sq, int sk, int hq, int hkv, int dh,
                                    float scale, int causal, int window, void* stream) {
  return simt::launch<__nv_bfloat16>(q, k, v, out, lse, b, sq, sk, hq, hkv, dh, scale, causal,
                                     window, stream);
}

// bf16 on the tensor cores: head_dim 64 or 128, any Hq % Hkv == 0, and q, k, v and
// out 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int b, int sq, int sk, int hq, int hkv, int dh,
                                          float scale, int causal, int window, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) return wg::launch<64>(q, k, v, out, lse, b, sq, sk, hq, hkv, scale, causal, window, stream);
  if (dh == 128) return wg::launch<128>(q, k, v, out, lse, b, sq, sk, hq, hkv, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: q, k, v, the forward's out and lse, dout -> dq, dk, dv (q's shapes and
// dtype), with `delta` a float32 [B, Hq, Sq] workspace. Three launches on `stream`.
extern "C" int flash_attention_backward_f32(const void* q, const void* k, const void* v,
                                            const void* out, const void* lse, const void* dout,
                                            void* dq, void* dk, void* dv, void* delta, int b,
                                            int sq, int sk, int hq, int hkv, int dh, float scale,
                                            int causal, int window, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = simt::launch_delta<float>(out, dout, delta, b, sq, hq, dh, st);
  if (err != 0 || b == 0 || sq == 0 || sk == 0) return err;
  return simt::launch_backward<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, hq, hkv, dh,
                                      scale, causal, window, st);
}

extern "C" int flash_attention_backward_bf16(const void* q, const void* k, const void* v,
                                             const void* out, const void* lse, const void* dout,
                                             void* dq, void* dk, void* dv, void* delta, int b,
                                             int sq, int sk, int hq, int hkv, int dh, float scale,
                                             int causal, int window, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = simt::launch_delta<__nv_bfloat16>(out, dout, delta, b, sq, hq, dh, st);
  if (err != 0 || b == 0 || sq == 0 || sk == 0) return err;
  return simt::launch_backward<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, hq,
                                              hkv, dh, scale, causal, window, st);
}

// bf16 on the tensor cores: head_dim 64 or 128, every tensor 16-byte aligned (the wrapper
// checks).
extern "C" int flash_attention_backward_bf16_wgmma(const void* q, const void* k, const void* v,
                                                   const void* out, const void* lse,
                                                   const void* dout, void* dq, void* dk, void* dv,
                                                   void* delta, int b, int sq, int sk, int hq,
                                                   int hkv, int dh, float scale, int causal,
                                                   int window, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || (dh != 64 && dh != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = simt::launch_delta<__nv_bfloat16>(out, dout, delta, b, sq, hq, dh, st);
  if (err != 0 || b == 0 || sq == 0 || sk == 0) return err;
  // warpgroups a block: at head_dim 64 one (two blocks an SM, each on its own schedule), at 128
  // two (the register file holds one block an SM either way); both measured faster so
  if (dh == 64) return wg::launch_backward<64, 1>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, hq, hkv, scale, causal, window, st);
  return wg::launch_backward<128, 2>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, hq, hkv, scale, causal, window, st);
}
