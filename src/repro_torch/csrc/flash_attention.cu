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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

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
// apart, into a swizzled tile at `dst`; rows at or past `nrows` are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int64_t stride,
                                          int row0, int nrows, int tid) {
  constexpr int kChunks = DH / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads, r = i / kChunks, c = i % kChunks;
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
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int sq,
                   int sk, int hq, int hkv, float scale, int causal, int window) {
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
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk, int hq,
           int hkv, float scale, int causal, int window, void* stream) {
  const int bytes = Layout<DH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b > 0 && sq > 0 && sk > 0) {
    dim3 grid(hq, (sq + kBM - 1) / kBM, b);
    flash_kernel_wgmma<DH><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, hq, hkv,
        scale, causal, window);
  }
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
                  T* __restrict__ out, int sq, int sk, int hkv, int g, int dh, float scale,
                  int causal, int window) {
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
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk,
           int hq, int hkv, int dh, float scale, int causal, int window, void* stream) {
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
        static_cast<T*>(out), sq, sk, hkv, g, dh, scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int b, int sq, int sk, int hq, int hkv, int dh, float scale,
                                   int causal, int window, void* stream) {
  return simt::launch<float>(q, k, v, out, b, sq, sk, hq, hkv, dh, scale, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int b, int sq, int sk, int hq, int hkv, int dh, float scale,
                                    int causal, int window, void* stream) {
  return simt::launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, hq, hkv, dh, scale, causal, window,
                                     stream);
}

// bf16 on the tensor cores: head_dim 64 or 128, any Hq % Hkv == 0, and q, k, v and
// out 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k, const void* v, void* out,
                                          int b, int sq, int sk, int hq, int hkv, int dh,
                                          float scale, int causal, int window, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) return wg::launch<64>(q, k, v, out, b, sq, sk, hq, hkv, scale, causal, window, stream);
  if (dh == 128) return wg::launch<128>(q, k, v, out, b, sq, sk, hq, hkv, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
