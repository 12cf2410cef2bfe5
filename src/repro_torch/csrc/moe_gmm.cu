// Grouped (per-expert) matrix product for Hopper (sm_90a): the MoE expert FFN.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:moe_gmm (_gmm_kernel):
// out[e] = xe[e] @ we[e] for every expert e, xe [E, R, D], we [E, D, F],
// out [E, R, F], accumulated in float32 and written in xe's dtype. The TPU
// kernel pads R, D and F to block multiples; this one masks the ragged edges
// itself. The R rows of an expert are G groups of C rows (R = G*C); with the
// optional int32 `live` [E, G], only the first live[e, g] rows of group g may
// be non-zero: the rows past them are neither loaded nor multiplied, and
// their output rows are written as zero. An expert with no live row reads no
// weight. On the TPU an empty capacity block "costs nothing extra"; on this
// card it costs its weight bytes, which are most of what a call moves.
//
// Bound on the H100: bytes at decode, about the ridge at prefill. The expert
// weights (E*D*F elements) dominate what a call moves: at decode (C = 8) a
// call does 2*C = 16 operations per weight element read, at prefill (C = 160)
// 320, against the card's ~295 bf16 operations per byte. So each weight element
// is read from device memory once per call, and only for experts with a live
// row; the loads stream through a pipelined ring so they never wait on the
// products, and the products run on the tensor cores.
//
// Two kernels; the wrapper (kernels/moe_gmm.py:kernel_for) chooses by dtype:
//
// 1. gmm_wgmma_kernel<NI, NS>, bf16. A and B are swapped: the weight tile
//    we[e, k0:k0+64, f0:f0+128] is the M operand (M = F, 64 columns per
//    warpgroup, two warpgroups), read MN-major under wgmma's transpose bit;
//    the block's token rows are N, in NS wgmma products of NI rows each
//    (m64n8k16 for R <= 16, as at decode; m64n80k16 above, two for olmoe's
//    prefill capacity of 160; kernels/moe_gmm.py:tile_plan). So one block
//    holds up to 240 rows of one expert for 128 columns of F: each weight
//    element is read once per call (R <= 240), and xe once per 128 columns
//    of F, from the L2. The block walks D in steps of 64 through a 3- or 4-stage
//    shared-memory ring (3 where that lets two blocks share an SM, so one's
//    barrier and load issue overlap the other's products) fed by 16-byte
//    cp.async in the 128-byte swizzled layout that wgmma's descriptors read:
//    the loads of the next steps are in flight while step k multiplies. Each
//    product re-reads the weight tile from shared memory, so few wide
//    products (two n80, not five n32) keep that read under the tensor work. A
//    product of NI rows none of which is live is skipped (warpgroup-uniform).
//    Rows past `live`
//    are zero-filled in shared memory without a read. The float32 sums go out
//    through shared memory as bf16 rows, 16 bytes a store. Sources that are
//    not 16-byte aligned rows (D or F not a multiple of 8) are staged with
//    scalar loads into the same layout. No TMA and no warp specialisation.
//
// 2. gmm_f32_kernel<MF>, float32 (no float32 tensor cores): one block of 4
//    warps per (64-column F tile, row tile of up to 160 rows, expert); each
//    thread owns one column and MF*8 rows on the CUDA cores; a row tile with
//    no live row writes zeros and reads nothing.
//
// The backward (moe_gmm_backward_*; the TPU kernel has none: XLA differentiates
// the einsum of repro/kernels/ref.py:moe_gmm), kernels/moe_gmm.py:plain_backward
// in PyTorch:
//   dxe[e] = dout[e] @ we[e]^T  on the live rows, zero past them;
//   dwe[e] = xe[e]^T @ dout[e]  summed over the live rows only.
// Two grouped products, each one launch. A row past `live` is never loaded (xe and
// dout may hold anything there): dX's output rows there are written as zero and a
// row tile with no live row reads nothing; dW's K loop walks each group's live rows
// only. Each output element is summed by one block in a fixed order: no split-K and
// no atomics, so a run repeats bitwise.
//
// Bound on the H100: operations at the training shapes (olmoe-1b-7b's micro-batch,
// xe [64, 1280, 2048] against we [64, 2048, 1024]: 2*R*D*F = 344 GFLOP a product,
// about 640 operations a byte moved).
//
// 3. gmm_bwd_wgmma_kernel<KIND, BN>, bf16 (the forward's machinery): a block of two
//    warpgroups owns a 128 x BN output tile (BN 256, or 128 for a narrow product;
//    kernels/moe_gmm.py:backward_tile_plan), 64 rows a warpgroup, one wgmma
//    m64nBNk16 per 16 of K. K runs in steps of 64 through a 4-stage ring of
//    128-byte-swizzled tiles fed by 16-byte cp.async: two steps load while one
//    multiplies, and its wgmmas stay in flight while the threads issue the next
//    step's loads (wait_group 1). Both products read their operands as they lie,
//    with no transposed copy:
//      dX: C[rows, d], K = f: A = dout[e] and B(k, n) = we[e][n][k] are both
//          K-major, wgmma's native layout; dead rows of A are zero-filled without a
//          read, and a row tile with none live skips its K loop.
//      dW: C[d, f], K = the live rows: A(m, k) = xe[e][k][m] and B = dout[e] are
//          both MN-major (the transpose bits, as the forward reads we); the K loop
//          walks each group's live rows 64 at a time, the ragged end zero-filled.
//    The float32 sums go out through shared memory as bf16 rows, 16 bytes a store.
//    On the tensor cores the bound is 989 TFLOP/s; at olmoe's shape dX is 5,120
//    tiles of 128 x 256 and dW 4,096, one block an SM (193 KB of ring): 70 waves.
// 4. gmm_bwd_f32_kernel<KIND>, float32 on the CUDA cores: 64 x 64 tiles, 4 x 4 a
//    thread, K in steps of 16, through one strided loader (`stage`) into shared
//    memory, 16 bytes a load along each matrix's contiguous dim; each output
//    element is summed by one thread in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Row `row` of expert e's `groups` groups of c rows may be non-zero (live null: every row).
__device__ __forceinline__ bool row_live(const int* live, int e, int groups, int c, int row) {
  if (row >= groups * c) return false;
  return live == nullptr || row % c < live[e * groups + row / c];
}

// ---------------------------------------------------------------------------
// 1. bf16 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int kThreads = 256;            // two warpgroups
constexpr int kBM = 128;                 // F columns per block: 64 per warpgroup (wgmma's M)
constexpr int kBK = 64;                  // D per stage: one 128-byte row of the swizzle
constexpr int kATile = kBK * kBM * 2;    // weight tile bytes, two 64-column blocks

template <int NI, int NS>
struct Tile {
  static constexpr int kRows = NI * NS;              // token rows per block
  // ring stages: 4, or 3 where that lets two blocks share an SM (<= 160 rows)
  static constexpr int kStages = kRows > 64 && kRows <= 160 ? 3 : 4;
  static constexpr int kBTile = kRows * kBK * 2;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kOutLd = kBM + 8;             // epilogue row stride, elements
  static constexpr int kSmemBytes = kStages * kStage + 1024;  // + alignment slack
  static_assert(kRows <= kThreads, "one thread per row decides liveness");
  static_assert(kRows * kOutLd * 2 <= kStages * kStage, "epilogue fits in the ring");
};

// D[64 x N] += A[64 x 16] B[16 x N]: A MN-major in shared memory (transpose bit),
// B K-major in shared memory.
__device__ __forceinline__ void wgmma_tn(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tn(float (&d)[40], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, %40, %41, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(1));
}
// Accumulator fragment of m64nNk16 (per warp 16 rows of M): element i of a thread
// sits at M row lane/4 + 8*((i/2)%2) and N column 8*(i/4) + 2*(lane%4) + i%2.
template <int NI, int NS>
__global__ void __launch_bounds__(kThreads)
gmm_wgmma_kernel(const bf16* __restrict__ xe, const bf16* __restrict__ we,
                 const int* __restrict__ live, bf16* __restrict__ out, int rows, int groups,
                 int d, int f, bool vec_x, bool vec_w, bool vec_o) {
  using T = Tile<NI, NS>;
  constexpr int kRows = T::kRows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_mask;                 // bit j: product j holds a live row
  __shared__ bool s_live[kRows];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, lane = tid % 32, wgi = tid / 128, warp = (tid % 128) / 32;
  const int f0 = blockIdx.x * kBM, r0 = blockIdx.y * kRows, e = blockIdx.z;
  const int c = rows / groups;
  const bf16* xb = xe + static_cast<int64_t>(e) * rows * d;
  const bf16* wb = we + static_cast<int64_t>(e) * d * f;

  if (tid == 0) s_mask = 0;
  __syncthreads();
  if (tid < kRows) {
    const bool l = row_live(live, e, groups, c, r0 + tid);
    s_live[tid] = l;
    if (l) atomicOr(&s_mask, 1 << (tid / NI));
  }
  __syncthreads();
  const int mask = s_mask;

  // stage st <- weights we[e, k0:k0+64, f0:f0+128] and rows xe[e, r0:r0+kRows, k0:k0+64]
  auto load_stage = [&](int st, int kt) {
    const uint32_t a_s = base + st * T::kStage, b_s = a_s + kATile;
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * kBM / 8; i += kThreads) {
      const int r = i / (kBM / 8), c8 = i % (kBM / 8);
      const uint32_t off = swz(r, c8, kBK);
      load_chunk(a_s + off, smem + (a_s - base) + off, wb, d, f, k0 + r, f0 + 8 * c8, true, vec_w);
    }
    for (int i = tid; i < kRows * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c8 = i % (kBK / 8);
      const uint32_t off = swz(r, c8, kRows);
      load_chunk(b_s + off, smem + (b_s - base) + off, xb, rows, d, r0 + r, k0 + 8 * c8,
                 s_live[r], vec_x);
    }
  };

  float acc[NS][NI / 2];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) acc[j][i] = 0.f;

  const int nk = mask ? (d + kBK - 1) / kBK : 0;  // an expert tile with no live row reads nothing
#pragma unroll
  for (int st = 0; st < T::kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<T::kStages - 2>();  // step kt has landed
    fence_proxy_async();
    __syncthreads();               // ... for every thread; step kt-1's products are done
    const int next = kt + T::kStages - 1;
    if (next < nk) load_stage(next % T::kStages, next);
    cp_async_commit();

    const uint32_t a_s = base + (kt % T::kStages) * T::kStage, b_s = a_s + kATile;
#pragma unroll
    for (int j = 0; j < NS; ++j) fence_regs(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: this warpgroup's 64-column block, rows (D) 16kk .. 16kk+15, MN-major
      const uint64_t da = desc(a_s + wgi * kBK * 128 + kk * 16 * 128, kBK * 128, 1024);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        // B: token rows NI*j .. NI*j+NI-1, D columns 16kk .. 16kk+15 (32 bytes), K-major
        if (mask >> j & 1) wgmma_tn(acc[j], da, desc(b_s + j * NI * 128 + kk * 32, 16, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < NS; ++j) fence_regs(acc[j]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  // epilogue: out tile [kRows][kBM] in bf16 through shared memory, then 16-byte rows
  bf16* os = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) {
      const int m = wgi * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const int n = j * NI + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      os[n * T::kOutLd + m] = __float2bfloat16(acc[j][i]);
    }
  __syncthreads();
  for (int i = tid; i < kRows * kBM / 8; i += kThreads) {
    const int r = i / (kBM / 8), c8 = i % (kBM / 8), col = f0 + 8 * c8;
    if (r0 + r >= rows || col >= f) continue;
    bf16* o = out + (static_cast<int64_t>(e) * rows + r0 + r) * f + col;
    const bf16* s = os + r * T::kOutLd + 8 * c8;
    if (vec_o) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int j = 0; j < 8 && col + j < f; ++j) o[j] = s[j];
    }
  }
}

template <int NI, int NS>
int launch(const void* xe, const void* we, const int* live, void* out, int e, int rows,
           int groups, int d, int f, void* stream) {
  using T = Tile<NI, NS>;
  cudaError_t err = cudaFuncSetAttribute(gmm_wgmma_kernel<NI, NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  dim3 grid((f + kBM - 1) / kBM, (rows + T::kRows - 1) / T::kRows, e);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gmm_wgmma_kernel<NI, NS><<<grid, kThreads, T::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xe), static_cast<const bf16*>(we), live, static_cast<bf16*>(out),
      rows, groups, d, f, d % 8 == 0 && aligned(xe), f % 8 == 0 && aligned(we),
      f % 8 == 0 && aligned(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// 2. float32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBN = 64;        // F columns per block
constexpr int kBK = 32;
constexpr int kMaxMF = 10;     // row fragments of 16 per block: up to 160 rows

// Stage rows [r0, r0 + NR) x cols [c0, c0 + NC) of a row-major [rows, cols]
// matrix into dst [NR][NC]; entries outside the matrix, and rows whose
// `row_ok` flag is false (null: all true), become zero. With `vec`, cols is a
// multiple of 4 and src 16-byte aligned, so a vector is wholly in or out.
template <int NR, int NC>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int cols, int r0, int c0, const bool* row_ok, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < NR * NC / 4; i += kThreads) {
      const int r = i / (NC / 4), c = (i % (NC / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < rows && c0 + c < cols && (row_ok == nullptr || row_ok[r])) {
        v = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(r0 + r) * cols + c0 + c);
      }
      *reinterpret_cast<float4*>(dst + r * NC + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < NR * NC; i += kThreads) {
      const int r = i / NC, c = i % NC;
      float v = 0.f;
      if (r0 + r < rows && c0 + c < cols && (row_ok == nullptr || row_ok[r])) {
        v = src[static_cast<int64_t>(r0 + r) * cols + c0 + c];
      }
      dst[r * NC + c] = v;
    }
  }
}

template <int MF>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ xe, const float* __restrict__ we,
               const int* __restrict__ live, float* __restrict__ out, int rows, int groups,
               int d, int f, bool vec_x, bool vec_w) {
  constexpr int kBM = 16 * MF;
  constexpr int kGroups = kThreads / kBN;  // row groups: thread rows g, g + 2, g + 4, ...
  constexpr int kRows = kBM / kGroups;
  __shared__ __align__(16) float as[kBM * kBK];
  __shared__ __align__(16) float bs[kBK * kBN];
  __shared__ bool s_live[kBM];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int col = threadIdx.x % kBN, grp = threadIdx.x / kBN;
  const int c = rows / groups;
  const float* xb = xe + static_cast<int64_t>(e) * rows * d;
  const float* wb = we + static_cast<int64_t>(e) * d * f;

  int any = 0;
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    s_live[r] = row_live(live, e, groups, c, m0 + r);
    any |= s_live[r];
  }
  any = __syncthreads_or(any);  // also publishes s_live

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int k0 = 0; any && k0 < d; k0 += kBK) {  // a tile with no live row reads nothing
    load_tile<kBM, kBK>(as, xb, rows, d, m0, k0, s_live, vec_x);
    load_tile<kBK, kBN>(bs, wb, d, f, k0, n0, nullptr, vec_w);
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
      if (row < rows) out[(static_cast<int64_t>(e) * rows + row) * f + n0 + col] = acc[i];
    }
  }
}

// Row fragments per block for R rows: the fewest instantiated that hold R,
// else the largest (R > 160 then takes several row tiles).
int pick_mf(int rows) {
  constexpr int kChoices[] = {1, 2, 4, 6, 8};
  const int frags = (rows + 15) / 16;
  for (int mf : kChoices) {
    if (frags <= mf) return mf;
  }
  return kMaxMF;
}

using KernelFn = void (*)(const float*, const float*, const int*, float*, int, int, int, int,
                          bool, bool);

KernelFn kernel_for(int mf) {
  switch (mf) {
    case 1: return gmm_f32_kernel<1>;
    case 2: return gmm_f32_kernel<2>;
    case 4: return gmm_f32_kernel<4>;
    case 6: return gmm_f32_kernel<6>;
    case 8: return gmm_f32_kernel<8>;
    default: return gmm_f32_kernel<kMaxMF>;
  }
}

int launch(const void* xe, const void* we, const int* live, void* out, int e, int rows,
           int groups, int d, int f, void* stream) {
  const bool vec_x = d % 4 == 0 && reinterpret_cast<uintptr_t>(xe) % 16 == 0;
  const bool vec_w = f % 4 == 0 && reinterpret_cast<uintptr_t>(we) % 16 == 0;
  const int mf = pick_mf(rows);
  dim3 grid((f + kBN - 1) / kBN, (rows + 16 * mf - 1) / (16 * mf), e);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel_for(mf)<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xe), static_cast<const float*>(we), live,
      static_cast<float*>(out), rows, groups, d, f, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// 3. the backward: dX = dout @ we^T and dW = xe^T @ dout
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int kThreads = 256;
enum Kind { kDX = 0, kDW = 1 };

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ void put(float v, float* o) { *o = v; }

// Stages a TI x TJ tile of a product's operand into shared memory. The operand is a
// row-major matrix of `no` rows and `nc` columns (row stride `ld`); with `along_j` the
// tile's j runs along its columns (tile (i, j) = matrix (o0 + i, c0 + j)), else its i
// does (tile (i, j) = matrix (o0 + j, c0 + i)). Tile (i, j) lands at dst[i*di + j*dj].
// Entries outside the matrix, and whole rows for which live_row(row) is false, are
// zero and are not read. 16 bytes a load where `vec` (nc a multiple of 16 bytes of T
// and src 16-byte aligned).
template <typename T, int TI, int TJ, typename Live>
__device__ __forceinline__ void stage(T* dst, int di, int dj, const T* __restrict__ src,
                                      int64_t ld, bool along_j, int o0, int no, int c0, int nc,
                                      bool vec, Live live_row) {
  constexpr int V = 16 / sizeof(T);
  const int outer = along_j ? TI : TJ, inner = along_j ? TJ : TI;
  static_assert(TI % V == 0 && TJ % V == 0, "tiles hold whole vectors");
  const int nvec = inner / V;
  for (int idx = threadIdx.x; idx < outer * nvec; idx += kThreads) {
    const int o = idx / nvec, c = (idx % nvec) * V;
    const int go = o0 + o, gc = c0 + c;
    const bool row = go < no && live_row(go);
    const T* p = src + static_cast<int64_t>(go) * ld + gc;
    __align__(16) T v[V];
    if (row && vec && gc < nc) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = row && gc + e < nc ? p[e] : zero_of(T());
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = along_j ? o : c + e, j = along_j ? c + e : o;
      dst[i * di + j * dj] = v[e];
    }
  }
}

// The two products of one expert e as C[M, N] = sum_k A(m, k) B(k, n):
//   kDX: M = rows, N = d, K = f; A = dout[e] (rows live), B(k, n) = we[e][n][k]; C = dxe[e]
//   kDW: M = d, N = f, K = rows; A(m, k) = xe[e][k][m], B = dout[e]; K over live rows; C = dwe[e]
struct Problem {
  const void* xe;
  const void* we;
  const int* live;
  const void* dout;
  void* out;
  int rows, groups, d, f;
  bool vec_x, vec_w, vec_o;  // xe rows (d), we rows (f), dout rows (f): 16-byte loads
};

// Calls tile(k0, k_end) for each K step of `bk` of kind K: every step of F for kDX; for
// kDW the steps over each group's live rows (k_end: the group's first dead row).
template <int K, typename Tile>
__device__ __forceinline__ void for_k(const Problem& pr, int e, int bk, Tile tile) {
  if (K == kDX) {
    for (int k0 = 0; k0 < pr.f; k0 += bk) tile(k0, pr.f);
    return;
  }
  const int c = pr.rows / pr.groups;
  for (int g = 0; g < pr.groups; ++g) {
    const int lo = g * c;
    const int hi = lo + (pr.live ? min(max(pr.live[e * pr.groups + g], 0), c) : c);
    for (int k0 = lo; k0 < hi; k0 += bk) tile(k0, hi);
  }
}

// A tile [m0, m0 + TM) x [k0, k0 + TK) and B tile [k0, k0 + TK) x [n0, n0 + TN) of kind K
// into shared memory (A at a[m*adi + k*adj], B at b[k*bdi + n*bdj]).
template <int K, int TM, int TN, int TK, typename T>
__device__ __forceinline__ void stage_ab(const Problem& pr, int e, int m0, int n0, int k0,
                                         int k_end, T* a, int adi, int adj, T* b, int bdi,
                                         int bdj) {
  const int c = pr.rows / pr.groups;
  const int* live = pr.live;
  const int groups = pr.groups;
  auto live_row = [=](int r) { return row_live(live, e, groups, c, r); };
  auto all = [](int) { return true; };
  const T* xe = static_cast<const T*>(pr.xe) + static_cast<int64_t>(e) * pr.rows * pr.d;
  const T* we = static_cast<const T*>(pr.we) + static_cast<int64_t>(e) * pr.d * pr.f;
  const T* dout = static_cast<const T*>(pr.dout) + static_cast<int64_t>(e) * pr.rows * pr.f;
  if (K == kDX) {
    // A(m, k) = dout[m][k]: rows m, columns k; B(k, n) = we[n][k]: rows n, columns k
    stage<T, TM, TK>(a, adi, adj, dout, pr.f, true, m0, pr.rows, k0, k_end, pr.vec_o, live_row);
    stage<T, TK, TN>(b, bdi, bdj, we, pr.f, false, n0, pr.d, k0, k_end, pr.vec_w, all);
  } else {
    // A(m, k) = xe[k][m]: rows k (live, below k_end), columns m; B(k, n) = dout[k][n]
    stage<T, TM, TK>(a, adi, adj, xe, pr.d, false, k0, k_end, m0, pr.d, pr.vec_x, all);
    stage<T, TK, TN>(b, bdi, bdj, dout, pr.f, true, k0, k_end, n0, pr.f, pr.vec_o, all);
  }
}

template <int K>
__device__ __forceinline__ void mn_of(const Problem& pr, int& m, int& n) {
  m = K == kDX ? pr.rows : pr.d;
  n = K == kDX ? pr.d : pr.f;
}

// kDX: does row tile [m0, m0 + tm) hold a live row? (The block-wide vote ends with a barrier.)
template <int K>
__device__ __forceinline__ bool tile_has_work(const Problem& pr, int e, int m0, int tm) {
  if (K == kDW) return true;
  const int c = pr.rows / pr.groups;
  int any = 0;
  for (int r = threadIdx.x; r < tm; r += kThreads) any |= row_live(pr.live, e, pr.groups, c, m0 + r);
  return __syncthreads_or(any);
}

// Writes element (m, n) of expert e's output: the sum, or zero on a dead dX row.
template <int K, typename T>
__device__ __forceinline__ void write_out(const Problem& pr, int e, int m, int n, float v) {
  int mm, nn;
  mn_of<K>(pr, mm, nn);
  if (m >= mm || n >= nn) return;
  if (K == kDX && !row_live(pr.live, e, pr.groups, pr.rows / pr.groups, m)) v = 0.f;
  put(v, static_cast<T*>(pr.out) + (static_cast<int64_t>(e) * mm + m) * nn + n);
}

// bf16: wgmma on the tensor cores, float32 sums (see the file's head)
namespace tc {

using namespace hopper;

constexpr int kBM = 128;    // output rows a block: 64 a warpgroup (wgmma's M)
constexpr int kBK = 64;     // K a stage: one 128-byte row of the swizzle
constexpr int kStages = 4;  // ring stages: 2 loading, 1 multiplying, 1 read by the wgmmas in flight
constexpr int kATile = kBM * kBK * 2;

template <int BN>
struct Tile {
  static constexpr int kBTile = BN * kBK * 2;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kOutLd = BN + 8;  // epilogue row stride, elements
  static constexpr int kSmemBytes = kStages * kStage + 1024;  // + alignment slack
  static_assert(kBM * kOutLd * 2 <= kStages * kStage, "epilogue fits in the ring");
};

// D[64 x 128] += A[64 x 16] B[16 x 128], both from shared memory; TA, TB: the
// transpose bits (1: the operand is MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}
// D[64 x 256] += A[64 x 16] B[16 x 256], both from shared memory; TA, TB: the
// transpose bits (1: the operand is MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 128) {
    wgmma_n128<TA, TB>(d, a, b);
  } else {
    static_assert(BN == 256, "block columns: 128 or 256");
    wgmma_n256<TA, TB>(d, a, b);
  }
}

// Live rows of group g of expert e (every row when live is null), clamped to [0, c].
__device__ __forceinline__ int group_live(const Problem& pr, int e, int g, int c) {
  return pr.live ? min(max(pr.live[e * pr.groups + g], 0), c) : c;
}

// dW's K steps in load order: kBK rows at a time over each group's live rows, the
// ragged end of a group zero-filled. Every thread keeps the same cursor.
struct Cursor {
  int g, k0, hi;  // group, first row of the step, the group's first dead row
  __device__ __forceinline__ void settle(const Problem& pr, int e, int c) {
    while (k0 >= hi && g + 1 < pr.groups) {
      ++g;
      k0 = g * c;
      hi = k0 + group_live(pr, e, g, c);
    }
  }
};

// One (BN-column, 128-row) output tile of expert blockIdx.z's product of kind K:
//   kDX: C[rows, d] = dout[e] (K-major A) · we[e]ᵀ (K-major B: we's rows are N), K = f;
//   kDW: C[d, f] = xe[e]ᵀ (MN-major A) · dout[e] (MN-major B), K = the live rows.
template <int K, int BN>
__global__ void __launch_bounds__(kThreads, 1) gmm_bwd_wgmma_kernel(Problem pr) {
  using T = Tile<BN>;
  constexpr int kTA = K == kDW, kTB = K == kDW;  // dW's operands are MN-major
  extern __shared__ uint8_t smem_raw[];
  __shared__ bool s_live[kBM];  // kDX: row m0 + r holds a live row
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, lane = tid % 32, wgi = tid / 128, warp = (tid % 128) / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int c = pr.rows / pr.groups;
  const bf16* xe = static_cast<const bf16*>(pr.xe) + static_cast<int64_t>(e) * pr.rows * pr.d;
  const bf16* we = static_cast<const bf16*>(pr.we) + static_cast<int64_t>(e) * pr.d * pr.f;
  const bf16* dout = static_cast<const bf16*>(pr.dout) + static_cast<int64_t>(e) * pr.rows * pr.f;

  int nk = 0;  // K steps
  Cursor cur{0, 0, 0};
  if (K == kDX) {
    const bool l = tid < kBM && row_live(pr.live, e, pr.groups, c, m0 + tid);
    if (tid < kBM) s_live[tid] = l;
    // a row tile with no live row reads nothing and writes zeros
    nk = __syncthreads_or(l) ? (pr.f + kBK - 1) / kBK : 0;
  } else {
    for (int g = 0; g < pr.groups; ++g) nk += (group_live(pr, e, g, c) + kBK - 1) / kBK;
    cur.hi = group_live(pr, e, 0, c);
    cur.settle(pr, e, c);
  }

  // stage `slot` <- the A and B tiles of the next K step (steps load in order)
  auto load_stage = [&](int slot, int kt) {
    const uint32_t a_s = base + slot * T::kStage, b_s = a_s + kATile;
    uint8_t* a_p = smem + (a_s - base);
    uint8_t* b_p = a_p + kATile;
    if (K == kDX) {
      const int k0 = kt * kBK;
      for (int i = tid; i < kBM * kBK / 8; i += kThreads) {  // dout rows m, 64 of F
        const int r = i / 8, c8 = i % 8;
        const uint32_t off = swz(r, c8, kBM);
        load_chunk(a_s + off, a_p + off, dout, pr.rows, pr.f, m0 + r, k0 + 8 * c8, s_live[r],
                   pr.vec_o);
      }
      for (int i = tid; i < BN * kBK / 8; i += kThreads) {   // we rows n (D), 64 of F
        const int r = i / 8, c8 = i % 8;
        const uint32_t off = swz(r, c8, BN);
        load_chunk(b_s + off, b_p + off, we, pr.d, pr.f, n0 + r, k0 + 8 * c8, true, pr.vec_w);
      }
    } else {
      const int k0 = cur.k0, hi = cur.hi;  // rows at or past hi: zero, not read
      for (int i = tid; i < kBK * kBM / 8; i += kThreads) {  // xe rows k, 128 of D
        const int r = i / (kBM / 8), c8 = i % (kBM / 8);
        const uint32_t off = swz(r, c8, kBK);
        load_chunk(a_s + off, a_p + off, xe, hi, pr.d, k0 + r, m0 + 8 * c8, true, pr.vec_x);
      }
      for (int i = tid; i < kBK * BN / 8; i += kThreads) {   // dout rows k, BN of F
        const int r = i / (BN / 8), c8 = i % (BN / 8);
        const uint32_t off = swz(r, c8, kBK);
        load_chunk(b_s + off, b_p + off, dout, hi, pr.f, k0 + r, n0 + 8 * c8, true, pr.vec_o);
      }
      cur.k0 += kBK;
      cur.settle(pr, e, c);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // Step kt multiplies while steps kt+1 and kt+2 load; the wgmmas of step kt stay in
  // flight while the threads issue the loads of step kt+2 into the slot of step kt-2,
  // whose wgmmas the barrier at the top of step kt has seen finish.
#pragma unroll
  for (int st = 0; st < kStages - 2; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 3>();  // step kt has landed
    fence_proxy_async();
    __syncthreads();               // ... for every thread; step kt-2's wgmmas are done
    const uint32_t a_s = base + (kt % kStages) * T::kStage, b_s = a_s + kATile;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint64_t da, db;
      if (K == kDX) {  // K-major: 16 K columns are 32 bytes along each 128-byte row
        da = desc(a_s + wgi * 64 * 128 + kk * 32, 16, 1024);
        db = desc(b_s + kk * 32, 16, 1024);
      } else {         // MN-major: 16 K rows of 128 bytes; 64-column blocks kBK*128 apart
        da = desc(a_s + wgi * kBK * 128 + kk * 16 * 128, kBK * 128, 1024);
        db = desc(b_s + kk * 16 * 128, kBK * 128, 1024);
      }
      wgmma_bn<BN, kTA, kTB>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // step kt-1's wgmmas are done
    fence_regs(acc);
    const int next = kt + kStages - 2;
    if (next < nk) load_stage(next % kStages, next);
    cp_async_commit();
  }
  wgmma_wait0();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  // epilogue: the tile in bf16 through shared memory, then 16-byte rows; dX's dead rows zero
  bf16* os = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {  // accumulator pairs (i, i + 1): neighbouring columns
    const int m = wgi * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int n = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(os + m * T::kOutLd + n) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
  __syncthreads();
  const int mm = K == kDX ? pr.rows : pr.d, nn = K == kDX ? pr.d : pr.f;
  bf16* out = static_cast<bf16*>(pr.out) + static_cast<int64_t>(e) * mm * nn;
  const bool vec = nn % 8 == 0 && reinterpret_cast<uintptr_t>(pr.out) % 16 == 0;
  for (int i = tid; i < kBM * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), c8 = i % (BN / 8), row = m0 + r, col = n0 + 8 * c8;
    if (row >= mm || col >= nn) continue;
    uint4 v = *reinterpret_cast<const uint4*>(os + r * T::kOutLd + 8 * c8);
    if (K == kDX && !s_live[r]) v = make_uint4(0u, 0u, 0u, 0u);
    bf16* o = out + static_cast<int64_t>(row) * nn + col;
    if (vec) {
      *reinterpret_cast<uint4*>(o) = v;
    } else {
      const bf16* s = reinterpret_cast<const bf16*>(&v);
      for (int j = 0; j < 8 && col + j < nn; ++j) o[j] = s[j];
    }
  }
}

template <int K, int BN>
int launch_product(const Problem& pr, int e, cudaStream_t st) {
  using T = Tile<BN>;
  const cudaError_t err = cudaFuncSetAttribute(gmm_bwd_wgmma_kernel<K, BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = K == kDX ? pr.rows : pr.d, n = K == kDX ? pr.d : pr.f;
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + BN - 1) / BN, (m + kBM - 1) / kBM, e);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gmm_bwd_wgmma_kernel<K, BN><<<grid, kThreads, T::kSmemBytes, st>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

// bn_dx, bn_dw: each product's block columns (kernels/moe_gmm.py:backward_tile_plan)
int launch(const void* xe, const void* we, const int* live, const void* dout, void* dxe,
           void* dwe, int e, int rows, int groups, int d, int f, int bn_dx, int bn_dw,
           void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  Problem pr{xe, we, live, dout, dxe, rows, groups, d, f,
             d % 8 == 0 && aligned(xe), f % 8 == 0 && aligned(we), f % 8 == 0 && aligned(dout)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((bn_dx != 128 && bn_dx != 256) || (bn_dw != 128 && bn_dw != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = bn_dx == 128 ? launch_product<kDX, 128>(pr, e, st) : launch_product<kDX, 256>(pr, e, st);
  if (err != 0) return err;
  pr.out = dwe;
  return bn_dw == 128 ? launch_product<kDW, 128>(pr, e, st) : launch_product<kDW, 256>(pr, e, st);
}

}  // namespace tc

// float32: CUDA cores, 4 x 4 outputs a thread
constexpr int kFM = 64, kFN = 64, kFK = 16, kFLd = 64 + 4;

template <int K>
__global__ void __launch_bounds__(kThreads) gmm_bwd_f32_kernel(Problem pr) {
  __shared__ __align__(16) float as[kFK * kFLd];  // A(m, k) at [k][m]
  __shared__ __align__(16) float bs[kFK * kFLd];  // B(k, n) at [k][n]
  const int n0 = blockIdx.x * kFN, m0 = blockIdx.y * kFM, e = blockIdx.z;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (tile_has_work<K>(pr, e, m0, kFM)) {
    for_k<K>(pr, e, kFK, [&](int k0, int k_end) {
      stage_ab<K, kFM, kFN, kFK>(pr, e, m0, n0, k0, k_end, as, 1, kFLd, bs, kFLd, 1);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(as + k * kFLd + 4 * tm);
        const float4 b = *reinterpret_cast<const float4*>(bs + k * kFLd + 4 * tn);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    });
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) write_out<K, float>(pr, e, m0 + 4 * tm + i, n0 + 4 * tn + j, acc[i][j]);
}

int launch_f32(const void* xe, const void* we, const int* live, const void* dout, void* dxe,
               void* dwe, int e, int rows, int groups, int d, int f, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  Problem pr{xe, we, live, dout, nullptr, rows, groups, d, f,
             d % 4 == 0 && aligned(xe), f % 4 == 0 && aligned(we), f % 4 == 0 && aligned(dout)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // dX [rows, d], then dW [d, f], each expert's tiles along grid z
  for (int kind = 0; kind < 2; ++kind) {
    const int m = kind == kDX ? rows : d, n = kind == kDX ? d : f;
    if (m == 0 || n == 0) continue;
    dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM, e);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    pr.out = kind == kDX ? dxe : dwe;
    if (kind == kDX) gmm_bwd_f32_kernel<kDX><<<grid, kThreads, 0, st>>>(pr);
    else gmm_bwd_f32_kernel<kDW><<<grid, kThreads, 0, st>>>(pr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace bwd

bool bad_shape(int e, int rows, int groups, int d, int f) {
  return e < 0 || rows < 0 || d < 0 || f < 0 || e > 65535 || groups <= 0 || rows % groups != 0;
}

}  // namespace

// live: int32 [E, groups] on the device, or null (every row live).
extern "C" int moe_gmm_f32(const void* xe, const void* we, const void* live, void* out, int e,
                           int rows, int groups, int d, int f, void* stream) {
  if (bad_shape(e, rows, groups, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0 || rows == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  return simt::launch(xe, we, static_cast<const int*>(live), out, e, rows, groups, d, f, stream);
}

// ni, ns: the tile plan (kernels/moe_gmm.py:tile_plan): ns wgmma products of ni rows
// per block; the instantiated pairs are (8, 1), (8, 2), (80, 1), (80, 2) and (80, 3).
extern "C" int moe_gmm_bf16(const void* xe, const void* we, const void* live, void* out, int e,
                            int rows, int groups, int d, int f, int ni, int ns, void* stream) {
  if (bad_shape(e, rows, groups, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0 || rows == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  const int* lv = static_cast<const int*>(live);
  const int plan = ni * 16 + ns;
  switch (plan) {
    case 8 * 16 + 1: return wg::launch<8, 1>(xe, we, lv, out, e, rows, groups, d, f, stream);
    case 8 * 16 + 2: return wg::launch<8, 2>(xe, we, lv, out, e, rows, groups, d, f, stream);
    case 80 * 16 + 1: return wg::launch<80, 1>(xe, we, lv, out, e, rows, groups, d, f, stream);
    case 80 * 16 + 2: return wg::launch<80, 2>(xe, we, lv, out, e, rows, groups, d, f, stream);
    case 80 * 16 + 3: return wg::launch<80, 3>(xe, we, lv, out, e, rows, groups, d, f, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: dxe [E, rows, d] and dwe [E, d, f] in the inputs' dtype (the formula of
// kernels/moe_gmm.py:plain_backward); live as for the forward.
extern "C" int moe_gmm_backward_f32(const void* xe, const void* we, const void* live,
                                    const void* dout, void* dxe, void* dwe, int e, int rows,
                                    int groups, int d, int f, void* stream) {
  if (bad_shape(e, rows, groups, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return static_cast<int>(cudaGetLastError());
  return bwd::launch_f32(xe, we, static_cast<const int*>(live), dout, dxe, dwe, e, rows, groups,
                          d, f, stream);
}

// bn_dx, bn_dw: the block columns of the dX and dW products (128 or 256;
// kernels/moe_gmm.py:backward_tile_plan).
extern "C" int moe_gmm_backward_bf16(const void* xe, const void* we, const void* live,
                                     const void* dout, void* dxe, void* dwe, int e, int rows,
                                     int groups, int d, int f, int bn_dx, int bn_dw,
                                     void* stream) {
  if (bad_shape(e, rows, groups, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return static_cast<int>(cudaGetLastError());
  return bwd::tc::launch(xe, we, static_cast<const int*>(live), dout, dxe, dwe, e, rows, groups,
                         d, f, bn_dx, bn_dw, stream);
}
