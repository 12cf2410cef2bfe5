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
// 16-byte chunk `c8` (8 elements from column c0 + 8*c8) of row `r` of a row-major
// [rows, cols] bf16 matrix to shared address `dst` (generic `dst_ptr`); a
// chunk outside the matrix, or with `ok` false, is zero and reads nothing. `vec`:
// cols % 8 == 0 and a 16-byte aligned base, so a chunk is wholly in or out.
__device__ __forceinline__ void load_chunk(uint32_t dst, uint8_t* dst_ptr, const bf16* src,
                                           int rows, int cols, int r, int c0, bool ok, bool vec) {
  ok = ok && r < rows && c0 < cols;
  if (vec) {
    cp_async16(dst, ok ? src + static_cast<int64_t>(r) * cols + c0 : src, ok ? 16 : 0);
    return;
  }
  __align__(16) bf16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = (ok && c0 + j < cols) ? src[static_cast<int64_t>(r) * cols + c0 + j]
                                 : __float2bfloat16(0.f);
  }
  *reinterpret_cast<uint4*>(dst_ptr) = *reinterpret_cast<const uint4*>(v);
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
