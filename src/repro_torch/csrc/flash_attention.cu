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
// A row that allows no key is, in the plain version and the reference's chunked_attention,
// the mean of V over Sk and the zero columns that pad it to the KV block (every score of
// the row is masked alike; kernels/flash_attention.py:dead_row_keys): for shapes with such
// rows, and only for them, flash_fwd_dead first sums V by (batch, KV head) in a fixed order,
// and both kernels write that mean for every row whose running max never left kNegInf
// (ROADMAP C4). The TPU kernel instead averages over the KV blocks it visits, or gives 0.
//
// The backward (flash_attention_backward_*; the TPU kernel has none: XLA
// differentiates repro/models/attention.py:chunked_attention), the formula of
// kernels/flash_attention.py:plain_backward, without float atomics, so a run repeats
// bitwise. P and scale * dS round to q's dtype before their products (bf16: as
// plain_backward rounds them); the products sum in float32. A query row that allows no
// key (from Sk + window - 1 on) is, in plain, the mean of V over every key and the zero
// columns that pad Sk to its KV block: flash_bwd_dead, launched only for such shapes, sums
// the G heads' such rows of dO in a fixed order into a float32 [B, Hkv, dh] vector (divided
// by that count, `dead_keys`) that every dK/dV epilogue adds to dV, and writes their dq = 0
// (ROADMAP C3; the forward kernels give that mean, C4). Bound on the H100: operations (dV, dP, dQ, dK: 8 * dh flops
// a head and allowed pair).
//
// The bf16 backward at head_dim 64 and 128 runs on the tensor cores by one of two routes; the
// wrapper chooses (kernels/flash_attention.py:one_pass_for: the one pass under a causal
// sliding window, the two kernels otherwise) and the entry runs the one pass when it is handed
// the ordered dQ sums. Both start with flash_bwd_prep: D = rowsum(dO * O) and the lse in base
// 2 (+inf where no key is allowed, and past Sq) into a float32 [2, B, Hq, Sqp] workspace.
// Both walk items of 128 keys of one KV head and batch row: two consumer warpgroups own 64 keys
// each and keep their dK and dV in registers; for each query tile the item's mask reaches
// (backward_plan), the G heads in turn, a step computes S^T = K Q^T and dP^T = V dO^T (m64n64,
// K and V resident), P^T, dS^T, dV += P^T dO and dK += dS^T Q; dK and dV leave through the K
// and V tiles by TMA stores. Q, dO, lse and D stream through a two-stage ring on mbarrier
// full/empty pairs, loaded by TMA (128-byte swizzle, the layout hopper::swz and desc read).
// 1. The one pass (head_dim 64): prep, flash_bwd_wgmma<64, true>, flash_bwd_dq_convert<64>.
//    A persistent grid of co-resident blocks, launched cooperatively (all resident at once, or
//    the launch fails: it never spins on a block that other work keeps off the card), walks
//    the work list of backward_schedule. A step also computes the dQ partial dS K over the
//    warpgroup's own keys (dS^T through a shared tile, bf16): five products where the two
//    kernels need seven. A producer warpgroup (setmaxnreg 40, consumers 232) holds the loader
//    warp, which loads each item's K and V once, and two dQ writer warps, one a buffer: the
//    writer adds the two warpgroups' partials in shared memory, waits until the tile's flag
//    counts the key blocks before this one (ld.acquire), stores or bulk-adds
//    (cp.reduce.async.bulk) the 64 x 64 float32 partial into the tile's sum, frees the buffer
//    once read, and publishes the next turn (st.release) once written. A tile takes its
//    partials from its highest key block down, the work list's order, so an item waits only
//    on items taken earlier by resident blocks; under causal and windowed masks none waits.
//    flash_bwd_dq_convert writes each tile's sum as bf16 rows of dq.
// 2. The two kernels (head_dim 64 and 128): prep, flash_bwd_wgmma<DH, false> (dK/dV, one
//    block an item, no dQ), flash_bwd_dq_wgmma<DH> (dQ of 64 query positions a block: the
//    producer loads Q and dO once and streams 64-key K and V tiles; the two consumer
//    warpgroups take alternate tiles and recompute S and dP; the second's dQ is added to the
//    first's through shared memory). At head_dim 64 the dK/dV pass has the producer warpgroup
//    (setmaxnreg 24, consumers 240); at 128 its thread 0 issues the loads between steps
//    instead: with a ninth warp ptxas gives every thread 168 registers and the 192 float32
//    accumulators of dK, dV, S^T and dP^T spill (setmaxnreg's budget does not change that).
// What bounds them: at head_dim 64 a step's tensor-core work is small beside its fixed costs
// (the softmax, the barriers, the one pass's hand-over of the dQ partial), so both reach a
// small share of their bound; the two kernels recompute S and dP for dQ (seven products); the
// one pass's fixed order is a chain without a sliding window (the last of n key blocks starts
// n - 1 steps late), which is why it runs only under one (PERF.md has both routes' times).
// 3. float32, and bf16 at other head dims (<= 128): flash_bwd_delta, then dK/dV and dQ on
//    the CUDA cores (simt::flash_bwd_simt<T, KV>).
#include <cuda.h>
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// The rows that allow no key (query positions from sq0 = Sk + window - 1 on): each is the
// mean of V over `keys` columns (kernels/flash_attention.py:dead_row_keys: Sk and the zero
// columns that pad it to the plain version's KV block), so it passes dO / keys to every key's
// dV and nothing to dQ and dK. One block a (batch, KV head) sums the G heads' such rows of dO,
// in a fixed order, into dead_dv [B, Hkv, dh] (float32; the dK/dV epilogue adds it before dV
// rounds) and writes their dq = 0.
template <typename T>
__global__ void __launch_bounds__(128)
flash_bwd_dead(const T* __restrict__ dout, float* __restrict__ dead_dv, T* __restrict__ dq, int sq,
               int keys, int hq, int hkv, int dh, int sq0) {
  const int bb = blockIdx.x / hkv, kvh = blockIdx.x % hkv, g = hq / hkv;
  for (int d = threadIdx.x; d < dh; d += 128) {
    float sum = 0.f;
    for (int gi = 0; gi < g; ++gi) {
      for (int i = sq0; i < sq; ++i) {
        const int64_t at = ((static_cast<int64_t>(bb) * sq + i) * hq + kvh * g + gi) * dh + d;
        sum += to_float(dout[at]);
        from_float(0.f, &dq[at]);
      }
    }
    dead_dv[(static_cast<int64_t>(bb) * hkv + kvh) * dh + d] = sum / keys;
  }
}

template <typename T>
int launch_dead(const void* dout, void* dead_dv, void* dq, int b, int sq, int sk, int hq, int hkv,
                int dh, int window, int keys, cudaStream_t st) {
  if (dead_dv == nullptr || keys < sk) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dead<T><<<b * hkv, 128, 0, st>>>(static_cast<const T*>(dout), static_cast<float*>(dead_dv),
                                             static_cast<T*>(dq), sq, keys, hq, hkv, dh, sk + window - 1);
  return static_cast<int>(cudaGetLastError());
}

// The forward's side of the same rows: one block a (batch, KV head) sums V over the Sk
// positions in order, a thread a column, into dead_v [B, Hkv, dh] (float32, divided by
// `keys`), which both forward kernels write, rounded to the output's dtype, for every row
// whose running max never left kNegInf (the rows whose lse is -inf).
template <typename T>
__global__ void __launch_bounds__(128)
flash_fwd_dead(const T* __restrict__ v, float* __restrict__ dead_v, int sk, int keys, int hkv, int dh) {
  const int bb = blockIdx.x / hkv, kvh = blockIdx.x % hkv;
  for (int d = threadIdx.x; d < dh; d += 128) {
    float sum = 0.f;
    for (int j = 0; j < sk; ++j) sum += to_float(v[((static_cast<int64_t>(bb) * sk + j) * hkv + kvh) * dh + d]);
    dead_v[(static_cast<int64_t>(bb) * hkv + kvh) * dh + d] = sum / keys;
  }
}

// Launched only for shapes with rows that allow no key; null `dead_v` elsewhere.
template <typename T>
int launch_fwd_dead(const void* v, void* dead_v, int b, int sq, int sk, int hkv, int dh, int window,
                    int keys, cudaStream_t st, const float** dead_out) {
  *dead_out = nullptr;
  if (!(window > 0 && sq > sk + window - 1) || b == 0 || sk == 0) return 0;
  if (dead_v == nullptr || keys < sk) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_dead<T><<<b * hkv, 128, 0, st>>>(static_cast<const T*>(v), static_cast<float*>(dead_v), sk,
                                             keys, hkv, dh);
  *dead_out = static_cast<const float*>(dead_v);
  return static_cast<int>(cudaGetLastError());
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
                   float* __restrict__ lse, const float* __restrict__ dead_v, int sq, int sk, int hq,
                   int hkv, float scale, int causal, int window) {
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

  // epilogue: O / l in bf16 into the Q tile's space (same swizzle), then 16-byte rows out; a
  // row that allows no key (m never left kNegInf) takes dead_v, V's mean (flash_fwd_dead)
  const float* dead = dead_v != nullptr ? dead_v + (static_cast<int64_t>(b) * hkv + kvh) * DH : nullptr;
  bool no_key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    no_key[r] = dead != nullptr && m[r] == kNegInf;
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
      const bool nk = no_key[(i / 2) % 2];
      *reinterpret_cast<uint32_t*>(smem + swz(r, n * 8 + c / 8, kBM) + (c % 8) * 2) =
          pack_bf16(nk ? dead[n * 64 + c] : o[n][i] * inv, nk ? dead[n * 64 + c + 1] : o[n][i + 1] * inv);
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
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const float* dead_v, int b,
           int sq, int sk, int hq, int hkv, float scale, int causal, int window, void* stream) {
  const int bytes = Layout<DH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b > 0 && sq > 0 && sk > 0) {
    dim3 grid(hq, (sq + kBM - 1) / kBM, b);
    flash_kernel_wgmma<DH><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), dead_v, sq, sk, hq, hkv, scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

// ----- the backward on the tensor cores: one pass (see the file's head) -----

constexpr int kKB = 128;               // keys a work item, 64 a consumer warpgroup
constexpr int kQT = 64;                // query positions a step
constexpr int kStages = 2;             // Q, dO, lse, D ring
constexpr int kDqBufs = 2;             // dQ partials handed to the writer warps, one a buffer
// setmaxnreg's budgets: the one pass's producer warpgroup holds the dQ writer warps as well
// as the loader; the two kernels' holds the loader alone
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kMathRegs = 240, kLoaderRegs = 24;

// Shared memory of the dK/dV pass, from a 1024-byte-aligned base: K and V of the item (128
// rows each), the ring's Q and dO tiles (64 rows), with DQ (the one pass) two dS^T tiles
// (128 keys x 64 queries, bf16) and the dQ partials' buffers (float32, both warpgroups'
// fragments), the ring's lse and D (64 float32 each), then the mbarriers.
template <int DH, bool DQ>
struct Bwd {
  static_assert(!DQ || DH == 64, "the one pass runs at head_dim 64 (it spills at 128)");
  // two consumer warpgroups, then the producer's. The dK/dV pass at head_dim 128 has no
  // producer: its thread 0 issues the TMA loads between steps, so that a block is 8 warps and
  // ptxas may give a thread 255 registers. With a ninth warp a sub-partition of the SM holds
  // three and ptxas gives each 168 whatever setmaxnreg asks (CUDA 12.9): dK, dV, S^T and dP^T,
  // 192 float32 a thread, spill there (PERF.md)
  static constexpr bool kProducerWarpgroup = DQ || DH == 64;
  static constexpr int kThreads = kProducerWarpgroup ? 384 : 256;
  static constexpr int kKvBytes = kKB * DH * 2;
  static constexpr int kTileBytes = kQT * DH * 2;
  static constexpr int kDsBytes = kKB * kQT * 2;
  static constexpr int kDqFloats = 2 * 32 * 128;  // two warpgroups' m64n64 fragments
  static constexpr int kDqBytes = kDqFloats * 4;
  // a query tile's float32 dQ sum in global memory: one 64 x 64 fragment set (the two
  // warpgroups' key halves added by the writer)
  static constexpr int kAccFloats = 32 * 128;
  static constexpr int kK = 0, kV = kKvBytes, kRing = 2 * kKvBytes;
  static constexpr int kDs = kRing + kStages * 2 * kTileBytes;
  static constexpr int kDq = kDs + (DQ ? 2 * kDsBytes : 0);
  static constexpr int kStats = kDq + (DQ ? kDqBufs * kDqBytes : 0);
  static constexpr int kBars = kStats + kStages * 2 * kQT * 4;
  // kv_full, kv_empty, full[kStages], empty[kStages], dq_full[kDqBufs], dq_empty[kDqBufs]
  static constexpr int kNumBars = 2 + 2 * kStages + 2 * kDqBufs;
  static constexpr int kSmemBytes = kBars + kNumBars * 8 + 1024;  // + alignment slack
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

// D[64x64] += A[64x16] B[16x64], A K-major and B MN-major (its transpose bit) in shared
// memory.
__device__ __forceinline__ void wgmma_st(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D[64x64] (+)= A[64x16] B[16x64], both MN-major in shared memory (the transpose bits).
__device__ __forceinline__ void wgmma_tt(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// S (+)= A B^T over DH for a warpgroup's 64 rows: A rows wgi * 64 .. of a ROWS-row tile,
// B a 64-row tile, both K-major (the forward's S = Q K^T).
template <int DH, int ROWS>
__device__ __forceinline__ void product_abt(float (&d)[32], uint32_t a_s, uint32_t b_s, int wgi) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(d, desc(a_s + (kk / 4) * ROWS * 128 + wgi * 64 * 128 + off, 16, 1024),
             desc(b_s + (kk / 4) * kQT * 128 + off, 16, 1024), kk > 0);
  }
}

// D[n] += A B over the 64 rows of a 64-row tile B (MN-major, the transpose bit: the
// forward's O += P V), A from registers, for every 64-column block n of DH.
template <int DH>
__device__ __forceinline__ void product_rb(float (&d)[DH / 64][32], const uint32_t (&a)[4][4],
                                           uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < kQT / 16; ++kk)
#pragma unroll
    for (int n = 0; n < DH / 64; ++n)
      wgmma_rs(d[n], a[kk], desc(b_s + n * kQT * 128 + kk * 16 * 128, kQT * 128, 1024));
}

// dK[n] += dS^T Q for a warpgroup's 64 keys: dS^T rows wgi * 64 .. of the dS^T tile (K-major:
// queries contiguous), Q a 64-row tile read MN-major, for every 64-column block n of DH.
template <int DH>
__device__ __forceinline__ void product_sq(float (&d)[DH / 64][32], uint32_t ds_s, uint32_t q_s,
                                           int wgi) {
#pragma unroll
  for (int kk = 0; kk < kQT / 16; ++kk)
#pragma unroll
    for (int n = 0; n < DH / 64; ++n)
      wgmma_st(d[n], desc(ds_s + wgi * 64 * 128 + kk * 32, 16, 1024),
               desc(q_s + n * kQT * 128 + kk * 16 * 128, kQT * 128, 1024));
}

// dQ partial = dS K over the 64 keys from key row0 of the item (head_dim 64): dS from the dS^T
// tile (keys as rows, MN-major) and K (MN-major).
__device__ __forceinline__ void product_dq(float (&d)[32], uint32_t ds_s, uint32_t k_s, int row0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tt(d, desc(ds_s + (row0 + kk * 16) * 128, kKB * 128, 1024),
             desc(k_s + (row0 + kk * 16) * 128, kKB * 128, 1024), kk > 0);
}

// Accumulator pairs (2j, 2j + 1) of k-slice kk as the A fragments of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// The block's items. The one pass (DQ) walks its row of the work list
// (kernels/flash_attention.py:backward_schedule) and reads each key block's reach from it;
// the dK/dV pass, whose items never wait, takes one item a block, blockIdx.x with the key
// block outermost (under a causal mask the first key blocks reach the most query tiles, so
// the longest items start first), and reaches the query tiles of backward_plan's bands.
template <bool DQ>
struct Walk {
  const int* reach_lo = nullptr;  // [nkb]: each key block's first query tile
  const int* reach_hi = nullptr;  // [nkb]: ... and one past its last
  const int* row = nullptr;       // this block's count, then its items
  const int* offsets = nullptr;   // [items]: where each item's turns start
  const int* turns = nullptr;
  int nkb, nqt, groups, n_items, sk, causal, window;
  __device__ Walk(const int* s, int b, int hkv, int sq, int sk_, int causal_, int window_)
      : nkb((sk_ + kKB - 1) / kKB), nqt((sq + kQT - 1) / kQT), groups(b * hkv), n_items(1),
        sk(sk_), causal(causal_), window(window_) {
    if constexpr (DQ) {
      const int blocks = s[0], width = s[1];
      reach_lo = s + 4;
      reach_hi = reach_lo + nkb;
      row = reach_hi + nkb + blockIdx.x * (width + 1);
      offsets = reach_hi + nkb + blocks * (width + 1);
      turns = offsets + groups * nkb;
      n_items = row[0];
    }
  }
  // the block's item it: (batch * Hkv + KV head) * nkb + key block
  __device__ int item(int it) const {
    if constexpr (DQ) return row[1 + it];
    const int m = static_cast<int>(blockIdx.x) / groups;
    return static_cast<int>(blockIdx.x) % groups * nkb + m;
  }
  __device__ int lo(int m) const {
    if constexpr (DQ) return reach_lo[m];
    return causal ? min(m * kKB / kQT, nqt) : 0;
  }
  __device__ int hi(int m) const {
    if constexpr (DQ) return reach_hi[m];
    if (window <= 0) return nqt;
    const int kl = min(sk, (m + 1) * kKB) - 1;
    return max(lo(m), min(nqt, (kl + window - 1) / kQT + 1));
  }
};

// The backward of bf16 attention at head_dim DH over items of (key block of 128 keys, KV
// head, batch row): with DQ the one pass (dK, dV and the ordered dQ sums, the blocks walking
// their rows of the work list), without it the dK/dV pass of the two-kernel route.
template <int DH, bool DQ>
__global__ void __launch_bounds__(Bwd<DH, DQ>::kThreads, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
                const float* __restrict__ ws, const int* __restrict__ sched,
                float* __restrict__ acc, int* __restrict__ flags,
                const float* __restrict__ dead_dv, int b, int sq, int sk, int hq, int hkv, int sqp,
                float scale, int causal, int window) {
  using L = Bwd<DH, DQ>;
  constexpr int kNB = DH / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t bars = base + L::kBars;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int st) { return bars + 16 + 8 * st; };
  auto empty = [&](int st) { return bars + 16 + 8 * kStages + 8 * st; };
  auto dq_full = [&](int i) { return bars + 16 + 16 * kStages + 8 * i; };
  auto dq_empty = [&](int i) { return bars + 16 + 16 * kStages + 8 * kDqBufs + 8 * i; };
  auto q_tile = [&](int st) { return base + L::kRing + st * 2 * L::kTileBytes; };
  auto stats = [&](int st) { return reinterpret_cast<const float*>(smem + L::kStats) + st * 2 * kQT; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 256);
    }
    for (int i = 0; i < kDqBufs; ++i) {
      mbar_init(dq_full(i), 256);
      mbar_init(dq_empty(i), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The block's work (made by each role after its setmaxnreg: nothing but the parameters and
  // the shared-memory base is live across it). An item's steps are the query tiles of its
  // reach, each for the G heads in turn.
  auto items = [&](const Walk<DQ>& sc, int it, int& bi, int& kvh, int& m) {
    const int item = sc.item(it);
    m = item % sc.nkb;
    bi = item / sc.nkb / hkv;
    kvh = item / sc.nkb % hkv;
    return item;
  };
  // K and V of key block m (KV head kvh, batch row bi) onto kv_full
  auto load_kv = [&](int bi, int kvh, int m) {
    mbar_expect_tx(kv_full, 2 * L::kKvBytes);
#pragma unroll
    for (int cb = 0; cb < kNB; ++cb) {
      tma_load_4d(k_s + cb * kKB * 128, &tm_k, kv_full, cb * 64, kvh, m * kKB, bi);
      tma_load_4d(v_s + cb * kKB * 128, &tm_v, kv_full, cb * 64, kvh, m * kKB, bi);
    }
  };
  // Q, dO, the base-2 lse and D of query tile t, head h, batch row bi into ring stage st
  auto load_step = [&](int bi, int h, int t, int st) {
    mbar_expect_tx(full(st), 2 * L::kTileBytes + 2 * kQT * 4);
#pragma unroll
    for (int cb = 0; cb < kNB; ++cb) {
      tma_load_4d(q_tile(st) + cb * kQT * 128, &tm_q, full(st), cb * 64, h, t * kQT, bi);
      tma_load_4d(q_tile(st) + L::kTileBytes + cb * kQT * 128, &tm_do, full(st), cb * 64, h, t * kQT, bi);
    }
    const int64_t row = (static_cast<int64_t>(bi) * hq + h) * sqp + t * kQT;
    const uint32_t st_s = base + L::kStats + st * 2 * kQT * 4;
    bulk_load(st_s, ws + row, kQT * 4, full(st));
    bulk_load(st_s + kQT * 4, ws + static_cast<int64_t>(b) * hq * sqp + row, kQT * 4, full(st));
  };
  // A dQ partial (at shared src) into its tile's float32 sum in the tile's turn: the first
  // writer stores, the others add once the tile's flag counts them; returns once issued.
  auto add_partial = [&](int64_t tile, int turn, uint32_t src) {
    float* dst = acc + tile * L::kAccFloats;
    if (turn == 0) {
      bulk_store(dst, src, L::kAccFloats * 4);
    } else {
      wait_flag(flags + tile, turn);
      fence_proxy_async_global();
      bulk_add_f32(dst, src, L::kAccFloats * 4);
    }
    bulk_commit();
  };
  // once an add's writes are done (bulk_wait_all): the next writer's turn
  auto publish = [&](int64_t tile, int turn) {
    fence_proxy_async_global();
    st_release(flags + tile, turn + 1);
  };

  if (tid >= 256) {  // ---------------- producer warpgroup ----------------
    if constexpr (L::kProducerWarpgroup) setmaxnreg_dec<DQ ? kProducerRegs : kLoaderRegs>();
    const int g = hq / hkv;
    const Walk<DQ> sc(sched, b, hkv, sq, sk, causal, window);
    const int n_items = sc.n_items;
    const int warp = (tid - 256) / 32, lane = tid % 32;
    if (warp == 0 && lane == 0) {
      // the loader: an item's first ring stages, then its K and V (once the last item's
      // epilogue has stored dK and dV from their tiles), then the ring a step
      int st = 0, ph = 0;
      for (int it = 0; it < n_items; ++it) {
        int bi, kvh, m;
        items(sc, it, bi, kvh, m);
        const int t0 = sc.lo(m), n_steps = (sc.hi(m) - t0) * g;
        if (n_steps == 0) {
          mbar_wait(kv_empty, (it & 1) ^ 1);
          load_kv(bi, kvh, m);
        }
        for (int j = 0; j < n_steps; ++j) {
          mbar_wait(empty(st), ph ^ 1);
          load_step(bi, kvh * g + j % g, t0 + j / g, st);
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
          if (j + 1 == min(kStages, n_steps)) {
            mbar_wait(kv_empty, (it & 1) ^ 1);
            load_kv(bi, kvh, m);
          }
        }
      }
    } else if (DQ && warp >= 1 && warp <= kDqBufs) {
      // the dQ writers: writer w takes the steps of buffer w - 1 (every other step), adds
      // each partial to its tile's float32 sum in the tile's turn, and frees the buffer once
      // the add has read it (one writer a buffer: a writer never waits on a buffer's barrier
      // a phase ahead of the last it saw end)
      int n = 0;  // steps so far
      for (int it = 0; it < n_items; ++it) {
        int bi, kvh, m;
        const int item = items(sc, it, bi, kvh, m);
        for (int t = sc.lo(m); t < sc.hi(m); ++t) {
          const int turn = sc.turns[sc.offsets[item] + t - sc.lo(m)];
          for (int gi = 0; gi < g; ++gi, ++n) {
            const int slot = n % kDqBufs;
            if (slot != warp - 1) continue;
            mbar_wait(dq_full(slot), (n / kDqBufs) & 1);
            {  // the second warpgroup's key half onto the first's
              float4* p0 = reinterpret_cast<float4*>(smem + L::kDq + slot * L::kDqBytes);
              const float4* p1 = p0 + L::kDqFloats / 8;
              for (int i = lane; i < L::kDqFloats / 8; i += 32) {
                const float4 x = p0[i], y = p1[i];
                p0[i] = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
              }
              fence_proxy_async();
              __syncwarp();
            }
            if (lane == 0) {  // the add; its buffer is free once read; then published
              const int64_t tile = (static_cast<int64_t>(bi) * hq + kvh * g + gi) * sc.nqt + t;
              add_partial(tile, turn, base + L::kDq + slot * L::kDqBytes);
              bulk_wait_read_all();
              mbar_arrive(dq_empty(slot));
              bulk_wait_all();
              publish(tile, turn);
            }
            __syncwarp();
          }
        }
      }
    }
    return;
  }
  if constexpr (L::kProducerWarpgroup) setmaxnreg_inc<DQ ? kConsumerRegs : kMathRegs>();

  // ---------------- consumers: two warpgroups of 64 keys each ----------------
  const int g = hq / hkv;
  const Walk<DQ> sc(sched, b, hkv, sq, sk, causal, window);
  const int n_items = sc.n_items;
  const int lane = tid % 32, wgi = tid / 128, warp = (tid % 128) / 32, wtid = tid % 128;
  const float scale2 = scale * kLog2e;
  int st = 0, ph = 0, step = 0;
  for (int it = 0; it < n_items; ++it) {
    int bi, kvh, m;
    items(sc, it, bi, kvh, m);
    const int k0 = m * kKB, wg_first = k0 + wgi * 64, wg_last = wg_first + 63;
    const int key0 = wg_first + warp * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
    float dk_acc[kNB][32], dv_acc[kNB][32];
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
    const int t_begin = sc.lo(m), t_end = sc.hi(m), n_steps = (t_end - t_begin) * g;
    if constexpr (!L::kProducerWarpgroup) {  // no producer (one item a block): K, V and the
      if (tid == 0) {                        // ring's first stages from thread 0
        for (int j = 0; j < min(kStages, n_steps); ++j) load_step(bi, kvh * g + j % g, t_begin + j / g, j);
        load_kv(bi, kvh, m);
      }
      __syncwarp();
    }
    mbar_wait(kv_full, it & 1);

    for (int t = t_begin; t < t_end; ++t) {
      const int qf = t * kQT, ql = qf + kQT - 1;
      const bool need_mask = (causal && wg_last > qf) || (window > 0 && ql - wg_first >= window) ||
                             wg_last >= sk || ql >= sq;
      for (int gi = 0; gi < g; ++gi, ++step) {
        if constexpr (!L::kProducerWarpgroup) {
          // thread 0 refills the stage of the step before this one, once both warpgroups have
          // freed it, with the step kStages after that one
          const int jn = step - 1 + kStages;
          if (tid == 0 && step >= 1 && jn < n_steps) {
            mbar_wait(empty((step - 1) % kStages), ((step - 1) / kStages) & 1);
            load_step(bi, kvh * g + jn % g, t_begin + jn / g, (step - 1) % kStages);
          }
          __syncwarp();
        }
        mbar_wait(full(st), ph);
        const uint32_t q_s = q_tile(st), do_s = q_s + L::kTileBytes;
        const float* lse2 = stats(st);
        const float* dd = lse2 + kQT;
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        fence_regs(s);
        fence_regs(dp);
        uint32_t ka = k_s, va = v_s;  // opaque: no descriptor is held in registers across steps
        asm volatile("" : "+r"(ka), "+r"(va));
        wgmma_fence();
        product_abt<DH, kKB>(s, ka, q_s, wgi);    // S^T = K Q^T
        wgmma_commit();
        product_abt<DH, kKB>(dp, va, do_s, wgi);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<1>();  // S^T has landed; P^T is computed while dP^T multiplies
        fence_regs(s);
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
        wgmma_wait0();  // dP^T has landed
        fence_regs(dp);
        if constexpr (!DQ) {
          // dS^T = P^T (dP^T - D) scale; P^T and dS^T as the bf16 A fragments of dV and dK
          // (S^T and dP^T die before either product is issued)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
            dp[i] = s[i] * (dp[i] - dd[col]) * scale;
          }
          uint32_t pa[4][4], da[4][4];
          pack_a(pa, s);
          pack_a(da, dp);
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            fence_regs(dv_acc[n]);
            fence_regs(dk_acc[n]);
          }
          wgmma_fence();
          product_rb<DH>(dv_acc, pa, do_s);  // dV += P^T dO
          product_rb<DH>(dk_acc, da, q_s);   // dK += dS^T Q (Q read MN-major)
          wgmma_commit();
          wgmma_wait0();
          mbar_arrive(empty(st));  // the stage is free
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
        } else {
          // dS^T = P^T (dP^T - D) scale, as bf16 into the dS^T tile (the A operand of dK and
          // dQ) straight from its registers; then P^T as the bf16 A fragments of dV: S^T and
          // dP^T die before any product is issued
          uint8_t* ds_tile = smem + L::kDs + (step & 1) * L::kDsBytes;
          {  // pair (i, i + 1) sits at row wgi * 64 + warp * 16 + lane / 4 + 8 ((i / 2) % 2),
             // columns 8 (i / 4) + 2 (lane % 4) ..: chunk i / 4, swizzled by lane / 4
            int ln = lane, row0 = wgi * 64 + warp * 16;
            asm volatile("" : "+r"(ln), "+r"(row0));
            const int x = ln / 4;
            uint8_t* ds_row = ds_tile + (row0 + x) * 128 + (ln % 4) * 4;
#pragma unroll
            for (int i = 0; i < 32; i += 2) {
              const int col = 8 * (i / 4) + 2 * (lane % 4);
              const float d0 = s[i] * (dp[i] - dd[col]) * scale;
              const float d1 = s[i + 1] * (dp[i + 1] - dd[col + 1]) * scale;
              *reinterpret_cast<uint32_t*>(ds_row + ((i / 2) % 2) * 8 * 128 + (((i / 4) ^ x) << 4)) =
                  pack_bf16(d0, d1);
            }
          }
          uint32_t pa[4][4];
          pack_a(pa, s);
#pragma unroll
          for (int n = 0; n < kNB; ++n) fence_regs(dv_acc[n]);
          wgmma_fence();
          product_rb<DH>(dv_acc, pa, do_s);  // dV += P^T dO
          wgmma_commit();
          fence_proxy_async();
          named_barrier(2 + wgi, 128);  // the warpgroup's rows of dS^T are in the tile
          const uint32_t ds_s = base + L::kDs + (step & 1) * L::kDsBytes;
#pragma unroll
          for (int n = 0; n < kNB; ++n) fence_regs(dk_acc[n]);
          wgmma_fence();
          product_sq<DH>(dk_acc, ds_s, q_s, wgi);  // dK += dS^T Q
          wgmma_commit();
          float dqp[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) dqp[i] = 0.f;
          fence_regs(dqp);
          wgmma_fence();
          product_dq(dqp, ds_s, k_s, wgi * 64);  // the dQ partial over its own 64 keys
          wgmma_commit();
          wgmma_wait<1>();  // dV and dK are done (dQ may be in flight): the stage is free
          mbar_arrive(empty(st));
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
          // to the buffer's writer warp, fragment-major: element i of thread w of warpgroup p
          // (keys p * 64 ..) at (p * 32 + i) * 128 + w
          const int slot = step % kDqBufs;
          mbar_wait(dq_empty(slot), ((step / kDqBufs) & 1) ^ 1);
          wgmma_wait0();
          fence_regs(dqp);
          float* buf = reinterpret_cast<float*>(smem + L::kDq + slot * L::kDqBytes) + wgi * 32 * 128 + wtid;
#pragma unroll
          for (int i = 0; i < 32; ++i) buf[i * 128] = dqp[i];
          fence_proxy_async();
          mbar_arrive(dq_full(slot));
        }
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          fence_regs(dk_acc[n]);
          fence_regs(dv_acc[n]);
        }
      }
    }

    // epilogue: dK, and dV plus dO / n of the rows that allow no key, as bf16 into the K and
    // V tiles (their swizzle), once both warpgroups' last products have read them; then a
    // TMA store of each, whose reads end before the next item's K and V may land
    named_barrier(1, 256);
    const float* dead = dead_dv != nullptr ? dead_dv + (static_cast<int64_t>(bi) * hkv + kvh) * DH : nullptr;
    // this thread's rows r = row0 + ln / 4 (+ 8) all have r % 8 = ln / 4, so each pair's
    // swizzled address is a row base plus constants (made here, not hoisted out of the steps)
    int ln = lane, row0 = wgi * 64 + warp * 16;
    asm volatile("" : "+r"(ln), "+r"(row0));
    const int x = ln / 4;
    uint8_t* k_row = smem + L::kK + (row0 + x) * 128 + (ln % 4) * 4;
    const float* dead_c = dead != nullptr ? dead + 2 * (ln % 4) : nullptr;
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * q + 2 * hh;
          const int at = n * kKB * 128 + hh * 8 * 128 + ((q ^ x) << 4);
          const float v0 = dv_acc[n][i] + (dead_c != nullptr ? dead_c[n * 64 + 8 * q] : 0.f);
          const float v1 = dv_acc[n][i + 1] + (dead_c != nullptr ? dead_c[n * 64 + 8 * q + 1] : 0.f);
          *reinterpret_cast<uint32_t*>(k_row + at) = pack_bf16(dk_acc[n][i], dk_acc[n][i + 1]);
          *reinterpret_cast<uint32_t*>(k_row + (L::kV - L::kK) + at) = pack_bf16(v0, v1);
        }
    fence_proxy_async();
    named_barrier(1, 256);
    if (tid == 0) {
#pragma unroll
      for (int cb = 0; cb < kNB; ++cb) {
        tma_store_4d(&tm_dk, k_s + cb * kKB * 128, cb * 64, kvh, k0, bi);
        tma_store_4d(&tm_dv, v_s + cb * kKB * 128, cb * 64, kvh, k0, bi);
      }
      bulk_commit();
      bulk_wait_read_all();
      mbar_arrive(kv_empty);
    }
  }
  if (tid == 0) bulk_wait_all();
}

// The dQ pass of the two-kernel route: dQ of 64 query positions of one head and batch row
// (one item a block, the last positions first: under a causal mask they reach the most keys).
// The producer warp TMA-loads the block's Q and dO (and their base-2 lse and D) once and
// streams the 64-key K and V tiles its mask reaches through a ring on mbarrier full/empty
// pairs. The two consumer warpgroups take alternate key tiles (each its own two stages of
// the ring); a step recomputes S = Q K^T and dP = dO V^T, then dQ += dS K with dS from
// registers. At the end the second warpgroup's dQ is added to the first's through shared
// memory: a fixed order, so a run repeats bitwise. (128-position blocks, a warpgroup each
// half, were as fast at granite's shape and 1.4x slower at whisper's cross attention, whose
// grid they leave at 32 blocks: PERF.md.)
template <int DH>
struct BwdDq {
  static constexpr int kThreads = 384;
  static constexpr int kRows = 64;
  static constexpr int kRing = 4;  // two stages a warpgroup
  static constexpr int kBigBytes = kRows * DH * 2;   // Q or dO
  static constexpr int kTileBytes = kQT * DH * 2;    // one K or V tile
  static constexpr int kQ = 0, kDo = kBigBytes, kRingOff = 2 * kBigBytes;
  static constexpr int kStats = kRingOff + kRing * 2 * kTileBytes;
  static constexpr int kBars = kStats + 2 * kRows * 4;
  static constexpr int kNumBars = 1 + 2 * kRing;  // qo_full, full[kRing], empty[kRing]
  static constexpr int kSmemBytes = kBars + kNumBars * 8 + 1024;
  static_assert(kRing * 2 * kTileBytes >= 64 * DH * 4, "the ring holds a dQ block");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

template <int DH>
__global__ void __launch_bounds__(BwdDq<DH>::kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ ws, int b,
                   int sq, int sk, int hq, int hkv, int sqp, float scale, int causal, int window) {
  using L = BwdDq<DH>;
  constexpr int kNB = DH / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base + L::kQ, do_s = base + L::kDo;
  const uint32_t bars = base + L::kBars, qo_full = bars;
  auto full = [&](int st) { return bars + 8 + 8 * st; };
  auto empty = [&](int st) { return bars + 8 + 8 * L::kRing + 8 * st; };
  auto k_tile = [&](int st) { return base + L::kRingOff + st * 2 * L::kTileBytes; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(qo_full, 1);
    for (int i = 0; i < L::kRing; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the item: query block qb (the last first), head h, batch row bi; its K/V tiles
  const int groups = b * hq, nqb = (sq + L::kRows - 1) / L::kRows;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / groups;
  const int h = static_cast<int>(blockIdx.x) % groups % hq, bi = static_cast<int>(blockIdx.x) % groups / hq;
  const int q0 = qb * L::kRows, kvh = h / (hq / hkv);
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kQT : 0;
  int t_end = (sk + kQT - 1) / kQT;
  if (causal) t_end = min(t_end, (q0 + L::kRows - 1) / kQT + 1);

  if (tid >= 256) {  // ---------------- producer warpgroup: one loader thread ----------------
    setmaxnreg_dec<kLoaderRegs>();
    if (tid == 256) {
      mbar_expect_tx(qo_full, 2 * L::kBigBytes + 2 * L::kRows * 4);
#pragma unroll
      for (int cb = 0; cb < kNB; ++cb) {
        tma_load_4d(q_s + cb * L::kRows * 128, &tm_q, qo_full, cb * 64, h, q0, bi);
        tma_load_4d(do_s + cb * L::kRows * 128, &tm_do, qo_full, cb * 64, h, q0, bi);
      }
      const int64_t row = (static_cast<int64_t>(bi) * hq + h) * sqp + q0;
      bulk_load(base + L::kStats, ws + row, L::kRows * 4, qo_full);
      bulk_load(base + L::kStats + L::kRows * 4, ws + static_cast<int64_t>(b) * hq * sqp + row,
                L::kRows * 4, qo_full);
      for (int t = t_begin; t < t_end; ++t) {
        const int j = t - t_begin, st = j % L::kRing;
        mbar_wait(empty(st), ((j / L::kRing) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kNB; ++cb) {
          tma_load_4d(k_tile(st) + cb * kQT * 128, &tm_k, full(st), cb * 64, kvh, t * kQT, bi);
          tma_load_4d(k_tile(st) + L::kTileBytes + cb * kQT * 128, &tm_v, full(st), cb * 64, kvh,
                      t * kQT, bi);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kMathRegs>();

  // ---------------- consumers: two warpgroups, alternate key tiles ----------------
  const int lane = tid % 32, wgi = tid / 128, warp = (tid % 128) / 32, wtid = tid % 128;
  const int wg_first = q0, wg_last = q0 + 63;
  const int rl = warp * 16 + lane / 4;  // this thread's rows: rl, rl + 8 of the block
  const int row0 = q0 + rl;
  const float scale2 = scale * kLog2e;
  mbar_wait(qo_full, 0);
  const float* stat = reinterpret_cast<const float*>(smem + L::kStats);
  const float lse2[2] = {stat[rl], stat[rl + 8]};
  const float dd[2] = {stat[L::kRows + rl], stat[L::kRows + rl + 8]};
  float dq_acc[kNB][32];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[n][i] = 0.f;

  for (int t = t_begin + wgi; t < t_end; t += 2) {
    const int j = t - t_begin, st = j % L::kRing;
    mbar_wait(full(st), (j / L::kRing) & 1);
    const int k0 = t * kQT;
    // a tile that every row of this warpgroup masks is skipped (warpgroup-uniform)
    const bool skip = (causal && k0 > wg_last) || (window > 0 && wg_first - (k0 + kQT - 1) >= window);
    if (!skip) {
      const uint32_t k_s = k_tile(st), v_s = k_s + L::kTileBytes;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      product_abt<DH, L::kRows>(s, q_s, k_s, 0);    // S = Q K^T
      wgmma_commit();
      product_abt<DH, L::kRows>(dp, do_s, v_s, 0);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();  // S has landed; P is computed while dP multiplies
      fence_regs(s);
      const bool need_mask = (causal && k0 + kQT - 1 > wg_first) ||
                             (window > 0 && wg_last - k0 >= window) || k0 + kQT > sk;
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
    mbar_arrive(empty(st));
  }

  // epilogue: the second warpgroup's dQ onto the first's through the ring's space, once every
  // product has read the ring; then dQ as bf16 into the Q tile (its swizzle) and a TMA store
  // (rows past Sq are not written)
  named_barrier(1, 256);
  float* part = reinterpret_cast<float*>(smem + L::kRingOff) + wtid;
  if (wgi == 1) {
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) part[(n * 32 + i) * 128] = dq_acc[n][i];
  }
  named_barrier(1, 256);
  if (wgi == 1) return;
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[n][i] += part[(n * 32 + i) * 128];
  int ln = lane, rb = warp * 16;
  asm volatile("" : "+r"(ln), "+r"(rb));
  const int x = ln / 4;
  uint8_t* q_row = smem + L::kQ + (rb + x) * 128 + (ln % 4) * 4;
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * q + 2 * hh;
        *reinterpret_cast<uint32_t*>(q_row + n * L::kRows * 128 + hh * 8 * 128 + ((q ^ x) << 4)) =
            pack_bf16(dq_acc[n][i], dq_acc[n][i + 1]);
      }
  fence_proxy_async();
  named_barrier(2, 128);
  if (tid == 0) {
#pragma unroll
    for (int cb = 0; cb < kNB; ++cb) tma_store_4d(&tm_dq, q_s + cb * L::kRows * 128, cb * 64, h, q0, bi);
    bulk_commit();
    bulk_wait_all();
  }
}

// The backward's last launch: each query tile's float32 dQ sum, fragment-major as the dQ
// writers left it (at head_dim 64 the two warpgroups' key halves, added here), as bf16 rows
// of dq, one block a tile. Rows from `live` on allow no key: flash_bwd_dead wrote them, and
// a tile of such rows alone has no sum.
template <int DH>
__global__ void __launch_bounds__(128)
flash_bwd_dq_convert(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq, int sq, int hq,
                     int nqt, int live) {
  constexpr int kFloats = Bwd<DH, true>::kAccFloats;
  __shared__ __align__(16) float part[kFloats];
  const int64_t tile = blockIdx.x;
  const int t = static_cast<int>(tile % nqt), h = static_cast<int>(tile / nqt % hq);
  const int64_t bi = tile / nqt / hq;
  const float4* a = reinterpret_cast<const float4*>(acc + tile * kFloats);
  for (int i = threadIdx.x; i < kFloats / 4; i += 128) reinterpret_cast<float4*>(part)[i] = a[i];
  __syncthreads();
  // 16-byte chunks of dq rows: element (r, c) of the tile is fragment element i of thread
  // w = 32 (r / 16) + 4 (r % 8) + (c % 8) / 2 of part p = c / 64 (the column half),
  // i = 4 ((c % 64) / 8) + 2 ((r % 16) / 8) + c % 2; eight columns are two float4 of part
  constexpr int kChunks = DH / 8;
  const int rows = min(sq - t * kQT, live - t * kQT);
  for (int j = threadIdx.x; j < kQT * kChunks; j += 128) {
    const int r = j / kChunks, c0 = j % kChunks * 8;
    if (r >= rows) continue;
    const int p = c0 / 64, i = 4 * ((c0 % 64) / 8) + 2 * ((r % 16) / 8);
    const int w = 32 * (r / 16) + 4 * (r % 8);
    const float4 e = *reinterpret_cast<const float4*>(part + (p * 32 + i) * 128 + w);
    const float4 o = *reinterpret_cast<const float4*>(part + (p * 32 + i + 1) * 128 + w);
    const uint4 out = make_uint4(pack_bf16(e.x, o.x), pack_bf16(e.y, o.y), pack_bf16(e.z, o.z),
                                 pack_bf16(e.w, o.w));
    *reinterpret_cast<uint4*>(dq + ((bi * sq + t * kQT + r) * hq + h) * DH + c0) = out;
  }
}

// The backward's first launch: D = rowsum(dO * O) and the logsumexp in base 2 (+inf where
// no key is allowed) of each query row into ws [2][B * Hq][sqp] (rows past Sq: +inf and
// 0, so the ring's last tile reads P = 0), one warp a row, and every dQ flag to 0.
__global__ void __launch_bounds__(256)
flash_bwd_prep(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ ws, int* __restrict__ flags,
               int64_t rows, int n_flags, int sq, int hq, int sqp, int dh) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; i < n_flags;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    flags[i] = 0;
  }
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int pos = static_cast<int>(row % sqp);
  const int64_t bh = row / sqp, h = bh % hq, bb = bh / hq;
  float sum = 0.f;
  if (pos < sq) {
    const int64_t at = ((bb * sq + pos) * hq + h) * dh;
    for (int d = lane; d < dh; d += 32) sum += __bfloat162float(o[at + d]) * __bfloat162float(dout[at + d]);
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    ws[row] = pos < sq ? lse_base2(lse[bh * sq + pos]) : INFINITY;
    ws[rows + row] = sum;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The rows of one head of a bf16 [B, S, H, dh] tensor: a box of `rows` positions x 64
// columns (one 128-byte swizzled column block), positions past S read as zeros.
bool rows_map(CUtensorMap* map, const void* base, int b, int s, int h, int dh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(dh) * 2, static_cast<cuuint64_t>(h) * dh * 2,
                                 static_cast<cuuint64_t>(s) * h * dh * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Blocks of the one pass (flash_bwd_wgmma<DH, true>) that can be resident at once on the
// current device: the largest grid a cooperative launch of it takes.
template <int DH>
int resident_blocks() {
  const int bytes = Bwd<DH, true>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_wgmma<DH, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int per_sm = 0, sms = 0, dev = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_bwd_wgmma<DH, true>,
                                                        Bwd<DH, true>::kThreads, bytes);
  }
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// prep (D, the base-2 lse, the dQ flags when given) and, for shapes with rows that allow no
// key, flash_bwd_dead: the launches before either route's main kernels. sqp is Sq rounded up
// to the route's query tile.
inline int launch_prep(const void* out, const void* lse, const void* dout, void* dq, void* ws,
                       void* flags, void* dead_dv, int b, int sq, int sk, int hq, int hkv, int dh,
                       int sqp, int window, int dead_keys, cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(b) * hq * sqp;
  const int n_flags = flags != nullptr ? b * hq * (sqp / kQT) : 0;
  using bf = __nv_bfloat16;
  flash_bwd_prep<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf*>(out), static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(ws), static_cast<int*>(flags), rows, n_flags, sq, hq, sqp, dh);
  if (window > 0 && sq > sk + window - 1) {
    return launch_dead<bf>(dout, dead_dv, dq, b, sq, sk, hq, hkv, dh, window, dead_keys, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The one pass: prep, [dead], the cooperative launch of the persistent grid, the conversion.
// A cooperative launch makes every block of the grid resident at once (a block waits on
// items of the others) or fails: with the SMs partly held by other work it waits for them.
template <int DH>
int launch_one_pass(const void* q, const void* k, const void* v, const void* out, const void* lse,
                    const void* dout, void* dq, void* dk, void* dv, void* ws, void* acc, void* flags,
                    void* dead_dv, const void* sched, int b, int sq, int sk, int hq, int hkv,
                    float scale, int causal, int window, int dead_keys, int blocks, cudaStream_t st) {
  using L = Bwd<DH, true>;
  const int resident = resident_blocks<DH>();
  if (resident < 0) return -resident;
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || blocks <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  if (!rows_map(&tm_q, q, b, sq, hq, DH, kQT) || !rows_map(&tm_do, dout, b, sq, hq, DH, kQT) ||
      !rows_map(&tm_k, k, b, sk, hkv, DH, kKB) || !rows_map(&tm_v, v, b, sk, hkv, DH, kKB) ||
      !rows_map(&tm_dk, dk, b, sk, hkv, DH, kKB) || !rows_map(&tm_dv, dv, b, sk, hkv, DH, kKB)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sqp = (sq + kQT - 1) / kQT * kQT;
  int err = launch_prep(out, lse, dout, dq, ws, flags, dead_dv, b, sq, sk, hq, hkv, DH, sqp, window,
                        dead_keys, st);
  if (err != 0) return err;
  const bool dead = window > 0 && sq > sk + window - 1;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kSmemBytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_bwd_wgmma<DH, true>, tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv,
                         static_cast<const float*>(ws), static_cast<const int*>(sched),
                         static_cast<float*>(acc), static_cast<int*>(flags),
                         dead ? static_cast<const float*>(dead_dv) : nullptr, b, sq, sk, hq, hkv, sqp,
                         scale, causal, window);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int live = window > 0 ? min(sq, sk + window - 1) : sq;
  flash_bwd_dq_convert<DH><<<b * hq * (sqp / kQT), 128, 0, st>>>(
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(dq), sq, hq, sqp / kQT, live);
  return static_cast<int>(cudaGetLastError());
}

// The two-kernel route: prep, [dead], the dK/dV pass (flash_bwd_wgmma<DH, false>, one block an
// item), the dQ pass (flash_bwd_dq_wgmma<DH>, one block a 128-position query block).
template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, void* dq, const float* ws,
              int b, int sq, int sk, int hq, int hkv, int sqp, float scale, int causal, int window,
              cudaStream_t st) {
  using Q = BwdDq<DH>;
  const cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DH>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  if (!rows_map(&tm_q, q, b, sq, hq, DH, Q::kRows) || !rows_map(&tm_do, dout, b, sq, hq, DH, Q::kRows) ||
      !rows_map(&tm_k, k, b, sk, hkv, DH, kQT) || !rows_map(&tm_v, v, b, sk, hkv, DH, kQT) ||
      !rows_map(&tm_dq, dq, b, sq, hq, DH, Q::kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_bwd_dq_wgmma<DH><<<b * hq * ((sq + Q::kRows - 1) / Q::kRows), Q::kThreads, Q::kSmemBytes, st>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dq, ws, b, sq, sk, hq, hkv, sqp, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// The two-kernel route: prep, [dead], the dK/dV pass (flash_bwd_wgmma<DH, false>, one block an
// item), the dQ pass (flash_bwd_dq_wgmma<DH>, one block 64 query positions).
template <int DH>
int launch_two_kernels(const void* q, const void* k, const void* v, const void* out, const void* lse,
                       const void* dout, void* dq, void* dk, void* dv, void* ws, void* dead_dv, int b,
                       int sq, int sk, int hq, int hkv, float scale, int causal, int window,
                       int dead_keys, cudaStream_t st) {
  using KV = Bwd<DH, false>;
  const cudaError_t e = cudaFuncSetAttribute(flash_bwd_wgmma<DH, false>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, KV::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  if (!rows_map(&tm_q, q, b, sq, hq, DH, kQT) || !rows_map(&tm_do, dout, b, sq, hq, DH, kQT) ||
      !rows_map(&tm_k, k, b, sk, hkv, DH, kKB) || !rows_map(&tm_v, v, b, sk, hkv, DH, kKB) ||
      !rows_map(&tm_dk, dk, b, sk, hkv, DH, kKB) || !rows_map(&tm_dv, dv, b, sk, hkv, DH, kKB)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sqp = (sq + kQT - 1) / kQT * kQT;
  int err = launch_prep(out, lse, dout, dq, ws, nullptr, dead_dv, b, sq, sk, hq, hkv, DH, sqp, window,
                        dead_keys, st);
  if (err != 0) return err;
  const bool dead = window > 0 && sq > sk + window - 1;
  const float* wsf = static_cast<const float*>(ws);
  const int nkb = (sk + kKB - 1) / kKB;
  flash_bwd_wgmma<DH, false><<<b * hkv * nkb, KV::kThreads, KV::kSmemBytes, st>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, wsf, nullptr, nullptr, nullptr,
      dead ? static_cast<const float*>(dead_dv) : nullptr, b, sq, sk, hq, hkv, sqp, scale, causal,
      window);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_dq<DH>(q, k, v, dout, dq, wsf, b, sq, sk, hq, hkv, sqp, scale, causal, window, st);
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
                  T* __restrict__ out, float* __restrict__ lse, const float* __restrict__ dead_v,
                  int sq, int sk, int hkv, int g, int dh, float scale, int causal, int window) {
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
    // a row that allows no key: V's mean (flash_fwd_dead)
    const float* dead = dead_v != nullptr && m[i] == kNegInf
                            ? dead_v + (static_cast<int64_t>(b) * hkv + h) * dh : nullptr;
#pragma unroll
    for (int j = 0; j < kDhPerThread; ++j) {
      const int c = cx + j * kColGroups;
      if (c < dh) from_float(dead != nullptr ? dead[c] : acc[i][j] * inv, &orow[c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const float* dead_v, int b,
           int sq, int sk, int hq, int hkv, int dh, float scale, int causal, int window, void* stream) {
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
        static_cast<T*>(out), static_cast<float*>(lse), dead_v, sq, sk, hkv, g, dh, scale, causal,
        window);
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
               const float* __restrict__ delta, const float* __restrict__ dead_dv, T* __restrict__ d1,
               T* __restrict__ d2, int sq, int sk, int hkv, int g, int dh, float scale, int causal,
               int window) {
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
      if constexpr (KV) {  // + dO / keys of each row that allows no key (flash_bwd_dead)
        const float dead = dead_dv != nullptr ? dead_dv[(static_cast<int64_t>(b) * hkv + kvh) * dh + col] : 0.f;
        from_float(acc2[c] + dead, &d2[static_cast<int64_t>(b) * sk * kv_stride + row * kv_stride +
                                       kvh * dh + col]);
      }
    }
  }
}

template <typename T>
int launch_backward(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dead_dv, void* dq, void* dk, void* dv, int b, int sq,
                    int sk, int hq, int hkv, int dh, float scale, int causal, int window,
                    int dead_keys, cudaStream_t st) {
  if (dh <= 0 || dh > kMaxDh) return static_cast<int>(cudaErrorInvalidValue);
  const bool dead = window > 0 && sq > sk + window - 1;
  if (dead) {
    const int e = launch_dead<T>(dout, dead_dv, dq, b, sq, sk, hq, hkv, dh, window, dead_keys, st);
    if (e != 0) return e;
  }
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
                            kBwdSmemBytes, st>>>(qp, kp, vp, dop, lp, dp,
                                                 dead ? static_cast<const float*>(dead_dv) : nullptr,
                                                 static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
                                                 hkv, g, dh, scale, causal, window);
  flash_bwd_simt<T, false><<<dim3((sq + kBwdRows - 1) / kBwdRows, hq, b), kBwdThreads,
                             kBwdSmemBytes, st>>>(qp, kp, vp, dop, lp, dp, nullptr,
                                                  static_cast<T*>(dq), nullptr, sq, sk, hkv, g, dh,
                                                  scale, causal, window);
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
// but `out`. `dead_v` (float32 [B, Hkv, dh]) is written and read only for shapes with rows
// that allow no key (window > 0 and Sq > Sk + window - 1): each such row is V's mean over
// `dead_keys` columns (kernels/flash_attention.py:dead_row_keys), and flash_fwd_dead runs
// first; other shapes launch the forward kernel alone.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   void* lse, void* dead_v, int b, int sq, int sk, int hq, int hkv,
                                   int dh, float scale, int causal, int window, int dead_keys,
                                   void* stream) {
  const float* dead = nullptr;
  const int err = launch_fwd_dead<float>(v, dead_v, b, sq, sk, hkv, dh, window, dead_keys,
                                         static_cast<cudaStream_t>(stream), &dead);
  if (err != 0) return err;
  return simt::launch<float>(q, k, v, out, lse, dead, b, sq, sk, hq, hkv, dh, scale, causal, window,
                             stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, void* dead_v, int b, int sq, int sk, int hq, int hkv,
                                    int dh, float scale, int causal, int window, int dead_keys,
                                    void* stream) {
  const float* dead = nullptr;
  const int err = launch_fwd_dead<__nv_bfloat16>(v, dead_v, b, sq, sk, hkv, dh, window, dead_keys,
                                                 static_cast<cudaStream_t>(stream), &dead);
  if (err != 0) return err;
  return simt::launch<__nv_bfloat16>(q, k, v, out, lse, dead, b, sq, sk, hq, hkv, dh, scale, causal,
                                     window, stream);
}

// bf16 on the tensor cores: head_dim 64 or 128, any Hq % Hkv == 0, and q, k, v and
// out 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k, const void* v, void* out,
                                          void* lse, void* dead_v, int b, int sq, int sk, int hq,
                                          int hkv, int dh, float scale, int causal, int window,
                                          int dead_keys, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || (dh != 64 && dh != 128)) return static_cast<int>(cudaErrorInvalidValue);
  const float* dead = nullptr;
  const int err = launch_fwd_dead<__nv_bfloat16>(v, dead_v, b, sq, sk, hkv, dh, window, dead_keys,
                                                 static_cast<cudaStream_t>(stream), &dead);
  if (err != 0) return err;
  if (dh == 64) return wg::launch<64>(q, k, v, out, lse, dead, b, sq, sk, hq, hkv, scale, causal, window, stream);
  if (dh == 128) return wg::launch<128>(q, k, v, out, lse, dead, b, sq, sk, hq, hkv, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: q, k, v, the forward's out and lse, dout -> dq, dk, dv (q's shapes and
// dtype). Workspaces: `ws` float32 (simt: D [B, Hq, Sq]; the tensor-core routes: the base-2
// lse and D, [2, B, Hq, Sqp], Sqp = Sq rounded up to 64); `dead_dv` float32 [B, Hkv, dh], written and read only where a row allows no
// key (window > 0 and Sq > Sk + window - 1), whose output gradient is divided by `dead_keys`.
// The bf16 tensor-core entry runs the one pass when it is given `acc` (float32
// [B, Hq, Sqp, 64], the ordered dQ sums), `flags` (int32 [B, Hq, Sqp / 64]) and `sched` (its
// work list for `blocks` co-resident blocks, kernels/flash_attention.py:backward_schedule),
// and the two kernels when `acc` is null; the caller chooses. Every launch is on `stream`.
extern "C" int flash_attention_backward_f32(const void* q, const void* k, const void* v,
                                            const void* out, const void* lse, const void* dout,
                                            void* dq, void* dk, void* dv, void* ws, void* acc,
                                            void* flags, void* dead_dv, const void* sched, int b,
                                            int sq, int sk, int hq, int hkv, int dh, float scale,
                                            int causal, int window, int dead_keys, int blocks,
                                            void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = simt::launch_delta<float>(out, dout, ws, b, sq, hq, dh, st);
  if (err != 0 || b == 0 || sq == 0 || sk == 0) return err;
  return simt::launch_backward<float>(q, k, v, dout, lse, ws, dead_dv, dq, dk, dv, b, sq, sk, hq, hkv,
                                      dh, scale, causal, window, dead_keys, st);
}

extern "C" int flash_attention_backward_bf16(const void* q, const void* k, const void* v,
                                             const void* out, const void* lse, const void* dout,
                                             void* dq, void* dk, void* dv, void* ws, void* acc,
                                             void* flags, void* dead_dv, const void* sched, int b,
                                             int sq, int sk, int hq, int hkv, int dh, float scale,
                                             int causal, int window, int dead_keys, int blocks,
                                             void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = simt::launch_delta<__nv_bfloat16>(out, dout, ws, b, sq, hq, dh, st);
  if (err != 0 || b == 0 || sq == 0 || sk == 0) return err;
  return simt::launch_backward<__nv_bfloat16>(q, k, v, dout, lse, ws, dead_dv, dq, dk, dv, b, sq, sk,
                                              hq, hkv, dh, scale, causal, window, dead_keys, st);
}

// bf16 on the tensor cores, head_dim 64 or 128: the one pass when `acc` is given (head_dim 64
// only), else the two kernels; q, k, v, out and dout 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_backward_bf16_wgmma(const void* q, const void* k, const void* v,
                                                   const void* out, const void* lse,
                                                   const void* dout, void* dq, void* dk, void* dv,
                                                   void* ws, void* acc, void* flags, void* dead_dv,
                                                   const void* sched, int b, int sq, int sk, int hq,
                                                   int hkv, int dh, float scale, int causal,
                                                   int window, int dead_keys, int blocks,
                                                   void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || (dh != 64 && dh != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0 || sk == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc != nullptr) {
    if (dh != 64 || flags == nullptr || sched == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return wg::launch_one_pass<64>(q, k, v, out, lse, dout, dq, dk, dv, ws, acc, flags, dead_dv, sched,
                                   b, sq, sk, hq, hkv, scale, causal, window, dead_keys, blocks, st);
  }
  if (dh == 64) {
    return wg::launch_two_kernels<64>(q, k, v, out, lse, dout, dq, dk, dv, ws, dead_dv, b, sq, sk, hq,
                                      hkv, scale, causal, window, dead_keys, st);
  }
  return wg::launch_two_kernels<128>(q, k, v, out, lse, dout, dq, dk, dv, ws, dead_dv, b, sq, sk, hq,
                                     hkv, scale, causal, window, dead_keys, st);
}

// How many blocks of the one pass (head_dim 64) the current device holds at once (the grid
// its work list is made for), or minus a CUDA error.
extern "C" int flash_attention_backward_resident_blocks(int dh) {
  if (dh == 64) return wg::resident_blocks<64>();
  return -static_cast<int>(cudaErrorInvalidValue);
}
