// Mamba2 SSD chunked scan for Hopper (sm_90a), chunk-parallel.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd (_ssd_kernel):
// the state-space dual form of Dao & Gu (2024). x [B, S, H, P] (already
// dt-weighted) in bf16 or float32, a [B, S, H] the float32 log decay, b and
// c [B, S, N] shared across heads (ngroups = 1). Outputs y [B, S, H, P] in
// x's dtype and the final state [B, H, P, N] in float32. S is a multiple of
// the chunk length l. Everything inside is float32, as in the Pallas body.
// With cum the cumulative sum of a restarting at each chunk:
//   L     = exp(where(i >= j, cum_i - cum_j, -1e30))   (masked before exp)
//   y     = (L ⊙ C·Bᵀ)·X + (C·h_{c-1}ᵀ) ⊙ exp(cum)
//   h_c   = h_{c-1}·exp(cum_last) + (X ⊙ exp(cum_last - cum))ᵀ·B
//
// The TPU kernel walks the chunks of a (batch, head) in order, carrying h.
// Here the recurrence is split as in mamba_ssm's ssd_combined, so that the
// heavy products run for every (batch, head, chunk) at once; three kernels,
// one call (kernels/ssd.py:chunked_reference is the same in PyTorch):
//   1. ssd_chunk_kernel, one block per (chunk, head, batch): cum over the
//      chunk, the chunk's decay cum_last, and its state contribution
//      s_c = (X ⊙ exp(cum_last - cum))ᵀ·B [P, N] into the float32 workspace
//      `states` [B, nc, H, P, N]. One more block per (chunk, batch), first in
//      the grid, forms C·Bᵀ once for all heads into `cb` [B, nc, l, l],
//      stored transposed (row j, column i) with the upper triangle zero.
//   2. ssd_state_kernel, one thread per (batch, head, state element): walks
//      the chunks in order, h_c = exp(cum_last_c)·h_{c-1} + s_c, overwrites
//      s_c with the state that enters chunk c, and writes the final state.
//   3. ssd_out_kernel, one block per (chunk, head, batch):
//      y = (L ⊙ C·Bᵀ)·X + (C·h_{c-1}ᵀ) ⊙ exp(cum), in two phases through one
//      shared-memory region (101 KB at l = 128, P = 64, N = 128: two blocks an
//      SM), each summing only the causal j <= i terms of its row tile.
// At batch-1 prefill that is 192 blocks a pass for mamba2 (8 chunks x 24
// heads) and 800 for hymba (16 x 50), where the chunk-serial kernel had 24
// and 50 on 132 SMs.
//
// Bound on the H100: operations. Every product runs on the CUDA cores in
// float32 (both entries; the float32 one must hold 1e-3, and bf16 inputs
// widen to float32 exactly), so the bound is the card's 67 TFLOP/s float32
// rate. Each thread owns an 8 x 4 or 4 x 4 (8 x 8 for C·Bᵀ) register tile of
// its output and reads its operands from shared memory as float4. The blocks
// are short, and staging their tiles was most of their time (on an H100 the
// output pass at hymba's shape took 141 us, and 80 us with its loads switched
// off), so every tile is staged with 16-byte loads, four in flight per thread
// (`load_tile`).
//
// The backward (ssd_backward_*; the TPU kernel has none: XLA differentiates
// repro/models/ssm.py:ssd_chunked), kernels/ssd.py:chunked_backward_reference in
// PyTorch, is the forward's passes in reverse, four launches a call. With G_c the
// gradient of the state leaving chunk c (G = dhf after the last chunk, zero without
// one) and H_c the state entering it (the forward's `states`):
//   1. ssd_bwd_contrib_kernel, one block per (chunk, head, batch): the chunk's
//      contribution Σ_i exp(cum_i)·dy_iᵀc_i [P, N] into `dstates`.
//   2. ssd_bwd_state_kernel, one thread per (batch, head, state element): walks
//      the chunks from the last, G_{c-1} = exp(cum_last_c)·G_c + contribution_c,
//      and overwrites each contribution with the G of the state leaving its chunk.
//   3. ssd_bwd_dx_kernel, one block per (chunk, head, batch): y again (the forward's
//      output pass), dx = (L ⊙ C·Bᵀ)ᵀ·dY + exp(cum_last - cum) ⊙ (B·Gᵀ), and the
//      gradient of cum as dy_i·y_i - x_i·dx_i (every term of y_i scales with
//      exp(cum_i), of dx_j with exp(-cum_j)) plus <G, H_next> at the chunk's last
//      step; da is its reverse cumulative sum within the chunk, by one warp.
//   4. ssd_bwd_dbc_kernel, one block per (chunk, 32 state columns, batch): walks the
//      heads in order, summing V = Σ_h L_h ⊙ dY_h·X_hᵀ and the state terms
//      Σ_h (exp(cum_h) ⊙ dY_h)·H_h and Σ_h (exp(cum_last_h - cum_h) ⊙ X_h)·G_h on
//      chip, then dc = V·B + ... and db = Vᵀ·C + ..., written once in x's dtype: b and
//      c are shared by the heads, and no head's share goes to device memory.
// Every product is cut into 32 x 32 warp patches (patch_mma). The bf16 entry runs them
// on the tensor cores with float32 sums: dY·Xᵀ, both operands bf16, as bf16 mma.sync
// m16n8k16; the others as TF32 m16n8k8, in which x, dy, b and c are exact and go in as
// they are, and the float32 intermediates (exp(cum) ⊙ dY, exp(cum_last - cum) ⊙ X, the
// forward's states H and their gradients G, W = L ⊙ C·Bᵀ and V) go in as two TF32
// numbers each, hi + lo, 21 bits of their 24. Rounded to one TF32 number (10 bits) they
// failed the bf16 tolerance at mamba2-130m's shape on entries of db and dc near zero:
// sums over 24 heads x 128 steps of terms near 10 carry ~2^-11 of each, a few
// hundredths, over the tolerance's 3e-2 floor. With hi + lo the products are float32 to
// ~2^-21, and the kernel's error is its outputs' bf16 rounding (2^-9), as the CUDA-core
// kernel's was. The gradient of cum, its reverse sum and <G, H_next> stay float32 on
// the CUDA cores; L's exponentials are __expf (relative error ~1e-5). The float32 entry
// runs the same patches as FMAs on the CUDA cores, exact float32 (it holds 1e-3).
// Every tile is staged with cp.async, all of a phase's loads in flight at once. Every
// sum runs in a fixed order (a thread's, a fixed tree, or the heads in order): no
// atomics, so a run repeats bitwise. The bound of the bf16 entry: TF32 operations on
// the tensor cores, about even with the bytes (at mamba2-130m's micro-batch 22.6 GFLOP
// at 495 TFLOP/s, 141.6 MB at 3.35 TB/s); of the float32 entry, float32 operations on
// the CUDA cores. The passes are short blocks that wait on device memory and barriers:
// at 0.05 of that bound, most of a call is the db/dc pass's walk over the heads (its
// dY·Xᵀ with L and its state products) and the dx pass's three staged phases.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;   // chunk length
constexpr int kMaxP = 64;    // head dim
constexpr int kMaxN = 128;   // state dim
constexpr int kSlice = 32;   // state columns of C·Bᵀ staged at a time; of a db/dc block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The (row, column) of this thread's elements of a [rows][cols] tile, element
// threadIdx.x + k*kThreads for k = 0, 1, ...: one division to start, then each
// step is an add and a compare.
struct Walk {
  int r, c;
  const int cols, dr, dc;
  __device__ __forceinline__ explicit Walk(int cols_)
      : r(threadIdx.x / cols_), c(threadIdx.x % cols_), cols(cols_), dr(kThreads / cols_),
        dc(kThreads % cols_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) c -= cols, ++r;
  }
};

// The 16-byte vector of T at p, as floats.
__device__ __forceinline__ void unpack(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// Stages a [rows, cols] matrix of T (row r at src + r * stride) into shared memory:
// put(r, c, v) receives columns c .. c + V - 1 of row r as floats (V = 16 bytes of
// T), for every row below rows_cover and column below cover (>= cols), zero outside
// the matrix. 16-byte loads where cols, stride and src allow, four in flight per
// thread before any is stored: the staging is each block's longest latency chain.
template <typename T, typename Put>
__device__ __forceinline__ void load_tile(const T* src, int64_t stride, int rows, int rows_cover,
                                          int cols, int cover, Put put) {
  constexpr int V = 16 / sizeof(T), kInFlight = 4;
  const bool vec = cols % V == 0 && stride % V == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  Walk w((cover + V - 1) / V);
  while (w.r < rows_cover) {
    float v[kInFlight][V];
    int rr[kInFlight], cc[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      rr[u] = w.r, cc[u] = w.c * V;
      const T* p = src + w.r * stride + cc[u];
      if (w.r < rows && vec && cc[u] < cols) {
        unpack(p, v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          v[u][e] = w.r < rows && cc[u] + e < cols ? to_float(p[e]) : 0.f;
        }
      }
      w.next();
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (rr[u] < rows_cover) put(rr[u], cc[u], v[u]);
    }
  }
}

// Inclusive cumsum of cum[t], t < l (<= kThreads), in place: warp 0, each lane summing a
// run of steps, then a shuffle scan over the lanes' run totals offsets each run. Ends
// with a barrier.
__device__ __forceinline__ void scan_in_place(float* cum, int l) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (l + 31) / 32, lo = lane * per, hi = min(lo + per, l);
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      run += cum[t];
      cum[t] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    for (int t = lo; t < hi; ++t) cum[t] += incl - run;
  }
  __syncthreads();
}

// Inclusive cumsum of a[t * stride], t < l, into cum[t]: every thread loads one step,
// then scan_in_place. Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a, int64_t stride, int l,
                                             float* cum) {
  if (threadIdx.x < l) cum[threadIdx.x] = a[threadIdx.x * stride];
  __syncthreads();
  scan_in_place(cum, l);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[R][4] += u[R] ⊗ v[4] for R = 4 or 8, u and v 16-byte aligned rows in shared memory
template <int R>
__device__ __forceinline__ void outer(float (&acc)[R][4], const float* u, const float* v) {
  float uu[R];
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const float4 q = ld4(u + i);
    uu[i] = q.x, uu[i + 1] = q.y, uu[i + 2] = q.z, uu[i + 3] = q.w;
  }
  const float4 w = ld4(v);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc[i][0] = fmaf(uu[i], w.x, acc[i][0]);
    acc[i][1] = fmaf(uu[i], w.y, acc[i][1]);
    acc[i][2] = fmaf(uu[i], w.z, acc[i][2]);
    acc[i][3] = fmaf(uu[i], w.w, acc[i][3]);
  }
}

// Transposed tiles are staged from coalesced loads along their rows; a row
// stride of a multiple of 4 plus 4 floats keeps float4 reads aligned and spreads
// the transposing stores over the banks.
__host__ __device__ __forceinline__ int padded(int v) { return v + 4; }

// Shared memory of the chunk pass: the larger of the head blocks' X and B
// ([l][P4], [l][N4], cum [l8]) and the C·Bᵀ block's slices ([kSlice][l8 + 4] twice).
size_t chunk_smem(int l, int p, int n) {
  const int l8 = round_up(l, 8);
  const int head = l * (round_up(p, 4) + round_up(n, 4)) + l8, cb = 2 * kSlice * padded(l8);
  return sizeof(float) * (head > cb ? head : cb);
}

// Floats of the output pass's two phases: the larger of phase 1 (L ⊙ C·Bᵀ as
// [l][l8], X [l][P4]) and phase 2 (Cᵀ [N4][l8 + 4], hᵀ [N4][P4 + 4]).
__host__ __device__ __forceinline__ int out_phase_floats(int l, int p, int n) {
  const int l8 = round_up(l, 8), p4 = round_up(p, 4), n4 = round_up(n, 4);
  const int ph1 = l * l8 + l * p4, ph2 = n4 * padded(l8) + n4 * padded(p4);
  return ph1 > ph2 ? ph1 : ph2;
}

// ... plus cum and exp(cum)
size_t out_smem(int l, int p, int n) {
  return sizeof(float) * (out_phase_floats(l, p, n) + 2 * round_up(l, 8));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ bm,
                 const T* __restrict__ cm, float* __restrict__ states, float* __restrict__ cb,
                 float* __restrict__ decay, int s, int nh, int p, int n, int l) {
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte load (load_tile)
  extern __shared__ __align__(16) float smem[];
  // blockIdx.y 0: C·Bᵀ (the longest blocks, scheduled first); 1 + hd: head hd
  const int ic = blockIdx.x, hd = static_cast<int>(blockIdx.y) - 1, b = blockIdx.z, nc = s / l;
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;  // row in [B*S]
  const int l8 = round_up(l, 8);

  if (hd < 0) {
    // ---- C·Bᵀ of the chunk, once for all heads: cb[j][i] = C_i·B_j for j <= i ----
    const int lp = padded(l8);
    float* ct = smem;                  // [kSlice][lp]: C's slice, transposed
    float* bt = ct + kSlice * lp;      // [kSlice][lp]: B's slice, transposed
    const int tiles = l8 / 8;          // 8 x 8 register tiles: at most 256, one a thread
    const int tj = tid / tiles, ti = tid % tiles;
    const bool mine = tid < tiles * tiles && tj <= ti;  // tiles wholly above the diagonal: zero
    float acc[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
    for (int k0 = 0; k0 < n; k0 += kSlice) {
      __syncthreads();  // the previous slice's readers are done
      const int cols = min(kSlice, n - k0);
      load_tile(cm + t0 * n + k0, n, l, l8, cols, kSlice, [&](int t, int k, const float* v) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) ct[(k + e) * lp + t] = v[e];
      });
      load_tile(bm + t0 * n + k0, n, l, l8, cols, kSlice, [&](int t, int k, const float* v) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) bt[(k + e) * lp + t] = v[e];
      });
      __syncthreads();
      if (mine) {
        for (int k = 0; k < cols; ++k) {
          float bj[8];
          const float4 q0 = ld4(bt + k * lp + 8 * tj), q1 = ld4(bt + k * lp + 8 * tj + 4);
          bj[0] = q0.x, bj[1] = q0.y, bj[2] = q0.z, bj[3] = q0.w;
          bj[4] = q1.x, bj[5] = q1.y, bj[6] = q1.z, bj[7] = q1.w;
          const float4 c0 = ld4(ct + k * lp + 8 * ti), c1 = ld4(ct + k * lp + 8 * ti + 4);
          const float ci[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int u = 0; u < 8; ++u)
#pragma unroll
            for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(bj[u], ci[v], acc[u][v]);
        }
      }
    }
    if (tid < tiles * tiles) {
      float* out = cb + (static_cast<int64_t>(b) * nc + ic) * l * l;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = 8 * tj + u;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int i = 8 * ti + v;
          if (j < l && i < l) out[j * l + i] = j <= i ? acc[u][v] : 0.f;
        }
      }
    }
    return;
  }

  // ---- head hd: the chunk's decay and state contribution ----
  const int p4 = round_up(p, 4), n4 = round_up(n, 4);
  float* xs = smem;                 // [l][p4]: X ⊙ exp(cum_last - cum)
  float* bs = xs + l * p4;          // [l][n4]
  float* cum = bs + l * n4;         // [l]
  chunk_cumsum(a + t0 * nh + hd, nh, l, cum);
  const float cum_last = cum[l - 1];
  if (tid == 0) decay[(static_cast<int64_t>(b) * nc + ic) * nh + hd] = cum_last;
  load_tile(x + (t0 * nh + hd) * p, static_cast<int64_t>(nh) * p, l, l, p, p4,
            [&](int t, int d, const float* v) {
    const float dec = expf(cum_last - cum[t]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (d + e < p4) xs[t * p4 + d + e] = v[e] * dec;
    }
  });
  load_tile(bm + t0 * n, n, l, l, n, n4, [&](int t, int k, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (k + e < n4) bs[t * n4 + k + e] = v[e];
    }
  });
  __syncthreads();
  float* out = states + ((static_cast<int64_t>(b) * nc + ic) * nh + hd) * p * n;
  const int tn = n4 / 4;
  for (int m = tid; m < (p4 / 4) * tn; m += kThreads) {  // 4 x 4 tiles of [P, N]
    const int mp = m / tn, mn = m % tn;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int t = 0; t < l; ++t) outer<4>(acc, xs + t * p4 + 4 * mp, bs + t * n4 + 4 * mn);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pp = 4 * mp + u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int k = 4 * mn + v;
        if (pp < p && k < n) out[pp * n + k] = acc[u][v];
      }
    }
  }
}

// states[b, c, hd] <- the state entering chunk c; hf[b, hd] <- the state after the last.
// The loads of kPrefetch chunks are issued before the serial updates that use them.
constexpr int kPrefetch = 8;
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(float* __restrict__ states, const float* __restrict__ decay,
                 float* __restrict__ hf, int nc, int nh, int pn) {
  const int i = blockIdx.x * kThreads + threadIdx.x, hd = blockIdx.y, b = blockIdx.z;
  if (i >= pn) return;
  float h = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPrefetch) {
    float contrib[kPrefetch], dec[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int64_t row = (static_cast<int64_t>(b) * nc + c0 + j) * nh + hd;
      const bool ok = c0 + j < nc;
      contrib[j] = ok ? states[row * pn + i] : 0.f;
      dec[j] = ok ? expf(decay[row]) : 1.f;
    }
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      if (c0 + j >= nc) break;
      states[((static_cast<int64_t>(b) * nc + c0 + j) * nh + hd) * pn + i] = h;
      h = h * dec[j] + contrib[j];
    }
  }
  hf[(static_cast<int64_t>(b) * nh + hd) * pn + i] = h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ cm,
               const float* __restrict__ states, const float* __restrict__ cb,
               T* __restrict__ y, int s, int nh, int p, int n, int l) {
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte load (load_tile)
  extern __shared__ __align__(16) float smem[];
  const int ic = blockIdx.x, hd = blockIdx.y, b = blockIdx.z, nc = s / l;
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;
  const int l8 = round_up(l, 8), p4 = round_up(p, 4), n4 = round_up(n, 4);
  float* cum = smem + out_phase_floats(l, p, n);  // [l8]
  float* ecum = cum + l8;   // [l8]: exp(cum)
  chunk_cumsum(a + t0 * nh + hd, nh, l, cum);
  for (int t = tid; t < l; t += kThreads) ecum[t] = expf(cum[t]);

  // phase 1: st[j][i] = L[i][j] · (C·Bᵀ)[i][j], zero for j > i; xs = X
  float* st = smem;          // [l][l8]
  float* xs = st + l * l8;   // [l][p4]
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + ic) * l * l;
  load_tile(cbc, l, l, l, l, l8, [&](int j, int r0, const float* v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + e;
      const float seg = j <= r ? cum[r] - cum[j] : kNegInf;  // mask, then exp
      if (r < l8) st[j * l8 + r] = r < l && j <= r ? expf(seg) * v[e] : 0.f;
    }
  });
  load_tile(x + (t0 * nh + hd) * p, static_cast<int64_t>(nh) * p, l, l, p, p4,
            [&](int t, int d, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (d + e < p4) xs[t * p4 + d + e] = v[e];
    }
  });
  __syncthreads();

  // one 8 x 4 tile of y [l, P] a thread (l8/8 x p4/4 <= 256 tiles)
  const int tp = p4 / 4, ntiles = (l8 / 8) * tp;
  const bool mine = tid < ntiles;
  const int mi = tid / tp, md = tid % tp;
  float acc[8][4], off[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = off[u][v] = 0.f;
  if (mine) {
    const int jmax = min(l, 8 * mi + 8);  // j > every row of the tile: L is zero
    for (int j = 0; j < jmax; ++j) outer<8>(acc, st + j * l8 + 8 * mi, xs + j * p4 + 4 * md);
  }
  __syncthreads();  // phase 1's readers are done

  // phase 2: ct = Cᵀ [N][l], ht = h_{c-1}ᵀ [N][P], both staged along N (coalesced)
  const int lp = padded(l8), hp = padded(p4);
  float* ct = smem;          // [n4][lp]
  float* ht = ct + n4 * lp;  // [n4][hp]
  load_tile(cm + t0 * n, n, l, l8, n, n4, [&](int t, int k, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (k + e < n4) ct[(k + e) * lp + t] = v[e];
    }
  });
  const float* hc = states + ((static_cast<int64_t>(b) * nc + ic) * nh + hd) * p * n;
  load_tile(hc, n, p, p4, n, n4, [&](int d, int k, const float* v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e < n4) ht[(k + e) * hp + d] = v[e];
    }
  });
  __syncthreads();
  if (mine) {
    for (int k = 0; k < n; ++k) outer<8>(off, ct + k * lp + 8 * mi, ht + k * hp + 4 * md);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = 8 * mi + u;
      if (r >= l) continue;
      T* yrow = y + ((t0 + r) * nh + hd) * p;
      const float e = ecum[r];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int d = 4 * md + v;
        if (d < p) from_float(acc[u][v] + off[u][v] * e, &yrow[d]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c, void* y, void* hf,
           void* states, void* cb, void* decay, int bsz, int s, int h, int p, int n, int l,
           void* stream) {
  if (l <= 0 || l > kMaxL || s % l != 0 || p <= 0 || p > kMaxP || n <= 0 || n > kMaxN ||
      bsz > 65535 || h + 1 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t chunk_bytes = chunk_smem(l, p, n), out_bytes = out_smem(l, p, n);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(chunk_bytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ssd_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(out_bytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bsz == 0 || s == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  const int nc = s / l;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ssd_chunk_kernel<T><<<dim3(nc, h + 1, bsz), kThreads, chunk_bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<float*>(states), static_cast<float*>(cb),
      static_cast<float*>(decay), s, h, p, n, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<<<dim3((p * n + kThreads - 1) / kThreads, h, bsz), kThreads, 0, st>>>(
      static_cast<float*>(states), static_cast<const float*>(decay), static_cast<float*>(hf), nc,
      h, p * n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_out_kernel<T><<<dim3(nc, h, bsz), kThreads, out_bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(c),
      static_cast<const float*>(states), static_cast<const float*>(cb), static_cast<T*>(y), s, h,
      p, n, l);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

// Each product of the backward is cut into warp patches: 32 x 32 outputs of C = A·B,
// kMI x kNI tiles of 16 x 8, K in steps of 8, A and B read from shared memory through
// the functors a(m, k) and b(k, n). kTC (the bf16 entry): TF32 mma.sync m16n8k8 on the
// tensor cores, float32 sums. x, dy, b and c are bf16, exact in TF32, and go in as they
// are; an operand that is a float32 intermediate (kSplitA, kSplitB) goes in as two TF32
// numbers, hi = rna(v) and lo = rna(v - hi), which keep 21 of its 24 bits: a product
// with one such operand takes two mma (hi·b, lo·b), with two three (the lo·lo term,
// 2^-22 of the product, dropped). Otherwise (the float32 entry) FMAs on the CUDA cores
// in exact float32, each thread the same 32 elements: a thread's element r of tile
// (mi, ni) lies at row m0 + 16 mi + lane/4 + 8 (r/2), column n0 + 8 ni + 2 (lane%4) + r%2.
constexpr int kMI = 2, kNI = 4, kPatch = 32;
constexpr int kSplitA = 1, kSplitB = 2;
using Patch = float[kMI][kNI][4];

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v as TF32 hi and lo (kSplit), or its bits as they are (an exact operand)
template <bool kSplit>
__device__ __forceinline__ void tf32_parts(float v, uint32_t& hi, uint32_t& lo) {
  if (kSplit) {
    hi = tf32(v);
    lo = tf32(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void zero(Patch& acc) {
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
}
// The row and column of a thread's element (mi, ni, r) of the patch at (m0, n0).
__device__ __forceinline__ int prow(int m0, int mi, int r) {
  return m0 + 16 * mi + (threadIdx.x % 32) / 4 + 8 * (r / 2);
}
__device__ __forceinline__ int pcol(int n0, int ni, int r) {
  return n0 + 8 * ni + 2 * (threadIdx.x % 4) + r % 2;
}

// acc += A[m0:m0+32, k0:k1] · B[k0:k1, n0:n0+32] (k0, k1 multiples of 8; the shared
// tiles are zero wherever the matrices end). kSplit: which operands are split (above).
template <bool kTC, int kSplit, typename A, typename B>
__device__ __forceinline__ void patch_mma(Patch& acc, int m0, int n0, int k0, int k1, A a, B b) {
  constexpr bool kSA = kSplit & kSplitA, kSB = kSplit & kSplitB;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int k = k0; k < k1; k += 8) {
    if constexpr (kTC) {
      uint32_t ah[kMI][4], al[kMI][4], bh[kNI][2], bl[kNI][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const int r = m0 + 16 * mi + g;
        tf32_parts<kSA>(a(r, k + t), ah[mi][0], al[mi][0]);
        tf32_parts<kSA>(a(r + 8, k + t), ah[mi][1], al[mi][1]);
        tf32_parts<kSA>(a(r, k + t + 4), ah[mi][2], al[mi][2]);
        tf32_parts<kSA>(a(r + 8, k + t + 4), ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int c = n0 + 8 * ni + g;
        tf32_parts<kSB>(b(k + t, c), bh[ni][0], bl[ni][0]);
        tf32_parts<kSB>(b(k + t + 4, c), bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          if (kSA) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
          if (kSB) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
          mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
        }
    } else {
#pragma unroll 2
      for (int kk = k; kk < k + 8; ++kk) {
        float av[kMI][2], bv[kNI][2];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          av[mi][0] = a(m0 + 16 * mi + g, kk);
          av[mi][1] = a(m0 + 16 * mi + g + 8, kk);
        }
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          bv[ni][0] = b(kk, n0 + 8 * ni + 2 * t);
          bv[ni][1] = b(kk, n0 + 8 * ni + 2 * t + 1);
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[mi][ni][r] = fmaf(av[mi][r / 2], bv[ni][r % 2], acc[mi][ni][r]);
            }
      }
    }
  }
}

// acc += A[m0:m0+32, k0:k1] · B[k0:k1, n0:n0+32] for bf16 A and Bᵀ in shared memory,
// both K-contiguous (A(m, k) at a[m*lda + k], B(k, n) at b[n*ldb + k]; k0, k1 multiples
// of 16, lda and ldb even): bf16 mma.sync m16n8k16, float32 sums, each fragment register
// one 32-bit load of two neighbouring k.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void patch_mma_bf16(Patch& acc, int m0, int n0, int k0, int k1,
                                               const __nv_bfloat16* a, int lda,
                                               const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  auto pair = [](const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); };
  for (int k = k0; k < k1; k += 16) {
    uint32_t af[kMI][4], bf[kNI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const __nv_bfloat16* r = a + (m0 + 16 * mi + g) * lda + k + 2 * t;
      af[mi][0] = pair(r);
      af[mi][1] = pair(r + 8 * lda);
      af[mi][2] = pair(r + 8);
      af[mi][3] = pair(r + 8 * lda + 8);
    }
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const __nv_bfloat16* c = b + (n0 + 8 * ni + g) * ldb + k + 2 * t;
      bf[ni][0] = pair(c);
      bf[ni][1] = pair(c + 8);
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
  }
}

// Shared tiles of the backward are raw copies of device memory (bf16 stays bf16, read
// as float by the products' functors), staged with cp.async so that every load of a
// phase is in flight at once: the blocks are short, and each round trip to device
// memory is most of a phase. Row strides, in elements: bf16 rows 8 more than a multiple
// of 64, float rows 4 more than a multiple of 32 where the fragments read a tile along
// its rows (a(m, k) at m*ld + k), 8 more where they read it along its columns (b(k, n)
// at k*ld + n): a warp's reads of one fragment register then hit distinct banks.
template <typename T>
__host__ __device__ __forceinline__ int ld_rows(int cols) {
  return sizeof(T) == 2 ? round_up(cols, 64) + 8 : round_up(cols, kPatch) + 4;
}
template <typename T>
__host__ __device__ __forceinline__ int ld_cols(int cols) {
  return sizeof(T) == 2 ? round_up(cols, 64) + 8 : round_up(cols, kPatch) + 8;
}

// Rows [0, rows) x columns [0, cols) of a row-major matrix of T (row r at src + r *
// stride) into dst (row r at dst + r * ld), zero over the rest of [0, rows_cover) x
// [0, cover) (cover: a multiple of 16 bytes of T): 16-byte cp.async where rows and src
// are 16-byte aligned, else scalar loads and stores. The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ src, int64_t stride,
                                      int rows, int rows_cover, int cols, int cover) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = cols % V == 0 && stride % V == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int nv = cover / V;
  for (int i = threadIdx.x; i < rows_cover * nv; i += kThreads) {
    const int r = i / nv, c = (i - r * nv) * V;
    T* d = dst + r * ld + c;
    const bool in = r < rows && c < cols;
    if (vec) {
      hopper::cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(d)),
                         in ? src + r * stride + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (r < rows && c + e < cols) {
          d[e] = src[r * stride + c + e];
        } else {
          from_float(0.f, &d[e]);
        }
      }
    }
  }
}

// a[t * stride], t < l, into dst[t] (4-byte cp.async, one a thread)
__device__ __forceinline__ void stage_steps(float* dst, const float* __restrict__ a,
                                            int64_t stride, int l) {
  if (threadIdx.x < l) {
    hopper::cp_async4(static_cast<uint32_t>(__cvta_generic_to_shared(dst + threadIdx.x)),
                      a + threadIdx.x * stride);
  }
}

// 1. dstates[b, c, hd] <- Σ_i exp(cum_i)·dy_iᵀ c_i [P, N]: A(p, i) = exp(cum_i)·dy[i][p]
// (split: an intermediate), B(i, n) = c[i][n].
template <typename T>
__host__ __device__ __forceinline__ int contrib_floats(int l, int p, int n) {
  const int l8 = round_up(l, 8);
  return l8 + (l8 * (ld_cols<T>(p) + ld_cols<T>(n)) * static_cast<int>(sizeof(T)) + 3) / 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_contrib_kernel(const T* __restrict__ dy, const float* __restrict__ a,
                       const T* __restrict__ cm, float* __restrict__ dstates, int s, int nh, int p,
                       int n, int l) {
  constexpr bool kTC = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int ic = blockIdx.x, hd = blockIdx.y, b = blockIdx.z, nc = s / l;
  const int warp = threadIdx.x / 32;
  const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;
  const int l8 = round_up(l, 8), p32 = round_up(p, kPatch), n32 = round_up(n, kPatch);
  const int ldy = ld_cols<T>(p), ldc = ld_cols<T>(n);
  float* cum = smem;                           // [l8]: cum, then exp(cum)
  T* ys = reinterpret_cast<T*>(cum + l8);      // [l8][ldy]: dY
  T* cs = ys + l8 * ldy;                       // [l8][ldc]: C
  stage_steps(cum, a + t0 * nh + hd, nh, l);
  stage(ys, ldy, dy + (t0 * nh + hd) * p, static_cast<int64_t>(nh) * p, l, l8, p, p32);
  stage(cs, ldc, cm + t0 * n, n, l, l8, n, n32);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  scan_in_place(cum, l);
  if (threadIdx.x < l8) cum[threadIdx.x] = threadIdx.x < l ? expf(cum[threadIdx.x]) : 0.f;
  __syncthreads();
  const int pn = n32 / kPatch;
  if (warp < (p32 / kPatch) * pn) {
    const int m0 = warp / pn * kPatch, n0 = warp % pn * kPatch;
    Patch acc;
    zero(acc);
    patch_mma<kTC, kSplitA>(acc, m0, n0, 0, l8,
                            [&](int m, int k) { return cum[k] * to_float(ys[k * ldy + m]); },
                            [&](int k, int c) { return to_float(cs[k * ldc + c]); });
    float* out = dstates + ((static_cast<int64_t>(b) * nc + ic) * nh + hd) * p * n;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = prow(m0, mi, r), col = pcol(n0, ni, r);
          if (row < p && col < n) out[row * n + col] = acc[mi][ni][r];
        }
  }
}

// 2. dstates[b, c, hd] <- the gradient of the state leaving chunk c, from the last chunk
// (dhf, or zero) back: G_{c-1} = exp(cum_last_c)·G_c + contribution_c.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(float* __restrict__ dstates, const float* __restrict__ decay,
                     const float* __restrict__ dhf, int nc, int nh, int pn) {
  const int i = blockIdx.x * kThreads + threadIdx.x, hd = blockIdx.y, b = blockIdx.z;
  if (i >= pn) return;
  float g = dhf != nullptr ? dhf[(static_cast<int64_t>(b) * nh + hd) * pn + i] : 0.f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kPrefetch) {
    float contrib[kPrefetch], dec[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int c = c1 - j;
      const int64_t row = (static_cast<int64_t>(b) * nc + (c < 0 ? 0 : c)) * nh + hd;
      contrib[j] = c >= 0 ? dstates[row * pn + i] : 0.f;
      dec[j] = c >= 0 ? expf(decay[row]) : 1.f;
    }
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int c = c1 - j;
      if (c < 0) break;
      dstates[((static_cast<int64_t>(b) * nc + c) * nh + hd) * pn + i] = g;
      g = g * dec[j] + contrib[j];
    }
  }
}

// The dx pass's shared memory, in floats: three phases through one region (the largest
// of them: C and H; B, G and the state leaving the chunk; C·Bᵀ (then W) with X and dY),
// then cum, exp(cum), exp(cum_last - cum), the partial dot products dy·y - x·dx by
// patch column ([2][l32]) and a reduction buffer.
template <typename T>
struct DxSmem {
  int l32, p32, n32, ldc, ldh, ldw, ldp;
  int ph1, ph2, ph3;  // floats of each phase
  __host__ __device__ DxSmem(int l, int p, int n)
      : l32(round_up(l, kPatch)), p32(round_up(p, kPatch)), n32(round_up(n, kPatch)),
        ldc(ld_rows<T>(n)), ldh(ld_rows<float>(n)), ldw(ld_cols<float>(l)), ldp(ld_cols<T>(p)) {
    const int tile = (l32 * ldc * static_cast<int>(sizeof(T)) + 15) / 16 * 4;  // C or B
    ph1 = tile + p32 * ldh;
    ph2 = tile + 2 * p32 * ldh;
    ph3 = l32 * ldw + (2 * l32 * ldp * static_cast<int>(sizeof(T)) + 15) / 16 * 4;
  }
  __host__ __device__ int region() const { return max(ph1, max(ph2, ph3)); }
  __host__ __device__ int floats() const { return region() + 5 * l32 + kThreads; }
};

// 3. dx = Wᵀ·dY + exp(cum_last - cum) ⊙ (B·Gᵀ) with W = L ⊙ C·Bᵀ, and da: the gradient of
// cum, dy_i·y_i - x_i·dx_i with y recomputed (y = W·X + exp(cum) ⊙ (C·Hᵀ)), plus
// <G, H_next> at the chunk's last step, summed in reverse within the chunk. Warp w owns
// one 32 x 32 patch of the [l, P] outputs y and dx.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const T* __restrict__ dy,
                  const float* __restrict__ states, const float* __restrict__ cb,
                  const float* __restrict__ dstates, const float* __restrict__ hf,
                  T* __restrict__ dx, float* __restrict__ da, int s, int nh, int p, int n, int l) {
  constexpr bool kTC = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int ic = blockIdx.x, hd = blockIdx.y, b = blockIdx.z, nc = s / l;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;
  const DxSmem<T> sm(l, p, n);
  const int l8 = round_up(l, 8), n8 = round_up(n, 8), l32 = sm.l32, p32 = sm.p32;
  float* cum = smem + sm.region();   // [l32]
  float* ecum = cum + l32;           // [l32]: exp(cum)
  float* edec = ecum + l32;          // [l32]: exp(cum_last - cum)
  float* part = edec + l32;          // [2][l32]: dy·y - x·dx by patch column
  float* red = part + 2 * l32;       // [kThreads]
  const int64_t row = (static_cast<int64_t>(b) * nc + ic) * nh + hd;
  const float* hc = states + row * p * n;   // H: the state entering the chunk
  const float* gc = dstates + row * p * n;  // G: the gradient of the state leaving it
  const float* hn = ic + 1 < nc ? states + (row + nh) * p * n   // the state leaving it
                                : hf + (static_cast<int64_t>(b) * nh + hd) * p * n;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + ic) * l * l;
  const T* xh = x + (t0 * nh + hd) * p;     // row t of this head at xh + t * nh * p
  const T* dyh = dy + (t0 * nh + hd) * p;
  const int64_t ld = static_cast<int64_t>(nh) * p;

  const int pn = p32 / kPatch;
  const bool mine = warp < (l32 / kPatch) * pn;
  const int m0 = warp / pn * kPatch, n0 = warp % pn * kPatch;  // rows i (or j), columns p
  Patch y, g;
  zero(y);
  zero(g);
  T* ms = reinterpret_cast<T*>(smem);                             // [l32][ldc]: C, then B
  float* ks = smem + (sm.ph1 - p32 * sm.ldh);                     // [p32][ldh]: H, then G
  float* ns = ks + p32 * sm.ldh;                                  // [p32][ldh]: H_next

  // ---- phase 1: y = exp(cum) ⊙ (C·Hᵀ) ----
  stage_steps(cum, a + t0 * nh + hd, nh, l);
  stage(ms, sm.ldc, cm + t0 * n, n, l, l32, n, sm.n32);
  stage(ks, sm.ldh, hc, n, p, p32, n, sm.n32);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  scan_in_place(cum, l);
  const float cum_last = cum[l - 1];
  for (int t = tid; t < l32; t += kThreads) {
    ecum[t] = t < l ? expf(cum[t]) : 0.f;
    edec[t] = t < l ? expf(cum_last - cum[t]) : 0.f;
  }
  if (mine) {
    patch_mma<kTC, kSplitB>(y, m0, n0, 0, n8, [&](int m, int k) { return to_float(ms[m * sm.ldc + k]); },
                            [&](int k, int c) { return ks[c * sm.ldh + k]; });
  }
  __syncthreads();  // phase 1's readers are done; ecum and edec are written

  // ---- phase 2: dx = exp(cum_last - cum) ⊙ (B·Gᵀ); <G, H_next> ----
  stage(ms, sm.ldc, bm + t0 * n, n, l, l32, n, sm.n32);
  stage(ks, sm.ldh, gc, n, p, p32, n, sm.n32);
  stage(ns, sm.ldh, hn, n, p, p32, n, sm.n32);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  float gh = 0.f;  // this thread's share of <G, H_next>, summed by a tree below
  for (int r = warp; r < p; r += kThreads / 32) {
    for (int c = lane; c < n; c += 32) gh = fmaf(ks[r * sm.ldh + c], ns[r * sm.ldh + c], gh);
  }
  red[tid] = gh;
  if (mine) {
    patch_mma<kTC, kSplitB>(g, m0, n0, 0, n8, [&](int m, int k) { return to_float(ms[m * sm.ldc + k]); },
                            [&](int k, int c) { return ks[c * sm.ldh + k]; });
  }
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = prow(m0, mi, r);
        y[mi][ni][r] *= ecum[i];
        g[mi][ni][r] *= edec[i];
      }
  __syncthreads();  // phase 2's readers are done

  // ---- phase 3: W = L ⊙ C·Bᵀ in place of C·Bᵀ; y += W·X, dx += Wᵀ·dY ----
  float* ws = smem;                                       // [l32][ldw]: (C·Bᵀ)ᵀ, then Wᵀ
  T* xs = reinterpret_cast<T*>(ws + l32 * sm.ldw);        // [l32][ldp]: X
  T* ys = xs + l32 * sm.ldp;                              // [l32][ldp]: dY
  stage(ws, sm.ldw, cbc, l, l, l32, l, l32);
  stage(xs, sm.ldp, xh, ld, l, l32, p, p32);
  stage(ys, sm.ldp, dyh, ld, l, l32, p, p32);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  for (int j = warp; j < l32; j += kThreads / 32) {  // ws[j][i]: row j, column i
    for (int i = lane; i < l32; i += 32) {
      float* w = ws + j * sm.ldw + i;
      *w = j <= i && i < l ? __expf(cum[i] - cum[j]) * *w : 0.f;  // L masked: j <= i < l only
    }
  }
  __syncthreads();
  if (mine) {
    patch_mma<kTC, kSplitA>(y, m0, n0, 0, min(l8, m0 + kPatch),  // rows i: Σ_{j <= i}
                            [&](int m, int k) { return ws[k * sm.ldw + m]; },
                            [&](int k, int c) { return to_float(xs[k * sm.ldp + c]); });
    patch_mma<kTC, kSplitA>(g, m0, n0, m0, l8,                   // rows j: Σ_{i >= j}
                            [&](int m, int k) { return ws[m * sm.ldw + k]; },
                            [&](int k, int c) { return to_float(ys[k * sm.ldp + c]); });
  }

  // ---- dx out, and the gradient of cum by rows: dy·y - x·dx ----
  if (mine) {
    float dot[kMI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) dot[mi][0] = dot[mi][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = prow(m0, mi, r), d = pcol(n0, ni, r);
          if (i >= l || d >= p) continue;
          const float gv = g[mi][ni][r];
          from_float(gv, &dx[(t0 + i) * ld + hd * p + d]);
          dot[mi][r / 2] += to_float(ys[i * sm.ldp + d]) * y[mi][ni][r] -
                            to_float(xs[i * sm.ldp + d]) * gv;
        }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = dot[mi][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);  // the quad's four column pairs
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int i = m0 + 16 * mi + lane / 4 + 8 * h;
        if (lane % 4 == 0) part[(n0 / kPatch) * l32 + i] = v;
      }
  }
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {  // <G, H_next>: a fixed tree
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }

  // ---- da: the reverse cumulative sum of the gradient of cum, by warp 0 ----
  if (tid < 32) {
    const int per = (l + 31) / 32, lo = min(lane * per, l), hi = min(lo + per, l);
    float run = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
      float gcum = t == l - 1 ? red[0] : 0.f;
      for (int q = 0; q < pn; ++q) gcum += part[q * l32 + t];
      run += gcum;
      cum[t] = run;  // cum is not read again
    }
    float incl = run;  // this lane's run plus every later lane's
    for (int o = 1; o < 32; o <<= 1) {
      const float down = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += down;
    }
    const float later = incl - run;
    for (int t = lo; t < hi; ++t) da[(t0 + t) * nh + hd] = cum[t] + later;
  }
}

// The db/dc pass's shared memory, in floats: two slots of a head's tiles (its steps'
// log decays, dY and X, kSlice columns of H and G), then V over them after the heads
// with kSlice columns of B and C; exp(cum) and exp(cum_last - cum).
template <typename T>
struct DbcSmem {
  int l32, p32, ldp, lds, ldv, ldm;
  int slot, vsum;  // floats of a head's slot; of V with B's and C's columns
  __host__ __device__ DbcSmem(int l, int p)
      : l32(round_up(l, kPatch)), p32(round_up(p, kPatch)), ldp(ld_rows<T>(p)),
        lds(ld_cols<float>(kSlice)), ldv(ld_rows<float>(l)), ldm(ld_cols<T>(kSlice)) {
    slot = l32 + (2 * l32 * ldp * static_cast<int>(sizeof(T)) + 15) / 16 * 4 + 2 * p32 * lds;
    vsum = l32 * ldv + (2 * l32 * ldm * static_cast<int>(sizeof(T)) + 15) / 16 * 4;
  }
  __host__ __device__ int floats() const { return max(2 * slot, vsum) + 2 * l32; }
};

// Lower-triangle patch q of an np x np grid of 32 x 32 patches (row-major over the
// triangle): its (row, column) patch, or false past the last.
__device__ __forceinline__ bool tri_patch(int q, int np, int& pi, int& pj) {
  for (pi = 0; pi < np; ++pi) {
    if (q <= pi) {
      pj = q;
      return true;
    }
    q -= pi + 1;
  }
  return false;
}

// 4. db and dc for kSlice state columns of a chunk, every head summed on chip, head 0
// first: with V = Σ_h L_h ⊙ dY_h·X_hᵀ,
//   dc = V·B + Σ_h (exp(cum_h) ⊙ dY_h)·H_h,   db = Vᵀ·C + Σ_h (exp(cum_last_h - cum_h) ⊙ X_h)·G_h.
// The heads stream through two slots: head h+1's tiles load while head h multiplies.
// Warps 0-3 own dc's 32 x 32 patches (rows i), warps 4-7 db's (rows j), and each warp up
// to two lower-triangle patches of V, in registers across the heads.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ bm,
                   const T* __restrict__ cm, const T* __restrict__ dy,
                   const float* __restrict__ states, const float* __restrict__ dstates,
                   T* __restrict__ db, T* __restrict__ dc, int s, int nh, int p, int n, int l) {
  constexpr bool kTC = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int ic = blockIdx.x, k0 = blockIdx.y * kSlice, b = blockIdx.z, nc = s / l;
  const int tid = threadIdx.x, warp = tid / 32;
  const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;
  const DbcSmem<T> sm(l, p);
  const int l8 = round_up(l, 8), p8 = round_up(p, 8), l32 = sm.l32, p32 = sm.p32;
  const int np = l32 / kPatch, cols = min(kSlice, n - k0);
  const int ldp = sm.ldp, lds = sm.lds;
  float* ecum = smem + max(2 * sm.slot, sm.vsum);  // [l32]: exp(cum) of the head
  float* edec = ecum + l32;                        // [l32]: exp(cum_last - cum)
  // slot u: cum [l32], dY and X [l32][ldp], H's and G's columns [p32][lds]
  auto cum_of = [&](int u) { return smem + u * sm.slot; };
  auto ys_of = [&](int u) { return reinterpret_cast<T*>(cum_of(u) + l32); };
  auto xs_of = [&](int u) { return ys_of(u) + l32 * ldp; };
  auto hs_of = [&](int u) { return cum_of(u) + sm.slot - 2 * p32 * lds; };
  auto gs_of = [&](int u) { return hs_of(u) + p32 * lds; };
  const int64_t ld = static_cast<int64_t>(nh) * p;
  auto load_head = [&](int hd, int u) {
    const int64_t st = ((static_cast<int64_t>(b) * nc + ic) * nh + hd) * p * n + k0;
    stage_steps(cum_of(u), a + t0 * nh + hd, nh, l);
    stage(ys_of(u), ldp, dy + (t0 * nh + hd) * p, ld, l, l32, p, p32);
    stage(xs_of(u), ldp, x + (t0 * nh + hd) * p, ld, l, l32, p, p32);
    stage(hs_of(u), lds, states + st, n, p, p32, cols, kSlice);
    stage(gs_of(u), lds, dstates + st, n, p, p32, cols, kSlice);
  };

  const bool is_dc = warp < 4;
  const bool mine = warp % 4 < np;  // this warp's dc or db patch: rows 32 (warp % 4)
  const int r0 = (warp % 4) * kPatch;
  int vp[2][2];                     // V patches (row, column) of this warp; -1: none
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!tri_patch(warp + 8 * u, np, vp[u][0], vp[u][1])) vp[u][0] = -1;
  }
  Patch acc, v[2];
  zero(acc);
  zero(v[0]);
  zero(v[1]);

  load_head(0, 0);
  hopper::cp_async_commit();
  for (int hd = 0; hd < nh; ++hd) {
    const int u = hd & 1;
    if (hd + 1 < nh) load_head(hd + 1, u ^ 1);  // into the slot head hd-1 left
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();                  // head hd has landed
    __syncthreads();
    float* cum = cum_of(u);
    const T* ys = ys_of(u);
    const T* xs = xs_of(u);
    const float* hs = hs_of(u);
    const float* gs = gs_of(u);
    scan_in_place(cum, l);
    const float cum_last = cum[l - 1];
    for (int t = tid; t < l32; t += kThreads) {
      ecum[t] = t < l ? expf(cum[t]) : 0.f;
      edec[t] = t < l ? expf(cum_last - cum[t]) : 0.f;
    }
    __syncthreads();
    // V += L ⊙ dY·Xᵀ on this warp's lower-triangle patches
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (vp[q][0] < 0) continue;
      const int i0 = vp[q][0] * kPatch, j0 = vp[q][1] * kPatch;
      Patch d;
      zero(d);
      if constexpr (kTC) {  // both operands bf16: m16n8k16, the pads zero up to p32
        patch_mma_bf16(d, i0, j0, 0, round_up(p, 16), ys, ldp, xs, ldp);
      } else {
        patch_mma<kTC, 0>(d, i0, j0, 0, p8, [&](int m, int k) { return to_float(ys[m * ldp + k]); },
                          [&](int k, int c) { return to_float(xs[c * ldp + k]); });
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = prow(i0, mi, r), j = pcol(j0, ni, r);
            if (j <= i && i < l) v[q][mi][ni][r] += __expf(cum[i] - cum[j]) * d[mi][ni][r];
          }
    }
    // the state terms of this head
    if (mine) {
      if (is_dc) {
        patch_mma<kTC, kSplitA | kSplitB>(
            acc, r0, 0, 0, p8, [&](int m, int k) { return ecum[m] * to_float(ys[m * ldp + k]); },
            [&](int k, int c) { return hs[k * lds + c]; });
      } else {
        patch_mma<kTC, kSplitA | kSplitB>(
            acc, r0, 0, 0, p8, [&](int m, int k) { return edec[m] * to_float(xs[m * ldp + k]); },
            [&](int k, int c) { return gs[k * lds + c]; });
      }
    }
    __syncthreads();  // slot u is free for head hd+2
  }

  // V (zero above the diagonal) to shared memory, and the columns of B and C
  float* vs = smem;                                        // [l32][ldv]
  T* bs = reinterpret_cast<T*>(vs + l32 * sm.ldv);         // [l32][ldm]: B's columns
  T* cs = bs + l32 * sm.ldm;                               // [l32][ldm]: C's columns
  stage(bs, sm.ldm, bm + t0 * n + k0, n, l, l32, cols, kSlice);
  stage(cs, sm.ldm, cm + t0 * n + k0, n, l, l32, cols, kSlice);
  hopper::cp_async_commit();
  for (int i = tid; i < l32 * sm.ldv; i += kThreads) vs[i] = 0.f;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (vp[q][0] < 0) continue;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = prow(vp[q][0] * kPatch, mi, r), j = pcol(vp[q][1] * kPatch, ni, r);
          vs[i * sm.ldv + j] = v[q][mi][ni][r];
        }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();
  if (!mine) return;
  if (is_dc) {  // rows i: Σ_{j <= i} V[i][j]·b_j
    patch_mma<kTC, kSplitA>(acc, r0, 0, 0, min(l8, r0 + kPatch),
                            [&](int m, int k) { return vs[m * sm.ldv + k]; },
                            [&](int k, int c) { return to_float(bs[k * sm.ldm + c]); });
  } else {      // rows j: Σ_{i >= j} V[i][j]·c_i
    patch_mma<kTC, kSplitA>(acc, r0, 0, r0, l8, [&](int m, int k) { return vs[k * sm.ldv + m]; },
                            [&](int k, int c) { return to_float(cs[k * sm.ldm + c]); });
  }
  T* out = is_dc ? dc : db;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = prow(r0, mi, r), k = pcol(0, ni, r);
        if (i < l && k < cols) from_float(acc[mi][ni][r], &out[(t0 + i) * n + k0 + k]);
      }
}

template <typename T>
int launch_backward(const void* x, const void* a, const void* b, const void* c, const void* dy,
                    const void* dhf, const void* states, const void* cb, const void* decay,
                    const void* hf, void* dx, void* da, void* db, void* dc, void* dstates,
                    int bsz, int s, int h, int p, int n, int l, void* stream) {
  if (l <= 0 || l > kMaxL || s % l != 0 || p <= 0 || p > kMaxP || n <= 0 || n > kMaxN ||
      bsz > 65535 || h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t contrib_bytes = sizeof(float) * contrib_floats<T>(l, p, n);
  const size_t dx_bytes = sizeof(float) * DxSmem<T>(l, p, n).floats();
  const size_t dbc_bytes = sizeof(float) * DbcSmem<T>(l, p).floats();
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_contrib_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(contrib_bytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ssd_bwd_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dx_bytes));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ssd_bwd_dbc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dbc_bytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bsz == 0 || s == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  const int nc = s / l;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* at = static_cast<const float*>(a);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const T* dyt = static_cast<const T*>(dy);
  float* dst = static_cast<float*>(dstates);
  ssd_bwd_contrib_kernel<T><<<dim3(nc, h, bsz), kThreads, contrib_bytes, st>>>(dyt, at, ct, dst, s,
                                                                             h, p, n, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_kernel<<<dim3((p * n + kThreads - 1) / kThreads, h, bsz), kThreads, 0, st>>>(
      dst, static_cast<const float*>(decay), static_cast<const float*>(dhf), nc, h, p * n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dx_kernel<T><<<dim3(nc, h, bsz), kThreads, dx_bytes, st>>>(
      xt, at, bt, ct, dyt, static_cast<const float*>(states), static_cast<const float*>(cb), dst,
      static_cast<const float*>(hf), static_cast<T*>(dx), static_cast<float*>(da), s, h, p, n, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbc_kernel<T><<<dim3(nc, (n + kSlice - 1) / kSlice, bsz), kThreads, dbc_bytes, st>>>(
      xt, at, bt, ct, dyt, static_cast<const float*>(states), dst, static_cast<T*>(db),
      static_cast<T*>(dc), s, h, p, n, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// states [B, S/l, H, P, N], cb [B, S/l, l, l] and decay [B, S/l, H]: float32 workspaces
extern "C" int ssd_f32(const void* x, const void* a, const void* b, const void* c, void* y,
                       void* hf, void* states, void* cb, void* decay, int bsz, int s, int h,
                       int p, int n, int l, void* stream) {
  return launch<float>(x, a, b, c, y, hf, states, cb, decay, bsz, s, h, p, n, l, stream);
}

extern "C" int ssd_bf16(const void* x, const void* a, const void* b, const void* c, void* y,
                        void* hf, void* states, void* cb, void* decay, int bsz, int s, int h,
                        int p, int n, int l, void* stream) {
  return launch<__nv_bfloat16>(x, a, b, c, y, hf, states, cb, decay, bsz, s, h, p, n, l, stream);
}

// The backward (kernels/ssd.py:backward): dhf [B, H, P, N] or null (zero); states, cb,
// decay and hf as the forward left them; dx [B, S, H, P] and db, dc [B, S, N] in x's
// dtype, da [B, S, H] float32; dstates [B, S/l, H, P, N]: a float32 workspace
extern "C" int ssd_backward_f32(const void* x, const void* a, const void* b, const void* c,
                                const void* dy, const void* dhf, const void* states,
                                const void* cb, const void* decay, const void* hf, void* dx,
                                void* da, void* db, void* dc, void* dstates, int bsz, int s, int h,
                                int p, int n, int l, void* stream) {
  return launch_backward<float>(x, a, b, c, dy, dhf, states, cb, decay, hf, dx, da, db, dc,
                                dstates, bsz, s, h, p, n, l, stream);
}

extern "C" int ssd_backward_bf16(const void* x, const void* a, const void* b, const void* c,
                                 const void* dy, const void* dhf, const void* states,
                                 const void* cb, const void* decay, const void* hf, void* dx,
                                 void* da, void* db, void* dc, void* dstates, int bsz, int s,
                                 int h, int p, int n, int l, void* stream) {
  return launch_backward<__nv_bfloat16>(x, a, b, c, dy, dhf, states, cb, decay, hf, dx, da, db,
                                        dc, dstates, bsz, s, h, p, n, l, stream);
}
