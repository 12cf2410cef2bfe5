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
// PyTorch, is the forward's passes in reverse, five launches a call. With G_c
// the gradient of the state leaving chunk c (G = dhf after the last chunk, zero
// without one) and H_c the state entering it (the forward's `states`):
//   1. ssd_bwd_contrib_kernel, one block per (chunk, head, batch): the chunk's
//      contribution Σ_i exp(cum_i)·dy_iᵀc_i [P, N] into `dstates` (the forward's
//      chunk pass with dy ⊙ exp(cum) for X and C for B).
//   2. ssd_bwd_state_kernel, one thread per (batch, head, state element): walks
//      the chunks from the last, G_{c-1} = exp(cum_last_c)·G_c + contribution_c,
//      and overwrites each contribution with the G of the state leaving its chunk.
//   3. ssd_bwd_dx_kernel, one block per (chunk, head, batch): y again in float32
//      (the forward's output pass), dx = (L ⊙ C·Bᵀ)ᵀ·dY + exp(cum_last - cum) ⊙
//      (B·Gᵀ) in the same two phases, and the gradient of cum as dy_i·y_i -
//      x_i·dx_i (every term of y_i scales with exp(cum_i), of dx_j with exp(-cum_j))
//      plus <G, H_next> at the chunk's last step; da is its reverse cumulative
//      sum within the chunk, by one warp.
//   4. ssd_bwd_dbc_kernel, one block per (chunk, head, batch): V = L ⊙ dY·Xᵀ
//      (8 x 8 register tiles on the causal pairs), then this head's share of
//      dc = V·B + exp(cum) ⊙ (dY·H) and of db = Vᵀ·C + exp(cum_last - cum) ⊙ (X·G),
//      32 state columns at a time, into float32 workspaces [B, nc, H, l, N].
//   5. ssd_bwd_sum_kernel, one thread per (batch, step, state column): db and dc
//      as the sums of the heads' shares, head 0 first, in x's dtype.
// b and c are shared by the heads, so their gradients sum over the heads; the sum
// runs in a fixed order, and every other reduction is one thread's or a fixed
// tree: no atomics, so a run repeats bitwise. The bound is again float32
// operations on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;   // chunk length
constexpr int kMaxP = 64;    // head dim
constexpr int kMaxN = 128;   // state dim
constexpr int kSlice = 32;   // state columns of C·Bᵀ staged at a time
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

// Inclusive cumsum of a[t * stride], t < l, into cum[t]: every thread loads one step
// (l <= kThreads), then warp 0 scans: each lane sums a run of steps, and a shuffle
// scan over the lanes' run totals offsets each run. Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a, int64_t stride, int l,
                                             float* cum) {
  if (threadIdx.x < l) cum[threadIdx.x] = a[threadIdx.x * stride];
  __syncthreads();
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

// 1. dstates[b, c, hd] <- Σ_i exp(cum_i)·dy_iᵀ c_i [P, N]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_contrib_kernel(const T* __restrict__ dy, const float* __restrict__ a,
                       const T* __restrict__ cm, float* __restrict__ dstates, int s, int nh, int p,
                       int n, int l) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) float smem[];
  const int ic = blockIdx.x, hd = blockIdx.y, b = blockIdx.z, nc = s / l;
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;
  const int p4 = round_up(p, 4), n4 = round_up(n, 4);
  float* ys = smem;                 // [l][p4]: dY ⊙ exp(cum)
  float* cs = ys + l * p4;          // [l][n4]
  float* cum = cs + l * n4;         // [l]
  chunk_cumsum(a + t0 * nh + hd, nh, l, cum);
  load_tile(dy + (t0 * nh + hd) * p, static_cast<int64_t>(nh) * p, l, l, p, p4,
            [&](int t, int d, const float* v) {
    const float e = expf(cum[t]);
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      if (d + q < p4) ys[t * p4 + d + q] = v[q] * e;
    }
  });
  load_tile(cm + t0 * n, n, l, l, n, n4, [&](int t, int k, const float* v) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      if (k + q < n4) cs[t * n4 + k + q] = v[q];
    }
  });
  __syncthreads();
  float* out = dstates + ((static_cast<int64_t>(b) * nc + ic) * nh + hd) * p * n;
  const int tn = n4 / 4;
  for (int m = tid; m < (p4 / 4) * tn; m += kThreads) {
    const int mp = m / tn, mn = m % tn;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int t = 0; t < l; ++t) outer<4>(acc, ys + t * p4 + 4 * mp, cs + t * n4 + 4 * mn);
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

// Floats of the dx pass: the output pass's two phases (reused for dx), cum, exp(cum),
// exp(cum_last - cum), the partial dot products dy·y and x·dx by thread column
// ([2][P4/4][l8]) and a reduction buffer.
__host__ __device__ __forceinline__ int bdx_floats(int l, int p, int n) {
  const int l8 = round_up(l, 8), tp = round_up(p, 4) / 4;
  return out_phase_floats(l, p, n) + 3 * l8 + 2 * tp * l8 + kThreads;
}

// 3. dx and da
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const T* __restrict__ dy,
                  const float* __restrict__ states, const float* __restrict__ cb,
                  const float* __restrict__ dstates, const float* __restrict__ hf,
                  T* __restrict__ dx, float* __restrict__ da, int s, int nh, int p, int n, int l) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) float smem[];
  const int ic = blockIdx.x, hd = blockIdx.y, b = blockIdx.z, nc = s / l;
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;
  const int l8 = round_up(l, 8), p4 = round_up(p, 4), n4 = round_up(n, 4), tp = p4 / 4;
  const int lp = padded(l8), hp = padded(p4);
  float* cum = smem + out_phase_floats(l, p, n);  // [l8]
  float* ecum = cum + l8;                          // [l8]: exp(cum)
  float* edec = ecum + l8;                         // [l8]: exp(cum_last - cum)
  float* part = edec + l8;                         // [2][tp][l8]: dy·y, x·dx
  float* red = part + 2 * tp * l8;                 // [kThreads]
  chunk_cumsum(a + t0 * nh + hd, nh, l, cum);
  const float cum_last = cum[l - 1];
  for (int t = tid; t < l; t += kThreads) {
    ecum[t] = expf(cum[t]);
    edec[t] = expf(cum_last - cum[t]);
  }
  const int64_t row = (static_cast<int64_t>(b) * nc + ic) * nh + hd;
  const float* hc = states + row * p * n;   // H: the state entering the chunk
  const float* gc = dstates + row * p * n;  // G: the gradient of the state leaving it
  const float* hn = ic + 1 < nc ? states + (row + nh) * p * n   // the state leaving it
                                : hf + (static_cast<int64_t>(b) * nh + hd) * p * n;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + ic) * l * l;
  const T* xh = x + (t0 * nh + hd) * p;     // row t of this head at xh + t * nh * p
  const T* dyh = dy + (t0 * nh + hd) * p;
  const int64_t ld = static_cast<int64_t>(nh) * p;

  float gh = 0.f;  // this thread's share of <G, H_next>, summed by a tree below
  for (int k = tid; k < p * n; k += kThreads) gh = fmaf(gc[k], hn[k], gh);
  red[tid] = gh;

  // one 8 x 4 tile of [l, P] a thread (l8/8 x p4/4 <= 256 tiles)
  const int ntiles = (l8 / 8) * tp;
  const bool mine = tid < ntiles;
  const int mi = tid / tp, md = tid % tp;
  float acc[8][4], off[8][4];

  // ---- y = (L ⊙ C·Bᵀ)·X + (C·Hᵀ) ⊙ exp(cum), as the output pass forms it ----
  float* st = smem;          // [l][l8]: st[j][i] = L[i][j]·(C·Bᵀ)[i][j]
  float* xs = st + l * l8;   // [l][p4]
  load_tile(cbc, l, l, l, l, l8, [&](int j, int r0, const float* v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + e;
      const float seg = j <= r ? cum[r] - cum[j] : kNegInf;
      if (r < l8) st[j * l8 + r] = r < l && j <= r ? expf(seg) * v[e] : 0.f;
    }
  });
  load_tile(xh, ld, l, l, p, p4, [&](int t, int d, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (d + e < p4) xs[t * p4 + d + e] = v[e];
    }
  });
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = off[u][v] = 0.f;
  if (mine) {
    const int jmax = min(l, 8 * mi + 8);
    for (int j = 0; j < jmax; ++j) outer<8>(acc, st + j * l8 + 8 * mi, xs + j * p4 + 4 * md);
  }
  __syncthreads();
  float* ct = smem;          // [n4][lp]: Cᵀ
  float* ht = ct + n4 * lp;  // [n4][hp]: Hᵀ
  load_tile(cm + t0 * n, n, l, l8, n, n4, [&](int t, int k, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (k + e < n4) ct[(k + e) * lp + t] = v[e];
    }
  });
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
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int d = 4 * md + v;
        if (d < p) dot = fmaf(to_float(dyh[r * ld + d]), acc[u][v] + off[u][v] * ecum[r], dot);
      }
      part[md * l8 + r] = dot;
    }
  }
  __syncthreads();

  // ---- dx = (L ⊙ C·Bᵀ)ᵀ·dY + exp(cum_last - cum) ⊙ (B·Gᵀ) ----
  float* wt = smem;          // [l][l8]: wt[i][j] = L[i][j]·(C·Bᵀ)[i][j], zero for j > i
  float* dys = wt + l * l8;  // [l][p4]
  load_tile(cbc, l, l, l8, l, l8, [&](int j, int r0, const float* v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + e;
      const float seg = j <= i ? cum[i] - cum[j] : kNegInf;
      if (i < l) wt[i * l8 + j] = j < l && j <= i ? expf(seg) * v[e] : 0.f;
    }
  });
  load_tile(dyh, ld, l, l, p, p4, [&](int t, int d, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (d + e < p4) dys[t * p4 + d + e] = v[e];
    }
  });
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = off[u][v] = 0.f;
  if (mine) {
    for (int i = 8 * mi; i < l; ++i) outer<8>(acc, wt + i * l8 + 8 * mi, dys + i * p4 + 4 * md);
  }
  __syncthreads();
  float* bt = smem;          // [n4][lp]: Bᵀ
  float* gt = bt + n4 * lp;  // [n4][hp]: Gᵀ
  load_tile(bm + t0 * n, n, l, l8, n, n4, [&](int t, int k, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (k + e < n4) bt[(k + e) * lp + t] = v[e];
    }
  });
  load_tile(gc, n, p, p4, n, n4, [&](int d, int k, const float* v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e < n4) gt[(k + e) * hp + d] = v[e];
    }
  });
  __syncthreads();
  if (mine) {
    for (int k = 0; k < n; ++k) outer<8>(off, bt + k * lp + 8 * mi, gt + k * hp + 4 * md);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = 8 * mi + u;
      if (j >= l) continue;
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int d = 4 * md + v;
        if (d >= p) continue;
        const float g = acc[u][v] + off[u][v] * edec[j];
        from_float(g, &dx[(t0 + j) * ld + hd * p + d]);
        dot = fmaf(to_float(xh[j * ld + d]), g, dot);
      }
      part[(tp + md) * l8 + j] = dot;
    }
  }
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {  // <G, H_next>: a fixed tree
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }

  // ---- da: the reverse cumulative sum of the gradient of cum, by warp 0 ----
  if (tid < 32) {
    const int lane = tid, per = (l + 31) / 32, lo = min(lane * per, l), hi = min(lo + per, l);
    float run = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
      float g = t == l - 1 ? red[0] : 0.f;
      for (int q = 0; q < tp; ++q) g += part[q * l8 + t] - part[(tp + q) * l8 + t];
      run += g;
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

// Floats of the db/dc pass: dYᵀ and Xᵀ [p4][lp], V [l8][l8], a slice of B or C
// [l8][kSlice + 4] and of H or G [p4][kSlice + 4], cum, exp(cum), exp(cum_last - cum).
__host__ __device__ __forceinline__ int bbc_floats(int l, int p) {
  const int l8 = round_up(l, 8), p4 = round_up(p, 4);
  return 2 * p4 * padded(l8) + l8 * l8 + (l8 + p4) * (kSlice + 4) + 3 * l8;
}

// 4. this head's shares of dc = V·B + exp(cum) ⊙ (dY·H) and db = Vᵀ·C + exp(cum_last - cum)
// ⊙ (X·G), with V = L ⊙ dY·Xᵀ, into dch and dbh [B, nc, H, l, N]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ bm,
                   const T* __restrict__ cm, const T* __restrict__ dy,
                   const float* __restrict__ states, const float* __restrict__ dstates,
                   float* __restrict__ dbh, float* __restrict__ dch, int s, int nh, int p, int n,
                   int l) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) float smem[];
  const int ic = blockIdx.x, hd = blockIdx.y, b = blockIdx.z, nc = s / l;
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;
  const int l8 = round_up(l, 8), p4 = round_up(p, 4), lp = padded(l8), sl = kSlice + 4;
  float* dyt = smem;            // [p4][lp]: dYᵀ
  float* xt = dyt + p4 * lp;    // [p4][lp]: Xᵀ
  float* vs = xt + p4 * lp;     // [l8][l8]: V as [j][i], then as [i][j]
  float* ms = vs + l8 * l8;     // [l8][sl]: 32 columns of B, then of C
  float* ks = ms + l8 * sl;     // [p4][sl]: 32 columns of H, then of G
  float* cum = ks + p4 * sl;    // [l8]
  float* ecum = cum + l8;       // [l8]: exp(cum)
  float* edec = ecum + l8;      // [l8]: exp(cum_last - cum)
  chunk_cumsum(a + t0 * nh + hd, nh, l, cum);
  const float cum_last = cum[l - 1];
  for (int t = tid; t < l; t += kThreads) {
    ecum[t] = expf(cum[t]);
    edec[t] = expf(cum_last - cum[t]);
  }
  const int64_t ld = static_cast<int64_t>(nh) * p;
  const int64_t row = (static_cast<int64_t>(b) * nc + ic) * nh + hd;
  const float* hc = states + row * p * n;
  const float* gc = dstates + row * p * n;
  load_tile(dy + (t0 * nh + hd) * p, ld, l, l8, p, p4, [&](int t, int d, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (d + e < p4) dyt[(d + e) * lp + t] = v[e];
    }
  });
  load_tile(x + (t0 * nh + hd) * p, ld, l, l8, p, p4, [&](int t, int d, const float* v) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (d + e < p4) xt[(d + e) * lp + t] = v[e];
    }
  });
  __syncthreads();

  // V: 8 x 8 tiles (ti rows i, tj columns j); the tiles above the diagonal stay zero
  const int tiles = l8 / 8;
  const int ti = tid / tiles, tj = tid % tiles;
  const bool owner = tid < tiles * tiles;
  float v8[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int w = 0; w < 8; ++w) v8[u][w] = 0.f;
  if (owner && tj <= ti) {
    for (int d = 0; d < p; ++d) {
      const float4 y0 = ld4(dyt + d * lp + 8 * ti), y1 = ld4(dyt + d * lp + 8 * ti + 4);
      const float4 x0 = ld4(xt + d * lp + 8 * tj), x1 = ld4(xt + d * lp + 8 * tj + 4);
      const float yi[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float xj[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) v8[u][w] = fmaf(yi[u], xj[w], v8[u][w]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = 8 * ti + u;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int j = 8 * tj + w;
        v8[u][w] = i < l && j <= i ? v8[u][w] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
  }
  if (owner) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int w = 0; w < 8; ++w) vs[(8 * tj + w) * l8 + 8 * ti + u] = v8[u][w];
  }

  // 4 x 4 tiles of a [l, 32] slice of the outputs
  const int groups = kSlice / 4, otiles = (l8 / 4) * groups;
  float* outs[2] = {dch + row * l * n, dbh + row * l * n};
  for (int pass = 0; pass < 2; ++pass) {  // 0: dc, with V as [j][i]; 1: db, with V as [i][j]
    if (pass == 1) {
      __syncthreads();  // dc's readers of V are done
      if (owner) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 8; ++w) vs[(8 * ti + u) * l8 + 8 * tj + w] = v8[u][w];
      }
    }
    const T* mat = pass == 0 ? bm : cm;
    const float* st8 = pass == 0 ? hc : gc;
    const float* tpose = pass == 0 ? dyt : xt;
    const float* scale = pass == 0 ? ecum : edec;
    for (int n0 = 0; n0 < n; n0 += kSlice) {
      const int cols = min(kSlice, n - n0);
      __syncthreads();  // the previous slice's readers are done (and V is written)
      load_tile(mat + t0 * n + n0, n, l, l8, cols, kSlice, [&](int t, int k, const float* v) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if (k + e < kSlice) ms[t * sl + k + e] = v[e];
        }
      });
      load_tile(st8 + n0, n, p, p4, cols, kSlice, [&](int d, int k, const float* v) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k + e < kSlice) ks[d * sl + k + e] = v[e];
        }
      });
      __syncthreads();
      for (int m = tid; m < otiles; m += kThreads) {
        const int mr = m / groups, mn = m % groups;
        float acc[4][4], off[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = off[u][v] = 0.f;
        if (pass == 0) {  // dc rows i: Σ_{j <= i} V[i][j]·b_j
          const int jmax = min(l, 4 * mr + 4);
          for (int j = 0; j < jmax; ++j) outer<4>(acc, vs + j * l8 + 4 * mr, ms + j * sl + 4 * mn);
        } else {          // db rows j: Σ_{i >= j} V[i][j]·c_i
          for (int i = 4 * mr; i < l; ++i) outer<4>(acc, vs + i * l8 + 4 * mr, ms + i * sl + 4 * mn);
        }
        for (int d = 0; d < p; ++d) outer<4>(off, tpose + d * lp + 4 * mr, ks + d * sl + 4 * mn);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = 4 * mr + u;
          if (r >= l) continue;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int k = 4 * mn + v;
            if (k < cols) outs[pass][static_cast<int64_t>(r) * n + n0 + k] = acc[u][v] + off[u][v] * scale[r];
          }
        }
      }
    }
  }
}

// 5. db, dc [B, S, N] <- the heads' shares summed, head 0 first
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(const float* __restrict__ dbh, const float* __restrict__ dch, T* __restrict__ db,
                   T* __restrict__ dc, int s, int nh, int n, int l, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int k = static_cast<int>(idx % n);
  const int64_t bt = idx / n;
  const int t = static_cast<int>(bt % s), b = static_cast<int>(bt / s), nc = s / l;
  const int64_t base = ((static_cast<int64_t>(b) * nc + t / l) * nh) * l * n +
                       static_cast<int64_t>(t % l) * n + k;
  const int64_t step = static_cast<int64_t>(l) * n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < nh; ++h) {
    sb += dbh[base + h * step];
    sc += dch[base + h * step];
  }
  from_float(sb, &db[idx]);
  from_float(sc, &dc[idx]);
}

template <typename T>
int launch_backward(const void* x, const void* a, const void* b, const void* c, const void* dy,
                    const void* dhf, const void* states, const void* cb, const void* decay,
                    const void* hf, void* dx, void* da, void* db, void* dc, void* dstates,
                    void* dbh, void* dch, int bsz, int s, int h, int p, int n, int l,
                    void* stream) {
  if (l <= 0 || l > kMaxL || s % l != 0 || p <= 0 || p > kMaxP || n <= 0 || n > kMaxN ||
      bsz > 65535 || h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int l8 = round_up(l, 8);
  const size_t contrib_bytes = sizeof(float) * (l * (round_up(p, 4) + round_up(n, 4)) + l8);
  const size_t dx_bytes = sizeof(float) * bdx_floats(l, p, n);
  const size_t dbc_bytes = sizeof(float) * bbc_floats(l, p);
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
  ssd_bwd_dbc_kernel<T><<<dim3(nc, h, bsz), kThreads, dbc_bytes, st>>>(
      xt, at, bt, ct, dyt, static_cast<const float*>(states), dst, static_cast<float*>(dbh),
      static_cast<float*>(dch), s, h, p, n, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(bsz) * s * n;
  ssd_bwd_sum_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                          st>>>(static_cast<const float*>(dbh), static_cast<const float*>(dch),
                                static_cast<T*>(db), static_cast<T*>(dc), s, h, n, l, total);
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
// dtype, da [B, S, H] float32; dstates [B, S/l, H, P, N], dbh and dch [B, S/l, H, l, N]:
// float32 workspaces
extern "C" int ssd_backward_f32(const void* x, const void* a, const void* b, const void* c,
                                const void* dy, const void* dhf, const void* states,
                                const void* cb, const void* decay, const void* hf, void* dx,
                                void* da, void* db, void* dc, void* dstates, void* dbh, void* dch,
                                int bsz, int s, int h, int p, int n, int l, void* stream) {
  return launch_backward<float>(x, a, b, c, dy, dhf, states, cb, decay, hf, dx, da, db, dc,
                                dstates, dbh, dch, bsz, s, h, p, n, l, stream);
}

extern "C" int ssd_backward_bf16(const void* x, const void* a, const void* b, const void* c,
                                 const void* dy, const void* dhf, const void* states,
                                 const void* cb, const void* decay, const void* hf, void* dx,
                                 void* da, void* db, void* dc, void* dstates, void* dbh,
                                 void* dch, int bsz, int s, int h, int p, int n, int l,
                                 void* stream) {
  return launch_backward<__nv_bfloat16>(x, a, b, c, dy, dhf, states, cb, decay, hf, dx, da, db,
                                        dc, dstates, dbh, dch, bsz, s, h, p, n, l, stream);
}
