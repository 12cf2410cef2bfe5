// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd (_ssd_kernel):
// the state-space dual form of Dao & Gu (2024). x [B, S, H, P] (already
// dt-weighted) in bf16 or float32, a [B, S, H] the float32 log decay, b and
// c [B, S, N] shared across heads (ngroups = 1). Outputs y [B, S, H, P] in
// x's dtype and the final state [B, H, P, N] in float32. S is a multiple of
// the chunk length l. Everything inside is float32, as in the Pallas body.
// Per chunk, with cum the cumulative sum of a restarting at the chunk:
//   L     = exp(where(i >= j, cum_i - cum_j, -1e30))   (masked before exp)
//   y     = (L ⊙ C·Bᵀ)·X + (C·hᵀ) ⊙ exp(cum)
//   h    <- h·exp(cum_last) + (X ⊙ exp(cum_last - cum))ᵀ·B
//
// Bound on the H100: operations. At mamba2's shapes (l = 128, P = 64,
// N = 128) a chunk of one head does ~4 M float32 FMAs on 64 KB of inputs.
//
// Design (simple; a chunk-parallel form is left for a later change): one
// block of 256 threads per (head, batch), the TPU grid's (B, H) with its
// sequential chunk axis as a loop inside the block. The block keeps h [P, N]
// in shared memory across chunks. Each chunk's X, B and C are staged in
// shared memory as float32; L ⊙ C·Bᵀ is formed 32 query rows at a time,
// only up to the sub-tile's last row (the causal mask zeroes the rest), so
// a chunk of 128 rows with N = 128 fits in 216 KB. Every product runs on
// the CUDA cores with register micro-tiles; B·H blocks underfill the 132
// SMs at batch-1 prefill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;   // chunk length
constexpr int kMaxP = 64;    // head dim
constexpr int kMaxN = 128;   // state dim
constexpr int kRows = 32;    // query rows of L ⊙ C·Bᵀ held at a time
constexpr float kNegInf = -1e30f;

// Thread layouts: scores and y use 8 warps x 4 rows, each lane a column
// (lane + 32 j); the state update uses 16 groups of 4 P rows x 16 lanes of N
// columns (ng + 16 k).
static_assert(kThreads / 32 * 4 == kRows, "score rows");
static_assert(kThreads / 16 * 4 == kMaxP, "state rows");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

size_t smem_bytes(int l, int p, int n) {
  const size_t ns = n + 1;
  return sizeof(float) * (static_cast<size_t>(l) * p + 2 * l * ns + p * ns +
                          static_cast<size_t>(kRows) * (l + 1) + 3 * static_cast<size_t>(l));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ hf, int s, int nh,
           int p, int n, int l) {
  extern __shared__ float smem[];
  const int ns = n + 1;                // padded row stride of B, C and h
  const int ls = l + 1;
  float* xs = smem;                    // [l][p]
  float* bs = xs + l * p;              // [l][ns]
  float* cs = bs + l * ns;             // [l][ns]
  float* hs = cs + l * ns;             // [p][ns]  the carried state
  float* ss = hs + p * ns;             // [kRows][ls]  L ⊙ C·Bᵀ for one row sub-tile
  float* cum = ss + kRows * ls;        // [l]
  float* ecum = cum + l;               // exp(cum_i)
  float* dec = ecum + l;               // exp(cum_last - cum_j)

  const int hd = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = s / l;

  for (int i = tid; i < p * ns; i += kThreads) hs[i] = 0.f;

  for (int ic = 0; ic < nc; ++ic) {
    const int64_t t0 = static_cast<int64_t>(b) * s + static_cast<int64_t>(ic) * l;  // row in [B*S]
    __syncthreads();  // the previous chunk's readers are done; h is up to date
    for (int i = tid; i < l * p; i += kThreads) {
      const int t = i / p, d = i % p;
      xs[i] = to_float(x[((t0 + t) * nh + hd) * p + d]);
    }
    for (int i = tid; i < l * n; i += kThreads) {
      const int t = i / n, k = i % n;
      bs[t * ns + k] = to_float(bm[(t0 + t) * n + k]);
      cs[t * ns + k] = to_float(cm[(t0 + t) * n + k]);
    }
    if (warp == 0) {
      // inclusive cumsum of a over the chunk: each lane sums a run of steps, then a
      // shuffle scan over the lanes' run totals gives each run its offset
      const int per = (l + 31) / 32, lo = lane * per, hi = min(lo + per, l);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += a[(t0 + t) * nh + hd];
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
    const float cum_last = cum[l - 1];
    for (int t = tid; t < l; t += kThreads) {
      ecum[t] = expf(cum[t]);
      dec[t] = expf(cum_last - cum[t]);
    }

    // ---- y, kRows query rows at a time ----
    for (int i0 = 0; i0 < l; i0 += kRows) {
      const int ncols = min(l, i0 + kRows);  // key columns past the sub-tile's last row are masked
      __syncthreads();  // the previous sub-tile's readers of ss are done; ecum, dec written
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int k = 0; k < n; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i0 + warp * 4 + i;
          cv[i] = r < l ? cs[r * ns + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          bv[j] = c < ncols ? bs[c * ns + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (32 * j >= ncols) break;  // uniform over the block
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[i][j] += cv[i] * bv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = warp * 4 + i, r = i0 + rr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          if (c >= ncols) continue;
          float val = 0.f;
          if (r < l) {
            const float seg = r >= c ? cum[r] - cum[c] : kNegInf;  // mask, then exp
            val = expf(seg) * sc[i][j];
          }
          ss[rr * ls + c] = val;
        }
      }
      __syncthreads();

      float acc[4][2], off[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = off[i][j] = 0.f;
      for (int t = 0; t < ncols; ++t) {  // (L ⊙ C·Bᵀ)·X
        float sv[4], xv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = ss[(warp * 4 + i) * ls + t];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = lane + 32 * j;
          xv[j] = d < p ? xs[t * p + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] += sv[i] * xv[j];
      }
      for (int k = 0; k < n; ++k) {      // C·hᵀ
        float cv[4], hv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i0 + warp * 4 + i;
          cv[i] = r < l ? cs[r * ns + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = lane + 32 * j;
          hv[j] = d < p ? hs[d * ns + k] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) off[i][j] += cv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i0 + warp * 4 + i;
        if (r >= l) continue;
        const float e = ecum[r];
        T* yrow = y + ((t0 + r) * nh + hd) * p;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = lane + 32 * j;
          if (d < p) from_float(acc[i][j] + off[i][j] * e, &yrow[d]);
        }
      }
    }

    // ---- h <- h·exp(cum_last) + (X ⊙ dec)ᵀ·B ----
    __syncthreads();  // every reader of the old h is done
    const int pg = tid >> 4, ng = tid & 15;
    float st[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) st[i][k] = 0.f;
    for (int t = 0; t < l; ++t) {
      const float dt = dec[t];
      float xv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pp = pg * 4 + i;
        xv[i] = pp < p ? xs[t * p + pp] * dt : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int nn = ng + 16 * k;
        bv[k] = nn < n ? bs[t * ns + nn] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (16 * k >= n) break;  // uniform over the block
#pragma unroll
        for (int i = 0; i < 4; ++i) st[i][k] += xv[i] * bv[k];
      }
    }
    const float decay_all = expf(cum_last);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pp = pg * 4 + i;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int nn = ng + 16 * k;
        if (pp < p && nn < n) hs[pp * ns + nn] = hs[pp * ns + nn] * decay_all + st[i][k];
      }
    }
  }

  __syncthreads();
  float* hout = hf + (static_cast<int64_t>(b) * nh + hd) * p * n;
  for (int i = tid; i < p * n; i += kThreads) hout[i] = hs[(i / n) * ns + i % n];
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c, void* y, void* hf,
           int bsz, int s, int h, int p, int n, int l, void* stream) {
  if (l <= 0 || l > kMaxL || s % l != 0 || p <= 0 || p > kMaxP || n <= 0 || n > kMaxN ||
      bsz > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(l, p, n);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bsz > 0 && s > 0 && h > 0) {
    dim3 grid(h, bsz);
    ssd_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(b),
        static_cast<const T*>(c), static_cast<T*>(y), static_cast<float*>(hf), s, h, p, n, l);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_f32(const void* x, const void* a, const void* b, const void* c, void* y,
                       void* hf, int bsz, int s, int h, int p, int n, int l, void* stream) {
  return launch<float>(x, a, b, c, y, hf, bsz, s, h, p, n, l, stream);
}

extern "C" int ssd_bf16(const void* x, const void* a, const void* b, const void* c, void* y,
                        void* hf, int bsz, int s, int h, int p, int n, int l, void* stream) {
  return launch<__nv_bfloat16>(x, a, b, c, y, hf, bsz, s, h, p, n, l, stream);
}
