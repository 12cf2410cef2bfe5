// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * scale, statistics in
// float32, output in x's dtype, x flattened to [rows, D].
//
// Bound on the H100: bytes. It reads each row and the scale once and writes
// the row once, at about one operation per byte, far below the card's
// ~295 bf16 operations per byte of memory traffic.
//
// Design: one block per row. Each thread loads 16 bytes at a time (8 bf16 or
// 4 float), neighbouring threads on neighbouring addresses, and sums squares
// in float32; a warp shuffle reduction and one pass through shared memory
// give the row's sum. The second pass re-reads the row, which the first pass
// has just brought into L1/L2, so device memory sees the row once. A row
// that is not 16-byte aligned takes a scalar loop.
//
// The backward (rmsnorm_backward_*; the TPU kernel has none: XLA differentiates
// the jnp norm), the formula of kernels/rmsnorm.py:plain_backward: with
// r = rsqrt(mean(x^2) + eps), x^ = x * r and gs = g * scale,
// dx = r * (gs - x^ * mean(gs * x^)) and dscale = sum over rows of g * x^. Bound by
// bytes as the forward: x, g and dx once each, about eight operations an element.
// Two launches, no atomics, so a run repeats bitwise:
//   1. rmsnorm_bwd_rows<T, V, E>: each row is read from device memory once and stays in
//      registers between its two sums and the dx it writes. A team of threads takes a row,
//      each thread V units of E elements (16 bytes) at the same columns in every row, the
//      team's size a multiple of 8 chosen from d (kernels/rmsnorm.py:backward_plan) so that
//      at the training widths (768-4096) every thread holds the same number of units and
//      none idles; a block of up to 256 threads (whole groups of 8, not always whole warps)
//      runs `teams` teams, one row each a step, and takes a contiguous run of rows. Each thread loads the next step's units before it
//      reduces the current row, so a row's loads are in flight through every step's
//      reduction and barrier (a ring of shared-memory stages filled by bulk copies (TMA) on
//      mbarriers was measured no faster at the training widths, and slower at 768: PERF.md).
//      Each thread keeps its columns' sums of g * x^ in registers; at the end the block's
//      teams add them in order into its float32 row of the workspace partial[blocks, d].
//   2. rmsnorm_bwd_scale<T>: dscale, the workspace's rows added in a fixed order, sixteen
//      warps a block of 32 columns (each every sixteenth row), then the warps in order.
//   The grid (rows a block, blocks) is a function of the shape alone, so the sums do not
//   depend on the card, nor on which blocks share an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int d, float eps, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;

  float sq = 0.f;
  if (vec) {
    for (int i = threadIdx.x * kVec; i < d; i += kThreads * kVec) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_float(e[j]);
        sq += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_float(xr[i]);
      sq += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(sq) / d + eps);

  if (vec) {
    for (int i = threadIdx.x * kVec; i < d; i += kThreads * kVec) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      uint4 sraw = *reinterpret_cast<const uint4*>(scale + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) from_float(to_float(e[j]) * inv * to_float(s[j]), &o[j]);
      *reinterpret_cast<uint4*>(outr + i) = oraw;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      from_float(to_float(xr[i]) * inv * to_float(scale[i]), &outr[i]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
           void* stream) {
  // 16-byte loads need 16-byte aligned rows: aligned pointers and D a
  // multiple of the vector width
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(x) |
                              reinterpret_cast<uintptr_t>(scale) |
                              reinterpret_cast<uintptr_t>(out);
  const bool vec = (addr_bits % 16) == 0 && (d % (16 / sizeof(T))) == 0;
  if (rows > 0) {
    rmsnorm_kernel<T><<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), d, eps,
        vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------
constexpr int kBwdMaxThreads = 256;  // a block: `teams` teams of `team` threads, one row a team
constexpr int kScaleWarps = 16;      // rmsnorm_bwd_scale: warps a block (kernels/rmsnorm.py:SCALE_WARPS)

// `E` elements of a row as one register value: 16 bytes, or one element where rows are not
// 16-byte aligned
template <typename T, int E>
using Unit = typename std::conditional<E == 1, T, uint4>::type;

template <typename T, int E>
__device__ __forceinline__ float elem(const Unit<T, E>& u, int e) {
  if constexpr (E == 1) {
    return to_float(u);
  } else {
    return to_float(reinterpret_cast<const T*>(&u)[e]);
  }
}

template <typename T, int E>
__device__ __forceinline__ Unit<T, E> zero_unit() {
  if constexpr (E == 1) {
    T z;
    from_float(0.f, &z);
    return z;
  } else {
    return make_uint4(0u, 0u, 0u, 0u);
  }
}

// Thread lt of a team: units lt, lt + team, ... (V of them) of row `row`, zeros past the
// row's `units` or where !ok.
template <typename T, int V, int E>
__device__ __forceinline__ void load_units(const T* __restrict__ p, int64_t row, int64_t d, int lt,
                                           int team, int units, bool ok, Unit<T, E> (&out)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int u = lt + j * team;
    out[j] = ok && u < units ? *reinterpret_cast<const Unit<T, E>*>(p + row * d + static_cast<int64_t>(u) * E)
                             : zero_unit<T, E>();
  }
}

// The rows pass. Block b takes rows [b * rows_per_block, ...) in steps of `teams` rows, one a
// team; the team's thread lt holds units lt, lt + team, ... (V of them) of its row, the same
// columns in every step, so its column sums of g * x^ stay in registers. A step: the next
// step's units of x and g are loaded into registers first, then the current row's two sums
// (shuffles in groups of 8, 16 or 32 lanes, then the team's groups in order through shared
// memory, one __syncthreads a step), dx written, g * x^ added. At the end the teams' column
// sums are added in team order into partial[b, :].
template <typename T, int V, int E>
__global__ void __launch_bounds__(kBwdMaxThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ g,
                 T* __restrict__ dx, float* __restrict__ partial, int rows, int d, int team,
                 int rows_per_block, float eps) {
  using U = Unit<T, E>;
  __shared__ float2 red[2][kBwdMaxThreads / 8];  // the row sums of each group of lanes, by step parity
  extern __shared__ float col[];                 // [teams, d]: the teams' column sums at the end
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int teams = nthreads / team, tm = tid / team, lt = tid % team;
  const int units = d / E;
  // a row's sums go through shuffles within aligned groups of 8, 16 or 32 lanes, each
  // inside one team (a block of whole groups may end in a part of a warp)
  const int group = team % 32 == 0 ? 32 : (team % 16 == 0 ? 16 : 8);
  const int groups = team / group;
  const unsigned gmask = group == 32 ? 0xffffffffu : ((1u << group) - 1u) << ((tid % 32) & (32 - group));
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block, dd = d;
  const int64_t left = rows - row0;
  const int nrows = static_cast<int>(left < rows_per_block ? left : rows_per_block);
  const int steps = (nrows + teams - 1) / teams;

  U sc[V], xc[V], gc[V];
  load_units<T, V, E>(scale, 0, 0, lt, team, units, true, sc);
  load_units<T, V, E>(x, row0 + tm, dd, lt, team, units, tm < nrows, xc);
  load_units<T, V, E>(g, row0 + tm, dd, lt, team, units, tm < nrows, gc);
  float acc[V][E];
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;

  for (int k = 0; k < steps; ++k) {
    const int i = k * teams + tm;  // this team's row within the block
    const bool live = i < nrows, more = i + teams < nrows;
    U xn[V], gn[V];
    load_units<T, V, E>(x, row0 + i + teams, dd, lt, team, units, more, xn);
    load_units<T, V, E>(g, row0 + i + teams, dd, lt, team, units, more, gn);

    float sq = 0.f, dot = 0.f;  // sum of x^2, sum of gs * x (units past the row hold zeros)
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xf = elem<T, E>(xc[j], e);
        sq += xf * xf;
        dot += elem<T, E>(gc[j], e) * elem<T, E>(sc[j], e) * xf;
      }
    for (int off = 1; off < group; off <<= 1) {
      sq += __shfl_xor_sync(gmask, sq, off);
      dot += __shfl_xor_sync(gmask, dot, off);
    }
    float2* rb = red[k & 1];
    if (tid % group == 0) rb[tid / group] = make_float2(sq, dot);
    __syncthreads();
    float2 tot = make_float2(0.f, 0.f);
    for (int j = 0; j < groups; ++j) {
      const float2 p = rb[tm * groups + j];
      tot.x += p.x;
      tot.y += p.y;
    }
    if (live) {
      const float r = rsqrtf(tot.x / d + eps);
      const float mean = r * tot.y / d;  // mean(gs * x^)
      T* dxr = dx + (row0 + i) * dd;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int u = lt + j * team;
        if (u < units) {
          __align__(16) T out[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float gf = elem<T, E>(gc[j], e), xh = elem<T, E>(xc[j], e) * r;
            from_float(r * (gf * elem<T, E>(sc[j], e) - xh * mean), &out[e]);
            acc[j][e] += gf * xh;
          }
          *reinterpret_cast<U*>(dxr + static_cast<int64_t>(u) * E) = *reinterpret_cast<const U*>(out);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xc[j] = xn[j];
      gc[j] = gn[j];
    }
  }

  // the block's column sums: each team's into shared memory, added in team order
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int u = lt + j * team;
    if (u < units) {
#pragma unroll
      for (int e = 0; e < E; ++e) col[tm * dd + u * E + e] = acc[j][e];
    }
  }
  __syncthreads();
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  for (int c = tid; c < d; c += nthreads) {
    float s = 0.f;
    for (int t = 0; t < teams; ++t) s += col[t * dd + c];
    prow[c] = s;
  }
}

// dscale = the sum of partial's `blocks` rows: a block 32 columns, warp w adding rows w, w +
// kScaleWarps, ... in order, then the warps' sums in warp order.
template <typename T>
__global__ void __launch_bounds__(32 * kScaleWarps)
rmsnorm_bwd_scale(const float* __restrict__ partial, T* __restrict__ dscale, int blocks, int d) {
  __shared__ float part[kScaleWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int b = w; b < blocks; b += kScaleWarps) sum += partial[static_cast<int64_t>(b) * d + col];
  }
  part[w][lane] = sum;
  __syncthreads();
  if (w == 0 && col < d) {
    float total = 0.f;
    for (int i = 0; i < kScaleWarps; ++i) total += part[i][lane];
    from_float(total, &dscale[col]);
  }
}

struct BwdArgs {
  const void *x, *scale, *g;
  void *dx, *dscale, *partial;
  int rows, d, unit, vectors, team, teams, rows_per_block, blocks;
  float eps;
};

template <typename T, int V, int E>
int launch_rows(const BwdArgs& a, cudaStream_t st) {
  const int smem = a.teams * a.d * static_cast<int>(sizeof(float));  // the teams' column sums
  cudaError_t err = cudaFuncSetAttribute(rmsnorm_bwd_rows<T, V, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_rows<T, V, E><<<a.blocks, a.team * a.teams, smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale), static_cast<const T*>(a.g),
      static_cast<T*>(a.dx), static_cast<float*>(a.partial), a.rows, a.d, a.team, a.rows_per_block,
      a.eps);
  return static_cast<int>(cudaGetLastError());
}

// The units a thread holds of a row (kernels/rmsnorm.py:VECTORS): 16-byte units, or single
// elements where rows are not 16-byte aligned.
template <typename T>
int launch_rows_any(const BwdArgs& a, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int inv = static_cast<int>(cudaErrorInvalidValue);
  if (a.unit == kVec) {
    switch (a.vectors) {
      case 2: return launch_rows<T, 2, kVec>(a, st);
      case 3: return launch_rows<T, 3, kVec>(a, st);
      case 4: return launch_rows<T, 4, kVec>(a, st);
      case 5: return launch_rows<T, 5, kVec>(a, st);
      case 6: return launch_rows<T, 6, kVec>(a, st);
      case 8: return launch_rows<T, 8, kVec>(a, st);
      default: return inv;
    }
  }
  switch (a.vectors) {
    case 4: return launch_rows<T, 4, 1>(a, st);
    case 8: return launch_rows<T, 8, 1>(a, st);
    case 16: return launch_rows<T, 16, 1>(a, st);
    default: return inv;
  }
}

template <typename T>
int launch_backward(const BwdArgs& a, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int inv = static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.scale) |
                              reinterpret_cast<uintptr_t>(a.g) | reinterpret_cast<uintptr_t>(a.dx);
  // the plan (kernels/rmsnorm.py:backward_plan): whole rows of units, teams of whole groups
  // of 8 lanes, contiguous runs of rows that cover every row once
  if (a.unit != 1 && (a.unit != kVec || a.d % kVec != 0 || addr_bits % 16 != 0)) return inv;
  if (a.team <= 0 || a.team % 8 != 0 || a.teams <= 0 || a.team * a.teams > kBwdMaxThreads || static_cast<int64_t>(a.team) * a.vectors * a.unit < a.d) {
    return inv;
  }
  if (a.rows > 0 && (a.rows_per_block <= 0 || a.blocks <= 0 ||
                     static_cast<int64_t>(a.blocks) * a.rows_per_block < a.rows ||
                     static_cast<int64_t>(a.blocks - 1) * a.rows_per_block >= a.rows)) {
    return inv;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rows > 0 && a.d > 0) {
    const int err = launch_rows_any<T>(a, st);
    if (err != 0) return err;
  }
  if (a.d > 0) {
    rmsnorm_bwd_scale<T><<<(a.d + 31) / 32, 32 * kScaleWarps, 0, st>>>(
        static_cast<const float*>(a.partial), static_cast<T*>(a.dscale), a.rows > 0 ? a.blocks : 0,
        a.d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out, int rows, int d,
                           float eps, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out, int rows, int d,
                            float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}

// The backward: x, scale, g (the output's gradient) -> dx, dscale in x's dtype, with
// `partial` a float32 [blocks, d] workspace, by the plan of kernels/rmsnorm.py:backward_plan
// (the unit's elements, the units a thread holds, the threads a row, the rows a step, the
// rows a block, the blocks). Two launches on `stream`.
extern "C" int rmsnorm_backward_f32(const void* x, const void* scale, const void* g, void* dx,
                                    void* dscale, void* partial, int rows, int d, int unit,
                                    int vectors, int team, int teams, int rows_per_block,
                                    int blocks, float eps, void* stream) {
  return launch_backward<float>({x, scale, g, dx, dscale, partial, rows, d, unit, vectors, team,
                                 teams, rows_per_block, blocks, eps}, stream);
}

extern "C" int rmsnorm_backward_bf16(const void* x, const void* scale, const void* g, void* dx,
                                     void* dscale, void* partial, int rows, int d, int unit,
                                     int vectors, int team, int teams, int rows_per_block,
                                     int blocks, float eps, void* stream) {
  return launch_backward<__nv_bfloat16>({x, scale, g, dx, dscale, partial, rows, d, unit, vectors,
                                         team, teams, rows_per_block, blocks, eps}, stream);
}
