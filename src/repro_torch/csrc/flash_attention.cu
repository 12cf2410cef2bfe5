// Flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel): GQA attention with an online softmax in float32, a causal
// mask, a sliding window, padded KV columns masked through sk_valid, and
// fully masked KV tiles skipped. q [B, Sq, Hq, dh], k/v [B, Sk, Hkv, dh],
// out [B, Sq, Hq, dh] in q's dtype. Unlike the TPU kernel, `window` is a
// runtime argument (<= 0 means full attention), as the model's per-layer
// windows need. Masked scores take the finite sentinel -1e30.
//
// Bound on the H100: operations at long prompts. Causal prefill does
// ~2*Sq*Sk*dh*Hq flops over ~(Sq*Hq + 2*Sk*Hkv)*dh elements, thousands of
// operations per byte at Sq = Sk = 1024, above the card's ~295 bf16
// operations per byte.
//
// Design (simple, on the CUDA cores; tensor cores through wgmma are left
// for a later change): one block of 128 threads per (q tile, kv_head,
// batch). The block's 64 rows are the G query heads of the GQA group times
// 64/G query positions, so each K/V tile is read from device memory once for
// the whole group. Q is staged in shared memory once as float32; K and V
// tiles of 32 positions stream through shared memory. Each thread owns a
// 4x4 micro-tile of the 64x32 score tile and a 4x16 micro-tile of the 64xdh
// accumulator; the 8 threads that share a row reduce its max and sum with
// warp shuffles. Rows past Sq compute on zeros and are never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr float kNegInf = -1e30f;

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
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = hq / hkv;
  const int qt = kRows / g;
  if (b > 0 && sq > 0 && sk > 0) {
    dim3 grid((sq + qt - 1) / qt, hkv, b);
    flash_kernel<T><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), sq, sk, hkv, g, dh, scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int b, int sq, int sk, int hq, int hkv, int dh, float scale,
                                   int causal, int window, void* stream) {
  return launch<float>(q, k, v, out, b, sq, sk, hq, hkv, dh, scale, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int b, int sq, int sk, int hq, int hkv, int dh, float scale,
                                    int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, hq, hkv, dh, scale, causal, window,
                               stream);
}
