// Decode attention for Hopper (sm_90a): one query token per sequence against
// a linear or ring KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention
// (_decode_kernel). q [B, Hq, dh], caches [B, S, Hkv, dh], slot_pos [B, S]
// int32 (-1 = empty), cur_pos [B] int32. q and the caches share a dtype
// (float32 or bf16, out in that dtype), or q is float32 against a bf16 cache,
// as a float32 model's batched decode has it: then the scores are float32,
// the probabilities are rounded to bf16 before the PV product and the output
// is bf16, the steps of the plain version. A slot is valid iff
// 0 <= slot_pos <= cur_pos and, with window > 0, cur_pos - slot_pos < window.
// Masked scores take the finite sentinel -1e30, as the reference does.
//
// Bound on the H100: bytes. Every valid or not slot of K and V is read once
// for G = Hq/Hkv query rows, about 2*G operations per byte of cache, far
// below the card's ~295 bf16 operations per byte.
//
// Design: one block per (kv_head, batch). The G query rows of the GQA group
// sit in shared memory, so each K/V tile is read from device memory once for
// the whole group. The block walks the cache in tiles of 32 slots staged in
// shared memory as float32, with an online softmax (running max m, sum l and
// accumulator in float32): one thread per (row, slot) score, one warp per
// row for the max and the sum (32 slots = 32 lanes), and each thread keeps
// up to 16 of the G*dh accumulator entries in registers. Out-of-range slots
// of the last tile contribute nothing. B*Hkv blocks underfill the card at
// small batch; splitting the KV axis is left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // slots per tile: one lane per slot in the softmax
constexpr int kMaxG = 16;
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kMaxG * kMaxDh / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// TQ: q's dtype; TKV: the caches' and the output's. With TQ != TKV (float32
// q, bf16 cache) the probabilities are rounded to TKV before the PV product.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc, const TKV* __restrict__ vc,
              const int* __restrict__ slot_pos, const int* __restrict__ cur_pos,
              TKV* __restrict__ out, int s, int hkv, int g, int dh, float scale, int window) {
  constexpr bool kRoundP = !std::is_same<TQ, TKV>::value;
  __shared__ float qs[kMaxG][kMaxDh];
  __shared__ float ks[kTile][kMaxDh + 1];  // +1: lanes read different rows, spread banks
  __shared__ float vs[kTile][kMaxDh];
  __shared__ float ps[kMaxG][kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ int flag_s[kTile];  // 1 valid, 0 masked, -1 past the end of the cache

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hq = hkv * g;
  const int cur = cur_pos[b];
  const int64_t slot_stride = static_cast<int64_t>(hkv) * dh;
  const TQ* qb = q + (static_cast<int64_t>(b) * hq + static_cast<int64_t>(h) * g) * dh;
  const TKV* kb = kc + static_cast<int64_t>(b) * s * slot_stride + static_cast<int64_t>(h) * dh;
  const TKV* vb = vc + static_cast<int64_t>(b) * s * slot_stride + static_cast<int64_t>(h) * dh;
  const int* spb = slot_pos + static_cast<int64_t>(b) * s;

  for (int i = tid; i < g * dh; i += kThreads) qs[i / dh][i % dh] = to_float(qb[i]);
  for (int r = tid; r < g; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < s; t0 += kTile) {
    for (int i = tid; i < kTile * dh; i += kThreads) {
      const int t = i / dh, d = i % dh;
      float kv = 0.f, vv = 0.f;
      if (t0 + t < s) {
        kv = to_float(kb[(t0 + t) * slot_stride + d]);
        vv = to_float(vb[(t0 + t) * slot_stride + d]);
      }
      ks[t][d] = kv;
      vs[t][d] = vv;
    }
    if (tid < kTile) {
      int flag = -1;
      if (t0 + tid < s) {
        const int sp = spb[t0 + tid];
        bool ok = sp >= 0 && sp <= cur;
        if (window > 0) ok = ok && (cur - sp < window);
        flag = ok ? 1 : 0;
      }
      flag_s[tid] = flag;
    }
    __syncthreads();

    for (int i = tid; i < g * kTile; i += kThreads) {
      const int r = i / kTile, t = i % kTile;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot += qs[r][d] * ks[t][d];
      ps[r][t] = flag_s[t] == 1 ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < g; r += kThreads / 32) {
      const float sc = ps[r][lane];
      const bool in_cache = flag_s[lane] >= 0;
      float mx = sc;
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = in_cache ? expf(sc - m_new) : 0.f;
      float sum = p;
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (kRoundP) {
        TKV pr;
        from_float(p, &pr);
        ps[r][lane] = to_float(pr);
      } else {
        ps[r][lane] = p;
      }
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int i = tid + j * kThreads;
      if (i < g * dh) {
        const int r = i / dh, d = i % dh;
        float pv = 0.f;
        for (int t = 0; t < kTile; ++t) pv += ps[r][t] * vs[t][d];
        acc[j] = acc[j] * corr_s[r] + pv;
      }
    }
    __syncthreads();
  }

  TKV* ob = out + (static_cast<int64_t>(b) * hq + static_cast<int64_t>(h) * g) * dh;
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i < g * dh) from_float(acc[j] / fmaxf(l_s[i / dh], 1e-30f), &ob[i]);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kc, const void* vc, const void* slot_pos,
           const void* cur_pos, void* out, int b, int s, int hq, int hkv, int dh, float scale,
           int window, void* stream) {
  const int g = hq / hkv;
  if (hkv <= 0 || hq % hkv != 0 || g > kMaxG || dh > kMaxDh || dh <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b > 0 && s > 0) {
    dim3 grid(hkv, b);
    decode_kernel<TQ, TKV><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(kc), static_cast<const TKV*>(vc),
        static_cast<const int*>(slot_pos), static_cast<const int*>(cur_pos),
        static_cast<TKV*>(out), s, hkv, g, dh, scale, window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* kc, const void* vc,
                                    const void* slot_pos, const void* cur_pos, void* out, int b,
                                    int s, int hq, int hkv, int dh, float scale, int window,
                                    void* stream) {
  return launch<float, float>(q, kc, vc, slot_pos, cur_pos, out, b, s, hq, hkv, dh, scale,
                              window, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* kc, const void* vc,
                                     const void* slot_pos, const void* cur_pos, void* out, int b,
                                     int s, int hq, int hkv, int dh, float scale, int window,
                                     void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, slot_pos, cur_pos, out, b, s, hq, hkv,
                                              dh, scale, window, stream);
}

extern "C" int decode_attention_f32q_bf16kv(const void* q, const void* kc, const void* vc,
                                            const void* slot_pos, const void* cur_pos, void* out,
                                            int b, int s, int hq, int hkv, int dh, float scale,
                                            int window, void* stream) {
  return launch<float, __nv_bfloat16>(q, kc, vc, slot_pos, cur_pos, out, b, s, hq, hkv, dh,
                                      scale, window, stream);
}
