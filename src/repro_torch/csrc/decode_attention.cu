// Decode attention for Hopper (sm_90a): one query token per sequence against
// a linear or ring KV cache, split across the KV axis (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:_decode_kernel
// (called through decode_attention). q [B, Hq, dh], caches [B, S, Hkv, dh],
// slot_pos [B, S] int32 (-1 = empty), cur_pos [B] int32. q and the caches
// share a dtype (float32 or bf16, out in that dtype), or q is float32 against
// a bf16 cache, as a float32 model's batched decode has it: then the scores
// are float32, the probabilities are rounded to bf16 before the PV product
// and the output is bf16, the steps of the plain version. A slot is valid iff
// 0 <= slot_pos <= cur_pos and, with window > 0, cur_pos - slot_pos < window.
// Masked scores take the finite sentinel -1e30, as the reference does.
//
// Bound on the H100: bytes. Each valid slot's K and V are read once for the
// G = Hq/Hkv query rows of its group, about 2*G operations per byte of cache,
// far below the card's ~295 bf16 operations per byte. So the design reads
// only what it must, and spreads the reads over enough blocks to fill the card:
//
// decode_kernel_split: one block of 128 threads per (kv head x chunk of up to
// 8 query rows of its group, batch, split); the wrapper's split_plan
// (kernels/decode_attention.py) cuts the S slots into splits of a multiple of
// 16 slots, at most one round of loads (below) each, so that the grid has at
// least ~2 blocks per SM where S allows. The block
//   1. loads its query rows into registers as float32 and reads its split's
//      slot_pos (coalesced int32), compacting the valid slots' indices into
//      shared memory (a ballot per warp), so K and V are loaded only for
//      valid slots: a linear cache's empty tail and a ring's unfilled part
//      cost nothing but their slot_pos;
//   2. issues the K and the V loads of all its valid slots at once (one
//      round: a group of dh*size/16 lanes covers one slot with 16-byte loads,
//      at bf16 dh 128 16 lanes, two slots per warp instruction, at dh 64 8
//      lanes; each lane group holds kU slots' K and V in registers), then
//      computes the scores, each dot product reduced by shuffles within the
//      lane group;
//   3. takes each row's max over the split, the probabilities relative to it
//      (rounded to bf16 for a float32 q on a bf16 cache) and their sum;
//   4. accumulates P V from the V rows already in registers, sums the lane
//      groups by shuffles and the warps in shared memory, and writes the
//      split's m, l and unnormalised acc (float32 workspace).
// So a block waits on device memory twice, for slot_pos and then for K and
// V together, whatever its split's size.
// decode_kernel_combine: one block per (batch, query head) takes M = max m_i
// and writes sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M) l_i in the output
// dtype, its threads spread over the splits and dh (16-byte loads of acc). A
// split without a valid slot wrote m = -1e30, l = 0 and weighs 0.
// A row with no valid slot at all (never on the serving path, which writes
// the current token's slot before attention) gets what the plain version
// gives there: every score is the sentinel, the softmax is uniform, and the
// output is the mean of V over all S slots, which the combine reads.
//
// Where it departs from the Pallas kernel: the max and the sum are taken per
// split and merged, not carried along the whole cache; with a float32 q on a
// bf16 cache the probabilities are rounded relative to the split's max (the
// plain version rounds the normalised ones), within the bf16 tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 512;  // slots per split (kernels/decode_attention.py:MAX_SPLIT_SLOTS)
constexpr int kMaxDh = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// The 16 bytes of `u` as float32: 8 bf16 or 4 float32 values.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(h[j]);
      f[2 * j] = x.x;
      f[2 * j + 1] = x.y;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Slots of K and V each lane group holds in registers: 8, or 4 where the
// group's query rows and accumulators already take 128 registers
// (kernels/decode_attention.py:round_slots).
__host__ __device__ constexpr int loads_in_flight(int rows, int vec) {
  return rows * vec >= 64 ? 4 : 8;
}

// TQ: q's dtype; TKV: the caches'. RMAX: query rows per block (the group, or a
// chunk of 8 of it). With TQ != TKV (float32 q, bf16 cache) the probabilities
// are rounded to TKV before the PV product.
template <typename TQ, typename TKV, int RMAX>
__global__ void __launch_bounds__(kThreads)
decode_kernel_split(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                    const TKV* __restrict__ vc, const int* __restrict__ slot_pos,
                    const int* __restrict__ cur_pos, float* __restrict__ m_part,
                    float* __restrict__ l_part, float* __restrict__ acc_part, int s, int hkv, int g,
                    int dh, float scale, int window, int nsplit, int split_slots) {
  constexpr bool kRoundP = !std::is_same<TQ, TKV>::value;
  constexpr int kVec = 16 / sizeof(TKV);
  constexpr int kU = loads_in_flight(RMAX, kVec);
  __shared__ int idx_s[kMaxSplit];              // the split's valid slots, in order
  __shared__ float p_s[RMAX][kMaxSplit];        // scores, then probabilities
  __shared__ float acc_s[kWarps][RMAX][kMaxDh];
  __shared__ float m_s[RMAX], l_s[RMAX];
  __shared__ int wcount[kWarps];

  const int nchunk = (g + RMAX - 1) / RMAX;
  const int kvh = blockIdx.x / nchunk, r0 = (blockIdx.x % nchunk) * RMAX;
  const int rows = min(RMAX, g - r0);
  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hq = hkv * g;
  // lane group grp of the warp takes the slots u * step + warp * spw + grp, u < kU;
  // lane sub of it 16 bytes of each
  const int lps = dh / kVec, spw = 32 / lps, sub = lane % lps, grp = lane / lps;
  const int step = kWarps * spw;
  const int64_t row0 = static_cast<int64_t>(b) * hq + kvh * g + r0;  // first (batch, q head) row

  // 1. the query rows (in flight while slot_pos is read), then the valid slots compacted
  float qv[RMAX][kVec];
  {
    const TQ* qb = q + row0 * dh + sub * kVec;
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) qv[r][e] = r < rows ? to_float(qb[r * dh + e]) : 0.f;
  }
  const int cur = cur_pos[b];
  const int start = split * split_slots, end = min(s, start + split_slots);
  const int* spb = slot_pos + static_cast<int64_t>(b) * s;
  int n = 0;
  for (int base = start; base < end; base += kThreads) {
    const int t = base + tid;
    bool ok = false;
    if (t < end) {
      const int sp = spb[t];
      ok = sp >= 0 && sp <= cur && (window <= 0 || cur - sp < window);
    }
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int off = n, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (ok) idx_s[off + __popc(bal & ((1u << lane) - 1u))] = t;
    n += total;
    __syncthreads();
  }

  // 2. K and V of every valid slot of the split in flight at once, then the scores
  const int64_t slot_stride = static_cast<int64_t>(hkv) * dh;
  const int64_t head_off = (static_cast<int64_t>(b) * s * hkv + kvh) * dh + sub * kVec;
  uint4 rk[kU], rv[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = u * step + warp * spw + grp;
    rk[u] = rv[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < n) {
      const int64_t at = head_off + idx_s[i] * slot_stride;
      rk[u] = __ldg(reinterpret_cast<const uint4*>(kc + at));
      rv[u] = __ldg(reinterpret_cast<const uint4*>(vc + at));
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = u * step + warp * spw + grp;
    if (u * step >= n) break;  // uniform over the block
    float kf[kVec];
    unpack<TKV>(rk[u], kf);
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= rows) break;  // uniform over the block
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) d += qv[r][e] * kf[e];
      for (int off = lps / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (sub == 0 && i < n) p_s[r][i] = d * scale;
    }
  }
  __syncthreads();

  // 3. per row: the split's max, the probabilities relative to it, their sum
  for (int r = warp; r < rows; r += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, p_s[r][i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(p_s[r][i] - mx);
      sum += p;
      p_s[r][i] = kRoundP ? __bfloat162float(__float2bfloat16(p)) : p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  __syncthreads();

  // 4. acc = P V from the V rows in registers, then lane groups and warps summed
  float acc[RMAX][kVec];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = u * step + warp * spw + grp;
    if (i >= n) continue;
    float vf[kVec];
    unpack<TKV>(rv[u], vf);
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= rows) break;
      const float p = p_s[r][i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] += p * vf[e];
    }
  }
  for (int off = lps; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (r < rows) acc_s[warp][r][sub * kVec + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = tid; i < rows * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += acc_s[w][r][d];
    acc_part[((row0 + r) * nsplit + split) * dh + d] = a;
  }
  if (tid < rows) {
    m_part[(row0 + tid) * nsplit + split] = m_s[tid];
    l_part[(row0 + tid) * nsplit + split] = l_s[tid];
  }
}

// Max or sum over the block; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// One block per (batch, q head) row: thread t takes dims 4*(t % (dh/4)) .. +3 of
// the splits t / (dh/4), + kThreads / (dh/4), ...
template <typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_kernel_combine(const float* __restrict__ m_part, const float* __restrict__ l_part,
                      const float* __restrict__ acc_part, const TKV* __restrict__ vc,
                      TKV* __restrict__ out, int s, int hq, int hkv, int dh, int nsplit) {
  __shared__ float red[kWarps];
  __shared__ float part[kThreads * 4];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* mp = m_part + static_cast<int64_t>(row) * nsplit;
  const float* lp = l_part + static_cast<int64_t>(row) * nsplit;
  TKV* o = out + static_cast<int64_t>(row) * dh;
  const int nd4 = dh / 4, groups = kThreads / nd4, d4 = tid % nd4, grp = tid / nd4;

  float mx = kNegInf;
  for (int i = tid; i < nsplit; i += kThreads) mx = fmaxf(mx, mp[i]);
  mx = block_reduce<true>(mx, red);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float scale;
  if (mx == kNegInf) {  // no valid slot anywhere: the mean of V over all S slots
    const int b = row / hq, kvh = (row % hq) / (hq / hkv);
    const TKV* vb = vc + (static_cast<int64_t>(b) * s * hkv + kvh) * dh + 4 * d4;
#pragma unroll 4
    for (int t = grp; t < s; t += groups) {
      const TKV* x = vb + static_cast<int64_t>(t) * hkv * dh;
      a.x += to_float(x[0]);
      a.y += to_float(x[1]);
      a.z += to_float(x[2]);
      a.w += to_float(x[3]);
    }
    scale = 1.f / s;
  } else {
    float lsum = 0.f;
    for (int i = tid; i < nsplit; i += kThreads) lsum += expf(mp[i] - mx) * lp[i];
    scale = 1.f / fmaxf(block_reduce<false>(lsum, red), 1e-30f);
    const float* ap = acc_part + static_cast<int64_t>(row) * nsplit * dh + 4 * d4;
#pragma unroll 4
    for (int i = grp; i < nsplit; i += groups) {
      const float w = expf(mp[i] - mx);
      const float4 x = *reinterpret_cast<const float4*>(ap + static_cast<int64_t>(i) * dh);
      a.x += w * x.x;
      a.y += w * x.y;
      a.z += w * x.z;
      a.w += w * x.w;
    }
  }
  reinterpret_cast<float4*>(part)[tid] = a;  // part[grp][4 * d4 + j]
  __syncthreads();
  for (int d = tid; d < dh; d += kThreads) {
    float v = 0.f;
    for (int g2 = 0; g2 < groups; ++g2) v += part[g2 * dh + d];
    from_float(v * scale, &o[d]);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kc, const void* vc, const void* slot_pos,
           const void* cur_pos, void* out, void* work, int b, int s, int hq, int hkv, int dh,
           float scale, int window, int nsplit, int split_slots, void* stream) {
  constexpr int kVec = 16 / sizeof(TKV);
  const int lps = dh / kVec;
  if (hkv <= 0 || hq % hkv != 0 || dh <= 0 || dh > kMaxDh || dh % kVec != 0 || lps > 32 ||
      (lps & (lps - 1)) != 0 || split_slots <= 0 || split_slots > kMaxSplit ||
      nsplit != (s + split_slots - 1) / split_slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int g = hq / hkv;
  const int rmax = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  if (split_slots > loads_in_flight(rmax, kVec) * kWarps * (32 / lps)) {  // one round a block
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b > 0 && s > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    // workspace: acc [B, Hq, nsplit, dh] first (16-byte aligned for the combine's
    // loads), then m and l [B, Hq, nsplit], float32
    float* acc_part = static_cast<float*>(work);
    float* m_part = acc_part + static_cast<int64_t>(b) * hq * nsplit * dh;
    float* l_part = m_part + static_cast<int64_t>(b) * hq * nsplit;
    const dim3 grid(hkv * ((g + rmax - 1) / rmax), b, nsplit);
    const auto kernel = rmax == 1   ? decode_kernel_split<TQ, TKV, 1>
                        : rmax == 2 ? decode_kernel_split<TQ, TKV, 2>
                        : rmax == 4 ? decode_kernel_split<TQ, TKV, 4>
                                    : decode_kernel_split<TQ, TKV, 8>;
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(kc),
                                      static_cast<const TKV*>(vc), static_cast<const int*>(slot_pos),
                                      static_cast<const int*>(cur_pos), m_part, l_part, acc_part, s,
                                      hkv, g, dh, scale, window, nsplit, split_slots);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_kernel_combine<TKV><<<b * hq, kThreads, 0, st>>>(
        m_part, l_part, acc_part, static_cast<const TKV*>(vc), static_cast<TKV*>(out), s, hq, hkv,
        dh, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry: q, k, v, slot_pos, cur_pos, out, a 16-byte-aligned float32
// workspace of b*hq*nsplit*(dh + 2) elements, then the sizes and the split plan.
extern "C" int decode_attention_f32(const void* q, const void* kc, const void* vc,
                                    const void* slot_pos, const void* cur_pos, void* out,
                                    void* work, int b, int s, int hq, int hkv, int dh, float scale,
                                    int window, int nsplit, int split_slots, void* stream) {
  return launch<float, float>(q, kc, vc, slot_pos, cur_pos, out, work, b, s, hq, hkv, dh, scale,
                              window, nsplit, split_slots, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* kc, const void* vc,
                                     const void* slot_pos, const void* cur_pos, void* out,
                                     void* work, int b, int s, int hq, int hkv, int dh,
                                     float scale, int window, int nsplit, int split_slots,
                                     void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, slot_pos, cur_pos, out, work, b, s, hq,
                                              hkv, dh, scale, window, nsplit, split_slots, stream);
}

extern "C" int decode_attention_f32q_bf16kv(const void* q, const void* kc, const void* vc,
                                            const void* slot_pos, const void* cur_pos, void* out,
                                            void* work, int b, int s, int hq, int hkv, int dh,
                                            float scale, int window, int nsplit, int split_slots,
                                            void* stream) {
  return launch<float, __nv_bfloat16>(q, kc, vc, slot_pos, cur_pos, out, work, b, s, hq, hkv, dh,
                                      scale, window, nsplit, split_slots, stream);
}
