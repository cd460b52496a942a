// Single-query attention over a KV cache for Hopper (sm_90a), plain C interface
// for ctypes: the decode step's self and cross attention.
//
// No TPU kernel here: in the JAX package the decode step's attention is XLA's
// fusion of two batched dots over the cache (parler_tts_tpu/models/decoder.py
// _self_attention_decode / _cross_attention_decode; ops/runtime_flags.py says
// why there is no Pallas kernel).  Same function as the port's plain version
// (ops/decode_attention.py::decode_attention_plain): for q (B, H, 1, D),
// pre-scaled, k/v (B, H, R, D) and a per-key mask (B, R) (nonzero = valid),
// fp32 scores q.k, masked keys set to -1e9 (finite, so a row with no valid key
// attends uniformly), an fp32 softmax, the probabilities rounded to the input
// dtype, and p.v summed in fp32 and written in the input dtype.
//
// What bounds it on the H100: each cached K/V element is read once and used in
// one multiply-add, about one operation per byte against the card's ~20 for
// fp32 FMAs: bound by memory.  So no tensor cores; what matters is that every
// byte of K and V crosses HBM once, in 16-byte loads, with enough loads in
// flight, and that nothing else (scores, copies, casts) goes through device
// memory.
//
// Grouped-query attention: K/V may hold kv_heads = H / G heads, query head h
// reading K/V head h / G (G = 1, 4 or 16, a template parameter); G = 1 is MHA.
// At G = 16 a thread keeps two keys' loads in flight instead of four (its 16
// queries' registers), and at D = 128 its block asks for shared memory above
// 48 KB (32 KB of warp sums beside its scores).
//
// decode_attn_kernel: one block of 128 threads per (b, K/V head) row and split
// of its keys [k0, k0 + n), for the G query heads that share it: each K and V
// row is read once for the group.  A key row of D elements is D * sizeof(T) /
// 16 threads, each holding the matching 16 bytes of the G queries in fp32
// registers, so a
// warp reads 4 bf16 (2 fp32) keys of D = 64 per load instruction, and each
// thread has 4 keys' loads in flight before it uses them.  Pass 0 copies the
// split's mask to shared memory; pass 1 reads K (masked keys are never read:
// their score is -1e9 whatever k holds) and keeps the n fp32 scores in shared
// memory, G rows of them (G * n <= 4096, 16 KB); the block then takes each
// query's max and sum of exp(s - max), and pass 2 reads V for every key whose
// probability e / sum, rounded to T, is not 0 for some query of the group
// (masked keys, when the row has a valid key), accumulating p.v in fp32.  The threads of a key group each hold D / 8
// or D / 4 dims; the groups' sums meet by warp shuffles and shared memory.
// With one split (B * H fills the card) the block writes out; with several,
// each split's softmax is its own (local max, sum, probabilities rounded to T)
// and it writes its fp32 p.v with (max, sum) to a scratch buffer.
//
// decode_attn_combine_kernel: one block of D threads per (b, h) row weighs the
// splits' outputs by their share of the row's softmax mass, l_s * exp(m_s - M)
// over its sum, and writes out in T.  With one split the weight is 1, so the
// two routes are one algorithm; the split route rounds each probability
// relative to its split's sum instead of the row's, within a rounding of p.

#include "sm90_mma.cuh"

#include <cstdint>
#include <type_traits>

namespace {

using sm90::bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // keys each thread has in flight
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ void to_float(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

__device__ __forceinline__ void to_float(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, bf16>) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16_rn(x);
  else return x;
}

__device__ __forceinline__ bool nonzero(const unsigned char* p, int bytes) {
  switch (bytes) {
    case 1: return *p != 0;
    case 2: return *reinterpret_cast<const uint16_t*>(p) != 0;
    case 4: return *reinterpret_cast<const uint32_t*>(p) != 0;
    default: return *reinterpret_cast<const uint64_t*>(p) != 0;
  }
}

// The block's max (is_max) or sum of x; every thread gets it.  `red` holds
// kWarps floats and is free again when this returns.
__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();
  return x;
}

struct Strides {
  long long q_b, q_h, k_b, k_h, k_r, v_b, v_h, v_r, m_b;
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const unsigned char* __restrict__ mask, T* __restrict__ out,
                   float* __restrict__ part_o, float* __restrict__ part_ml, int kv_heads, int r,
                   int chunk, int mask_bytes, Strides st) {
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int kLanes = D / kVec;         // threads per key row
  constexpr int kGroups = kThreads / kLanes;  // keys per load instruction of the block
  constexpr int kKeys = G > 4 ? 2 : kUnroll;  // keys each thread has in flight
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "a key row lies inside one warp");
  __shared__ float red[kWarps];
  __shared__ float wo[kWarps][G * D];
  extern __shared__ float s[];  // the split's G rows of scores, then exp(s - max); then its mask flags

  const int bh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = bh / kv_heads, hk = bh % kv_heads;
  const int k0 = split * chunk;
  const int n = min(chunk, r - k0);
  unsigned char* valid = reinterpret_cast<unsigned char*>(s + G * chunk);
  const int tid = threadIdx.x, g = tid / kLanes, lane = tid % kLanes;

  const unsigned char* mrow = mask + (b * st.m_b + k0) * mask_bytes;
  for (int i = tid; i < n; i += kThreads) valid[i] = nonzero(mrow + i * mask_bytes, mask_bytes);

  float qf[G][kVec];  // the group's queries: query head hk * G + j
#pragma unroll
  for (int j = 0; j < G; ++j)
    to_float(*reinterpret_cast<const uint4*>(q + b * st.q_b + (hk * G + j) * st.q_h + lane * kVec), qf[j]);
  const T* kp = k + b * st.k_b + hk * st.k_h + k0 * st.k_r + lane * kVec;
  const T* vp = v + b * st.v_b + hk * st.v_h + k0 * st.v_r + lane * kVec;
  __syncthreads();

  // pass 1: scores of the valid keys, -1e9 for the others; each K row read once for the group
  for (int i0 = 0; i0 < n; i0 += kGroups * kKeys) {
    uint4 raw[kKeys];
    bool ok[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int i = i0 + u * kGroups + g;
      ok[u] = i < n && valid[i];
      if (ok[u]) raw[u] = __ldcs(reinterpret_cast<const uint4*>(kp + i * st.k_r));
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      float kf[kVec];
      if (ok[u]) to_float(raw[u], kf);
      const int i = i0 + u * kGroups + g;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float part = 0.f;
        if (ok[u]) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) part = fmaf(qf[j][e], kf[e], part);
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0 && i < n) s[j * chunk + i] = ok[u] ? part : kNegInf;
      }
    }
  }
  __syncthreads();

  float l[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float* sj = s + j * chunk;
    float m = -INFINITY;
    for (int i = tid; i < n; i += kThreads) m = fmaxf(m, sj[i]);
    m = block_reduce(m, red, true);
    float sum = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float e = expf(sj[i] - m);
      sj[i] = e;
      sum += e;
    }
    l[j] = block_reduce(sum, red, false);  // >= 1: the max adds exp(0)
    if (splits > 1 && tid == 0) {
      const long long at = (static_cast<long long>(bh) * G + j) * splits + split;
      part_ml[2 * at] = m;
      part_ml[2 * at + 1] = l[j];
    }
  }

  // pass 2: p.v over the keys whose rounded probability is not 0 for some query of the group
  float acc[G][kVec];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
  for (int i0 = 0; i0 < n; i0 += kGroups * kKeys) {
    uint4 raw[kKeys];
    float p[kKeys][G];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int i = i0 + u * kGroups + g;
      bool any = false;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        p[u][j] = i < n ? round_to<T>(s[j * chunk + i] / l[j]) : 0.f;
        any = any || p[u][j] != 0.f;
      }
      if (any) raw[u] = __ldcs(reinterpret_cast<const uint4*>(vp + i * st.v_r));
      else raw[u] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      float vf[kVec];
      to_float(raw[u], vf);
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (p[u][j] != 0.f)
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[j][e] = fmaf(p[u][j], vf[e], acc[j][e]);
    }
  }
  // the warp's key groups, then the block's warps
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
  if ((tid & 31) < kLanes)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) wo[tid / 32][j * D + lane * kVec + e] = acc[j][e];
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    float o = wo[0][idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += wo[w][idx];
    const long long row = static_cast<long long>(bh) * G + idx / D;  // b * heads + query head
    if (splits == 1) out[row * D + idx % D] = from_float<T>(o);
    else part_o[(row * splits + split) * D + idx % D] = o;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_attn_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                           T* __restrict__ out, int splits) {
  const long long row = static_cast<long long>(blockIdx.x) * splits;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + row;
  float mx = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, ml[sp].x);
  float o = 0.f, total = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float w = ml[sp].y * expf(ml[sp].x - mx);
    total += w;
    o = fmaf(w, part_o[(row + sp) * D + threadIdx.x], o);
  }
  out[static_cast<long long>(blockIdx.x) * D + threadIdx.x] = from_float<T>(o / total);
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* part_o,
           void* part_ml, int bhk, int kv_heads, int r, int splits, int chunk, int mask_bytes,
           const Strides& st, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(G) * chunk * sizeof(float) + chunk;
  if constexpr (G * D * kWarps * sizeof(float) > 16 * 1024) {  // its scores beside 32 KB of warp sums
    constexpr int kMaxChunk = 4096 / G;
    const cudaError_t err = sm90::allow_smem<decode_attn_kernel<T, D, G>>(G * kMaxChunk * sizeof(float) + kMaxChunk);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attn_kernel<T, D, G><<<dim3(bhk, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), kv_heads, r, chunk, mask_bytes, st);
  if (splits > 1)
    decode_attn_combine_kernel<T, D><<<bhk * G, D, 0, stream>>>(
        static_cast<const float*>(part_o), static_cast<const float*>(part_ml), static_cast<T*>(out),
        splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_group(int group, const void* q, const void* k, const void* v, const void* mask, void* out,
                 void* part_o, void* part_ml, int bhk, int kv_heads, int r, int splits, int chunk,
                 int mask_bytes, const Strides& st, cudaStream_t stream) {
#define PARLER_GROUP(G)                                                                          \
  launch<T, D, G>(q, k, v, mask, out, part_o, part_ml, bhk, kv_heads, r, splits, chunk, mask_bytes, \
                  st, stream)
  switch (group) {
    case 1: return PARLER_GROUP(1);
    case 4: return PARLER_GROUP(4);
    case 16: return PARLER_GROUP(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PARLER_GROUP
}

}  // namespace

// q (b, kv_heads * group, 1, d) and k/v (b, kv_heads, r, d) with unit stride
// over d and the other strides (in elements) given, every row 16-byte
// aligned; query head h reads K/V head h / group (group 1, 4 or 16); mask (b, r)
// of 1-, 2-, 4- or 8-byte elements (row stride m_b, unit stride over r); out
// (b * kv_heads * group, d) contiguous; fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1).  The keys are cut into `splits` runs of `chunk` (the last may be
// shorter, group * chunk <= 4096); with splits > 1, part_o (b * heads *
// splits, d) and part_ml (b * heads * splits, 2) are fp32 scratch.  Launches
// on `stream` without synchronising and returns cudaGetLastError() (0 =
// launched), cudaErrorMisalignedAddress for a misaligned tensor, or
// cudaErrorInvalidValue for a head dim other than 32, 64 or 128, another
// group or a bad cut.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* mask,
                                void* out, void* part_o, void* part_ml, int b, int kv_heads,
                                int group, int r, int d, int is_bf16, int splits, int chunk,
                                int mask_bytes, long long q_b, long long q_h, long long k_b,
                                long long k_h, long long k_r, long long v_b, long long v_h,
                                long long v_r, long long m_b, void* stream) {
  if (b <= 0 || kv_heads <= 0) return 0;
  if (r <= 0 || splits <= 0 || chunk <= 0 || group <= 0 || group * chunk > 4096 ||
      (splits - 1) * chunk >= r || splits * static_cast<long long>(chunk) < r ||
      (splits > 1 && (!part_o || !part_ml)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!sm90::aligned16({q, k, v, out})) return static_cast<int>(cudaErrorMisalignedAddress);
  const Strides st{q_b, q_h, k_b, k_h, k_r, v_b, v_h, v_r, m_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bhk = b * kv_heads;
#define PARLER_LAUNCH(T, D)                                                                    \
  launch_group<T, D>(group, q, k, v, mask, out, part_o, part_ml, bhk, kv_heads, r, splits, chunk, \
                     mask_bytes, st, s)
  if (d == 64) return is_bf16 ? PARLER_LAUNCH(bf16, 64) : PARLER_LAUNCH(float, 64);
  if (d == 32) return is_bf16 ? PARLER_LAUNCH(bf16, 32) : PARLER_LAUNCH(float, 32);
  if (d == 128) return is_bf16 ? PARLER_LAUNCH(bf16, 128) : PARLER_LAUNCH(float, 128);
#undef PARLER_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
