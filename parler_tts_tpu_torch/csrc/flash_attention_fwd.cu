// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel parler_tts_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _fwd).  Same function: online-softmax attention
// softmax(q.k^T * scale).v over q (BH, Tq, D) and k/v (BH, Tk, D), keys outside
// the per-row bounds [kv_start, min(kv_end, Tk)) and, when causal, keys past
// q_offset + row masked with -1e9; probabilities of masked keys are zeroed, so a
// row with no valid key gives out = 0 and lse = -1e9 + log(1e-30).  Running max,
// sum and accumulator are fp32; out is written in the input dtype, lse in fp32.
//
// What bounds it on the H100: the causal prefill does 4*D operations per
// (query, valid key) pair, about 2*D*T^2 per head, over 8*T*D bytes of bf16
// q, k, v and out, i.e. about T/4 operations per byte.  At the main path's
// T <= 257 that is far below the card's ~295 operations per byte for bf16
// tensor cores, so the least time is set by memory (and, at T = 17, by launch
// latency).  This first design does its arithmetic as fp32 FMAs on CUDA cores
// (67 TFLOP/s, a ridge near 20 operations per byte), so from T of about 80 it
// is bound by those operations and by the serial key loop of the block that
// owns the last query tile, not by memory; PERF.md holds its times.
// The design, simple and right: one block of 128 threads per (bh, 64-row
// query tile), two threads per query row each holding half of D in registers
// (interleaved dims, so the pair reads neighbouring shared-memory words), K/V
// tiles of 64 keys staged in shared memory as fp32, and the key loop running
// only over [kv_start, kv_end) cut at the block's causal limit, so padded and
// future keys are never loaded.  wgmma, TMA and a warp-specialised pipeline
// are later work.  Ragged edges (Tq, Tk not multiples of 64) are masked in
// the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kBlockQ = 64;            // query rows per block
constexpr int kBlockK = 64;            // keys per shared-memory tile
constexpr int kChunk = 16;             // keys per online-softmax update
constexpr int kThreads = 2 * kBlockQ;  // two threads per query row
constexpr float kNegInf = -1e9f;       // finite mask value, as the TPU kernel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kv_start, const int* __restrict__ kv_end,
                 T* __restrict__ out, float* __restrict__ lse, int tq, int tk, float scale,
                 int causal, int q_offset) {
  constexpr int DH = D / 2;  // dims held by each thread of a row's pair
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int row = q0 + tid / 2;
  const int half = tid & 1;
  const bool row_ok = row < tq;

  // this thread's half of the query row: dims 2*i + half (zeros past Tq)
  float qr[DH];
  const T* qrow = q + ((size_t)bh * tq + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int i = 0; i < DH; ++i) qr[i] = row_ok ? to_float(qrow[2 * i + half]) : 0.f;

  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // keys this block needs: the row bounds, cut at the causal limit of its
  // last row; the per-row causal limit is applied below
  const int start = max(kv_start[bh], 0);
  int stop = min(kv_end[bh], tk);
  if (causal) stop = min(stop, q_offset + min(q0 + kBlockQ, tq));
  const int row_limit = causal ? q_offset + row : INT_MAX;  // inclusive

  for (int k0 = start; k0 < stop; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int kp = k0 + r;
      const bool ok = kp < stop;
      const size_t off = ((size_t)bh * tk + (ok ? kp : 0)) * D + c;
      ks[r][c] = ok ? to_float(k[off]) : 0.f;
      vs[r][c] = ok ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    const int n = min(kBlockK, stop - k0);
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float s[kChunk];
      unsigned valid = 0u;
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int r = c0 + j;  // < kBlockK: kBlockK is a multiple of kChunk
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < DH; ++i) d = fmaf(qr[i], ks[r][2 * i + half], d);
        d += __shfl_xor_sync(0xffffffffu, d, 1);  // the pair's other half
        const int kp = k0 + r;
        const bool ok = row_ok && kp < stop && kp <= row_limit;
        s[j] = ok ? d * scale : kNegInf;
        valid |= (ok ? 1u : 0u) << j;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        // explicit zero for masked keys, as the TPU kernel
        s[j] = (valid >> j) & 1u ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        float a = acc[i] * corr;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) a = fmaf(s[j], vs[c0 + j][2 * i + half], a);
        acc[i] = a;
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = out + ((size_t)bh * tq + row) * D;
#pragma unroll
    for (int i = 0; i < DH; ++i) orow[2 * i + half] = from_float<T>(acc[i] / lc);
    if (half == 0) lse[(size_t)bh * tq + row] = m + logf(lc);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* kv_start,
            const void* kv_end, void* out, void* lse, int bh, int tq, int tk, float scale,
            int causal, int q_offset, cudaStream_t stream) {
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_start), static_cast<const int*>(kv_end), static_cast<T*>(out),
      static_cast<float*>(lse), tq, tk, scale, causal, q_offset);
}

}  // namespace

// q/out (bh, tq, d), k/v (bh, tk, d) contiguous, fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); kv_start/kv_end (bh,) int32; lse (bh, tq) fp32.  Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a head dim other than 32 or 64.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_start, const void* kv_end, void* out,
                                   void* lse, int bh, int tq, int tk, int d, int is_bf16,
                                   float scale, int causal, int q_offset, void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PARLER_LAUNCH(T, D) \
  launch<T, D>(q, k, v, kv_start, kv_end, out, lse, bh, tq, tk, scale, causal, q_offset, st)
  if (d == 64) {
    if (is_bf16) PARLER_LAUNCH(__nv_bfloat16, 64);
    else PARLER_LAUNCH(float, 64);
  } else if (d == 32) {
    if (is_bf16) PARLER_LAUNCH(__nv_bfloat16, 32);
    else PARLER_LAUNCH(float, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PARLER_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
