// The Mamba-2 single-step state update for Hopper (sm_90a), plain C interface
// for ctypes (K8): the decode step of Nemotron-H's state-space layers.
//
// No TPU kernel here: the Nemotron-H block family exists only in the port.
// Same function as the port's plain version (ops/ssm.py::ssm_step_plain), the
// published Mamba-2 step (mamba_ssm's selective_state_update without z): for
// each row b and head h of P channels over a state of N, with the head's group
// g = h / (H / G),
//
//   dt = softplus(dt_raw[b, h] + dt_bias[h])   (x > 20: x, as torch's)
//   dA = exp(dt * -exp(A_log[h]))
//   S[b, h, p, n] = dA * S[b, h, p, n] + (dt * x[b, h, p]) * B[b, g, n]
//   y[b, h, p] = sum_n S[b, h, p, n] * C[b, g, n] + D[h] * x[b, h, p]
//
// all in fp32; the state S is fp32 and updated in place, y is written in the
// inputs' dtype.  x, B, C and dt_raw are rows of the step's projections, read
// through their row strides (x, B and C slices of the convolution's output).
//
// What bounds it on the H100: each state element is read once and written once
// (8 bytes) for 4 fp32 operations and a share of a reduction: bound by memory.
// At Nemotron-3-Nano's 64 heads x 64 x 128 a row's state is 2 MB a layer, 268
// MB at 128 rows, against 33 KB of inputs and outputs.  So the state crosses
// HBM once each way in 16-byte loads and stores with several in flight, and
// nothing else (a copy of the state, its products) goes through device memory.
//
// ssm_step_kernel: one block of 128 threads per (b, h), holding the head's
// P x N state tile as P rows of N; lane l of a warp holds elements [N/32 * l,
// N/32 * (l + 1)) of a row (one float4 at N = 128) and its share of B and C in
// registers, and warp w walks rows [w P / 4, (w + 1) P / 4), 4 at a time: the
// four rows' loads are issued before any is used.  A row's y is its lanes'
// partial sums met by warp shuffles.  The state goes through evict-first
// loads and stores (no step reads it twice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // state rows each warp has in flight

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same_v<T, bf16>) return __bfloat162float(v);
  else return v;
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16_rn(v);
  else return v;
}

template <int K>
struct Vec;
template <>
struct Vec<4> {
  using type = float4;
  __device__ static void get(const type& v, float (&f)[4]) { f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w; }
  __device__ static type put(const float (&f)[4]) { return make_float4(f[0], f[1], f[2], f[3]); }
};
template <>
struct Vec<2> {
  using type = float2;
  __device__ static void get(const type& v, float (&f)[2]) { f[0] = v.x; f[1] = v.y; }
  __device__ static type put(const float (&f)[2]) { return make_float2(f[0], f[1]); }
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_step_kernel(float* __restrict__ state, const T* __restrict__ x, const T* __restrict__ bm,
                const T* __restrict__ cm, const T* __restrict__ dt, const T* __restrict__ dt_bias,
                const T* __restrict__ a_log, const T* __restrict__ dskip, T* __restrict__ y, int heads,
                int p_dim, int heads_per_group, long long x_b, long long bc_b, long long dt_b) {
  constexpr int kPer = N / 32;  // state elements per lane of a row
  using V = Vec<kPer>;
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads, g = h / heads_per_group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float dtv = to_f(dt[b * dt_b + h]) + to_f(dt_bias[h]);
  dtv = dtv > 20.f ? dtv : log1pf(expf(dtv));
  const float da = expf(dtv * -expf(to_f(a_log[h])));
  const float dh = to_f(dskip[h]);
  float bv[kPer], cv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    bv[i] = to_f(bm[b * bc_b + g * N + lane * kPer + i]);
    cv[i] = to_f(cm[b * bc_b + g * N + lane * kPer + i]);
  }
  const T* xr = x + b * x_b + static_cast<long long>(h) * p_dim;
  T* yr = y + (static_cast<long long>(b) * heads + h) * p_dim;
  typename V::type* s = reinterpret_cast<typename V::type*>(state + static_cast<size_t>(bh) * p_dim * N) + lane;

  const int per_warp = (p_dim + kWarps - 1) / kWarps;
  const int p_begin = warp * per_warp, p_end = min(p_begin + per_warp, p_dim);
  for (int p0 = p_begin; p0 < p_end; p0 += kRows) {
    typename V::type raw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (p0 + r < p_end) raw[r] = __ldcs(s + static_cast<size_t>(p0 + r) * 32);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = p0 + r;
      if (p >= p_end) break;
      const float xp = to_f(xr[p]);
      const float dx = dtv * xp;
      float f[kPer];
      V::get(raw[r], f);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        f[i] = da * f[i] + dx * bv[i];
        part += f[i] * cv[i];
      }
      __stcs(s + static_cast<size_t>(p) * 32, V::put(f));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) yr[p] = from_f<T>(part + dh * xp);
    }
  }
}

template <typename T, int N>
int launch(void* state, const void* x, const void* bm, const void* cm, const void* dt, const void* dt_bias,
           const void* a_log, const void* dskip, void* y, int batch, int heads, int p_dim, int groups,
           long long x_b, long long bc_b, long long dt_b, cudaStream_t stream) {
  ssm_step_kernel<T, N><<<batch * heads, kThreads, 0, stream>>>(
      static_cast<float*>(state), static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(dt), static_cast<const T*>(dt_bias), static_cast<const T*>(a_log),
      static_cast<const T*>(dskip), static_cast<T*>(y), heads, p_dim, heads / groups, x_b, bc_b, dt_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// state (batch, heads, head_dim, state_size) fp32 contiguous, 16-byte aligned,
// updated in place; x (batch, heads * head_dim), B and C (batch, groups *
// state_size) and dt (batch, heads) with unit stride inside a row and the row
// strides given (in elements); dt_bias, A_log and D (heads,); y (batch, heads *
// head_dim) contiguous; every tensor but the state fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1).  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched), cudaErrorMisalignedAddress for a
// misaligned state, or cudaErrorInvalidValue for a state size other than 64 or
// 128 or heads that do not group.
extern "C" int ssm_step(void* state, const void* x, const void* bm, const void* cm, const void* dt,
                        const void* dt_bias, const void* a_log, const void* dskip, void* y, int batch, int heads,
                        int head_dim, int state_size, int groups, int is_bf16, long long x_b, long long bc_b,
                        long long dt_b, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (groups <= 0 || heads % groups || head_dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(state) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PARLER_LAUNCH(T, N) \
  launch<T, N>(state, x, bm, cm, dt, dt_bias, a_log, dskip, y, batch, heads, head_dim, groups, x_b, bc_b, dt_b, st)
  if (state_size == 128) return is_bf16 ? PARLER_LAUNCH(bf16, 128) : PARLER_LAUNCH(float, 128);
  if (state_size == 64) return is_bf16 ? PARLER_LAUNCH(bf16, 64) : PARLER_LAUNCH(float, 64);
#undef PARLER_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
