// The DAC decoder's Snake activation for Hopper (sm_90a), plain C interface for
// ctypes (K6).
//
// No TPU kernel here: in the JAX package XLA fuses the polynomial Snake
// (parler_tts_tpu/models/dac.py snake_fast) into one pass.  Same function as
// the port's plain version (models/dac.py::snake_fast), bit for bit: for x
// (B, C, T) bf16 and per-channel fp32 constants c1 = alpha * (1 / pi) and
// c2 = 1 / (alpha + 1e-9), computed by the caller with the plain function's
// own expressions, each element runs the plain function's chain in its order
// in fp32, every operation rounded to nearest on its own (no contraction into
// FMAs, as the plain version's one kernel per operation has none):
//
//   t = x * c1;  v = (t - floor(t)) - 0.5;  w = v * v;
//   p = w * k5 + k4;  p = p * w + k3;  ...;  p = p * w + k0;
//   y = x + p * c2,  rounded to bf16 (to nearest even)
//
// with k0..k5 the fp32 values of the polynomial's coefficients (_SIN2_COEFFS).
//
// What bounds it on the H100: 2 bytes read and 2 written per element against
// about 20 fp32 operations, below the ridge: bound by memory.  So each element
// crosses HBM once each way in 16-byte loads and stores, and nothing else
// (fp32 temporaries, casts) goes through device memory.
//
// snake_kernel: the tensor as one flat run of B * C * T elements, eight
// consecutive elements (one 16-byte load) per thread.  A row (b, c) is T
// elements; a thread finds its first element's row and position once and
// steps the channel when a row ends inside its eight, so T need not be a
// multiple of 8 (the decoder's first Snake runs at T = the frame count) and no
// row is padded.  Where T is a multiple of 8 every thread's eight lie in one
// row.  The last thread takes the tail of fewer than eight elements one by
// one, and a tensor not on a 16-byte boundary is read element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;  // bf16 elements per 16-byte load
constexpr int kThreads = 256;

struct Poly {
  float k[6];  // k[i] multiplies w^i
};

__device__ __forceinline__ float snake1(float x, float c1, float c2, const Poly& poly) {
  const float t = __fmul_rn(x, c1);
  const float v = __fsub_rn(__fsub_rn(t, floorf(t)), 0.5f);
  const float w = __fmul_rn(v, v);
  float p = __fadd_rn(__fmul_rn(w, poly.k[5]), poly.k[4]);
#pragma unroll
  for (int i = 3; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, w), poly.k[i]);
  return __fadd_rn(x, __fmul_rn(p, c2));
}

// I: the index type, 32-bit where every index fits, else 64-bit (a 64-bit
// division costs several times a 32-bit one, once per thread)
template <typename I>
__global__ void __launch_bounds__(kThreads)
    snake_kernel(const bf16* __restrict__ x, const float* __restrict__ c1, const float* __restrict__ c2,
                 bf16* __restrict__ out, I n, I t, int channels, Poly poly, bool vec) {
  const I i0 = (static_cast<I>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i0 >= n) return;
  const I row = i0 / t;
  I pos = i0 - row * t;
  int c = static_cast<int>(row % static_cast<I>(channels));
  float a1 = __ldg(c1 + c), a2 = __ldg(c2 + c);
  const int m = n - i0 < static_cast<I>(kVec) ? static_cast<int>(n - i0) : kVec;
  const bool whole = vec && m == kVec;

  float xs[kVec];
  if (whole) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(pairs[j]);
      xs[2 * j] = f.x;
      xs[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) xs[j] = j < m ? __bfloat162float(x[i0 + j]) : 0.0f;
  }

  float ys[kVec];
  if (pos + kVec <= t) {  // all eight in one row
#pragma unroll
    for (int j = 0; j < kVec; ++j) ys[j] = snake1(xs[j], a1, a2, poly);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      ys[j] = snake1(xs[j], a1, a2, poly);
      if (++pos == t) {  // the next row: the next channel
        pos = 0;
        c = c + 1 == channels ? 0 : c + 1;
        a1 = __ldg(c1 + c);
        a2 = __ldg(c2 + c);
      }
    }
  }

  if (whole) {
    uint4 raw;
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) pairs[j] = __floats2bfloat162_rn(ys[2 * j], ys[2 * j + 1]);
    *reinterpret_cast<uint4*>(out + i0) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < m) out[i0 + j] = __float2bfloat16_rn(ys[j]);
  }
}

template <typename I>
int launch(const void* x, const void* c1, const void* c2, void* out, long long n, long long t, int channels,
           const Poly& poly, bool vec, cudaStream_t stream) {
  const long long blocks = (n + static_cast<long long>(kVec) * kThreads - 1) / (kVec * kThreads);
  snake_kernel<I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(c1), static_cast<const float*>(c2),
      static_cast<bf16*>(out), static_cast<I>(n), static_cast<I>(t), channels, poly, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out (rows, t) bf16 contiguous, rows = B * channels of a (B, channels,
// t) NCW tensor; c1 and c2 (channels,) fp32 contiguous; k0..k5 the fp32
// polynomial coefficients.  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = launched; nothing is launched for an empty
// tensor), or cudaErrorInvalidValue for a negative size, no channels, rows
// not a multiple of channels or more blocks than a grid holds.
extern "C" int snake_bf16(const void* x, const void* c1, const void* c2, void* out, long long rows, int channels,
                          long long t, float k0, float k1, float k2, float k3, float k4, float k5, void* stream) {
  if (rows < 0 || t < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || t == 0) return 0;
  if (channels <= 0 || rows % channels) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > LLONG_MAX / t) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * t;
  if ((n + static_cast<long long>(kVec) * kThreads - 1) / (kVec * kThreads) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Poly poly{{k0, k1, k2, k3, k4, k5}};
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the 32-bit route's first index of the last thread, plus its eight, must fit
  if (n <= static_cast<long long>(UINT32_MAX) - kVec * kThreads)
    return launch<uint32_t>(x, c1, c2, out, n, t, channels, poly, vec, s);
  return launch<unsigned long long>(x, c1, c2, out, n, t, channels, poly, vec, s);
}
