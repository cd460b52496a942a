// The port's LayerNorm and RMSNorm on bf16 activations for Hopper (sm_90a),
// plain C interface for ctypes (K9).
//
// No TPU kernel here: in the JAX package XLA fuses each norm (parler_tts_tpu/
// ops/nn.py) into one pass.  The port's plain versions (ops/nn.py layer_norm,
// rms_norm) run eagerly as a chain of 5 (LayerNorm: three casts to fp32,
// F.layer_norm, a cast back) or 9 (RMSNorm) kernels, each a launch that moves
// a few hundred KB.  This kernel computes the same function in one pass, for
// x (rows, width) bf16 and a scale (and, for LayerNorm, a bias) of width
// elements in bf16 or fp32, read in their own dtype:
//
//   LayerNorm: mean = sum(x) / width;  var = sum((x - mean)^2) / width;
//              y = (x - mean) * rsqrt(var + eps) * scale + bias
//   RMSNorm:   y = (x * rsqrt(sum(x^2) / width + eps)) * scale
//
// x is widened to fp32, all statistics and arithmetic are fp32, and y is
// rounded once to bf16 (to nearest even).  The variance takes two passes over
// the row held in registers (the mean first, then the centred squares), so a
// row with a large mean and a small spread loses nothing to cancellation.
//
// What bounds it on the H100: at the decode step's shapes (96 x 1024 to
// 192 x 2048) the row block is 0.2-0.8 MB, under a microsecond at 3.35 TB/s;
// the launch and one round trip to memory set the time.  So each row crosses
// memory once each way in 16-byte loads and stores, with nothing in between
// (no fp32 copy, no separate statistics pass), and the mapping of rows to
// threads fills the card in one wave at every width the port uses:
//
//   width / 8 <= 32 chunks of 8:  a power of two of lanes a row, one chunk
//                                 each, several rows a warp (64: 8 lanes, 4
//                                 rows a warp; LFM2's q and k norms);
//   <= 128 chunks (1024):         a warp a row, up to 4 chunks a lane;
//   <= 384 chunks (3072):         a block of 4 warps a row (2048, 2688).
//
// No instance holds more than 3 chunks a lane past a warp a row: at 4 chunks
// and 4 warps ptxas spilled the LayerNorm with fp32 weights (12 bytes).  The
// widest row is 3072, past the widest a configuration sends (Nemotron-H's
// 2688).
//
// A lane's chunks are strided by the lanes of its row, so each load of the
// row's lanes is one contiguous run.  Sums go by warp shuffles within a row's
// lanes, and through shared memory only where a block holds one row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;           // bf16 elements per 16-byte load
constexpr int kRowThreads = 128;  // threads a block where a row takes a warp or less
constexpr int kMaxChunks = 384;  // widths up to 3072

// eight bf16 values (one 16-byte load) widened to fp32
__device__ __forceinline__ void unpack8(const uint4& raw, float* v) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(pairs[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const bf16* p, float* v) { unpack8(*reinterpret_cast<const uint4*>(p), v); }

// y[0..7] rounded to bf16 (to nearest even), one 16-byte store
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void store8(bf16* p, const float* y) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]), pack2(y[6], y[7]));
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// the sum over a row's kLanes lanes (kLanes <= 32: aligned groups of one
// warp; more: whole warps, through `part` in shared memory)
template <int kLanes>
__device__ __forceinline__ float row_sum(float v, float* part) {
#pragma unroll
  for (int offset = (kLanes < 32 ? kLanes : 32) / 2; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  if constexpr (kLanes > 32) {
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
    __syncthreads();
    v = 0.0f;
#pragma unroll
    for (int w = 0; w < kLanes / 32; ++w) v += part[w];
  }
  return v;
}

// kLanes threads a row, kChunks chunks of 8 elements a thread; kCentre:
// LayerNorm (mean subtracted, bias added), else RMSNorm; W the weights' type
template <int kLanes, int kChunks, bool kCentre, typename W>
__global__ void __launch_bounds__(kLanes > 32 ? kLanes : kRowThreads)
    norm_kernel(const bf16* __restrict__ x, const W* __restrict__ scale, const W* __restrict__ bias,
                bf16* __restrict__ out, int rows, int width, float eps) {
  __shared__ float part[2][kLanes > 32 ? kLanes / 32 : 1];  // one slot a warp for each of the two sums
  const int lane = kLanes > 32 ? threadIdx.x : threadIdx.x % kLanes;
  const int row = kLanes > 32 ? blockIdx.x : blockIdx.x * (kRowThreads / kLanes) + threadIdx.x / kLanes;
  const bool live = row < rows;  // a dead lane still takes part in its warp's shuffles
  const int chunks = width / kVec;
  const size_t base = static_cast<size_t>(live ? row : 0) * width;
  const bf16* xr = x + base;

  // the row stays in registers as it was read, bf16 (half the registers of
  // fp32), and is widened again at each pass; a padding chunk is zeros
  uint4 raw[kChunks];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = j * kLanes + lane;
    raw[j] = live && c < chunks ? *reinterpret_cast<const uint4*>(xr + c * kVec) : make_uint4(0, 0, 0, 0);
    float v[kVec];
    unpack8(raw[j], v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) sum += kCentre ? v[k] : v[k] * v[k];
  }
  sum = row_sum<kLanes>(sum, part[0]);

  float mean = 0.0f, r;
  if constexpr (kCentre) {
    mean = sum / static_cast<float>(width);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j * kLanes + lane < chunks) {  // a padding chunk holds zeros, not the mean
        float v[kVec];
        unpack8(raw[j], v);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float d = v[k] - mean;
          sq += d * d;
        }
      }
    }
    r = rsqrtf(row_sum<kLanes>(sq, part[1]) / static_cast<float>(width) + eps);
  } else {
    r = rsqrtf(sum / static_cast<float>(width) + eps);
  }
  if (!live) return;

  bf16* outr = out + base;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = j * kLanes + lane;
    if (c < chunks) {
      float v[kVec], s[kVec];
      unpack8(raw[j], v);
      load8(scale + c * kVec, s);
      if constexpr (kCentre) {
        float b[kVec];
        load8(bias + c * kVec, b);
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = (v[k] - mean) * r * s[k] + b[k];
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = (v[k] * r) * s[k];
      }
      store8(outr + c * kVec, v);
    }
  }
}

template <int kLanes, int kChunks, bool kCentre, typename W>
int launch(const void* x, const void* scale, const void* bias, void* out, int rows, int width, float eps,
           cudaStream_t stream) {
  const int threads = kLanes > 32 ? kLanes : kRowThreads;
  const long long blocks = kLanes > 32 ? rows : (static_cast<long long>(rows) * kLanes + threads - 1) / threads;
  norm_kernel<kLanes, kChunks, kCentre, W><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const W*>(scale), static_cast<const W*>(bias), static_cast<bf16*>(out),
      rows, width, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCentre, typename W>
int dispatch(const void* x, const void* scale, const void* bias, void* out, int rows, int width, float eps,
             cudaStream_t s) {
  const int chunks = width / kVec;
  if (chunks <= 1) return launch<1, 1, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 2) return launch<2, 1, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 4) return launch<4, 1, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 8) return launch<8, 1, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 16) return launch<16, 1, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 32) return launch<32, 1, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 64) return launch<32, 2, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 96) return launch<32, 3, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 128) return launch<32, 4, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  if (chunks <= 256) return launch<128, 2, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
  return launch<128, 3, kCentre, W>(x, scale, bias, out, rows, width, eps, s);
}

}  // namespace

// x and out (rows, width) bf16 contiguous; scale (width,) and bias (width,)
// contiguous in the weights' dtype (weights_bf16: 1 bf16, 0 fp32); bias null:
// RMSNorm, else LayerNorm.  Every pointer on a 16-byte boundary.  Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 =
// launched; nothing is launched for no rows), or cudaErrorInvalidValue for a
// width that is not a positive multiple of 8 up to 3072, negative or more
// than INT_MAX rows, or a pointer off its boundary.
extern "C" int norm_bf16(const void* x, const void* scale, const void* bias, void* out, long long rows, int width,
                         int weights_bf16, float eps, void* stream) {
  if (rows < 0 || rows > INT_MAX || width <= 0 || width % kVec || width / kVec > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : std::initializer_list<const void*>{x, scale, bias, out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int n = static_cast<int>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias == nullptr)
    return weights_bf16 ? dispatch<false, bf16>(x, scale, bias, out, n, width, eps, s)
                        : dispatch<false, float>(x, scale, bias, out, n, width, eps, s);
  return weights_bf16 ? dispatch<true, bf16>(x, scale, bias, out, n, width, eps, s)
                      : dispatch<true, float>(x, scale, bias, out, n, width, eps, s);
}
