// The DAC decoder's stride-1 convolutions for Hopper (sm_90a), bf16 on the
// tensor cores, plain C interface for ctypes (K7).
//
// No TPU kernel here: the JAX package leaves these convolutions to XLA
// (parler_tts_tpu/models/dac.py, lax.conv_general_dilated).  Same function as
// the port's plain version (ops/dac_conv.py::dac_conv): for x (B, C_in, T) and
// an optional residual r (B, C_out, T), bf16 and contiguous, the weight
// relaid by the caller as w (taps, C_out, C_in) bf16 and the bias fp32,
//
//   y[b, co, t] = bias[co] + sum_ci sum_j w[j, co, ci] * x[b, ci, t + (j - (taps - 1) / 2) * d]
//                 (+ r[b, co, t]),  x zero outside 0 <= t < T,
//
// summed in fp32 (mma.sync m16n8k16, bf16 x bf16 -> fp32), the bias and the
// residual added in fp32 and the sum rounded to bf16 once (to nearest even).
// taps is 1 or 7 ("same" padding, stride 1); C_in and C_out are multiples of 32.
//
// What bounds it on the H100: the decoder's k7 convolutions do 2 * 7 * C_in
// operations per output element against about 4 bytes (bound by operations);
// the k1 convolutions with their residual 2 * C_in against 6 bytes (bound by
// bytes, or nearly balanced at 768 channels).  A block owns BM = 32 * MI
// output channels x BN time steps of one row, and walks its share of the
// tiles (the grid's blocks take the tiles in turn), so that the loads of its
// next tile overlap the products of the current one.  The reduction walks
// C_in in chunks of 32 channels; cp.async brings each chunk's weights
// (taps x BM rows of 32 channels) and its x, channel-major, into shared memory.
// On the card the chunk loads and their barriers, not the products, bound
// the 7-tap kernel (PERF.md §7).
//
// - 7 taps (dac_conv7_kernel, 8 warps, BN 256, one block an SM): each chunk's
//   x window (256 steps and the 3d-step halo on each side) is transposed once
//   in shared memory (ldmatrix .trans, then stmatrix) into a time-major tile,
//   a row per step holding the chunk's 32 channels; the 7 taps read that one
//   tile at rows shifted by j * d, so a shift is only a row address (rows are
//   16 bytes wide, so ldmatrix takes any shift).  Two stages of weights and x.
// - 1 tap (dac_conv1_kernel, 8 warps, BN 256, one block an SM): no shift, so
//   ldmatrix .trans reads the channel-major x directly; a ring of kStages1
//   chunks keeps loads in flight (these convolutions are bound by bytes).
// - Epilogue: a quad of lanes exchanges its accumulators (4 x 4 transpose by
//   shuffles) so that each lane holds 8 consecutive time steps of one channel:
//   fp32 bias, the residual read 16 bytes at a time, one rounding, 16-byte
//   NCW stores.  Where T is not a multiple of 8 (the decoder's first
//   convolution runs at T = the frame count) loads and stores go 4 bytes at a
//   time, or element by element where T is odd or a tensor is off a 4-byte
//   boundary.

#include "sm90_mma.cuh"

#include <climits>
#include <cstdint>

namespace {

using sm90::bf16;
using sm90::cp_async_16;
using sm90::cp_async_4;
using sm90::ldsm_x4;
using sm90::ldsm_x4_trans;
using sm90::mma_16816;
using sm90::smem_addr;

constexpr int kBK = 32;        // input channels per chunk
constexpr int kRow = kBK + 8;  // time-major row: 32 channels and 16 bytes of padding
constexpr int kStages1 = 4;    // 1 tap: the cp.async ring
constexpr int kSmemMax = 232448;  // what a block can use on the H100

// how x, r and y are read and written: 16 bytes (T % 8 == 0, 16-byte
// boundaries), 4 bytes (T even, 4-byte boundaries) or one element at a time
enum Mode { kElem = 0, kPair = 1, kVec = 2 };

struct Params {
  const bf16* x;      // (B, C_in, T)
  const bf16* w;      // (taps, C_out, C_in)
  const float* bias;  // (C_out)
  const bf16* r;      // (B, C_out, T) or null
  bf16* y;            // (B, C_out, T)
  int c_in, c_out, t, dilation;
  int m_tiles, n_tiles;
  int tiles;    // B * m_tiles * n_tiles
  int window;   // 7 taps: staged steps of x per chunk, a multiple of 8
  int raw_row;  // 7 taps: the channel-major stage's row, window + 8 or + 16 (an odd number of 16 bytes)
  int off0;     // 7 taps: row of the window that tap 0 reads for a tile's first step
  int mode;
};

template <int MI, int BN>
struct TilePos {
  int b, m0, n0;
  __device__ TilePos(int tile, const Params& p) {
    m0 = tile % p.m_tiles * 32 * MI;
    const int rest = tile / p.m_tiles;
    n0 = rest % p.n_tiles * BN;
    b = rest / p.n_tiles;
  }
};

// A block's walk: steps over (tile, chunk), chunk fastest; the block takes
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...
struct Walk {
  int tile, chunk;
  __device__ void advance(int chunks) {
    if (++chunk == chunks) {
      chunk = 0;
      tile += gridDim.x;
    }
  }
};

__device__ __forceinline__ void stsm_x4(bf16* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_addr(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]));
}

// the weights of one chunk: taps x BM rows of 32 channels into [taps][BM][kRow]
template <int TAPS, int MI, int NT>
__device__ __forceinline__ void load_weights(bf16* dst, const Params& p, int m0, int chunk, int tid) {
  constexpr int BM = 32 * MI;
  constexpr int kCopies = TAPS * BM * (kBK / 8);
#pragma unroll
  for (int i = 0; i < (kCopies + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (kCopies % NT == 0 || e < kCopies) {
      const int row = e / (kBK / 8);  // j * BM + co
      const int q = e % (kBK / 8);
      const int co = m0 + row % BM;
      const bool ok = co < p.c_out;
      const bf16* src = p.w + ((size_t)(row / BM) * p.c_out + (ok ? co : 0)) * p.c_in + chunk * kBK + q * 8;
      cp_async_16(dst + row * kRow + q * 8, src, ok);
    }
  }
}

// x[b, chunk's 32 channels, t0 .. t0 + steps) channel-major into dst (row
// `row` elements), zero outside [0, T): cp.async of G = 8 or 2 elements, or
// element by element (G = 1, then synchronous)
template <int NT, int G>
__device__ __forceinline__ void load_x_by(bf16* dst, int row, const Params& p, int b, int chunk, int t0, int steps,
                                          int tid) {
  const bf16* base = p.x + ((size_t)b * p.c_in + chunk * kBK) * p.t;
  const int per_row = steps / G;
  for (int e = tid; e < kBK * per_row; e += NT) {
    const int ci = e / per_row;
    const int t = t0 + (e % per_row) * G;
    const bool ok = t >= 0 && t + G <= p.t;  // T a multiple of G: all of a copy or none
    const bf16* src = base + (size_t)ci * p.t + (ok ? t : 0);
    bf16* to = dst + ci * row + (t - t0);
    if constexpr (G == 8) {
      cp_async_16(to, src, ok);
    } else if constexpr (G == 2) {
      cp_async_4(to, src, ok);
    } else {
      *to = ok ? *src : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int NT>
__device__ __forceinline__ void load_x(bf16* dst, int row, const Params& p, int b, int chunk, int t0, int steps,
                                       int tid) {
  if (p.mode == kVec) {
    load_x_by<NT, 8>(dst, row, p, b, chunk, t0, steps, tid);
  } else if (p.mode == kPair) {
    load_x_by<NT, 2>(dst, row, p, b, chunk, t0, steps, tid);
  } else {
    load_x_by<NT, 1>(dst, row, p, b, chunk, t0, steps, tid);
  }
}

// ---- the epilogue ----

// lane l of a quad holds in v[j] its two steps of 8-step block j; afterwards
// v[j] holds the steps 2j, 2j + 1 of block l % 4
__device__ __forceinline__ void quad_transpose(float2 (&v)[4], int lane) {
  const bool odd = lane & 1;
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    const float2 send = odd ? v[j] : v[j + 1];
    float2 recv;
    recv.x = __shfl_xor_sync(0xffffffffu, send.x, 1);
    recv.y = __shfl_xor_sync(0xffffffffu, send.y, 1);
    if (odd) v[j] = recv; else v[j + 1] = recv;
  }
  const bool hi = lane & 2;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 send = hi ? v[j] : v[j + 2];
    float2 recv;
    recv.x = __shfl_xor_sync(0xffffffffu, send.x, 2);
    recv.y = __shfl_xor_sync(0xffffffffu, send.y, 2);
    if (hi) v[j] = recv; else v[j + 2] = recv;
  }
}

// acc[mi][nj]: the warp's 16 x 8 blocks, rows 16 mi.. of its channels, steps 8 nj.. of its 64
template <int MI, int BN>
__device__ __forceinline__ void epilogue(float (&acc)[MI][8][4], const Params& p, const TilePos<MI, BN>& tp, int wm,
                                         int wn, int lane) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = tp.m0 + wm * 16 * MI + 16 * mi + lane / 4 + 8 * h;
      const bool row_ok = co < p.c_out;
      const float bias = row_ok ? __ldg(p.bias + co) : 0.0f;
#pragma unroll
      for (int ng = 0; ng < 2; ++ng) {
        float2 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = make_float2(acc[mi][4 * ng + j][2 * h], acc[mi][4 * ng + j][2 * h + 1]);
        quad_transpose(v, lane);  // all lanes, before any lane leaves
        const int t0 = tp.n0 + wn * 64 + 32 * ng + 8 * (lane % 4);
        if (!row_ok || t0 >= p.t) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = make_float2(v[j].x + bias, v[j].y + bias);
        const size_t at = ((size_t)tp.b * p.c_out + co) * p.t + t0;
        if (p.mode == kVec) {  // t0 + 8 <= T
          if (p.r) {
            const uint4 raw = *reinterpret_cast<const uint4*>(p.r + at);
            const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 rr = __bfloat1622float2(pairs[j]);
              v[j] = make_float2(v[j].x + rr.x, v[j].y + rr.y);
            }
          }
          uint4 out;
          __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int j = 0; j < 4; ++j) pairs[j] = __floats2bfloat162_rn(v[j].x, v[j].y);
          *reinterpret_cast<uint4*>(p.y + at) = out;
        } else if (p.mode == kPair) {  // T even: a pair is all in or all out
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (t0 + 2 * j < p.t) {
              float2 f = v[j];
              if (p.r) {
                const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.r + at + 2 * j));
                f = make_float2(f.x + rr.x, f.y + rr.y);
              }
              *reinterpret_cast<__nv_bfloat162*>(p.y + at + 2 * j) = __floats2bfloat162_rn(f.x, f.y);
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (t0 + e < p.t) {
              const float f = (e % 2 ? v[e / 2].y : v[e / 2].x) + (p.r ? __bfloat162float(p.r[at + e]) : 0.0f);
              p.y[at + e] = __float2bfloat16_rn(f);
            }
          }
        }
      }
    }
  }
}

template <int MI>
__device__ __forceinline__ void zero(float (&acc)[MI][8][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
}

// ---- the kernels ----

constexpr int kThreads7 = 256, kBN7 = 256;  // 8 warps: 2 along the channels x 4 along time

template <int MI>
__global__ void __launch_bounds__(kThreads7, 1) dac_conv7_kernel(Params p) {
  constexpr int TAPS = 7, NT = kThreads7, BN = kBN7;
  constexpr int BM = 32 * MI;
  constexpr int kA = TAPS * BM * kRow;  // elements of one stage's weights
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int kX = kBK * p.raw_row;  // elements of one stage's channel-major x
  bf16* tile_x = smem + 2 * (kA + kX);  // the time-major x of the chunk being multiplied
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int chunks = p.c_in / kBK;
  if (static_cast<int>(blockIdx.x) >= p.tiles) return;
  const int steps = ((p.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * chunks;

  auto load = [&](Walk w, int st) {
    const TilePos<MI, BN> tp(w.tile, p);
    bf16* as = smem + st * (kA + kX);
    load_weights<TAPS, MI, NT>(as, p, tp.m0, w.chunk, tid);
    // the window of tile n0 starts at the 8-aligned step at or below n0 - 3d
    load_x<NT>(as + kA, p.raw_row, p, tp.b, w.chunk, tp.n0 - 3 * p.dilation - p.off0, p.window, tid);
  };
  // channel-major stage st -> tile_x, an 8-step x 32-channel block a warp at a time
  auto transpose = [&](int st) {
    const bf16* xs = smem + st * (kA + kX) + kA + (8 * (lane / 8) + lane % 8) * p.raw_row;
    for (int k = warp; k < p.window / 8; k += NT / 32) {
      uint32_t f[4];
      ldsm_x4_trans(f, xs + 8 * k);
      stsm_x4(tile_x + (8 * k + lane % 8) * kRow + 8 * (lane / 8), f);
    }
  };

  float acc[MI][8][4];
  zero(acc);
  Walk cur{static_cast<int>(blockIdx.x), 0};
  Walk ahead = cur;  // the next step to load
  load(ahead, 0);
  sm90::cp_async_commit();
  ahead.advance(chunks);
  if (steps > 1) load(ahead, 1);
  sm90::cp_async_commit();
  ahead.advance(chunks);
  sm90::cp_async_wait<1>();
  __syncthreads();
  transpose(0);
  __syncthreads();

  const int a_lane = (wm * 16 * MI + lane % 16) * kRow + (lane / 16) * 8;
  const int b_lane = (p.off0 + wn * 64 + lane % 8 + (lane / 16) * 8) * kRow + ((lane / 8) % 2) * 8;
  const int tap_rows = p.dilation * kRow;
  for (int s = 0; s < steps; ++s) {
    const bf16* as = smem + (s & 1) * (kA + kX) + a_lane;
    const bf16* xs = tile_x + b_lane;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) ldsm_x4(a[mi], as + (j * BM + 16 * mi) * kRow + 16 * kk);
#pragma unroll
        for (int nj = 0; nj < 8; nj += 2) {
          uint32_t b[4];
          ldsm_x4(b, xs + j * tap_rows + 8 * nj * kRow + 16 * kk);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_16816(acc[mi][nj], a[mi], b[0], b[1]);
            mma_16816(acc[mi][nj + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    if (cur.chunk == chunks - 1) {
      epilogue<MI, BN>(acc, p, TilePos<MI, BN>(cur.tile, p), wm, wn, lane);
      zero(acc);
    }
    sm90::cp_async_wait<0>();
    __syncthreads();  // every warp is done with step s; step s + 1 has landed
    if (s + 1 < steps) transpose((s + 1) & 1);
    if (s + 2 < steps) load(ahead, s & 1);
    sm90::cp_async_commit();
    ahead.advance(chunks);
    __syncthreads();  // step s + 1's time-major x is in place
    cur.advance(chunks);
  }
}

constexpr int kThreads1 = 256, kBN1 = 256;  // 8 warps: 2 along the channels x 4 along time
constexpr int kRawRow1 = kBN1 + 8;          // 1 tap: a channel's 256 steps and 16 bytes of padding

template <int MI>
__global__ void __launch_bounds__(kThreads1, 1) dac_conv1_kernel(Params p) {
  constexpr int NT = kThreads1, BN = kBN1;
  constexpr int BM = 32 * MI;
  constexpr int kA = BM * kRow;
  constexpr int kStage = kA + kBK * kRawRow1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int chunks = p.c_in / kBK;
  if (static_cast<int>(blockIdx.x) >= p.tiles) return;
  const int steps = ((p.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * chunks;
  const int a_lane = (wm * 16 * MI + lane % 16) * kRow + (lane / 16) * 8;
  const int b_lane = (lane % 8 + ((lane / 8) % 2) * 8) * kRawRow1 + wn * 64 + (lane / 16) * 8;

  auto load = [&](Walk w, int st) {
    const TilePos<MI, BN> tp(w.tile, p);
    bf16* as = smem + st * kStage;
    load_weights<1, MI, NT>(as, p, tp.m0, w.chunk, tid);
    load_x<NT>(as + kA, kRawRow1, p, tp.b, w.chunk, tp.n0, BN, tid);
  };

  float acc[MI][8][4];
  zero(acc);
  Walk cur{static_cast<int>(blockIdx.x), 0};
  Walk ahead = cur;  // the next step to load
#pragma unroll
  for (int i = 0; i < kStages1 - 1; ++i) {
    if (i < steps) load(ahead, i);
    sm90::cp_async_commit();
    ahead.advance(chunks);
  }
  for (int s = 0; s < steps; ++s) {
    sm90::cp_async_wait<kStages1 - 2>();
    __syncthreads();  // step s has landed; every warp is done with step s - 1's stage
    if (s + kStages1 - 1 < steps) load(ahead, (s + kStages1 - 1) % kStages1);
    sm90::cp_async_commit();
    ahead.advance(chunks);
    const bf16* as = smem + s % kStages1 * kStage + a_lane;
    const bf16* xs = smem + s % kStages1 * kStage + kA + b_lane;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldsm_x4(a[mi], as + 16 * mi * kRow + 16 * kk);
#pragma unroll
      for (int nj = 0; nj < 8; nj += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, xs + 16 * kk * kRawRow1 + 8 * nj);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_16816(acc[mi][nj], a[mi], b[0], b[1]);
          mma_16816(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (cur.chunk == chunks - 1) {
      epilogue<MI, BN>(acc, p, TilePos<MI, BN>(cur.tile, p), wm, wn, lane);
      zero(acc);
    }
    cur.advance(chunks);
  }
  sm90::cp_async_wait<0>();
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

template <auto Kernel>
int launch(const Params& p, int threads, int smem, cudaStream_t stream) {
  // set once per device, to the most any call can ask for
  cudaError_t err = sm90::allow_smem<Kernel>(kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = p.tiles < sms ? p.tiles : sms;  // one block an SM
  Kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned4(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 4) return false;
  return true;
}

}  // namespace

// x (batch, c_in, t), r and y (batch, c_out, t) bf16 contiguous (r may be
// null), w (taps, c_out, c_in) bf16 contiguous, bias (c_out) fp32.  taps 1 or
// 7 with "same" padding (3 * dilation for 7).  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched; nothing is
// launched for an empty tensor), or cudaErrorInvalidValue for taps other than
// 1 or 7, w off a 16-byte boundary, channel counts that are not positive
// multiples of 32, a negative size, a dilation below 1, T past 2**30, more
// than 2**31 tiles and chunks, or (7 taps) a dilation whose window does not
// fit the block's shared memory (up to 24 where C_out % 128 == 0, else 56).
extern "C" int dac_conv_bf16(const void* x, const void* w, const void* bias, const void* r, void* y, int batch,
                             int c_in, int c_out, long long t, int taps, int dilation, void* stream) {
  if (batch < 0 || t < 0 || dilation < 1 || t > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  if ((taps != 1 && taps != 7) || c_in <= 0 || c_out <= 0 || c_in % kBK || c_out % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!sm90::aligned16({w})) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || t == 0) return 0;
  const int mi = c_out % 128 == 0 ? 4 : 3;
  const int bm = 32 * mi;
  const int bn = taps == 1 ? kBN1 : kBN7;
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.r = static_cast<const bf16*>(r);
  p.y = static_cast<bf16*>(y);
  p.c_in = c_in;
  p.c_out = c_out;
  p.t = static_cast<int>(t);
  p.dilation = dilation;
  p.m_tiles = (c_out + bm - 1) / bm;
  p.n_tiles = static_cast<int>((t + bn - 1) / bn);
  const long long tiles = static_cast<long long>(batch) * p.m_tiles * p.n_tiles;
  if (tiles * (c_in / kBK) > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.mode = t % 8 == 0 && sm90::aligned16({x, r, y}) ? kVec : t % 2 == 0 && aligned4({x, r, y}) ? kPair : kElem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps == 1) {
    const int smem = kStages1 * (bm * kRow + kBK * kRawRow1) * static_cast<int>(sizeof(bf16));
    return mi == 4 ? launch<dac_conv1_kernel<4>>(p, kThreads1, smem, s)
                   : launch<dac_conv1_kernel<3>>(p, kThreads1, smem, s);
  }
  // tap 0 of a tile's first step reads step n0 - 3d; the window starts at the
  // 8-aligned step at or below it, off0 steps earlier (n0 is a multiple of 8)
  const long long halo = 3LL * dilation;
  p.off0 = static_cast<int>(halo % 8 == 0 ? 0 : 8 - halo % 8);
  const long long window = (p.off0 + 2 * halo + kBN7 + 7) / 8 * 8;
  const long long raw_row = window + (window / 8 % 2 ? 16 : 8);
  const long long smem =
      (2 * (7LL * bm * kRow + kBK * raw_row) + window * kRow) * static_cast<long long>(sizeof(bf16));
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  p.window = static_cast<int>(window);
  p.raw_row = static_cast<int>(raw_row);
  return mi == 4 ? launch<dac_conv7_kernel<4>>(p, kThreads7, static_cast<int>(smem), s)
                 : launch<dac_conv7_kernel<3>>(p, kThreads7, static_cast<int>(smem), s);
}
