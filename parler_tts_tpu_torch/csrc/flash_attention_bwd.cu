// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three backward TPU kernels of
// parler_tts_tpu/ops/pallas/flash_attention.py:
//   K2 _dq_kernel          -> flash_attention_dq   (dq, query-major)
//   K3 _dkv_kernel         -> flash_attention_dkv  (dk and dv, key-major)
//   K4 _dqkv_single_kernel -> flash_attention_dqkv (dq, dk and dv in one pass)
// They compute what the TPU kernels compute, from q, k, v, do (BH, T, D) in
// the input dtype and the forward's lse plus delta = rowsum(do * out), both
// (BH, Tq) fp32: on every valid (query, key) pair -- key inside the row bounds
// [kv_start, min(kv_end, Tk)), not after q_offset + row when causal, query row
// < Tq -- p = exp(q.k * scale - lse), dp = do.v, ds = p * (dp - delta) * scale;
// dq = sum_k ds * k, dk = sum_q ds * q, dv = sum_q p * do.  p is zeroed
// explicitly elsewhere, so a fully masked query row (a left-padded prompt row,
// lse = -1e9 - 69) contributes nothing and never produces NaN, and rows past
// Tq or keys past Tk are read as 0.  Sums are fp32; dq, dk, dv are written in
// the input dtype.
//
// What bounds it on the H100: per valid pair the backward does 6*D (K2),
// 8*D (K3) or 10*D (K4) operations over 4 input and 1-3 output (BH, T, D)
// tensors, so at the training shapes (T = 903 or 2623, D = 64) it has
// hundreds of operations per byte: with bf16 tensor cores (989 TFLOP/s) it
// would be bound by operations.  This first design does those operations as
// fp32 FMAs on CUDA cores (67 TFLOP/s), so it is bound by them, several times
// above the tensor-core bound; tensor-core MMA is later work.  PERF.md holds
// its times.
//
// Design, simple and right.  The TPU runs its grid in order on one core and
// carries the dq, dk and dv sums in VMEM from one grid step to the next; here
// blocks run in parallel and nothing carries over, so each block owns its
// outputs and loops over the other side itself, and no two blocks write the
// same output element except through K4's atomics:
//   K2: one block of 128 threads per (bh, 64-row query tile), two threads per
//       query row each holding half of D (interleaved dims) of q, do and the dq
//       sum in registers; it walks the key range [kv_start, min(kv_end, Tk)),
//       cut at the tile's causal limit as the forward does, in 64-key K/V
//       tiles staged in shared memory as fp32.  No atomics.
//   K3: one block per (bh, 64-key tile), two threads per key row holding half
//       of k, v and the dk, dv sums; it walks the query rows from the first
//       that can see a valid key of the tile (q_row >= key - q_offset, the
//       counterpart of the TPU's q_map) to Tq, in 32-row q/do tiles in shared
//       memory.  A tile with no valid key skips the walk and writes zeros.
//   K4: K3's kernel, plus dq.  The TPU's fused kernel holds one (bh) whole
//       sequence in VMEM (a 903 x 903 fp32 score tile is 3.3 MB, against 227 KB
//       of shared memory here), which does not translate.  Instead the block
//       also stores each 32 x 64 ds tile in shared memory and multiplies it by
//       its fp32 K tile, then adds the 32 x D partial dq into a zeroed fp32
//       (BH, Tq, D) scratch with atomicAdd; the wrapper casts the scratch to
//       q's dtype.  s, p, dp and ds are computed once per pair.  The atomics
//       make the order of dq's sum vary from run to run (about 1e-7 relative in
//       fp32); a single owner per bh would be deterministic but would leave
//       most of the card idle at BH = 48.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kDqRows = 64;   // K2: query rows per block (two threads per row)
constexpr int kDqKeys = 64;   // K2: keys per shared-memory tile
constexpr int kKvKeys = 64;   // K3/K4: keys per block (two threads per key)
constexpr int kKvRows = 32;   // K3/K4: query rows per shared-memory tile

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

// K2: dq for one (bh, 64-row query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ kv_start,
                const int* __restrict__ kv_end, T* __restrict__ dq, int tq, int tk, float scale,
                int causal, int q_offset) {
  constexpr int DH = D / 2;
  __shared__ float ks[kDqKeys][D];
  __shared__ float vs[kDqKeys][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kDqRows;
  const int tid = threadIdx.x;
  const int row = q0 + tid / 2;
  const int half = tid & 1;
  const bool row_ok = row < tq;
  const size_t roff = ((size_t)bh * tq + (row_ok ? row : 0)) * D;

  float qr[DH], dor[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qr[i] = row_ok ? to_float(q[roff + 2 * i + half]) : 0.f;
    dor[i] = row_ok ? to_float(dout[roff + 2 * i + half]) : 0.f;
    acc[i] = 0.f;
  }
  const float row_lse = row_ok ? lse[(size_t)bh * tq + row] : 0.f;
  const float row_delta = row_ok ? delta[(size_t)bh * tq + row] : 0.f;

  // keys this block needs: the row bounds, cut at the causal limit of its
  // last row; the per-row causal limit is applied below
  const int start = max(kv_start[bh], 0);
  int stop = min(kv_end[bh], tk);
  if (causal) stop = min(stop, q_offset + min(q0 + kDqRows, tq));
  const int row_limit = causal ? q_offset + row : INT_MAX;  // inclusive

  for (int k0 = start; k0 < stop; k0 += kDqKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kDqKeys * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int kp = k0 + r;
      const bool ok = kp < stop;
      const size_t off = ((size_t)bh * tk + (ok ? kp : 0)) * D + c;
      ks[r][c] = ok ? to_float(k[off]) : 0.f;
      vs[r][c] = ok ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    const int n = min(kDqKeys, stop - k0);
    for (int r = 0; r < n; ++r) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        s = fmaf(qr[i], ks[r][2 * i + half], s);
        dp = fmaf(dor[i], vs[r][2 * i + half], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // the pair's other half
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const bool ok = row_ok && k0 + r <= row_limit;
      const float p = ok ? expf(s * scale - row_lse) : 0.f;  // explicit zero off the mask
      const float ds = p * (dp - row_delta) * scale;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] = fmaf(ds, ks[r][2 * i + half], acc[i]);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DH; ++i) dq[roff + 2 * i + half] = from_float<T>(acc[i]);
  }
}

// K3 (kFusedDq = false): dk, dv for one (bh, 64-key tile).  K4 (kFusedDq =
// true): the same, plus this tile's share of dq added atomically to dq_acc.
template <typename T, int D, bool kFusedDq>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ kv_start,
                 const int* __restrict__ kv_end, float* __restrict__ dq_acc, T* __restrict__ dk,
                 T* __restrict__ dv, int tq, int tk, float scale, int causal, int q_offset) {
  constexpr int DH = D / 2;
  constexpr int kParts = kThreads / kKvRows;  // threads per query row in the dq pass
  constexpr int DP = D / kParts;
  __shared__ float qs[kKvRows][D];
  __shared__ float dos[kKvRows][D];
  __shared__ float lse_s[kKvRows];
  __shared__ float delta_s[kKvRows];
  __shared__ float kts[kFusedDq ? kKvKeys : 1][D];                // K4: the K tile
  __shared__ float ds_s[kFusedDq ? kKvRows : 1][kKvKeys + 1];    // K4: ds tile, padded

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKvKeys;
  const int tid = threadIdx.x;
  const int key = k0 + tid / 2;
  const int half = tid & 1;
  const int start = max(kv_start[bh], 0);
  const int stop = min(kv_end[bh], tk);
  const bool key_ok = key >= start && key < stop;
  const size_t koff = ((size_t)bh * tk + (key_ok ? key : 0)) * D;

  float kr[DH], vr[DH], dk_acc[DH], dv_acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    kr[i] = key_ok ? to_float(k[koff + 2 * i + half]) : 0.f;
    vr[i] = key_ok ? to_float(v[koff + 2 * i + half]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  if constexpr (kFusedDq) {
    for (int e = tid; e < kKvKeys * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int kp = k0 + r;
      const bool ok = kp >= start && kp < stop;
      kts[r][c] = ok ? to_float(k[((size_t)bh * tk + kp) * D + c]) : 0.f;
    }  // visible after the first barrier of the loop below
  }

  // query rows that can see a valid key of this tile: from the first row at
  // or after the tile's first valid key (causal) to Tq; none if the tile
  // holds no valid key
  const int first_key = max(k0, start);
  const bool any_key = first_key < min(k0 + kKvKeys, stop);
  const int i_begin = causal ? max(0, first_key - q_offset) : 0;
  const int i_end = any_key ? tq : 0;

  for (int i0 = i_begin; i0 < i_end; i0 += kKvRows) {
    __syncthreads();  // the previous tile (and its ds) is consumed
    for (int e = tid; e < kKvRows * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int qi = i0 + r;
      const bool ok = qi < tq;
      const size_t off = ((size_t)bh * tq + (ok ? qi : 0)) * D + c;
      qs[r][c] = ok ? to_float(q[off]) : 0.f;
      dos[r][c] = ok ? to_float(dout[off]) : 0.f;
    }
    if (tid < kKvRows) {
      const int qi = i0 + tid;
      const bool ok = qi < tq;
      lse_s[tid] = ok ? lse[(size_t)bh * tq + qi] : 0.f;
      delta_s[tid] = ok ? delta[(size_t)bh * tq + qi] : 0.f;
    }
    __syncthreads();

    const int m = min(kKvRows, tq - i0);
    for (int r = 0; r < m; ++r) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        s = fmaf(kr[i], qs[r][2 * i + half], s);
        dp = fmaf(vr[i], dos[r][2 * i + half], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // the pair's other half
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const bool ok = key_ok && (!causal || key <= q_offset + i0 + r);
      const float p = ok ? expf(s * scale - lse_s[r]) : 0.f;  // explicit zero off the mask
      const float ds = p * (dp - delta_s[r]) * scale;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        dv_acc[i] = fmaf(p, dos[r][2 * i + half], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[r][2 * i + half], dk_acc[i]);
      }
      if constexpr (kFusedDq) {
        if (half == 0) ds_s[r][tid / 2] = ds;
      }
    }

    if constexpr (kFusedDq) {
      __syncthreads();  // the ds tile is complete
      const int r = tid / kParts;
      const int part = tid % kParts;
      if (r < m) {
        float a[DP];
#pragma unroll
        for (int c = 0; c < DP; ++c) a[c] = 0.f;
        for (int j = 0; j < kKvKeys; ++j) {
          const float dsv = ds_s[r][j];
#pragma unroll
          for (int c = 0; c < DP; ++c) a[c] = fmaf(dsv, kts[j][kParts * c + part], a[c]);
        }
        float* dst = dq_acc + ((size_t)bh * tq + i0 + r) * D;
#pragma unroll
        for (int c = 0; c < DP; ++c) atomicAdd(dst + kParts * c + part, a[c]);
      }
    }
  }

  if (key < tk) {
    const size_t off = ((size_t)bh * tk + key) * D;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      dk[off + 2 * i + half] = from_float<T>(dk_acc[i]);
      dv[off + 2 * i + half] = from_float<T>(dv_acc[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *kv_start, *kv_end;
  int bh, tq, tk;
  float scale;
  int causal, q_offset;
  cudaStream_t stream;
};

template <typename T, int D>
void launch_dq(const Args& a, void* dq) {
  const dim3 grid(a.bh, (a.tq + kDqRows - 1) / kDqRows);
  flash_dq_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.kv_start),
      static_cast<const int*>(a.kv_end), static_cast<T*>(dq), a.tq, a.tk, a.scale, a.causal,
      a.q_offset);
}

template <typename T, int D, bool kFusedDq>
void launch_dkv(const Args& a, void* dq_acc, void* dk, void* dv) {
  const dim3 grid(a.bh, (a.tk + kKvKeys - 1) / kKvKeys);
  flash_dkv_kernel<T, D, kFusedDq><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.kv_start),
      static_cast<const int*>(a.kv_end), static_cast<float*>(dq_acc), static_cast<T*>(dk),
      static_cast<T*>(dv), a.tq, a.tk, a.scale, a.causal, a.q_offset);
}

// Runs CALL with T (the element type) and D (the head dim) bound; returns
// cudaErrorInvalidValue for a head dim other than 32 or 64.
#define PARLER_DISPATCH(d, is_bf16, CALL)                          \
  do {                                                             \
    if (d == 64 && is_bf16) {                                      \
      using T = __nv_bfloat16;                                     \
      constexpr int D = 64;                                        \
      CALL;                                                        \
    } else if (d == 64) {                                          \
      using T = float;                                             \
      constexpr int D = 64;                                        \
      CALL;                                                        \
    } else if (d == 32 && is_bf16) {                               \
      using T = __nv_bfloat16;                                     \
      constexpr int D = 32;                                        \
      CALL;                                                        \
    } else if (d == 32) {                                          \
      using T = float;                                             \
      constexpr int D = 32;                                        \
      CALL;                                                        \
    } else {                                                       \
      return static_cast<int>(cudaErrorInvalidValue);              \
    }                                                              \
  } while (0)

}  // namespace

// Common interface: q/dout (bh, tq, d), k/v (bh, tk, d) contiguous, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); lse/delta (bh, tq) fp32;
// kv_start/kv_end (bh,) int32; outputs in the input dtype except K4's dq_acc,
// a zeroed fp32 (bh, tq, d) buffer.  Each launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head dim other than 32 or 64.
#define PARLER_BWD_ARGS                                                                         \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,              \
      const void *delta, const void *kv_start, const void *kv_end
#define PARLER_BWD_TAIL \
  int bh, int tq, int tk, int d, int is_bf16, float scale, int causal, int q_offset, void *stream
#define PARLER_BWD_PACK \
  Args{q, k, v, dout, lse, delta, kv_start, kv_end, bh, tq, tk, scale, causal, q_offset, \
       static_cast<cudaStream_t>(stream)}

extern "C" int flash_attention_dq(PARLER_BWD_ARGS, void* dq, PARLER_BWD_TAIL) {
  if (bh <= 0 || tq <= 0) return 0;
  const Args a = PARLER_BWD_PACK;
  PARLER_DISPATCH(d, is_bf16, (launch_dq<T, D>(a, dq)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_dkv(PARLER_BWD_ARGS, void* dk, void* dv, PARLER_BWD_TAIL) {
  if (bh <= 0 || tk <= 0) return 0;
  const Args a = PARLER_BWD_PACK;
  PARLER_DISPATCH(d, is_bf16, (launch_dkv<T, D, false>(a, nullptr, dk, dv)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_dqkv(PARLER_BWD_ARGS, void* dq_acc, void* dk, void* dv,
                                    PARLER_BWD_TAIL) {
  if (bh <= 0 || tk <= 0) return 0;
  const Args a = PARLER_BWD_PACK;
  PARLER_DISPATCH(d, is_bf16, (launch_dkv<T, D, true>(a, dq_acc, dk, dv)));
  return static_cast<int>(cudaGetLastError());
}
