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
// What bounds it on the H100: the causal forward does 4*D operations per
// (query, valid key) pair, about 2*D*T^2 per head, over 8*T*D bytes of bf16
// q, k, v and out, i.e. about T/4 operations per byte against the card's
// ~295 for bf16 tensor cores: bound by memory at the prefill's T <= 257 (and
// by launch latency at T = 17), by the tensor cores at the training shapes
// (T = 903, 2623).  Either way the matrix products are a small part of the
// time; what surrounds them decides it: one exp per pair, the fragments'
// shared-memory traffic and the causal triangle's unequal blocks.  PERF.md
// holds the times.
//
// bf16 (flash_fwd_mma_kernel): FA2-style on the tensor cores.  One block of
// 4 warps per (bh, 64-row query tile), the last tiles (the longest causal
// walks) launched first; warp w owns rows [16w, 16w + 16) and keeps them as
// mma A fragments.  The block walks the keys [kv_start, min(kv_end, Tk)),
// cut at its last row's causal limit, in 64-key K/V tiles staged through a
// 2-stage cp.async ring (keys past the walk zero-filled, rows padded by 16
// bytes against ldmatrix bank conflicts).  Per tile each warp computes s =
// q.k^T (16 x 64, fp32), the online softmax on the accumulator fragments
// (row max and sum over the 4 lanes that share a row, exp2 with scale *
// log2(e)), rounds p to bf16 straight into A fragments and adds p.v into
// its 16 x D accumulator.  The row sum l adds the unrounded p, as FA2 does.
// Only tiles that straddle the diagonal or a bound take the per-element
// mask, which selects s = -1e9 and p = 0 (never a multiplication: 0 * inf
// is NaN).  The running max starts at -1e9 (in log2 units), and a row whose
// sum stays 0 (no valid key) writes out = 0 and the plain version's lse,
// -1e9 + log(1e-30), which the backward kernels read.
//
// fp32 (flash_fwd_kernel): the first, CUDA-core design, which holds the
// fp32 checks' 1e-4 that TF32 tensor cores would not: one block of 128
// threads per (bh, 64-row query tile), two threads per query row each
// holding half of D in registers (interleaved dims, so the pair reads
// neighbouring shared-memory words), K/V tiles of 64 keys staged in shared
// memory, and the same walk.

#include "sm90_mma.cuh"

#include <climits>
#include <type_traits>

namespace {

using namespace sm90;

constexpr int kBlockQ = 64;            // fp32: query rows per block
constexpr int kBlockK = 64;            // fp32: keys per shared-memory tile
constexpr int kChunk = 16;             // fp32: keys per online-softmax update
constexpr int kThreads = 2 * kBlockQ;  // fp32: two threads per query row
constexpr float kNegInf = -1e9f;       // finite mask value, as the TPU kernel
constexpr float kLn2 = 0.6931471805599453f;
// resident blocks per SM that __launch_bounds__ asks registers for (bf16)
constexpr int kFwdBlocksPerSm = 3;

// K1 in fp32: one (bh, 64-row query tile).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_start,
                 const int* __restrict__ kv_end, float* __restrict__ out, float* __restrict__ lse,
                 int tq, int tk, float scale, int causal, int q_offset) {
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
  const float* qrow = q + ((size_t)bh * tq + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int i = 0; i < DH; ++i) qr[i] = row_ok ? qrow[2 * i + half] : 0.f;

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
      ks[r][c] = ok ? k[off] : 0.f;
      vs[r][c] = ok ? v[off] : 0.f;
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
    float* orow = out + ((size_t)bh * tq + row) * D;
#pragma unroll
    for (int i = 0; i < DH; ++i) orow[2 * i + half] = acc[i] / lc;
    if (half == 0) lse[(size_t)bh * tq + row] = m + logf(lc);
  }
}

template <int D>
constexpr int fwd_mma_smem() {  // q, and the ring of k, v
  return (1 + 2 * kStages) * kTile * (D + kPad) * (int)sizeof(bf16);
}
static_assert(fwd_mma_smem<64>() <= 48 * 1024, "K1 asks for no more than the default shared memory");

// One K/V tile of a warp's walk: s = q.k^T, the online-softmax update of the
// running max m and sum l (both per row h of {g, g + 8}, m in log2 units,
// l this lane's share), then o += p.v.  Element e of column block j of s is
// (row h = e / 2, key key0 + 8j + e % 2).  kMask: keys at or past kmax[h]
// (the bounds' end, or the row's causal limit + 1) get s = -1e9 and p = 0.
template <bool kMask, int D>
__device__ __forceinline__ void fwd_tile(float (&o)[D / 8][4], float (&m)[2], float (&l)[2],
                                         const uint32_t (&qf)[D / 16][4], const bf16* kt,
                                         const bf16* vt, const int (&kmax)[2], int key0,
                                         float scale2, int lane) {
  float sa[kTile / 8][4] = {};
  mma_a_tile_t<D>(sa, qf, kt, lane);  // s = q.k^T
  float mt[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = sa[j][e] * scale2;
      if constexpr (kMask) s = key0 + 8 * j + e % 2 < kmax[e / 2] ? s : kNegInf;  // selected
      sa[j][e] = s;
      mt[e / 2] = fmaxf(mt[e / 2], s);
    }
  }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's max over the 4 lanes that hold it
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
    const float m_new = fmaxf(m[h], mt[h]);
    corr[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
  uint32_t pf[kTile / 16][4];
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[c] = exp2f(sa[j][2 * h + c] - m[h]);
        if constexpr (kMask) p[c] = key0 + 8 * j + c < kmax[h] ? p[c] : 0.f;  // selected
      }
      l[h] += p[0] + p[1];
      pf[j / 2][2 * (j % 2) + h] = pack_bf16(p[0], p[1]);
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= corr[e / 2];
  }
  mma_a_tile<D>(o, pf, vt, lane);  // o += p.v
}

// K1 in bf16: one (bh, 64-row query tile); warp w owns the rows
// [q0 + 16w, q0 + 16w + 16).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kFwdBlocksPerSm)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ kv_start,
                     const int* __restrict__ kv_end, bf16* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, float scale, int causal,
                     int q_offset) {
  constexpr int S = D + kPad;  // shared row stride, elements
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * S;            // [kStages][kTile][S]
  bf16* vs = ks + kStages * kTile * S;  // [kStages][kTile][S]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // the longest walks first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int w0 = q0 + 16 * warp;  // the warp's first row
  const int g = lane / 4;         // rows g and g + 8 of the warp ...
  const int t4 = lane % 4;        // ... and columns 2*t4, 2*t4 + 1 of each 8-block

  // keys this block needs: the row bounds, cut at the causal limit of its
  // last row; the per-row causal limit is the mask's
  const int start = max(kv_start[bh], 0);
  const int kv_stop = min(kv_end[bh], tk);
  int stop = kv_stop;
  if (causal) stop = min(stop, q_offset + min(q0 + kTile, tq));
  const int n_tiles = stop > start ? (stop - start + kTile - 1) / kTile : 0;

  const size_t qbase = (size_t)bh * tq;
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  if (n_tiles > 0) {
    const bf16* kb = k + (size_t)bh * tk * D;
    const bf16* vb = v + (size_t)bh * tk * D;
    auto load_kv = [&](int tile) {  // keys past the walk read as 0
      const int s = tile % kStages;
      load_tile<D>(ks + s * kTile * S, kb, start + tile * kTile, stop, tid);
      load_tile<D>(vs + s * kTile * S, vb, start + tile * kTile, stop, tid);
    };
    load_tile<D>(qs, q + qbase * D, q0, tq, tid);
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) load_kv(t);
      cp_async_commit();
    }

    int kmax[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + g + 8 * h;
      kmax[h] = causal ? min(kv_stop, q_offset + row + 1) : kv_stop;
    }
    const float scale2 = scale * kLog2e;
    uint32_t qf[D / 16][4];

    for (int it = 0; it < n_tiles; ++it) {
      if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);  // into the stage freed last
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // this tile (and q) have landed
      __syncthreads();
      if (it == 0) load_a_frags<D>(qf, qs, warp, lane);
      const bf16* kt = ks + (it % kStages) * kTile * S;
      const bf16* vt = vs + (it % kStages) * kTile * S;
      const int k0 = start + it * kTile;
      // every key valid for every row of the warp: no mask
      if (k0 + kTile <= kv_stop && (!causal || k0 + kTile - 1 <= q_offset + w0))
        fwd_tile<false, D>(o, m, l, qf, kt, vt, kmax, k0 + 2 * t4, scale2, lane);
      else
        fwd_tile<true, D>(o, m, l, qf, kt, vt, kmax, k0 + 2 * t4, scale2, lane);
      __syncthreads();  // the stage is consumed before it is refilled
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);  // the row's sum over its 4 lanes
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = w0 + g + 8 * h;
    if (row < tq) {
      const float lc = fmaxf(l[h], 1e-30f);
      bf16* dst = out + (qbase + row) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * h] / lc, o[n][2 * h + 1] / lc);
      // a row with a valid key has l >= 1 (its max adds exp2(0)); one with
      // none keeps m = -1e9 in natural units, as the plain version
      if (t4 == 0) lse[qbase + row] = (l[h] > 0.f ? m[h] * kLn2 : kNegInf) + logf(lc);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* kv_start,
                   const void* kv_end, void* out, void* lse, int bh, int tq, int tk, float scale,
                   int causal, int q_offset, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid(bh, (tq + kTile - 1) / kTile);
    flash_fwd_mma_kernel<D><<<grid, kMmaThreads, fwd_mma_smem<D>(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const int*>(kv_start), static_cast<const int*>(kv_end), static_cast<bf16*>(out),
        static_cast<float*>(lse), tq, tk, scale, causal, q_offset);
  } else {
    const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
    flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const int*>(kv_start), static_cast<const int*>(kv_end), static_cast<float*>(out),
        static_cast<float*>(lse), tq, tk, scale, causal, q_offset);
  }
}

}  // namespace

// q/out (bh, tq, d), k/v (bh, tk, d) contiguous, fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1, every tensor 16-byte aligned); kv_start/kv_end (bh,) int32;
// lse (bh, tq) fp32.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched), cudaErrorMisalignedAddress for a
// misaligned bf16 tensor, or cudaErrorInvalidValue for a head dim other than
// 32 or 64.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_start, const void* kv_end, void* out,
                                   void* lse, int bh, int tq, int tk, int d, int is_bf16,
                                   float scale, int causal, int q_offset, void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  if (is_bf16 && !aligned16({q, k, v, out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PARLER_LAUNCH(T, D) \
  launch<T, D>(q, k, v, kv_start, kv_end, out, lse, bh, tq, tk, scale, causal, q_offset, st)
  if (d == 64) {
    if (is_bf16) PARLER_LAUNCH(bf16, 64);
    else PARLER_LAUNCH(float, 64);
  } else if (d == 32) {
    if (is_bf16) PARLER_LAUNCH(bf16, 32);
    else PARLER_LAUNCH(float, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PARLER_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
