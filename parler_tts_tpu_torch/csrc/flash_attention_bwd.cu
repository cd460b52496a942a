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
// hundreds of operations per byte and is bound by operations: at the bf16
// tensor-core peak (989 TFLOP/s) by the matrix products, and, since those
// are fast, in practice by what surrounds them: one exp and a few FMAs per
// pair, the shared-memory traffic of the fragments, and the causal
// triangle's unequal blocks.  PERF.md holds the times.
//
// K2, K3 and K4 in bf16 (flash_dq_mma_kernel, flash_dkv_mma_kernel,
// flash_dqkv_mma_kernel): an FA2-style tiled backward on the tensor cores.
// Blocks run in parallel and nothing carries over between them, so each
// block owns 64 rows of its outputs (4 warps of 16 rows) and walks the other
// side in 64-row tiles:
//   K2: one block per (bh, 64-row query tile); q and do stay resident as
//       mma A fragments; it walks the key range [kv_start, min(kv_end, Tk)),
//       cut at the tile's causal limit as the forward does.  Per key tile,
//       each warp computes s = q.k^T and dp = do.v^T (16 x 64, fp32
//       accumulators), then p = exp(s * scale - lse) and ds = p * (dp -
//       delta) * scale, and dq += ds.k.  The last query tiles, the longest
//       walks under causality, are launched first.
//   K3: one block per (bh, 64-key tile); k and v stay resident as A
//       fragments; it walks the query rows from the first that can see a
//       valid key of the tile (q_row >= key - q_offset, the counterpart of
//       the TPU's q_map) to Tq; a tile with no valid key writes zeros.  Per
//       query tile, each warp computes s^T = k.q^T and dp^T = v.do^T for its
//       16 keys, then dv += p^T.do and dk += ds^T.q.  The first key tiles,
//       the longest walks, are launched first.
//   K4: K3, plus dq.  The TPU's fused kernel holds one (bh) whole sequence
//       in VMEM (a 903 x 903 fp32 score tile is 3.3 MB, against 227 KB of
//       shared memory here), which does not translate.  Instead, per query
//       tile, every warp also stores its 16 keys of ds^T (bf16) into one
//       shared 64 x 64 tile; after a barrier, warp w multiplies query rows
//       [16w, 16w + 16) of ds (ldmatrix.trans of that tile) by the resident
//       K tile and adds the 16 x D partial into a zeroed fp32 (BH, Tq, D)
//       scratch with float2 atomics; the wrapper casts the scratch to q's
//       dtype.  s, p, dp and ds are computed once per pair.  The atomics
//       make the order of dq's sum vary from run to run (about 1e-7
//       relative); a single owner per bh would be deterministic but would
//       leave most of the card idle at BH = 48.
// Products are mma.sync.m16n8k16 bf16 x bf16 -> fp32.  B fragments come from
// shared memory by ldmatrix (.trans where the tile is stored k-major, as k
// and q are for dq += ds.k and dk += ds^T.q).  The fp32 accumulator of an
// m16n8 product has the layout of the A fragment of the next m16n8k16, so p
// and ds, rounded to bf16, feed the second product from registers without a
// trip through shared memory; that rounding is the one error these kernels
// add (PERF.md reports it against the plain version).  The walked side is
// staged in bf16 through a ring of kStages tiles by cp.async (16 bytes a
// thread, neighbouring threads on neighbouring addresses, rows outside the
// tensor zero-filled), so the next tile loads while this one computes; rows
// are padded by 16 bytes so that ldmatrix reads no two rows from one bank.
// Only tiles that straddle the causal diagonal or a bound (kv bounds, Tq,
// Tk) take the per-element mask; masked p is selected to 0, never multiplied
// by a mask, since for a fully masked row (lse = -1e9 - 69) the exp
// overflows and inf * 0 is NaN.  One writer per output element and no
// atomics in K2 and K3, so their dq is deterministic, unlike K4's.
//
// fp32 instances (the fp32 checks: the small-config train step card-vs-CPU
// and the two routes at 1e-4 of the largest gradient) keep the first, CUDA-
// core design below: TF32 tensor cores keep about 1e-3 and would not hold
// that tolerance.  One block of 128 threads per 64-row tile, two threads per
// row each holding half of D (interleaved dims) in registers, the other side
// staged in shared memory as fp32:
//   K2 (flash_dq_kernel): per (bh, query tile), walking 64-key K/V tiles.
//   K3 (flash_dkv_kernel, kFusedDq = false): per (bh, key tile), walking
//       32-row q/do tiles from the first row that can see a valid key.
//   K4 (flash_dkv_kernel, kFusedDq = true): K3's kernel, plus dq as above:
//       each 32 x 64 ds tile goes through shared memory, is multiplied by
//       the fp32 K tile with scalar FMAs and added into the scratch with
//       scalar atomics.

#include "sm90_mma.cuh"

#include <climits>
#include <type_traits>

namespace {

using namespace sm90;

constexpr int kThreads = 128;
constexpr int kDqRows = 64;   // K2: query rows per block (two threads per row)
constexpr int kDqKeys = 64;   // K2: keys per shared-memory tile
constexpr int kKvKeys = 64;   // K3/K4: keys per block (two threads per key)
constexpr int kKvRows = 32;   // K3/K4: query rows per shared-memory tile

// K2 in fp32: dq for one (bh, 64-row query tile).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ kv_start, const int* __restrict__ kv_end,
                float* __restrict__ dq, int tq, int tk, float scale, int causal, int q_offset) {
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
    qr[i] = row_ok ? q[roff + 2 * i + half] : 0.f;
    dor[i] = row_ok ? dout[roff + 2 * i + half] : 0.f;
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
      ks[r][c] = ok ? k[off] : 0.f;
      vs[r][c] = ok ? v[off] : 0.f;
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
    for (int i = 0; i < DH; ++i) dq[roff + 2 * i + half] = acc[i];
  }
}

// K3 in fp32 (kFusedDq = false): dk, dv for one (bh, 64-key tile).  K4 (kFusedDq =
// true): the same, plus this tile's share of dq added atomically to dq_acc.
template <int D, bool kFusedDq>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ kv_start, const int* __restrict__ kv_end,
                 float* __restrict__ dq_acc, float* __restrict__ dk, float* __restrict__ dv, int tq,
                 int tk, float scale, int causal, int q_offset) {
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
    kr[i] = key_ok ? k[koff + 2 * i + half] : 0.f;
    vr[i] = key_ok ? v[koff + 2 * i + half] : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  if constexpr (kFusedDq) {
    for (int e = tid; e < kKvKeys * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int kp = k0 + r;
      const bool ok = kp >= start && kp < stop;
      kts[r][c] = ok ? k[((size_t)bh * tk + kp) * D + c] : 0.f;
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
      qs[r][c] = ok ? q[off] : 0.f;
      dos[r][c] = ok ? dout[off] : 0.f;
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
      dk[off + 2 * i + half] = dk_acc[i];
      dv[off + 2 * i + half] = dv_acc[i];
    }
  }
}

// --- K2 and K3 in bf16: tensor cores ----------------------------------------

// resident blocks per SM that __launch_bounds__ asks registers for: K2 fits
// 3 without spilling; K3 spills at 3, so it asks for 2, and K4 (K3 plus dq)
// as K3
constexpr int kDqBlocksPerSm = 3;
constexpr int kDkvBlocksPerSm = 2;
static_assert(kMmaThreads == 2 * kTile, "K3 loads a tile's lse and delta with one thread each");

// K2's scores -> ds as bf16 A fragments.  Accumulator element e of column
// block j is (row h = e / 2 of {g, g + 8}, key 8j + 2*t4 + e % 2); the pairs
// (e = 0, 1) and (2, 3) of blocks 2m and 2m + 1 form A fragment m.  kMask:
// keys at or past kmax[h] (the bounds' end, or the row's causal limit + 1)
// get p = 0.
template <bool kMask>
__device__ __forceinline__ void dq_ds(const float (&sa)[kTile / 8][4],
                                      const float (&pa)[kTile / 8][4],
                                      uint32_t (&dsf)[kTile / 16][4], const float (&lse2)[2],
                                      const float (&dlt)[2], const int (&kmax)[2], int key0,
                                      float scale2, float scale) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float p = exp2f(fmaf(sa[j][2 * h + c], scale2, -lse2[h]));
        if constexpr (kMask) p = key0 + 8 * j + c < kmax[h] ? p : 0.f;  // selected, not multiplied
        ds[c] = p * (pa[j][2 * h + c] - dlt[h]) * scale;
      }
      dsf[j / 2][2 * (j % 2) + h] = pack_bf16(ds[0], ds[1]);
    }
  }
}

// K3's transposed scores -> p^T and ds^T as bf16 A fragments.  Element e of
// column block j is (key h = e / 2 of {g, g + 8}, query 8j + 2*t4 + e % 2 of
// the tile).  kMask: queries below qmin[h] (the key's causal first row, or
// Tq when the key is out of bounds) or at or past `qend` get p = 0.
template <bool kMask>
__device__ __forceinline__ void dkv_p_ds(const float (&sa)[kTile / 8][4],
                                         const float (&pa)[kTile / 8][4],
                                         uint32_t (&pf)[kTile / 16][4],
                                         uint32_t (&dsf)[kTile / 16][4], const float* lse_t,
                                         const float* dlt_t, const int (&qmin)[2], int qend,
                                         int col0, float scale2, float scale) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int col = 8 * j + col0;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + col);
    const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
    const float dlt[2] = {d2.x, d2.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[c] = exp2f(fmaf(sa[j][2 * h + c], scale2, -lse2[c]));
        if constexpr (kMask) p[c] = col + c >= qmin[h] && col + c < qend ? p[c] : 0.f;
        ds[c] = p[c] * (pa[j][2 * h + c] - dlt[c]) * scale;
      }
      pf[j / 2][2 * (j % 2) + h] = pack_bf16(p[0], p[1]);
      dsf[j / 2][2 * (j % 2) + h] = pack_bf16(ds[0], ds[1]);
    }
  }
}

template <int D>
constexpr int dq_mma_smem() {  // q, do, and the ring of k, v
  return (2 + 2 * kStages) * kTile * (D + kPad) * (int)sizeof(bf16);
}
template <int D, bool kDq>
constexpr int dkv_mma_smem() {  // k, v, the ring of q, do, lse, delta; K4: the ds tile
  return (2 + 2 * kStages) * kTile * (D + kPad) * (int)sizeof(bf16) +
         2 * kStages * kTile * (int)sizeof(float) +
         (kDq ? kTile * (kTile + kPad) * (int)sizeof(bf16) : 0);
}

// K4's dq for one query tile: the block's ds^T tile (64 keys x 64 queries,
// bf16, stored by every warp for its keys) times the resident K tile; warp
// w takes the query rows [16w, 16w + 16) of the tile, A by ldmatrix.trans,
// and adds its 16 x D partial into the fp32 scratch `dst` (the tile's first
// row) by float2 atomics (float4 adds, with lane pairs trading halves, were
// slower: PERF.md), rows at or past `rows` left out.
template <int D>
__device__ __forceinline__ void dq_tile(float* dst, const bf16* dss, const bf16* kt, int rows,
                                        int warp, int lane) {
  constexpr int SD = kTile + kPad;
  uint32_t af[kTile / 16][4];
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    ldsm_x4_trans(af[kk], dss + (16 * kk + lane % 8 + (lane / 16) * 8) * SD + 16 * warp +
                              ((lane / 8) % 2) * 8);
  float acc[D / 8][4] = {};
  mma_a_tile<D>(acc, af, kt, lane);  // ds.k over the tile's 64 keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    if (r < rows) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        atomicAdd(reinterpret_cast<float2*>(dst + (size_t)r * D + 8 * n + 2 * (lane % 4)),
                  make_float2(acc[n][2 * h], acc[n][2 * h + 1]));
    }
  }
}

// K2 in bf16: dq for one (bh, 64-row query tile); warp w owns the rows
// [q0 + 16w, q0 + 16w + 16).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kDqBlocksPerSm)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_start, const int* __restrict__ kv_end,
                    bf16* __restrict__ dq, int tq, int tk, float scale, int causal, int q_offset) {
  constexpr int S = D + kPad;  // shared row stride, elements
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile * S;
  bf16* ks = dos + kTile * S;           // [kStages][kTile][S]
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
  float dqa[D / 8][4] = {};
  if (n_tiles > 0) {
    const bf16* kb = k + (size_t)bh * tk * D;
    const bf16* vb = v + (size_t)bh * tk * D;
    auto load_kv = [&](int tile) {
      const int s = tile % kStages;
      load_tile<D>(ks + s * kTile * S, kb, start + tile * kTile, tk, tid);
      load_tile<D>(vs + s * kTile * S, vb, start + tile * kTile, tk, tid);
    };
    load_tile<D>(qs, q + qbase * D, q0, tq, tid);
    load_tile<D>(dos, dout + qbase * D, q0, tq, tid);
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) load_kv(t);
      cp_async_commit();
    }

    float lse2[2], dlt[2];
    int kmax[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + g + 8 * h;
      const bool ok = row < tq;  // rows past Tq read 0: q = do = 0 there, so ds = 0
      lse2[h] = ok ? lse[qbase + row] * kLog2e : 0.f;
      dlt[h] = ok ? delta[qbase + row] : 0.f;
      kmax[h] = causal ? min(kv_stop, q_offset + row + 1) : kv_stop;
    }
    const float scale2 = scale * kLog2e;
    uint32_t qf[D / 16][4], dof[D / 16][4];

    for (int it = 0; it < n_tiles; ++it) {
      if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);  // into the stage freed last
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // this tile (and q, do) have landed
      __syncthreads();
      if (it == 0) {
        load_a_frags<D>(qf, qs, warp, lane);
        load_a_frags<D>(dof, dos, warp, lane);
      }
      const bf16* kt = ks + (it % kStages) * kTile * S;
      const bf16* vt = vs + (it % kStages) * kTile * S;
      const int k0 = start + it * kTile;

      float sa[kTile / 8][4] = {};
      float pa[kTile / 8][4] = {};
      mma_a_tile_t<D>(sa, qf, kt, lane);  // s = q.k^T
      mma_a_tile_t<D>(pa, dof, vt, lane);  // dp = do.v^T
      uint32_t dsf[kTile / 16][4];
      // every pair valid for every row of the warp: no mask
      if (k0 + kTile <= kv_stop && (!causal || k0 + kTile - 1 <= q_offset + w0))
        dq_ds<false>(sa, pa, dsf, lse2, dlt, kmax, k0 + 2 * t4, scale2, scale);
      else
        dq_ds<true>(sa, pa, dsf, lse2, dlt, kmax, k0 + 2 * t4, scale2, scale);
      mma_a_tile<D>(dqa, dsf, kt, lane);  // dq += ds.k
      __syncthreads();  // the stage is consumed before it is refilled
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    if (row < tq) {
      bf16* dst = dq + (qbase + row) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(dqa[n][2 * h], dqa[n][2 * h + 1]);
    }
  }
}

// K3 (kDq = false) in bf16: dk, dv for one (bh, 64-key tile); warp w owns
// the keys [k0 + 16w, k0 + 16w + 16).  K4 (kDq = true): the same, plus the
// tile's share of dq, added into the zeroed fp32 scratch dq_acc.
template <int D, bool kDq>
__device__ __forceinline__ void dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        const int* __restrict__ kv_start,
                                        const int* __restrict__ kv_end, float* __restrict__ dq_acc,
                                        bf16* __restrict__ dk, bf16* __restrict__ dv, int tq,
                                        int tk, float scale, int causal, int q_offset) {
  constexpr int S = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * S;
  bf16* qs = vs + kTile * S;             // [kStages][kTile][S]
  bf16* dos = qs + kStages * kTile * S;  // [kStages][kTile][S]
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kTile * S);  // [kStages][kTile]
  float* dlt_s = lse_s + kStages * kTile;                               // [kStages][kTile]
  bf16* dss = reinterpret_cast<bf16*>(dlt_s + kStages * kTile);  // K4: [kTile][kTile + kPad]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // the first key tiles, the longest walks, first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int w0 = k0 + 16 * warp;  // the warp's first key
  const int g = lane / 4;         // keys g and g + 8 of the warp ...
  const int t4 = lane % 4;        // ... and queries 2*t4, 2*t4 + 1 of each 8-block

  // query rows that can see a valid key of this tile: from the first row at
  // or after the tile's first valid key (causal) to Tq; none if the tile
  // holds no valid key
  const int start = max(kv_start[bh], 0);
  const int stop = min(kv_end[bh], tk);
  const int first_key = max(k0, start);
  const bool any_key = first_key < min(k0 + kTile, stop);
  const int i_begin = causal ? max(0, first_key - q_offset) : 0;
  const int i_end = any_key ? tq : 0;
  const int n_tiles = i_end > i_begin ? (i_end - i_begin + kTile - 1) / kTile : 0;

  const size_t kbase = (size_t)bh * tk;
  float dka[D / 8][4] = {};
  float dva[D / 8][4] = {};
  if (n_tiles > 0) {
    const size_t qbase = (size_t)bh * tq;
    auto load_q = [&](int tile) {
      const int s = tile % kStages;
      const int i0 = i_begin + tile * kTile;
      load_tile<D>(qs + s * kTile * S, q + qbase * D, i0, tq, tid);
      load_tile<D>(dos + s * kTile * S, dout + qbase * D, i0, tq, tid);
      const int r = tid % kTile;
      const bool ok = i0 + r < tq;
      const size_t off = qbase + (ok ? i0 + r : 0);
      if (tid < kTile)
        cp_async_4(lse_s + s * kTile + r, lse + off, ok);
      else
        cp_async_4(dlt_s + s * kTile + r, delta + off, ok);
    };
    load_tile<D>(ks, k + kbase * D, k0, tk, tid);
    load_tile<D>(vs, v + kbase * D, k0, tk, tid);
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) load_q(t);
      cp_async_commit();
    }

    // per key: the first query (tile-relative: minus i0) that may see it;
    // Tq for a key out of bounds, so that no query does
    int qmin_abs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = w0 + g + 8 * h;
      const bool ok = key >= start && key < stop;
      qmin_abs[h] = !ok ? tq : causal ? key - q_offset : INT_MIN / 2;
    }
    const bool keys_inside = w0 >= start && w0 + 16 <= stop;
    const float scale2 = scale * kLog2e;
    uint32_t kf[D / 16][4], vf[D / 16][4];

    for (int it = 0; it < n_tiles; ++it) {
      if (it + kStages - 1 < n_tiles) load_q(it + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      if (it == 0) {
        load_a_frags<D>(kf, ks, warp, lane);
        load_a_frags<D>(vf, vs, warp, lane);
      }
      const int s = it % kStages;
      const bf16* qt = qs + s * kTile * S;
      const bf16* dot = dos + s * kTile * S;
      const int i0 = i_begin + it * kTile;

      float sa[kTile / 8][4] = {};
      float pa[kTile / 8][4] = {};
      mma_a_tile_t<D>(sa, kf, qt, lane);   // s^T = k.q^T
      mma_a_tile_t<D>(pa, vf, dot, lane);  // dp^T = v.do^T
      uint32_t pf[kTile / 16][4], dsf[kTile / 16][4];
      if (keys_inside && i0 + kTile <= tq && (!causal || w0 + 15 <= q_offset + i0)) {
        const int qmin[2] = {0, 0};
        dkv_p_ds<false>(sa, pa, pf, dsf, lse_s + s * kTile, dlt_s + s * kTile, qmin, kTile,
                        2 * t4, scale2, scale);
      } else {
        const int qmin[2] = {qmin_abs[0] - i0, qmin_abs[1] - i0};
        dkv_p_ds<true>(sa, pa, pf, dsf, lse_s + s * kTile, dlt_s + s * kTile, qmin, tq - i0,
                       2 * t4, scale2, scale);
      }
      if constexpr (kDq) {  // the warp's 16 keys of the ds^T tile, for dq below
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(dss + (16 * warp + g + 8 * h) * (kTile + kPad) + 8 * j +
                                         2 * t4) = dsf[j / 2][2 * (j % 2) + h];
        }
      }
      mma_a_tile<D>(dva, pf, dot, lane);  // dv += p^T.do
      mma_a_tile<D>(dka, dsf, qt, lane);  // dk += ds^T.q
      if constexpr (kDq) {
        __syncthreads();  // the ds^T tile is complete
        dq_tile<D>(dq_acc + (qbase + i0) * D, dss, ks, tq - i0, warp, lane);  // dq += ds.k
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = w0 + g + 8 * h;
    if (key < tk) {
      const size_t off = (kbase + key) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
            __floats2bfloat162_rn(dka[n][2 * h], dka[n][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
            __floats2bfloat162_rn(dva[n][2 * h], dva[n][2 * h + 1]);
      }
    }
  }
}

#define PARLER_MMA_BWD_PARAMS                                                                   \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,          \
      const bf16 *__restrict__ dout, const float *__restrict__ lse,                             \
      const float *__restrict__ delta, const int *__restrict__ kv_start,                        \
      const int *__restrict__ kv_end

// K3 in bf16
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kDkvBlocksPerSm)
flash_dkv_mma_kernel(PARLER_MMA_BWD_PARAMS, bf16* __restrict__ dk, bf16* __restrict__ dv, int tq,
                     int tk, float scale, int causal, int q_offset) {
  dkv_mma<D, false>(q, k, v, dout, lse, delta, kv_start, kv_end, nullptr, dk, dv, tq, tk, scale,
                    causal, q_offset);
}

// K4 in bf16
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kDkvBlocksPerSm)
flash_dqkv_mma_kernel(PARLER_MMA_BWD_PARAMS, float* __restrict__ dq_acc, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int tq, int tk, float scale, int causal,
                      int q_offset) {
  dkv_mma<D, true>(q, k, v, dout, lse, delta, kv_start, kv_end, dq_acc, dk, dv, tq, tk, scale,
                   causal, q_offset);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *kv_start, *kv_end;
  int bh, tq, tk;
  float scale;
  int causal, q_offset;
  cudaStream_t stream;
};

// Args' inputs, cast for a bf16 tensor-core kernel or an fp32 CUDA-core one
#define PARLER_MMA_ARGS(a)                                                                       \
  static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),  \
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),                       \
      static_cast<const float*>(a.delta), static_cast<const int*>(a.kv_start),                  \
      static_cast<const int*>(a.kv_end)
#define PARLER_FP32_ARGS(a)                                                                      \
  static_cast<const float*>(a.q), static_cast<const float*>(a.k),                               \
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),                        \
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),                     \
      static_cast<const int*>(a.kv_start), static_cast<const int*>(a.kv_end)

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid(a.bh, (a.tq + kTile - 1) / kTile);
    constexpr int smem = dq_mma_smem<D>();
    const cudaError_t err = allow_smem<flash_dq_mma_kernel<D>>(smem);
    if (err != cudaSuccess) return err;
    flash_dq_mma_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
        PARLER_MMA_ARGS(a), static_cast<bf16*>(dq), a.tq, a.tk, a.scale, a.causal, a.q_offset);
  } else {
    const dim3 grid(a.bh, (a.tq + kDqRows - 1) / kDqRows);
    flash_dq_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        PARLER_FP32_ARGS(a), static_cast<float*>(dq), a.tq, a.tk, a.scale, a.causal, a.q_offset);
  }
  return cudaSuccess;
}

template <typename T, int D, bool kFusedDq>
cudaError_t launch_dkv(const Args& a, void* dq_acc, void* dk, void* dv) {
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid(a.bh, (a.tk + kTile - 1) / kTile);
    constexpr int smem = dkv_mma_smem<D, kFusedDq>();
    if constexpr (kFusedDq) {
      const cudaError_t err = allow_smem<flash_dqkv_mma_kernel<D>>(smem);
      if (err != cudaSuccess) return err;
      flash_dqkv_mma_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
          PARLER_MMA_ARGS(a), static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), a.tq, a.tk, a.scale, a.causal, a.q_offset);
    } else {
      const cudaError_t err = allow_smem<flash_dkv_mma_kernel<D>>(smem);
      if (err != cudaSuccess) return err;
      flash_dkv_mma_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
          PARLER_MMA_ARGS(a), static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.tq, a.tk, a.scale,
          a.causal, a.q_offset);
    }
  } else {
    const dim3 grid(a.bh, (a.tk + kKvKeys - 1) / kKvKeys);
    flash_dkv_kernel<D, kFusedDq><<<grid, kThreads, 0, a.stream>>>(
        PARLER_FP32_ARGS(a), static_cast<float*>(dq_acc), static_cast<float*>(dk),
        static_cast<float*>(dv), a.tq, a.tk, a.scale, a.causal, a.q_offset);
  }
  return cudaSuccess;
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
// (is_bf16 = 0) or bf16 (is_bf16 = 1, every tensor 16-byte aligned);
// lse/delta (bh, tq) fp32; kv_start/kv_end (bh,) int32; outputs in the input
// dtype except K4's dq_acc, a zeroed fp32 (bh, tq, d) buffer.  Each launches
// on `stream` without synchronising and returns cudaGetLastError() (0 =
// launched), cudaErrorMisalignedAddress for a misaligned bf16 tensor, or
// cudaErrorInvalidValue for a head dim other than 32 or 64.
#define PARLER_BWD_ARGS                                                                         \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,              \
      const void *delta, const void *kv_start, const void *kv_end
#define PARLER_BWD_TAIL \
  int bh, int tq, int tk, int d, int is_bf16, float scale, int causal, int q_offset, void *stream
#define PARLER_BWD_PACK \
  Args{q, k, v, dout, lse, delta, kv_start, kv_end, bh, tq, tk, scale, causal, q_offset, \
       static_cast<cudaStream_t>(stream)}

// The launch's own error, else cudaGetLastError() (which it also clears).
int launch_result(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" int flash_attention_dq(PARLER_BWD_ARGS, void* dq, PARLER_BWD_TAIL) {
  if (bh <= 0 || tq <= 0) return 0;
  if (is_bf16 && !aligned16({q, k, v, dout, dq}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a = PARLER_BWD_PACK;
  cudaError_t err = cudaSuccess;
  PARLER_DISPATCH(d, is_bf16, (err = launch_dq<T, D>(a, dq)));
  return launch_result(err);
}

extern "C" int flash_attention_dkv(PARLER_BWD_ARGS, void* dk, void* dv, PARLER_BWD_TAIL) {
  if (bh <= 0 || tk <= 0) return 0;
  if (is_bf16 && !aligned16({q, k, v, dout, dk, dv}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a = PARLER_BWD_PACK;
  cudaError_t err = cudaSuccess;
  PARLER_DISPATCH(d, is_bf16, (err = launch_dkv<T, D, false>(a, nullptr, dk, dv)));
  return launch_result(err);
}

extern "C" int flash_attention_dqkv(PARLER_BWD_ARGS, void* dq_acc, void* dk, void* dv,
                                    PARLER_BWD_TAIL) {
  if (bh <= 0 || tk <= 0) return 0;
  if (is_bf16 && !aligned16({q, k, v, dout, dq_acc, dk, dv}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a = PARLER_BWD_PACK;
  cudaError_t err = cudaSuccess;
  PARLER_DISPATCH(d, is_bf16, (err = launch_dkv<T, D, true>(a, dq_acc, dk, dv)));
  return launch_result(err);
}
