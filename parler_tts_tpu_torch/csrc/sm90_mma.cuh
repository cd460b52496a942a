// Building blocks of the bf16 tensor-core attention kernels for Hopper
// (sm_90a), shared by flash_attention_fwd.cu (K1) and flash_attention_bwd.cu
// (K2, K3, K4): cp.async staging of 64-row tiles into 16-byte-padded shared
// rows, ldmatrix fragment loads and mma.sync m16n8k16 bf16 x bf16 -> fp32.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane l of a warp holds, for g =
// l / 4 and t4 = l % 4, elements (row g or g + 8, columns 2*t4 and 2*t4 + 1)
// of each 8-column block of a 16-row accumulator.  That is the layout of the
// A fragment of the next m16n8k16, so a 16 x 64 accumulator rounded to bf16
// feeds the next product from registers: accumulator block j, element e goes
// to A fragment j / 2, register 2 * (j % 2) + e / 2, packed in pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows
constexpr int kTile = 64;         // rows a block owns; rows of each walked tile
constexpr int kStages = 2;        // cp.async ring of the walked side
constexpr int kPad = 8;           // bf16 padding per shared row: 16 bytes
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared without blocking; zero-filled when !ok
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (.trans: each matrix transposed)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + kTile) of a (rows, D) bf16 matrix into a padded shared
// tile, by cp.async; rows past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int rows, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int r = e / kChunks;
    const int c = e % kChunks;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async_16(dst + r * (D + kPad) + c * 8, src + (size_t)(ok ? row : 0) * D + c * 8, ok);
  }
}

// A fragments (16 rows x D) of a warp's rows of a padded shared tile
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* tile, int warp,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(f[kk], tile + (16 * warp + lane % 16) * (D + kPad) + 16 * kk + (lane / 16) * 8);
}

// acc[j] (16 x 8, columns = rows 8j.. of the tile) += a . tile^T over D: the
// tile is stored row-major (rows x D), so its rows are B's columns
template <int D>
__device__ __forceinline__ void mma_a_tile_t(float (&acc)[kTile / 8][4],
                                             const uint32_t (&a)[D / 16][4], const bf16* tile,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kTile / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, tile + (8 * j + lane % 8 + (lane / 16) * 8) * (D + kPad) + 16 * kk +
                     ((lane / 8) % 2) * 8);
      mma_16816(acc[j], a[kk], b[0], b[1]);
      mma_16816(acc[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[n] (16 x 8, columns 8n.. of D) += a . tile over the tile's 64 rows:
// a is 16 x 64 (as 4 k-steps), the tile row-major (64 x D), read transposed
template <int D>
__device__ __forceinline__ void mma_a_tile(float (&acc)[D / 8][4],
                                           const uint32_t (&a)[kTile / 16][4], const bf16* tile,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, tile + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * (D + kPad) + 8 * n +
                           (lane / 16) * 8);
      mma_16816(acc[n], a[kk], b[0], b[1]);
      mma_16816(acc[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// Lets Kernel take `bytes` of dynamic shared memory (above 48 KB only when
// asked for), once per device: the setting never changes, and a launch that
// set it again would pay a CUDA runtime call each time.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static std::atomic<uint64_t> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// The tensor-core kernels copy 16 bytes at a time: every (bh, T, D) tensor
// must start on a 16-byte boundary (torch's allocations do).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace sm90
