// mma.sync building blocks shared by the backward kernels' bf16 tensor-core
// routes (flash_attention_bwd.cu, mlstm_chunk_bwd.cu): a block of four
// warps, each owning 16 rows of a 64-row tile and walking 64-row tiles of
// the other side. Tiles are staged as bf16 [64][DP + 8] (DP the head dim
// rounded up to 64, 128 or 256, the pad columns zero; the 16-byte row pad
// puts the eight rows of an ldmatrix in distinct banks) and read into
// fragments with ldmatrix (.trans where the product's k index is the
// tile's row); mma.sync m16n8k16 takes bf16 and accumulates in float32. A
// product's C fragment becomes the next product's A fragment in registers,
// rounded to bf16 (`c_to_a`).
//
// Not to be included beside wgmma.cuh, whose cp.async helpers share these
// names. `kernels/_build.py` hashes every csrc/*.cuh into each library's
// name, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMmaThreads = 128;  // four warps
constexpr int kMmaRows = 64;      // a block's rows and a walked tile's rows

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
// c[4] += a[4] (16x16, row) · {b0, b1} (16x8, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The A fragment (16 rows x k16) of columns 16·kc.. of a warp's C tiles
// c[n-tile][4] over the same 16 rows.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every copy group but the newest has landed (this thread's)
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// `rows` rows of d bf16 elements from row r0 of src (n rows in all) into
// dst [rows][DP + 8], zeros past row n and past column d. With `vec` (d a
// multiple of 8, src 16-byte aligned) 16-byte cp.async copies, which land
// at the caller's wait; else plain loads and stores.
template <int DP>
__device__ __forceinline__ void load_tile_mma(bf16* dst, const bf16* src, int r0, int rows,
                                              int n, int d, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < rows * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const bool in = r0 + r < n && c < d;
      cp_async16(dst + r * LD + c, in ? src + (size_t)(r0 + r) * d + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kMmaThreads) {
      const int r = i / DP, c = i - r * DP;
      dst[r * LD + c] = r0 + r < n && c < d ? src[(size_t)(r0 + r) * d + c]
                                            : __float2bfloat16_rn(0.0f);
    }
  }
}

// kMmaRows floats from src[r0..] (n in all; zeros past n) into dst, by
// cp.async.
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int r0, int n) {
  for (int r = threadIdx.x; r < kMmaRows; r += kMmaThreads) {
    const bool in = r0 + r < n;
    cp_async4(dst + r, in ? src + r0 + r : src, in ? 4 : 0);
  }
}

// acc[8][4] += A (a warp's 16 rows of a, nk16 k16 steps from column 0) ·
// Bᵀ, B the 64 rows of b (both [rows][DP + 8], k along the row): a warp's
// 16 x 64 block of A·Bᵀ.
template <int DP>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* a, const bf16* b, int nk16) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk >= nk16) break;
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * np], af, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[COLS / 8][4] += X · B[:, c0 : c0 + COLS], X a warp's 16 x 64 C tiles
// x[8][4] (rounded to bf16), B the 64 rows of b ([rows][DP + 8], k along
// the column), over the first nn16 16-column groups of the slice.
template <int DP, int COLS>
__device__ __forceinline__ void mma_xb(float (*acc)[4], float (*x)[4], const bf16* b, int c0,
                                       int nn16) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t af[4];
    c_to_a(af, x[2 * kc], x[2 * kc + 1]);
#pragma unroll
    for (int np = 0; np < COLS / 16; ++np) {
      if (np >= nn16) break;
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kc * 16 + (lane & 15)) * LD + c0 + np * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * np], af, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

}  // namespace
