// Hopper building blocks shared by the bf16 tensor-core kernels
// (flash_attention.cu, flash_attention_bwd.cu, mlstm_chunk.cu,
// mlstm_chunk_bwd.cu; rglru_scan.cu and rglru_scan_bwd.cu take only the
// cp.async helpers):
// wgmma's 128-byte-swizzled shared-memory layout and descriptors, cp.async
// loads of 16-byte chunks into that layout and of float32 rows, the wgmma
// instructions (m64n64k16, bf16 in, float32 accumulate) and the split of
// a float32 operand into a bf16 pair hi + lo.
//
// Layout: a tile of ROWS rows x DP head-dim columns is stored as DP / 64
// panels of 64 columns, 128-byte rows, each panel 1024-byte aligned, with
// 16-byte chunk c of row r at chunk c ^ (r % 8): wgmma's canonical SW128
// layout. A K-major operand (SBO = 1024 bytes between 8-row groups)
// advances 32 bytes a k16 step inside a panel; an MN-major operand uses
// the same panels with LBO = one panel. A descriptor's high word (SBO,
// swizzle mode) is the same for all of them, an immediate of the
// instruction, so each descriptor costs one register.
//
// Included by the kernels' sources; `kernels/_build.py` hashes every
// csrc/*.cuh into each library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWgThreads = 256;  // a block: two warpgroups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of row r in a ROWS-row tile stored as
// panels of 64 columns (128-byte rows) with the 128-byte swizzle.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// A wgmma shared-memory descriptor as two words. The low word holds the
// start address and the leading byte offset (LBO), both in 16-byte units;
// the high word the stride byte offset (SBO = 1024 bytes between 8-row
// groups for every operand here) and the 128-byte swizzle mode, a constant
// that the instruction takes as an immediate. Offsets added to the low word
// stay in its 14-bit address field (shared memory ends below 2^18 bytes).
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes from global to shared memory, zero-filled when bytes == 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy (cp.async, st.shared) become
// visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// all but the N most recent committed groups of this warpgroup have ended
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// ties accumulator registers to this point of the program, so the compiler
// neither reads them before the wgmma that writes them has been waited for
// nor writes them after it was issued
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x64] (+)= A[64x16] . B[16x64], A and B K-major in shared memory;
// a_lo, b_lo: the descriptors' low words
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint32_t a_lo, uint32_t b_lo,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\nmov.b32 hi, %35;\n"
      "mov.b64 da, {%32, hi};\nmov.b64 db, {%33, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a_lo), "r"(b_lo), "r"(scale_d), "n"(kDescHi));
}

// d[64x64] += A[64x16] . B[16x64], A from registers, B MN-major in shared
// memory; b_lo: its descriptor's low word
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 hi;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %37, 0;\nmov.b32 hi, %38;\nmov.b64 db, {%36, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "r"(1), "n"(kDescHi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&x);
}

// p0, p1 as two packed bf16 pairs: hi = bf16(p), lo = bf16(p - hi). p - hi
// is exact in float32, so hi + lo keeps p to about 16 bits.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// The 64 float32 values src[r0 .. r0 + 64) into dst by cp.async (threads
// 0-63), zero past n.
__device__ __forceinline__ void load_row64(float* dst, const float* __restrict__ src, int r0,
                                           int n, int tid) {
  if (tid < 64) {
    const bool in = r0 + tid < n;
    cp_async4(smem_u32(dst + tid), in ? src + r0 + tid : src, in ? 4 : 0);
  }
}

// Copy rows [row0, row0 + ROWS) x the DP head-dim columns of a [S][dh]
// matrix into the swizzled panels at `dst`, zero past S and past dh.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* __restrict__ src,
                                          int row0, int S, int dh, bool aligned, int tid) {
  constexpr int CPR = DP / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = tid; i < ROWS * CPR; i += kWgThreads) {
    const int r = i / CPR, c = i - r * CPR;
    const int gr = row0 + r, col = c * 8;
    const uint32_t off = swz<ROWS>(r, c);
    if (aligned) {
      const bool in = gr < S && col < dh;
      cp_async16(smem_u32(dst + off), in ? src + (size_t)gr * dh + col : src, in ? 16 : 0);
    } else {  // dh % 8 != 0: rows are not 16-byte aligned
      const int n = gr < S ? dh - col : 0;  // elements of this chunk inside the row
      const bf16* p = src + (size_t)(gr < S ? gr : 0) * dh + col;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = 2 * e < n ? __bfloat16_as_ushort(p[2 * e]) : 0u;
        const uint32_t hi = 2 * e + 1 < n ? __bfloat16_as_ushort(p[2 * e + 1]) : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 64-row tiles, a warpgroup's products on them (the backward kernels)
// ---------------------------------------------------------------------------

constexpr int kT = 64;                 // rows of a tile: wgmma's M and a score tile's N
constexpr uint32_t kPanel = kT * 128;  // bytes of one 64-column panel of a 64-row tile

// d[64 x 64] = A·Bᵀ over the DP head-dim columns (zeros past the operands'
// widths), A and B 64-row K-major tiles at a_addr and b_addr, issued and
// committed as one group (`wg_wait` ends it; then `fence_regs(d)`). A
// warpgroup's call. No branch between the fence and the commit: ptxas
// serializes every wgmma of a kernel whose pipeline stage has one (C7520).
template <int DP>
__device__ __forceinline__ void scores_issue(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  fence_regs(d);
  wg_fence();
  const uint32_t ad = desc_lo(a_addr, 16), bd = desc_lo(b_addr, 16);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = ((kk >> 2) * kPanel + (kk & 3) * 32) >> 4;
    wgmma_ss(d, ad + off, bd + off, kk > 0);
  }
  wg_commit();
}

// `scores_issue`, waited for.
template <int DP>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
  scores_issue<DP>(d, a_addr, b_addr);
  wg_wait0();
  fence_regs(d);
}

// acc[j] += X·B[:, 64 (p0 + j) ...] for the panels j < NPW, X (64 x 64) as
// bf16 A fragments a, B a 64-row MN-major tile at b_addr, issued and
// committed as one group: a and acc stay untouched until a `wg_wait` ends
// it (then `fence_regs` on acc). A warpgroup's call.
template <int NPW>
__device__ __forceinline__ void accumulate_issue(float (&acc)[NPW][32], const uint32_t (&a)[4][4],
                                                 uint32_t b_addr, int p0) {
  const uint32_t bd = desc_lo(b_addr, kPanel);
#pragma unroll
  for (int j = 0; j < NPW; ++j) fence_regs(acc[j]);
  wg_fence();
#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[j], a[kk], bd + (((p0 + j) * kPanel + kk * 16 * 128) >> 4));
  wg_commit();
}

// `accumulate_issue`, waited for.
template <int NPW>
__device__ __forceinline__ void accumulate(float (&acc)[NPW][32], const uint32_t (&a)[4][4],
                                           uint32_t b_addr, int p0) {
  accumulate_issue<NPW>(acc, a, b_addr, p0);
  wg_wait0();
#pragma unroll
  for (int j = 0; j < NPW; ++j) fence_regs(acc[j]);
}

// This thread's warpgroup, as a value the compiler knows is warp-uniform
// (a broadcast from lane 0), so the branches on it around a warpgroup's
// wgmma stages are not divergent paths.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
}

// x (a 64 x 64 accumulator) rounded to bf16 A fragments: k step kk holds
// columns 16 kk .. 16 kk + 15
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// A warpgroup's 64 x NPW panels of float32 accumulators, rows r0 + ra and
// r0 + ra + 8 (< n), columns 64 (p0 + j) + 8 jj + cq + {0, 1} (< cols),
// times mul: bf16 into out (row stride cols) or, with part, float32 there.
template <int NPW>
__device__ __forceinline__ void store_rows(const float (&acc)[NPW][32], bf16* out, float* part,
                                           size_t row0, int r0, int n, int p0, int cols,
                                           float mul, int ra, int cq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + ra + 8 * half;
    if (r >= n) continue;
    const size_t off = (row0 + r) * (size_t)cols;
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = 64 * (p0 + j) + 8 * jj + cq;
        const float x0 = acc[j][4 * jj + 2 * half] * mul, x1 = acc[j][4 * jj + 2 * half + 1] * mul;
        if (part != nullptr) {
          if (d < cols) part[off + d] = x0;
          if (d + 1 < cols) part[off + d + 1] = x1;
        } else if (d + 1 < cols && (cols & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + off + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < cols) out[off + d] = __float2bfloat16_rn(x0);
          if (d + 1 < cols) out[off + d + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

}  // namespace
