// Single-query GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py::decode_attention
// (`_kernel`, a Pallas grid (B, KV, Sc/bk) whose third dimension walks the
// cache in order, carrying the online-softmax state in VMEM scratch):
//   out[b, h] = softmax_s(where(valid[b, s], cap(q[b, h] . k[b, s, h / G] / sqrt(dh)), -1e30))
//               . v[b, :, h / G]
//   cap(s) = tanh(s / c) * c with the logit cap c > 0 (recurrentgemma's 50), else s
// q [B,H,dh], k/v [B,Sc,KV,dh] (float32 or bfloat16, all one type),
// valid [B,Sc] bytes -> out [B,H,dh] in q's type; arithmetic in float32.
//
// A second entry reads an int8-quantized cache (the reference model's
// `kv_cache_dtype="int8"`, src/repro/models/attention.py:170-220): k/v
// [B,Sc,KV,dh] int8 and float32 scales [B,Sc,KV], one per (slot, head).
// Each element is dequantized as it is loaded, exactly as the reference's
// `_kv_dequantize` does it (float32 product q8 * scale, then rounded to q's
// type), into the same shared-memory layout the bf16 path fills; from
// there on it runs the same code, so it gives bit for bit what the bf16
// entry gives on the dequantized cache, while reading 1 byte an element
// (plus 4 a row of dh) instead of 2. Its loads go through registers, not
// cp.async (which cannot convert): with a bf16 q (the model's) a thread
// fetches its share of chunk c + 1 before the scores of chunk c and
// dequantizes it into the other stage after chunk c's P.V, so the loads
// overlap one chunk's work; a float32 q (the checks only) dequantizes each
// chunk as it lands, in the loop of the bf16 path.
//
// Bound: decode reads the whole (valid part of the) cache once and does 4
// flops per cache element and query head: ~1.5 flops a byte read at llama's
// serving shape (B = 8, Sc = 4096, KV = 8, G = 3, dh = 128, bf16), ~24 at
// recurrentgemma's (B = 4, Sc = 2048, KV = 1, G = 16, dh = 256), both far
// below the card's ~295 flops a byte: bytes bound it.
//
// Design: split over the cache, every K/V byte read once per head.
// - The Pallas grid's sequential third dimension becomes a split of the
//   cache: block (b, kv head, split) takes `per` slots (whole chunks of 32,
//   at most 256 chunks) and all G = H / KV query rows of its head, up to 16
//   (more rows take another block each). The plan comes from the wrapper
//   (`ops.split_plan`, from the shapes and the card's SM count alone: the
//   host never reads `valid`), which aims at six blocks an SM. A bf16 block
//   at dh 128 takes 45 KB of shared memory, so four are resident an SM and
//   six an SM run in 1.5 waves or more (1.8 at llama3.2-3b's decode).
//   Small splits balance rows whose valid prefixes differ (a block over
//   invalid chunks ends at once); a full cache runs best in one whole
//   wave. chip_smoke.py times 2 to 12 an SM.
// - A block first reads the row's Sc mask bytes (whether the row has any
//   valid slot) and its own slots' as one 32-bit mask a chunk, and lists
//   the chunks it needs in shared memory: a chunk whose 32 slots are all
//   invalid is skipped (not even loaded) when the row has a valid slot
//   elsewhere, since it would add exp(-1e30 - m) = 0 terms, exactly. A row
//   with no valid slot walks every chunk and gives the mean of v, as the
//   TPU kernel does.
// - K and V rows of the listed chunks stream through two shared-memory
//   stages with 16-byte cp.async (plain loads into the same layout when a
//   row is not 16-byte aligned, dh % (16 / sizeof(T)) != 0): chunk c + 1
//   loads while chunk c is used. Each byte comes from device memory once per
//   block and serves all its rows. K rows are 16 bytes longer than a
//   head-dim row, so the lanes of a warp reading 32 different slots hit
//   different banks.
// - Scores on the CUDA cores (the bytes bound it; tensor cores would not
//   move them faster): warp w takes rows w, w + 4, w + 8, w + 12, lane =
//   slot, q rows in shared memory as float32 (a broadcast to the warp), a
//   dot product in 16 / sizeof(T) partial sums. The same warp runs the
//   chunk's online softmax with shuffles and writes P and the rescale alpha
//   to shared memory. Then P·V: a thread owns 16 bytes of head-dim columns
//   of up to 4 units (8 in float32); the 16 units are the G rows, each over
//   16 / G interleaved groups of the chunk's slots, so a small G (llama's
//   3) keeps most threads busy; the groups are summed once, at the end.
//   Nothing is indexed at run time, nothing lives in local memory.
// - Each block writes float32 partials (m, l, acc[dh]) of its rows into
//   scratch the wrapper allocates; the second kernel, on the same stream,
//   merges the splits of each row in split order (max, rescale, sum) and
//   writes out in q's type. No atomics: every call gives the same bits.
// The logit cap (which the TPU kernel lacks; the reference model applies it
// after the scale and before the mask) is one tanhf per valid slot and row.
//
// Masked scores are the finite -1e30 of the TPU kernel, never -inf: a row
// whose first chunk is all masked adds exp(0) = 1 terms that the next valid
// slot wipes out through alpha = exp(-1e30 - m_new) = 0, where -inf would
// give exp(-inf + inf) = NaN; a split with no needed chunk leaves m = -1e30,
// l = 0, which the merge weighs by exp(-1e30 - M) = 0. Slots past the end of
// a split are -inf (no term at all). Products use fmaf explicitly, since the
// library is built with -fmad=false for the geo_schedule kernel.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // cache slots a chunk: one a lane
constexpr int kRows = 16;   // query rows a block
constexpr int kMaxChunks = 256;  // chunks a split: at most 8192 slots
constexpr int kMaxSplits = 4096;  // the merge holds two floats a split in shared memory
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes of shared memory as float32 values
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> float32 is exact: the high half of the word
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the first n (<= 16 bytes) elements at p as 16 bytes, zero after them:
// the element-load path for rows that are not 16-byte aligned
__device__ __forceinline__ uint4 load_partial(const float* p, int n) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = e < n ? __float_as_uint(p[e]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 load_partial(const __nv_bfloat16* p, int n) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < n ? __bfloat16_as_ushort(p[2 * e]) : 0u;
    const uint32_t hi = 2 * e + 1 < n ? __bfloat16_as_ushort(p[2 * e + 1]) : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared-memory layout of a block, for head dims up to DH
template <typename T, int DH>
struct Plan {
  static constexpr int VE = 16 / (int)sizeof(T);   // elements in 16 bytes
  static constexpr int NCG = DH / VE;              // 16-byte column groups of a row
  static constexpr int KROW = DH * (int)sizeof(T) + 16;  // bytes
  static constexpr int VROW = DH * (int)sizeof(T);
  static constexpr int STAGE = kChunk * (KROW + VROW);
  static constexpr int NS = 2;  // stages: chunk c + 1 loads while chunk c is used
  static constexpr int RG = kThreads / NCG;        // row groups of the P.V step
  static constexpr int RPT = kRows / RG;           // rows a thread in the P.V step
  static constexpr int PSTRIDE = kChunk + 1;       // floats a row of P
  static constexpr size_t BYTES = NS * (size_t)STAGE +
                                  sizeof(float) * (kRows * DH + kRows * PSTRIDE + kRows) +
                                  sizeof(uint32_t) * kMaxChunks + sizeof(int) * (kMaxChunks + 1);
  static_assert(RPT >= 1 && RG * NCG == kThreads, "head-dim bucket does not fit the block");
  static_assert(NS * STAGE >= (int)sizeof(float) * kRows * DH, "no room for the units' sums");
};

// The int8 cache's loads. fetch_q8: the first n (<= VE) bytes of the int8
// row at p as VE / 4 words, zero after them (`vec`: VE-aligned and all
// inside the row, one load). dequant16: those bytes as the 16 bytes of
// shared memory the bf16 path would hold, VE elements of T, each the
// float32 product q8 * scale rounded to T (the reference's
// `_kv_dequantize`), zero after the first n.
template <int VE>
__device__ __forceinline__ void fetch_q8(const int8_t* p, int n, bool vec,
                                         uint32_t (&w)[VE / 4]) {
  if (vec) {
    if constexpr (VE == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x;
      w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < VE / 4; ++i) {
    uint32_t x = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * i + e < n) x |= (uint32_t)(uint8_t)p[4 * i + e] << (8 * e);
    w[i] = x;
  }
}

template <typename T>
__device__ __forceinline__ uint4 dequant16(const uint32_t (&w)[16 / sizeof(T) / 4], int n,
                                           float scale) {
  constexpr int VE = 16 / (int)sizeof(T);
  float x[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) x[e] = (float)(int8_t)((w[e / 4] >> (8 * (e % 4))) & 0xffu);
  uint32_t o[4];
  if constexpr (VE == 8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = 2 * e < n ? __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * e] * scale))
                                    : 0u;
      const uint32_t hi = 2 * e + 1 < n
                              ? __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * e + 1] * scale))
                              : 0u;
      o[e] = lo | (hi << 16);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = e < n ? __float_as_uint(x[e] * scale) : 0u;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// load_q8: 16 bytes of shared memory holding VE elements of T: the first
// n of the int8 row at p dequantized (float32 product q8 * scale rounded to T, as
// `_kv_dequantize`), zero after them. `vec`: the VE bytes are VE-aligned
// and all inside the row, so one load takes them.
template <typename T>
__device__ __forceinline__ uint4 load_q8(const int8_t* p, int n, bool vec, float scale) {
  constexpr int VE = 16 / (int)sizeof(T);
  int8_t x[VE];
  if (vec) {
    if constexpr (VE == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = (int8_t)((w.x >> (8 * e)) & 0xffu);
        x[4 + e] = (int8_t)((w.y >> (8 * e)) & 0xffu);
      }
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = (int8_t)((w >> (8 * e)) & 0xffu);
    }
  } else {
#pragma unroll
    for (int e = 0; e < VE; ++e) x[e] = e < n ? p[e] : (int8_t)0;
  }
  uint32_t w[4];
  if constexpr (VE == 8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = 2 * e < n ? __bfloat16_as_ushort(__float2bfloat16_rn(
                                          (float)x[2 * e] * scale)) : 0u;
      const uint32_t hi = 2 * e + 1 < n ? __bfloat16_as_ushort(__float2bfloat16_rn(
                                              (float)x[2 * e + 1] * scale)) : 0u;
      w[e] = lo | (hi << 16);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = e < n ? __float_as_uint((float)x[e] * scale) : 0u;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid: x = (b * KV + kv head) * row groups + row group, y = split.
// C: the cache's element type, T or int8_t (then k_sc / v_sc are its
// float32 scales [B,Sc,KV]; unused otherwise).
template <typename T, int DH, typename C>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
                    const float* __restrict__ k_sc, const float* __restrict__ v_sc,
                    const uint8_t* __restrict__ valid, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc, int H, int KV,
                    int Sc, int dh, float scale, float cap, int per, int aligned) {
  using P = Plan<T, DH>;
  constexpr bool kQ8 = sizeof(C) == 1;
  const int G = H / KV, nrg = (G + kRows - 1) / kRows;
  const int rgi = blockIdx.x % nrg, bkv = blockIdx.x / nrg;
  const int b = bkv / KV, kv = bkv % KV;
  const int g0 = rgi * kRows, gb = min(kRows, G - g0);
  const int split = blockIdx.y, splits = gridDim.y;
  const int s_lo = split * per, s_hi = min(Sc, s_lo + per);
  const int nch = (s_hi - s_lo + kChunk - 1) / kChunk;  // <= kMaxChunks
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage0 = smem;  // stage st: K rows at stage0 + st STAGE, V rows after them
  float* q_s = reinterpret_cast<float*>(smem + P::NS * P::STAGE);  // [kRows][DH]
  float* p_s = q_s + kRows * DH;                                    // [kRows][PSTRIDE]
  float* alpha_s = p_s + kRows * P::PSTRIDE;                        // [kRows]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(alpha_s + kRows);  // valid bits of a chunk
  int* list_s = reinterpret_cast<int*>(bits_s + kMaxChunks);        // needed chunks, in order
  int* nlist_s = list_s + kMaxChunks;

  const T* qrow = q + ((size_t)b * H + (size_t)kv * G + g0) * dh;
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int g = i / DH, d = i - g * DH;
    q_s[i] = g < gb && d < dh ? to_f32(qrow[(size_t)g * dh + d]) : 0.0f;
  }
  // the valid slots: whether the row has any, and a bit mask of each chunk
  const uint8_t* vrow = valid + (size_t)b * Sc;
  const bool words = ((uintptr_t)vrow & 3) == 0;
  int any = 0;
  if (words) {
    const uint32_t* vw = reinterpret_cast<const uint32_t*>(vrow);
#pragma unroll 8
    for (int j = tid; j < Sc / 4; j += kThreads) any |= vw[j] != 0;
    for (int j = Sc / 4 * 4 + tid; j < Sc; j += kThreads) any |= vrow[j];
  } else {
    for (int j = tid; j < Sc; j += kThreads) any |= vrow[j];
  }
  for (int ci = tid; ci < nch; ci += kThreads) {
    const int s0 = s_lo + kChunk * ci;
    uint32_t bits = 0;
    if (words && s0 + kChunk <= s_hi) {
      const uint32_t* vw = reinterpret_cast<const uint32_t*>(vrow + s0);
#pragma unroll
      for (int w = 0; w < kChunk / 4; ++w) {
        const uint32_t x = vw[w];
#pragma unroll
        for (int e = 0; e < 4; ++e) bits |= (uint32_t)(((x >> (8 * e)) & 0xffu) != 0) << (4 * w + e);
      }
    } else {
      for (int j = 0; j < kChunk && s0 + j < s_hi; ++j) bits |= (uint32_t)(vrow[s0 + j] != 0) << j;
    }
    bits_s[ci] = bits;
  }
  const bool skip_masked = __syncthreads_or(any) != 0;  // also publishes q_s and bits_s
  // a chunk is needed unless all-invalid while the row has a valid slot
  // elsewhere; warp 0 lists the needed ones in order with ballots
  if (warp == 0) {
    int n = 0;
    for (int c0 = 0; c0 < nch; c0 += 32) {
      const int ci = c0 + lane;
      const bool need = ci < nch && (!skip_masked || bits_s[ci] != 0);
      const unsigned bal = __ballot_sync(kFull, need);
      if (need) list_s[n + __popc(bal & ((1u << lane) - 1u))] = ci;
      n += __popc(bal);
    }
    if (lane == 0) *nlist_s = n;
  }
  __syncthreads();
  const int nneed = *nlist_s;

  const size_t slot = (size_t)KV * dh;  // elements between two cache slots
  const C* kb = k + (size_t)b * Sc * slot + (size_t)kv * dh;
  const C* vb = v + (size_t)b * Sc * slot + (size_t)kv * dh;
  auto load = [&](int c, int st) {
    unsigned char* ks = stage0 + st * P::STAGE;
    unsigned char* vs = ks + kChunk * P::KROW;
    for (int i = tid; i < kChunk * P::NCG; i += kThreads) {
      const int r = i / P::NCG, cg = i - r * P::NCG;
      const int s = s_lo + kChunk * c + r, col = cg * P::VE;
      const bool in = s < s_hi;
      const size_t off = (size_t)(in ? s : s_lo) * slot + col;
      unsigned char* kd = ks + r * P::KROW + cg * 16;
      unsigned char* vd = vs + r * P::VROW + cg * 16;
      if constexpr (kQ8) {  // dequantized as it lands (a float32 q: no prefetch, below)
        const int n = in ? min(P::VE, dh - col) : 0;
        const size_t si = ((size_t)b * Sc + (in ? s : s_lo)) * KV + kv;
        const float ksc = n > 0 ? k_sc[si] : 0.0f, vsc = n > 0 ? v_sc[si] : 0.0f;
        const bool vec = aligned && n == P::VE;
        *reinterpret_cast<uint4*>(kd) = load_q8<T>(kb + off, n, vec, ksc);
        *reinterpret_cast<uint4*>(vd) = load_q8<T>(vb + off, n, vec, vsc);
      } else if (aligned) {
        const int bytes = in && col < dh ? 16 : 0;
        cp_async16((uint32_t)__cvta_generic_to_shared(kd), kb + (bytes ? off : 0), bytes);
        cp_async16((uint32_t)__cvta_generic_to_shared(vd), vb + (bytes ? off : 0), bytes);
      } else {  // rows not 16-byte aligned: element loads into the same layout
        const int n = in ? dh - col : 0;
        *reinterpret_cast<uint4*>(kd) = load_partial(kb + off, n);
        *reinterpret_cast<uint4*>(vd) = load_partial(vb + off, n);
      }
    }
  };

  // The int8 cache with a bf16 q (the model's): each thread's share of a
  // chunk (IT items of VE bytes of K and of V, and their scales) is fetched
  // into registers before the scores of the chunk before it, and
  // dequantized into its stage after them, so the loads of chunk c + 1
  // overlap the work on chunk c. A float32 q (the checks only) has twice
  // the items a thread, which do not fit beside its sums: it takes `load`,
  // each chunk dequantized as it lands.
  constexpr bool kPrefetch = kQ8 && sizeof(T) == 2;
  constexpr int IT = kPrefetch ? kChunk * P::NCG / kThreads : 1;
  uint32_t rk[IT][P::VE / 4], rv[IT][P::VE / 4];
  float rks[IT], rvs[IT];
  auto q8_item = [&](int c, int j, int& r, int& cg, int& n, size_t& off, size_t& si) {
    const int i = tid + j * kThreads;
    r = i / P::NCG;
    cg = i - r * P::NCG;
    const int s = s_lo + kChunk * c + r, col = cg * P::VE;
    const bool in = s < s_hi;
    n = in ? min(P::VE, dh - col) : 0;
    off = (size_t)(in ? s : s_lo) * slot + col;
    si = ((size_t)b * Sc + (in ? s : s_lo)) * KV + kv;
  };
  auto fetch_chunk = [&](int c) {
#pragma unroll
    for (int j = 0; j < IT; ++j) {
      int r, cg, n;
      size_t off, si;
      q8_item(c, j, r, cg, n, off, si);
      const bool vec = aligned && n == P::VE;
      rks[j] = n > 0 ? k_sc[si] : 0.0f;
      rvs[j] = n > 0 ? v_sc[si] : 0.0f;
      fetch_q8<P::VE>(reinterpret_cast<const int8_t*>(kb) + off, n, vec, rk[j]);
      fetch_q8<P::VE>(reinterpret_cast<const int8_t*>(vb) + off, n, vec, rv[j]);
    }
  };
  auto put_chunk = [&](int c, int st) {
    unsigned char* ks = stage0 + st * P::STAGE;
    unsigned char* vs = ks + kChunk * P::KROW;
#pragma unroll
    for (int j = 0; j < IT; ++j) {
      int r, cg, n;
      size_t off, si;
      q8_item(c, j, r, cg, n, off, si);
      *reinterpret_cast<uint4*>(ks + r * P::KROW + cg * 16) = dequant16<T>(rk[j], n, rks[j]);
      *reinterpret_cast<uint4*>(vs + r * P::VROW + cg * 16) = dequant16<T>(rv[j], n, rvs[j]);
    }
  };

  float m[kRowsPerWarp], l[kRowsPerWarp];  // rows warp + 4 i, the same in every lane
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
  }
  // P.V: thread tid owns 16 bytes of columns (cg) of units rg + RG i; unit u
  // is row u % gb over the chunk's slots u / gb, u / gb + nsg, ... (the idle
  // units of a small G share the slots, summed once at the end)
  const int cg = tid % P::NCG, rg = tid / P::NCG;
  const int nsg = kRows / gb;  // slot groups
  float acc[P::RPT][P::VE];
#pragma unroll
  for (int i = 0; i < P::RPT; ++i)
#pragma unroll
    for (int e = 0; e < P::VE; ++e) acc[i][e] = 0.0f;

  // a ring of NS stages: chunk it + NS - 1 loads while chunk it is used
  if constexpr (kPrefetch) {
    if (nneed > 0) {
      fetch_chunk(list_s[0]);
      put_chunk(list_s[0], 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < P::NS - 1; ++i) {
      if (i < nneed) load(list_s[i], i);
      cp_async_commit();
    }
  }
  for (int it = 0; it < nneed; ++it) {
    if constexpr (!kPrefetch) asm volatile("cp.async.wait_group %0;\n" ::"n"(P::NS - 2) : "memory");
    // chunk it has landed for every thread, and every thread is done with
    // chunk it - 1: its stage, P and alpha can be overwritten
    __syncthreads();
    if constexpr (kPrefetch) {
      if (it + 1 < nneed) fetch_chunk(list_s[it + 1]);  // into registers, in flight
    } else {
      if (it + P::NS - 1 < nneed) load(list_s[it + P::NS - 1], (it + P::NS - 1) % P::NS);
      cp_async_commit();
    }
    const int c = list_s[it];
    const unsigned char* ks = stage0 + (it % P::NS) * P::STAGE;

    // scores and the online softmax: lane = slot, warp = rows warp + 4 i
    {
      const unsigned char* krow = ks + lane * P::KROW;
      float dot[kRowsPerWarp][P::VE];  // partial sums: short dependency chains
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int e = 0; e < P::VE; ++e) dot[i][e] = 0.0f;
#pragma unroll 4
      for (int g = 0; g < P::NCG; ++g) {
        float kx[P::VE];
        unpack(*reinterpret_cast<const uint4*>(krow + 16 * g), kx);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          if (warp + kWarps * i >= gb) continue;
          const float4* qx =
              reinterpret_cast<const float4*>(q_s + (warp + kWarps * i) * DH + g * P::VE);
#pragma unroll
          for (int e4 = 0; e4 < P::VE / 4; ++e4) {
            const float4 qq = qx[e4];
            dot[i][4 * e4] = fmaf(qq.x, kx[4 * e4], dot[i][4 * e4]);
            dot[i][4 * e4 + 1] = fmaf(qq.y, kx[4 * e4 + 1], dot[i][4 * e4 + 1]);
            dot[i][4 * e4 + 2] = fmaf(qq.z, kx[4 * e4 + 2], dot[i][4 * e4 + 2]);
            dot[i][4 * e4 + 3] = fmaf(qq.w, kx[4 * e4 + 3], dot[i][4 * e4 + 3]);
          }
        }
      }
      const int s = s_lo + kChunk * c + lane;
      const bool in = s < s_hi;
      const bool ok = (bits_s[c] >> lane) & 1u;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int g = warp + kWarps * i;
        if (g >= gb) continue;
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < P::VE; ++e) d += dot[i][e];
        // past the split's end: no term; masked: the TPU kernel's finite -1e30
        float x = -INFINITY;
        if (in && !ok) x = kNeg;
        if (ok) {
          x = d * scale;
          if (cap > 0.0f) x = tanhf(x / cap) * cap;
        }
        float mx = x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        const float p = expf(x - m_new);
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
        p_s[g * P::PSTRIDE + lane] = p;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // P.V on the chunk's V rows
    {
      const unsigned char* vs = ks + kChunk * P::KROW + cg * 16;
#pragma unroll
      for (int i = 0; i < P::RPT; ++i) {
        const int u = rg + P::RG * i;
        if (u >= gb * nsg) continue;
        const int g = u % gb;
        const float a = alpha_s[g];
#pragma unroll
        for (int e = 0; e < P::VE; ++e) acc[i][e] *= a;
        for (int j = u / gb; j < kChunk; j += nsg) {
          float vx[P::VE];
          unpack(*reinterpret_cast<const uint4*>(vs + j * P::VROW), vx);
          const float p = p_s[g * P::PSTRIDE + j];
#pragma unroll
          for (int e = 0; e < P::VE; ++e) acc[i][e] = fmaf(p, vx[e], acc[i][e]);
        }
      }
    }
    // the int8 cache: chunk it + 1 into the stage chunk it - 1 used (every
    // thread passed this iteration's barrier, so none reads it any more)
    if constexpr (kPrefetch) {
      if (it + 1 < nneed) put_chunk(list_s[it + 1], (it + 1) % P::NS);
    }
  }

  // this split's partials: row r = b H + kv G + g0 + g, at (r * splits + split)
  const size_t r0 = (size_t)b * H + (size_t)kv * G + g0;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int g = warp + kWarps * i;
      if (g >= gb) continue;
      part_m[(r0 + g) * splits + split] = m[i];
      part_l[(r0 + g) * splits + split] = l[i];
    }
  }
  // the units' sums through shared memory (the stages are free now), each
  // row's slot groups added in order
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* red = reinterpret_cast<float*>(stage0);  // [kRows units][DH]
#pragma unroll
  for (int i = 0; i < P::RPT; ++i) {
    const int u = rg + P::RG * i;
#pragma unroll
    for (int e = 0; e < P::VE; ++e) red[u * DH + cg * P::VE + e] = acc[i][e];
  }
  __syncthreads();
  for (int i = tid; i < gb * dh; i += kThreads) {
    const int g = i / dh, d = i - g * dh;
    float sum = 0.0f;
    for (int sg = 0; sg < nsg; ++sg) sum += red[(g + gb * sg) * DH + d];
    part_acc[((r0 + g) * splits + split) * dh + d] = sum;
  }
}

// One block per query row (b, h): the splits in order, rescaled to their
// max. The splits' (m, l) come to shared memory first, all loads at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out, int splits,
                    int dh) {
  extern __shared__ float w_s[];  // [splits] weights exp(m - max), then [splits] l
  float* l_s = w_s + splits;
  const size_t r = blockIdx.x;
  for (int s = threadIdx.x; s < splits; s += kThreads) {
    w_s[s] = part_m[r * splits + s];
    l_s[s] = part_l[r * splits + s];
  }
  __syncthreads();
  float mm = kNeg;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, w_s[s]);
  __syncthreads();
  for (int s = threadIdx.x; s < splits; s += kThreads) w_s[s] = expf(w_s[s] - mm);
  __syncthreads();
  float ll = 0.0f;
  for (int s = 0; s < splits; ++s) ll = fmaf(l_s[s], w_s[s], ll);
  const float inv = 1.0f / fmaxf(ll, 1e-30f);
  const float* acc = part_acc + r * splits * dh;
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float aa = 0.0f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) aa = fmaf(acc[(size_t)s * dh + d], w_s[s], aa);
    store(out + r * dh + d, aa * inv);
  }
}

template <typename T, int DH, typename C>
int launch(const void* q, const void* k, const void* v, const void* k_sc, const void* v_sc,
           const void* valid, void* out, void* scratch, int B, int H, int KV, int Sc, int dh,
           float scale, float cap, int splits, int per, cudaStream_t stream) {
  using P = Plan<T, DH>;
  const int G = H / KV, nrg = (G + kRows - 1) / kRows;
  const long long bx = (long long)B * KV * nrg;
  if (bx > 0x7fffffffLL || splits > kMaxSplits) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::BYTES);
  if (err != cudaSuccess) return (int)err;
  // whole 16-byte rows of T (int8: VE-byte groups) at aligned addresses
  const int aligned = dh % P::VE == 0 &&
                      ((uintptr_t)k | (uintptr_t)v) % (P::VE * sizeof(C)) == 0;
  const size_t rows = (size_t)B * H;
  float* pm = (float*)scratch;
  float* pl = pm + rows * splits;
  float* pacc = pl + rows * splits;
  decode_split_kernel<T, DH, C><<<dim3((unsigned)bx, splits), kThreads, P::BYTES, stream>>>(
      (const T*)q, (const C*)k, (const C*)v, (const float*)k_sc, (const float*)v_sc,
      (const uint8_t*)valid, pm, pl, pacc, H, KV, Sc, dh, scale, cap, per, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (rows > 0x7fffffffULL) return (int)cudaErrorInvalidConfiguration;
  decode_merge_kernel<T><<<(unsigned)rows, kThreads, 2 * sizeof(float) * splits, stream>>>(
      pm, pl, pacc, (T*)out, splits, dh);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int launch_dh(const void* q, const void* k, const void* v, const void* k_sc, const void* v_sc,
              const void* valid, void* out, void* scratch, int B, int H, int KV, int Sc, int dh,
              float scale, float cap, int splits, int per, cudaStream_t st) {
  if (dh <= 64)
    return launch<T, 64, C>(q, k, v, k_sc, v_sc, valid, out, scratch, B, H, KV, Sc, dh, scale,
                            cap, splits, per, st);
  if (dh <= 128)
    return launch<T, 128, C>(q, k, v, k_sc, v_sc, valid, out, scratch, B, H, KV, Sc, dh, scale,
                             cap, splits, per, st);
  if (dh <= 256)
    return launch<T, 256, C>(q, k, v, k_sc, v_sc, valid, out, scratch, B, H, KV, Sc, dh, scale,
                             cap, splits, per, st);
  return (int)cudaErrorInvalidValue;
}

int check_plan(int B, int H, int KV, int Sc, int dh, int splits, int per) {
  if (KV <= 0 || H % KV != 0 || Sc <= 0 || dh <= 0) return (int)cudaErrorInvalidValue;
  if (per <= 0 || per % kChunk != 0 || per > kChunk * kMaxChunks || splits <= 0 ||
      (long long)splits * per < Sc ||
      (long long)(splits - 1) * per >= Sc)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cap <= 0: no logit cap. `splits` blocks
// of `per` slots (a multiple of 32, at most 8192) cover [0, Sc); `scratch` holds
// B·H·splits·(dh + 2) float32. Shapes are checked by the Python wrapper.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, void* scratch, int B,
                                       int H, int KV, int Sc, int dh, float scale, float cap,
                                       int splits, int per, int dtype, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (const int err = check_plan(B, H, KV, Sc, dh, splits, per)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dh<float, float>(q, k, v, nullptr, nullptr, valid, out, scratch, B, H, KV, Sc,
                                   dh, scale, cap, splits, per, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, valid, out,
                                                   scratch, B, H, KV, Sc, dh, scale, cap,
                                                   splits, per, st);
  return (int)cudaErrorInvalidValue;
}

// The int8 cache: k/v [B,Sc,KV,dh] int8, k_scale / v_scale [B,Sc,KV]
// float32; dtype is q's and out's (0 = float32, 1 = bfloat16), the type
// each element is dequantized to. The rest as decode_attention_launch.
extern "C" int decode_attention_int8_launch(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* valid, void* out, void* scratch, int B,
                                            int H, int KV, int Sc, int dh, float scale,
                                            float cap, int splits, int per, int dtype,
                                            void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (const int err = check_plan(B, H, KV, Sc, dh, splits, per)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dh<float, int8_t>(q, k, v, k_scale, v_scale, valid, out, scratch, B, H, KV,
                                    Sc, dh, scale, cap, splits, per, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, valid, out, scratch, B,
                                            H, KV, Sc, dh, scale, cap, splits, per, st);
  return (int)cudaErrorInvalidValue;
}
