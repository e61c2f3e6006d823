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
// Each element is dequantized exactly as the reference's `_kv_dequantize`
// does it (the float32 product q8 * scale, rounded to q's type) at the point
// where the bf16 / float32 entry would read the cache element, and from
// there on the two entries run the same code: the int8 entry gives bit for
// bit what the same dtype's entry gives on the dequantized cache, while
// reading 1 byte an element (plus 4 a row of dh) instead of 2.
//
// Bound: decode reads the whole (valid part of the) cache once and does 4
// flops per cache element and query head: ~1.5 flops a byte read at llama's
// serving shape (B = 8, Sc = 4096, KV = 8, G = 3, dh = 128, bf16), ~24 at
// recurrentgemma's (B = 4, Sc = 2048, KV = 1, G = 16, dh = 256), both far
// below the card's ~295 flops a byte: bytes bound it.
//
// Both routes split the cache: block (b, kv head, row group, split) takes
// `per` slots (whole chunks of 32, at most 256 chunks) and up to 16 query
// rows of its head (more rows take another block each), so every K/V byte is
// read once per block; the plan comes from the wrapper (`ops.split_plan` /
// `ops.split_plan_mma`, from the shapes and the card's SM count alone: the
// host never reads `valid`). A block first reads the row's mask bytes
// (whether the row has any valid slot) and its own slots' as one 32-bit mask
// a chunk, and lists the chunks it needs in shared memory: a chunk whose 32
// slots are all invalid is skipped (not even loaded) when the row has a valid
// slot elsewhere, since it would add exp(-1e30 - m) = 0 terms, exactly. A
// row with no valid slot walks every chunk and gives the mean of v, as the
// TPU kernel does. Each block writes float32 partials (m, l, acc[dh]) of its
// rows into scratch the wrapper allocates; `decode_merge_kernel`, on the same
// stream, merges the splits of each row in split order (max, rescale, sum)
// and writes out in q's type. No atomics: every call gives the same bits.
//
// The bf16 route (a bf16 q: every model's), `decode_mma_kernel`: tensor
// cores, which leave the CUDA cores to the softmax and the int8 cache's
// dequantization.
// - Four warps, each with its own online softmax over steps of 16 slots
//   (half a chunk): a round gives each warp one step (two chunks a round; at
//   dh 256 two warps share a step, each with half the output columns, so a
//   warp's accumulators stay at 64 registers). The warps' partials are merged
//   in warp order at the block's end.
// - K and V rows, and the int8 cache's scales, are copied raw into a ring of
//   round stages with cp.async: 16 bytes where a row is 16-byte aligned, a
//   row's pieces on consecutive lanes; else 8 or 4 bytes (h2o-danube's dh
//   120 puts an int8 head's row at kv * 120 in a 960-byte slot row, 8-byte
//   aligned), a row a thread, whose pieces L1 merges into the row's lines;
//   element loads where a row is not 4-byte aligned. The ring is three
//   rounds deep (two rounds of copies in flight while one is used) where the
//   blocks an SM leave room, two for bf16 at dh 64 and 256. No barrier waits
//   on a conversion: one barrier a round, for the ring.
// - Bound in practice by the access pattern, not the bytes: a block reads
//   one KV head's piece of each slot row, and the copies, not the math,
//   hold most of the int8 kernel's time at h2o's full ring (PERF.md §6).
// - S = q kᵀ on mma.sync m16n8k16 (bf16 in, float32 sums): the block's 16
//   query rows (zeros past G) are the A operand, held in registers; each
//   thread's K operand is 4 adjacent head-dim elements of one slot, one 4-
//   or 8-byte shared-memory load (the head dims are permuted inside each
//   k16 step, in q's operand the same way, which leaves the dot product's
//   terms as they are). The int8 cache is dequantized right there: 4 bytes
//   to 4 exact floats (a byte permute into 2^23's mantissa, less 2^23 +
//   128), times the slot's scale, rounded to a bf16 pair.
// - P·V on mma.sync: P (float32) as a bf16 pair hi + lo, from the S
//   accumulators' registers; each thread's V operand is 4 adjacent output
//   columns (one an n-tile, permuted back when the partials are written) of
//   4 slots, dequantized the same way. Both entries build the same bf16
//   operands, so the int8 entry's result is the bf16 entry's on the
//   dequantized cache, bit for bit.
// Shared-memory rows are padded so that every operand load is free of bank
// conflicts; K's head-dim padding is zeroed once (q's is zero).
//
// The float32 route (a float32 q: the checks only), `decode_split_kernel`,
// on the CUDA cores: K and V rows of the listed chunks stream through two
// stages (cp.async for a float cache where rows are 16-byte aligned, element
// loads otherwise; the int8 cache is dequantized as it lands); warp w takes
// rows w, w + 4, ... with lane = slot for the scores and the chunk's online
// softmax (shuffles), then P·V with a thread on 16 bytes of head-dim columns
// of up to 4 units (a unit is a row over an interleaved group of the chunk's
// slots, so a small G keeps most threads busy; the groups are summed once,
// at the end).
//
// The logit cap (which the TPU kernel lacks; the reference model applies it
// after the scale and before the mask) is one tanhf per valid slot and row.
// Masked scores are the finite -1e30 of the TPU kernel, never -inf: a row
// whose first slots are all masked adds exp(0) = 1 terms that the next valid
// slot wipes out through alpha = exp(-1e30 - m_new) = 0, where -inf would
// give exp(-inf + inf) = NaN; a split (or a warp) with no needed chunk leaves
// m = -1e30, l = 0, which the merge weighs by exp(-1e30 - M) = 0. Slots past
// the end of a split are -inf (no term at all). Products use fmaf
// explicitly, since the library is built with -fmad=false for the
// geo_schedule kernel.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // cache slots a chunk: one a lane
constexpr int kRows = 16;   // query rows a block
constexpr int kMaxChunks = 256;  // chunks a split: at most 8192 slots
constexpr int kMaxSplits = 4096;  // the merge holds two floats a split in shared memory
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// W bytes from global to shared memory, zero-filled past `bytes` (0 or W);
// 16 bytes bypass L1 (.cg), 8 and 4 go through it (.ca: only it takes them)
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(W),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The split's chunks that need work, in order, into list_s (their count is
// returned); bits_s[ci] holds the valid bits of chunk ci of [s_lo, s_hi). A
// chunk is needed unless all-invalid while the row has a valid slot
// elsewhere. Its barriers also publish the caller's earlier shared-memory
// writes.
__device__ int list_chunks(const uint8_t* vrow, int Sc, int s_lo, int s_hi, int nch,
                           uint32_t* bits_s, int* list_s, int* nlist_s) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
        for (int e = 0; e < 4; ++e)
          bits |= (uint32_t)(((x >> (8 * e)) & 0xffu) != 0) << (4 * w + e);
      }
    } else {
      for (int j = 0; j < kChunk && s0 + j < s_hi; ++j) bits |= (uint32_t)(vrow[s0 + j] != 0) << j;
    }
    bits_s[ci] = bits;
  }
  const bool skip_masked = __syncthreads_or(any) != 0;  // also publishes bits_s
  if (warp == 0) {  // warp 0 lists the needed chunks in order with ballots
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
  return *nlist_s;
}

// ---------------------------------------------------------------------------
// The float32 route: CUDA cores

// 16 bytes of shared memory as float32 values
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

// the first n (<= 4) elements at p as 16 bytes, zero after them: the
// element-load path for rows that are not 16-byte aligned
__device__ __forceinline__ uint4 load_partial(const float* p, int n) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = e < n ? __float_as_uint(p[e]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes of shared memory holding the first n (<= 4) elements of the int8
// row at p dequantized (the float32 product q8 * scale, as `_kv_dequantize`),
// zero after them. `vec`: the 4 bytes are 4-aligned and all inside the row.
__device__ __forceinline__ uint4 load_q8(const int8_t* p, int n, bool vec, float scale) {
  int8_t x[4];
  if (vec) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = (int8_t)((w >> (8 * e)) & 0xffu);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = e < n ? p[e] : (int8_t)0;
  }
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = e < n ? __float_as_uint((float)x[e] * scale) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared-memory layout of a float32 block, for head dims up to DH
template <int DH>
struct Plan {
  static constexpr int VE = 4;                     // elements in 16 bytes
  static constexpr int NCG = DH / VE;              // 16-byte column groups of a row
  static constexpr int KROW = DH * 4 + 16;         // bytes
  static constexpr int VROW = DH * 4;
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

// grid: x = (b * KV + kv head) * row groups + row group, y = split.
// C: the cache's element type, float or int8_t (then k_sc / v_sc are its
// float32 scales [B,Sc,KV]; unused otherwise).
template <int DH, typename C>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
                    const float* __restrict__ k_sc, const float* __restrict__ v_sc,
                    const uint8_t* __restrict__ valid, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc, int H, int KV,
                    int Sc, int dh, float scale, float cap, int per, int aligned) {
  using P = Plan<DH>;
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

  const float* qrow = q + ((size_t)b * H + (size_t)kv * G + g0) * dh;
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int g = i / DH, d = i - g * DH;
    q_s[i] = g < gb && d < dh ? qrow[(size_t)g * dh + d] : 0.0f;
  }
  const int nneed = list_chunks(valid + (size_t)b * Sc, Sc, s_lo, s_hi, nch, bits_s, list_s,
                                nlist_s);

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
      if constexpr (kQ8) {  // dequantized as it lands
        const int n = in ? min(P::VE, dh - col) : 0;
        const size_t si = ((size_t)b * Sc + (in ? s : s_lo)) * KV + kv;
        const float ksc = n > 0 ? k_sc[si] : 0.0f, vsc = n > 0 ? v_sc[si] : 0.0f;
        const bool vec = aligned && n == P::VE;
        *reinterpret_cast<uint4*>(kd) = load_q8(kb + off, n, vec, ksc);
        *reinterpret_cast<uint4*>(vd) = load_q8(vb + off, n, vec, vsc);
      } else if (aligned) {
        const int bytes = in && col < dh ? 16 : 0;
        cp_async<16>(smem_u32(kd), kb + (bytes ? off : 0), bytes);
        cp_async<16>(smem_u32(vd), vb + (bytes ? off : 0), bytes);
      } else {  // rows not 16-byte aligned: element loads into the same layout
        const int n = in ? dh - col : 0;
        *reinterpret_cast<uint4*>(kd) = load_partial(kb + off, n);
        *reinterpret_cast<uint4*>(vd) = load_partial(vb + off, n);
      }
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
#pragma unroll
  for (int i = 0; i < P::NS - 1; ++i) {
    if (i < nneed) load(list_s[i], i);
    cp_async_commit();
  }
  for (int it = 0; it < nneed; ++it) {
    cp_async_wait<P::NS - 2>();
    // chunk it has landed for every thread, and every thread is done with
    // chunk it - 1: its stage, P and alpha can be overwritten
    __syncthreads();
    if (it + P::NS - 1 < nneed) load(list_s[it + P::NS - 1], (it + P::NS - 1) % P::NS);
    cp_async_commit();
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
          const float4 qq =
              *reinterpret_cast<const float4*>(q_s + (warp + kWarps * i) * DH + g * P::VE);
          dot[i][0] = fmaf(qq.x, kx[0], dot[i][0]);
          dot[i][1] = fmaf(qq.y, kx[1], dot[i][1]);
          dot[i][2] = fmaf(qq.z, kx[2], dot[i][2]);
          dot[i][3] = fmaf(qq.w, kx[3], dot[i][3]);
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

// ---------------------------------------------------------------------------
// The bf16 route: tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums)

constexpr int kHalf = 16;  // slots a warp's step: half a chunk

template <int DH, typename C>
struct MmaPlan {
  static constexpr bool Q8 = sizeof(C) == 1;
  static constexpr int CW = DH == 256 ? 2 : 1;  // warps sharing a step, each on its own columns
  static constexpr int WG = kWarps / CW;        // steps a round
  static constexpr int RC = WG / 2;             // chunks a round
  static constexpr int COLS = DH / CW;          // output columns a warp
  static constexpr int NT = COLS / 8;           // output n-tiles a warp
  static constexpr int KS = DH / 16;            // k16 steps of q.k
  // bytes a staged K / V row: K's operand loads (8 slots x 16 (int8) or 32
  // (bf16) bytes) and V's (4 slots, two apart, x 32 or 64 bytes) each fall
  // on distinct banks
  static constexpr int KSTR = Q8 ? DH + 16 : 2 * DH + 32;
  static constexpr int VSTR = Q8 ? DH + 16 : 2 * DH + 16;
  static constexpr int SC = Q8 ? 2 * kHalf * 4 : 0;        // a step's K and V scales
  static constexpr int STEP = kHalf * (KSTR + VSTR) + SC;  // bytes a staged step
  static constexpr int ROUND = WG * STEP;
  // blocks an SM the registers must allow: four at dh 64 (128 registers a
  // thread), three for the int8 cache at 128 (168), else two (bf16 at 128
  // needs 178 without a spill; at 256 the accumulators and q's operand take
  // 128)
  static constexpr int MIN_BLOCKS = DH == 64 ? 4 : DH == 128 && Q8 ? 3 : 2;
  // rounds in the ring: three where the blocks an SM leave the room, else two
  static constexpr int NR = Q8 || (MIN_BLOCKS == 2 && DH == 128) ? 3 : 2;
  static constexpr int RING = NR * ROUND;
  static constexpr size_t BYTES =
      RING + sizeof(uint32_t) * kMaxChunks + sizeof(int) * (kMaxChunks + 1);
  static_assert(COLS % 32 == 0 && STEP % 16 == 0, "head-dim bucket does not fit the block");
  static_assert(RING >= (int)sizeof(float) * WG * kRows * (DH + 2), "no room for the merge");
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 int8 (a little-endian word) times the scale: the float32 products
// (float)q8 * sc of the reference's `_kv_dequantize`, before its rounding.
// Each byte, offset by 128, goes into the mantissa of 2^23; less 2^23 + 128,
// that float is q8 exactly.
__device__ __forceinline__ void dequant4(uint32_t w, float sc, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - 8388736.0f) * sc;
}

// Pieces piece, piece + lanes, ... of W bytes of a cache row (of n pieces)
// into shared memory at dst; zeros when the slot is out of range (src then
// points at a slot in range). W = 1: plain byte loads and stores.
template <int W>
__device__ __forceinline__ void copy_pieces(unsigned char* dst, const unsigned char* src,
                                            int piece, int n, int lanes, bool in) {
  for (int pc = piece; pc < n; pc += lanes) {
    if constexpr (W == 1)
      dst[pc] = in ? src[pc] : 0;
    else
      cp_async<W>(smem_u32(dst + pc * W), src + pc * W, in ? W : 0);
  }
}

// grid as decode_split_kernel's. C: bf16 or int8_t (then k_sc / v_sc are
// the cache's float32 scales [B,Sc,KV]). copy: bytes a cp.async of a row
// (16, 8 or 4; 0: element loads), which divides dh * sizeof(C) and the
// caches' alignment.
template <int DH, typename C>
__global__ void __launch_bounds__(kThreads, MmaPlan<DH, C>::MIN_BLOCKS)
decode_mma_kernel(const bf16* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
                  const float* __restrict__ k_sc, const float* __restrict__ v_sc,
                  const uint8_t* __restrict__ valid, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc, int H, int KV,
                  int Sc, int dh, float scale, float cap, int per, int copy) {
  using P = MmaPlan<DH, C>;
  const int G = H / KV, nrg = (G + kRows - 1) / kRows;
  const int rgi = blockIdx.x % nrg, bkv = blockIdx.x / nrg;
  const int b = bkv / KV, kv = bkv % KV;
  const int g0 = rgi * kRows, gb = min(kRows, G - g0);
  const int split = blockIdx.y, splits = gridDim.y;
  const int s_lo = split * per, s_hi = min(Sc, s_lo + per);
  const int nch = (s_hi - s_lo + kChunk - 1) / kChunk;  // <= kMaxChunks
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the mma fragments' row and column pair
  const int wg = warp / P::CW, ch = warp % P::CW;  // this warp's step of a round, its columns
  const int rowbytes = dh * (int)sizeof(C);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;  // NR rounds of WG steps: K rows, V rows (, K and V scales)
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(smem + P::RING);
  int* list_s = reinterpret_cast<int*>(bits_s + kMaxChunks);
  int* nlist_s = list_s + kMaxChunks;

  // K's head-dim padding is zero for good (q's is zero, and stale bytes
  // times zero could be NaN); copies write only the first rowbytes of a row
  for (int r = tid; r < P::NR * P::WG * kHalf; r += kThreads) {
    unsigned char* kr = ring + (r / kHalf) * P::STEP + (r % kHalf) * P::KSTR;
    for (int o = rowbytes; o < DH * (int)sizeof(C); ++o) kr[o] = 0;
  }
  // q's operand: rows gid and gid + 8 of the block (zero past gb); in k16
  // step t, thread tig holds head dims 16t + 4 tig .. + 3 (the same
  // permutation as K's operand below)
  uint32_t qa[P::KS][4];
  {
    const bf16* qb = q + ((size_t)b * H + (size_t)kv * G + g0) * dh;
    auto qbits = [&](int row, int d) -> uint32_t {
      return row < gb && d < dh ? (uint32_t)__bfloat16_as_ushort(qb[(size_t)row * dh + d]) : 0u;
    };
#pragma unroll
    for (int t = 0; t < P::KS; ++t) {
      const int d = 16 * t + 4 * tig;
      qa[t][0] = qbits(gid, d) | (qbits(gid, d + 1) << 16);
      qa[t][1] = qbits(gid + 8, d) | (qbits(gid + 8, d + 1) << 16);
      qa[t][2] = qbits(gid, d + 2) | (qbits(gid, d + 3) << 16);
      qa[t][3] = qbits(gid + 8, d + 2) | (qbits(gid + 8, d + 3) << 16);
    }
  }
  const int nneed = list_chunks(valid + (size_t)b * Sc, Sc, s_lo, s_hi, nch, bits_s, list_s,
                                nlist_s);
  const int nrounds = (nneed + P::RC - 1) / P::RC;

  const size_t slot = (size_t)KV * dh;  // elements between two cache slots
  const C* kb = k + (size_t)b * Sc * slot + (size_t)kv * dh;
  const C* vb = v + (size_t)b * Sc * slot + (size_t)kv * dh;
  const size_t sb = (size_t)b * Sc * KV + kv;  // scale of slot s: sb + s KV
  // a round's rows: WG steps x (K, V) blocks of 16 slot rows. 16-byte
  // pieces (.cg, to L2) go a row's pieces on consecutive lanes, 2^lsh lanes
  // a row, so a warp's copies are coalesced, two blocks a warp; smaller
  // pieces (.ca) go a row a thread, whose pieces L1 merges into the row's
  // lines (at h2o's int8 rows faster than the coalesced order)
  const int wbytes = copy ? copy : 1, npieces = rowbytes / wbytes;
  int lsh = 0;
  while (copy == 16 && (1 << lsh) < npieces && lsh < 5) ++lsh;
  const size_t slot_bytes = slot * sizeof(C);
  auto load_round = [&](int r, int st) {
    const int lanes = copy == 16 ? 1 << lsh : 1;  // lanes a row
    const int piece = lane & (lanes - 1);
    const int first = copy == 16 ? warp * (32 >> lsh) + (lane >> lsh) : tid;  // of the rows
    const int step = copy == 16 ? kWarps * (32 >> lsh) : kThreads;
    for (int rr = first; rr < P::WG * 2 * kHalf; rr += step) {
      const int hc = rr / (2 * kHalf), sel = (rr / kHalf) & 1, sl = rr % kHalf;
      const int ci = r * P::RC + hc / 2;
      if (ci >= nneed) continue;
      const int s = s_lo + kChunk * list_s[ci] + kHalf * (hc & 1) + sl;
      const bool in = s < s_hi;
      const size_t si = (size_t)(in ? s : s_lo);
      unsigned char* stp = ring + st * P::ROUND + hc * P::STEP;
      unsigned char* dst = stp + (sel ? kHalf * P::KSTR + sl * P::VSTR : sl * P::KSTR);
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(sel ? vb : kb) + si * slot_bytes;
      if (copy == 16)
        copy_pieces<16>(dst, src, piece, npieces, lanes, in);
      else if (copy == 8)
        copy_pieces<8>(dst, src, piece, npieces, lanes, in);
      else if (copy == 4)
        copy_pieces<4>(dst, src, piece, npieces, lanes, in);
      else  // rows not 4-byte aligned
        copy_pieces<1>(dst, src, piece, npieces, lanes, in);
      if constexpr (P::Q8) {
        if (piece == 0) {
          float* scs = reinterpret_cast<float*>(stp + kHalf * (P::KSTR + P::VSTR));
          cp_async<4>(smem_u32(scs + sel * kHalf + sl), (sel ? v_sc : k_sc) + sb + si * KV,
                      in ? 4 : 0);
        }
      }
    }
  };

  float o[P::NT][4];  // rows gid, gid + 8 of the warp's output columns
#pragma unroll
  for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};  // rows gid, gid + 8

#pragma unroll
  for (int i = 0; i < P::NR - 1; ++i) {
    if (i < nrounds) load_round(i, i);
    cp_async_commit();
  }
  for (int r = 0; r < nrounds; ++r) {
    cp_async_wait<P::NR - 2>();
    // round r has landed, and every warp is done with round r - 1's stage
    __syncthreads();
    if (r + P::NR - 1 < nrounds) load_round(r + P::NR - 1, (r + P::NR - 1) % P::NR);
    cp_async_commit();
    const int ci = r * P::RC + wg / 2;
    if (ci >= nneed) continue;  // no step for this warp in the last round
    const int c = list_s[ci], half = wg & 1;
    const unsigned char* ks = ring + (r % P::NR) * P::ROUND + wg * P::STEP;
    const unsigned char* vs = ks + kHalf * P::KSTR;
    const float* scs = reinterpret_cast<const float*>(vs + kHalf * P::VSTR);

    // S = q kᵀ over the step's 16 slots: n-tile j, slot 8j + gid in K's operand
    float sacc[2][4] = {};
    float ksc[2] = {0.0f, 0.0f};
    if constexpr (P::Q8) {
      ksc[0] = scs[gid];
      ksc[1] = scs[8 + gid];
    }
#pragma unroll
    for (int t = 0; t < P::KS; ++t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned char* kr = ks + (8 * j + gid) * P::KSTR;
        uint32_t b0, b1;
        if constexpr (P::Q8) {
          float f[4];
          dequant4(*reinterpret_cast<const uint32_t*>(kr + 16 * t + 4 * tig), ksc[j], f);
          b0 = pack_bf16(f[0], f[1]);
          b1 = pack_bf16(f[2], f[3]);
        } else {
          const uint2 kw = *reinterpret_cast<const uint2*>(kr + 2 * (16 * t + 4 * tig));
          b0 = kw.x;
          b1 = kw.y;
        }
        mma_bf16(sacc[j], qa[t], b0, b1);
      }
    }
    // scores at rows gid (e = 0, 1) and gid + 8 (e = 2, 3), slots 8j + 2 tig + (e & 1)
    const uint32_t bits = bits_s[c];
    float x[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = kHalf * half + 8 * j + 2 * tig + (e & 1);  // slot in the chunk
        const bool ok = (bits >> sl) & 1u;
        // past the split's end: no term; masked: the TPU kernel's finite -1e30
        float xv = s_lo + kChunk * c + sl < s_hi ? kNeg : -INFINITY;
        if (ok) {
          xv = sacc[j][e] * scale;
          if (cap > 0.0f) xv = tanhf(xv / cap) * cap;
        }
        x[j][e] = xv;
      }
    // the step's online softmax; a row's 16 scores lie in the 4 threads of a quad
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(x[0][2 * h], x[0][2 * h + 1]), fmaxf(x[1][2 * h], x[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = expf(x[j][e] - m[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = (p[0][2 * h] + p[0][2 * h + 1]) + (p[1][2 * h] + p[1][2 * h + 1]);
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l[h] = l[h] * alpha[h] + sum;
    }
    if (__any_sync(kFull, alpha[0] != 1.0f || alpha[1] != 1.0f)) {  // x * 1 is x
#pragma unroll
      for (int nt = 0; nt < P::NT; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }
    }
    // P as the A operand (the S accumulators' layout), a bf16 pair hi + lo
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (row gid | gid + 8) x (slots 2 tig | 8 + 2 tig)
      const float a0 = p[i >> 1][2 * (i & 1)], a1 = p[i >> 1][2 * (i & 1) + 1];
      ph[i] = pack_bf16(a0, a1);
      pl[i] = pack_bf16(a0 - __uint_as_float(ph[i] << 16),
                        a1 - __uint_as_float(ph[i] & 0xffff0000u));
    }
    // P.V: V's operand rows are slots 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9;
    // thread gid loads columns 4 gid .. + 3 of a 32-column group, one an n-tile
    const int kr4[4] = {2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9};
#pragma unroll
    for (int g4 = 0; g4 < P::NT / 4; ++g4) {
      const int col = ch * P::COLS + 32 * g4 + 4 * gid;
      uint32_t bq[4][2];
      if constexpr (P::Q8) {
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dequant4(*reinterpret_cast<const uint32_t*>(vs + kr4[i] * P::VSTR + col),
                   scs[kHalf + kr4[i]], f[i]);
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          bq[q4][0] = pack_bf16(f[0][q4], f[1][q4]);
          bq[q4][1] = pack_bf16(f[2][q4], f[3][q4]);
        }
      } else {  // columns 4 gid + 2h, + 1 of the 4 slots: the low halves, then the high
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t u[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            u[i] = *reinterpret_cast<const uint32_t*>(vs + kr4[i] * P::VSTR + 2 * col + 4 * h);
          bq[2 * h][0] = __byte_perm(u[0], u[1], 0x5410);
          bq[2 * h][1] = __byte_perm(u[2], u[3], 0x5410);
          bq[2 * h + 1][0] = __byte_perm(u[0], u[1], 0x7632);
          bq[2 * h + 1][1] = __byte_perm(u[2], u[3], 0x7632);
        }
      }
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        mma_bf16(o[4 * g4 + q4], ph, bq[q4][0], bq[q4][1]);
        mma_bf16(o[4 * g4 + q4], pl, bq[q4][0], bq[q4][1]);
      }
    }
  }

  // the warps' partials merged in step order: each warp's accumulators (n-tile
  // 4 g4 + q4, column pair 2 tig + e: column 32 g4 + 8 tig + 4 e + q4 of its
  // slice) and (m, l) through shared memory (the ring is free now)
  cp_async_wait<0>();
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(ring);     // [WG][kRows][DH]
  float* w_s = o_s + P::WG * kRows * DH;           // [WG][kRows] m, then the merge weight
  float* l_s = w_s + P::WG * kRows;                // [WG][kRows]
#pragma unroll
  for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = gid + 8 * (e >> 1);
      const int col = ch * P::COLS + 32 * (nt / 4) + 8 * tig + 4 * (e & 1) + nt % 4;
      o_s[(wg * kRows + row) * DH + col] = o[nt][e];
    }
  if (ch == 0 && tig == 0) {
    w_s[wg * kRows + gid] = m[0];
    w_s[wg * kRows + gid + 8] = m[1];
    l_s[wg * kRows + gid] = l[0];
    l_s[wg * kRows + gid + 8] = l[1];
  }
  __syncthreads();
  const size_t r0 = (size_t)b * H + (size_t)kv * G + g0;
  if (tid < gb) {
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < P::WG; ++w) mm = fmaxf(mm, w_s[w * kRows + tid]);
    float ll = 0.0f;
#pragma unroll
    for (int w = 0; w < P::WG; ++w) {
      const float wt = expf(w_s[w * kRows + tid] - mm);
      ll = fmaf(l_s[w * kRows + tid], wt, ll);
      w_s[w * kRows + tid] = wt;
    }
    part_m[(r0 + tid) * splits + split] = mm;
    part_l[(r0 + tid) * splits + split] = ll;
  }
  __syncthreads();
  for (int i = tid; i < gb * dh; i += kThreads) {
    const int g = i / dh, d = i - g * dh;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < P::WG; ++w)
      acc = fmaf(o_s[(w * kRows + g) * DH + d], w_s[w * kRows + g], acc);
    part_acc[((r0 + g) * splits + split) * dh + d] = acc;
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

// The split kernel `kern` with `bytes` of shared memory, then the merge.
template <typename T, typename K, typename Q, typename C>
int launch_pair(K kern, size_t bytes, const Q* q, const C* k, const C* v, const void* k_sc,
                const void* v_sc, const void* valid, void* out, void* scratch, int B, int H,
                int KV, int Sc, int dh, float scale, float cap, int splits, int per, int route,
                cudaStream_t stream) {
  const int G = H / KV, nrg = (G + kRows - 1) / kRows;
  const long long bx = (long long)B * KV * nrg;
  const size_t rows = (size_t)B * H;
  if (bx > 0x7fffffffLL || splits > kMaxSplits || rows > 0x7fffffffULL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* pm = (float*)scratch;
  float* pl = pm + rows * splits;
  float* pacc = pl + rows * splits;
  kern<<<dim3((unsigned)bx, splits), kThreads, bytes, stream>>>(
      q, k, v, (const float*)k_sc, (const float*)v_sc, (const uint8_t*)valid, pm, pl, pacc, H,
      KV, Sc, dh, scale, cap, per, route);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T><<<(unsigned)rows, kThreads, 2 * sizeof(float) * splits, stream>>>(
      pm, pl, pacc, (T*)out, splits, dh);
  return (int)cudaGetLastError();
}

// A float32 q: the CUDA-core kernel. `aligned`: whole 16-byte rows (int8:
// 4-byte groups) at aligned addresses.
template <int DH, typename C>
int launch_f32(const void* q, const void* k, const void* v, const void* k_sc, const void* v_sc,
               const void* valid, void* out, void* scratch, int B, int H, int KV, int Sc, int dh,
               float scale, float cap, int splits, int per, cudaStream_t stream) {
  using P = Plan<DH>;
  const int aligned = dh % P::VE == 0 &&
                      ((uintptr_t)k | (uintptr_t)v) % (P::VE * sizeof(C)) == 0;
  return launch_pair<float>(decode_split_kernel<DH, C>, P::BYTES, (const float*)q, (const C*)k,
                            (const C*)v, k_sc, v_sc, valid, out, scratch, B, H, KV, Sc, dh,
                            scale, cap, splits, per, aligned, stream);
}

// A bf16 q: the tensor-core kernel. `copy`: the widest cp.async (16, 8 or 4
// bytes) that a row's bytes and the caches' addresses allow, else 0.
template <int DH, typename C>
int launch_mma(const void* q, const void* k, const void* v, const void* k_sc, const void* v_sc,
               const void* valid, void* out, void* scratch, int B, int H, int KV, int Sc, int dh,
               float scale, float cap, int splits, int per, cudaStream_t stream) {
  const uintptr_t rowbytes = (uintptr_t)dh * sizeof(C), addr = (uintptr_t)k | (uintptr_t)v;
  const int widths[3] = {16, 8, 4};
  int copy = 0;
  for (int w : widths)
    if (copy == 0 && (rowbytes | addr) % w == 0) copy = w;
  return launch_pair<bf16>(decode_mma_kernel<DH, C>, MmaPlan<DH, C>::BYTES, (const bf16*)q,
                           (const C*)k, (const C*)v, k_sc, v_sc, valid, out, scratch, B, H, KV,
                           Sc, dh, scale, cap, splits, per, copy, stream);
}

// dtype 0: a float32 q (launch_f32), 1: bf16 (launch_mma); the head-dim
// bucket from dh.
template <typename CF, typename CB>
int launch_dh(int dtype, const void* q, const void* k, const void* v, const void* k_sc,
              const void* v_sc, const void* valid, void* out, void* scratch, int B, int H, int KV,
              int Sc, int dh, float scale, float cap, int splits, int per, cudaStream_t st) {
#define DECODE_ROUTE(DHB)                                                                        \
  if (dh <= DHB) {                                                                               \
    if (dtype == 0)                                                                              \
      return launch_f32<DHB, CF>(q, k, v, k_sc, v_sc, valid, out, scratch, B, H, KV, Sc, dh,     \
                                 scale, cap, splits, per, st);                                   \
    if (dtype == 1)                                                                              \
      return launch_mma<DHB, CB>(q, k, v, k_sc, v_sc, valid, out, scratch, B, H, KV, Sc, dh,     \
                                 scale, cap, splits, per, st);                                   \
    return (int)cudaErrorInvalidValue;                                                           \
  }
  DECODE_ROUTE(64)
  DECODE_ROUTE(128)
  DECODE_ROUTE(256)
#undef DECODE_ROUTE
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
  return launch_dh<float, bf16>(dtype, q, k, v, nullptr, nullptr, valid, out, scratch, B, H, KV,
                                Sc, dh, scale, cap, splits, per, (cudaStream_t)stream);
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
  return launch_dh<int8_t, int8_t>(dtype, q, k, v, k_scale, v_scale, valid, out, scratch, B, H,
                                   KV, Sc, dh, scale, cap, splits, per, (cudaStream_t)stream);
}
