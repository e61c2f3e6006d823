// Causal / sliding-window / chunk-local GQA prefill attention with an online
// softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (`_kernel`, a Pallas grid (B*H, S/bq, S/bk) whose third dimension walks
// the keys in order with (acc, m, l) in VMEM scratch):
//   out[b, h, i] = softmax_j(where(mask(i, j), cap(q[b, h, i] . k[b, h / G, j] / sqrt(dh)), -1e30))
//                  . v[b, h / G]
//   cap(s) = tanh(s / c) * c with the logit cap c > 0 (recurrentgemma's 50), else s
//   mask = (j <= i if causal) & (j // w == i // w if chunk_local, else j > i - w, if w > 0)
// q [B,H,S,dh], k [B,KV,Sk,dh], v [B,KV,Sk,dv] with dv <= dh (float32 or
// bfloat16, all one type) -> out [B,H,S,dv] in q's type. Sk == S except
// for cross-attention (no causal or window mask: an encoder-decoder's
// decoder tokens against the encoder's frames), which the CROSS variants
// take: queries run over S, key tiles over Sk, and each ragged edge is
// masked against its own length. dv < dh is MLA's
// prefill (minicpm3-4b: dh 96 = nope 64 + rope 32, dv 64): V's tile, the
// P·V product's N and the output's columns follow dv, so V is read as it is
// (padding it to dh in device memory would read 50% more V at that shape).
//
// Bound: 4·dh flops per unmasked (query, key) pair against 2·dh·(2H + 2KV)
// bytes a position, so at the serving path's prefill (B = 8, H = 24, KV = 8,
// S = 2048, dh = 128, causal, bf16) it does ~770 flops a byte: the tensor
// cores' rate bounds it (2·B·H·S²·dh = 2.06e11 flops, 0.21 ms at 989
// TFLOP/s bf16).
//
// Two kernels, chosen by dtype in flash_attention_launch:
//
// bfloat16 (every launch of the model path): `flash_wgmma_kernel`, both
// products on the tensor cores. One block of two warpgroups per (b·h, 128
// queries); each warpgroup owns 64 query rows, wgmma's M.
// - Shared memory holds the Q tile (loaded once) and a ring of two stages of
//   64-key K and V tiles. Loads are cp.async of 16 bytes issued by all 256
//   threads, so tile j+1 arrives while tile j is multiplied. cp.async, not
//   TMA: its src-size operand zero-fills the rows past S and the columns
//   past dh in shared memory (device memory is never padded) for every dh
//   that is a multiple of 8, and a head dim that is not (16-byte loads
//   would be misaligned) takes a plain-load path into the same layout; a
//   tensor map could do neither for all dh, and needs libcuda for its encoding.
// - Every tile is stored as panels of 64 head-dim columns, 128-byte rows
//   with the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)),
//   each panel 1024-byte aligned: wgmma's canonical SW128 layout. Q and K
//   are K-major operands (SBO = 1024 bytes between 8-row groups; a k16
//   step advances the start address by 32 bytes inside a panel). V is read
//   as the MN-major B operand (transpose bit set, which bf16 allows): the
//   same panels, SBO = 1024 bytes between 8-key groups, LBO = one panel.
//   A descriptor's high word (SBO, swizzle mode) is the same for all three,
//   an immediate of the instruction, so each descriptor costs one register.
// - Two blocks an SM at head dims up to 128 without the cap (128 registers
//   a thread, no spill): while one block's warpgroups run their softmax the
//   other's products keep the tensor cores busy. Capped and dh-256
//   variants take one. A variant for dv < dh (NARROW) holds dv in a
//   register of its own; the others use dh for it (dv == dh), so the
//   variants without MLA compile as they did before dv existed.
// - S = Q·Kᵀ is dh/16 wgmma.m64n64k16 (A and B from shared memory) into 32
//   float32 registers a thread. The online softmax runs on those fragments:
//   a thread holds two rows' 16 values each, and the four threads sharing a
//   row take its max with two shuffles; the row sum stays a per-thread
//   partial until the end. P is split in registers into two bf16 values,
//   hi + lo, each wgmma's A operand from registers for O += P·V (two
//   instructions a k16 step): the accumulator's fragment layout is the A
//   operand's, so no shuffle is needed. O is dh_pad/2 float32 registers a
//   thread (128 at dh 256).
// - The TPU kernel's block predicate gives the contiguous range of key
//   tiles a block needs; a warpgroup skips a tile its 64 rows do not need,
//   and only a tile that crosses the causal diagonal, a window or chunk edge
//   or S evaluates the per-element mask. Heaviest causal blocks first.
// - Head dims are padded to 64, 128 or 256 columns in shared memory only
//   (DP for Q and K, DPV for V, DPV <= DP); output is written for d < dv.
//   At dh = dv = 256 the block uses 193 KB of shared memory (Q 64 KB, two
//   K+V stages of 64 KB); at MLA's dh 96 / dv 64, 81 KB (Q 32 KB, K 16 KB
//   and V 8 KB a stage), and O is 32 registers a thread instead of 64.
// - Numerics: scores, softmax state and O are float32. P enters P·V as
//   hi + lo (hi = bf16(p), lo = bf16(p - hi)): about 16 bits of P, close to
//   the TPU kernel's and the plain version's float32 P. P rounded to one
//   bf16 (as the reference model's `p.astype(vs.dtype)` does,
//   src/repro/models/attention.py:98) saved one wgmma a k16 step but moved
//   the 2-layer llama3.2-3b logits GPU vs CPU past 0.05 absolute.
//   Exponentials are exp2f((x - m) * log2(e)) (the difference first, so a
//   fully masked row's exp(-1e30 - (-1e30)) is exactly 1, as in the TPU
//   kernel); the cap is the accurate tanhf, never tanh.approx (the cap
//   multiplies its error by 50).
//
// float32 (the checks of chip_smoke.py only; TF32 tensor cores keep ~3
// digits, short of the 2e-5 those checks hold): `flash_kernel`, on the CUDA
// cores in float32, unchanged since it was written. One block of 128 threads
// per (b·h, block of 64 queries; 32 for dh > 128) loops over blocks of 64
// keys inside the block: the loop replaces the Pallas grid's sequential
// third dimension, and the running (m, l) and the output accumulator stay in
// registers across it. A thread owns RQ query rows x 8 key columns of each
// score tile and RQ rows x dh/8 output columns; the 8 threads that share a
// row sit in one warp and reduce its max and sum with shuffles. Tiles are
// staged in shared memory with an odd word stride, so the threads of a warp
// reading different rows hit different banks. The logit cap is a template
// flag: the uncapped variant is the plain kernel (a per-score `cap > 0 ?`
// select cost 9% at llama's prefill).
//
// Both: under a gradient the wrapper passes a float32 [B,H,S] buffer and the
// epilogue writes each row's log-sum-exp m + log(l) there, which the
// backward (csrc/flash_attention_bwd.cu) forms P from; without one (null)
// nothing else changes. Masked scores are the finite -1e30 of the TPU
// kernel, never -inf: a
// row whose first needed tile is all masked adds exp(0) = 1 terms that the
// next real key wipes out through alpha = exp(-1e30 - m_new) = 0, where -inf
// would give NaN. Keys past the end of the sequence are -inf (no term). The
// library is built with -fmad=false: products use fmaf explicitly.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kBK = 64;        // keys per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Row stride (elements) of a Q/K tile: an odd number of 4-byte words.
template <typename T>
__host__ __device__ int tile_stride(int dh) {
  return dh + 4 / (int)sizeof(T);
}

// The TPU kernel's block predicate (flash_attention.py:55-64): does a block
// of bq queries from q0 need the bk keys from k0?
__device__ __forceinline__ bool tile_needed(int q0, int bq, int k0, int bk, int causal,
                                            int window, int chunk_local) {
  bool need = true;
  if (causal) need = k0 <= q0 + bq - 1;
  if (window > 0 && !chunk_local) need = need && (k0 + bk - 1 > q0 - window);
  if (window > 0 && chunk_local) {
    need = need && ((k0 + bk - 1) / window >= q0 / window);
    need = need && (k0 / window <= (q0 + bq - 1) / window);
  }
  return need;
}

template <typename T, int BQ>
size_t smem_bytes(int dh, int dv) {
  const int ts = tile_stride<T>(dh);
  return sizeof(T) * ((size_t)BQ * ts + (size_t)kBK * ts + (size_t)kBK * dv) +
         sizeof(float) * (size_t)BQ * (kBK + 1);
}

template <typename T, int BQ, int DMAX, bool CAP, bool NARROW, bool CROSS>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, float* __restrict__ lse, int H, int KV, int S, int Sk_arg,
             int dh, int dv_arg, float scale, float cap, int causal, int window,
             int chunk_local) {
  const int dv = NARROW ? dv_arg : dh;  // one live register fewer where dv == dh
  const int Sk = CROSS ? Sk_arg : S;    // keys: the queries' S unless CROSS
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int ND = DMAX / 8;  // output columns per thread
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - blockIdx.x % nq;  // heaviest causal blocks first
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qi * BQ;
  const int ts = tile_stride<T>(dh);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BQ][ts]
  T* k_s = q_s + BQ * ts;                   // [64][ts]
  T* v_s = k_s + kBK * ts;                  // [64][dv]
  float* p_s = reinterpret_cast<float*>(v_s + kBK * dv);  // [BQ][65]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const T* qb = q + (size_t)bh * S * dh;
  const T* kb = k + (size_t)(b * KV + kvh) * Sk * dh;
  const T* vb = v + (size_t)(b * KV + kvh) * Sk * dv;

  for (int i = tid; i < BQ * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    q_s[r * ts + d] = q0 + r < S ? qb[(size_t)(q0 + r) * dh + d] : T(0.0f);
  }

  float m[RQ], l[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    if (!tile_needed(q0, BQ, k0, kBK, causal, window, chunk_local)) continue;
    __syncthreads();  // the previous block's readers are done with k_s, v_s, p_s
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      k_s[r * ts + d] = k0 + r < Sk ? kb[(size_t)(k0 + r) * dh + d] : T(0.0f);
    }
    for (int i = tid; i < kBK * dv; i += kThreads) {
      const int r = i / dv, d = i - r * dv;
      v_s[r * dv + d] = k0 + r < Sk ? vb[(size_t)(k0 + r) * dv + d] : T(0.0f);
    }
    __syncthreads();

    float s[RQ][8];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    // NARROW (dv < dh, float32 checks only) holds dv as well: a shorter
    // unroll keeps it in registers
#pragma unroll(NARROW ? 2 : 4)
    for (int d = 0; d < dh; ++d) {
      float kx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kx[j] = to_f32(k_s[(tx + 8 * j) * ts + d]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float qx = to_f32(q_s[(ty * RQ + i) * ts + d]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qx, kx[j], s[i][j]);
      }
    }

    if (CAP) {  // the scaled scores, capped: tanh(s / cap) * cap
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = tanhf(s[i][j] * scale / cap) * cap;
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        float x = -INFINITY;  // past the end of the keys: no term
        if (kp < Sk) {
          bool ok = true;
          if (causal) ok = kp <= qp;
          if (window > 0) {
            if (chunk_local) ok = ok && (kp / window == qp / window);
            else ok = ok && (kp > qp - window);
          }
          x = ok ? (CAP ? s[i][j] : s[i][j] * scale) : kNeg;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty * RQ + i) * (kBK + 1) + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float vx[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = tx + 8 * j;
        vx[j] = d < dv ? to_f32(v_s[kk * dv + d]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = p_s[(ty * RQ + i) * (kBK + 1) + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(p, vx[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    if (qp >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * S + qp] = m[i] + logf(l[i]);
    T* orow = out + ((size_t)bh * S + qp) * dv;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 8 * j;
      if (d < dv) store(orow + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int BQ, int DMAX, bool CROSS>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
           int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal, int window,
           int chunk_local, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BQ>(dh, dv);
  auto kern = dv == dh ? (cap > 0.0f ? flash_kernel<T, BQ, DMAX, true, false, CROSS>
                                     : flash_kernel<T, BQ, DMAX, false, false, CROSS>)
                       : (cap > 0.0f ? flash_kernel<T, BQ, DMAX, true, true, CROSS>
                                     : flash_kernel<T, BQ, DMAX, false, true, CROSS>);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((S + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                     (T*)out, lse, H, KV, S, Sk, dh, dv, scale,
                                                     cap, causal, window, chunk_local);
  return (int)cudaGetLastError();
}

template <bool CROSS>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
               int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal,
               int window, int chunk_local, cudaStream_t st) {
  if (dh <= 64)
    return launch<float, 64, 64, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap,
                                        causal, window, chunk_local, st);
  if (dh <= 128)
    return launch<float, 64, 128, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap,
                                         causal, window, chunk_local, st);
  if (dh <= 256)
    return launch<float, 32, 256, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap,
                                         causal, window, chunk_local, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;     // queries a block: two warpgroups of 64 rows
constexpr int kWgBK = 64;      // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DP, int DPV>
constexpr size_t wg_smem_bytes() {
  // Q, then two stages of K and V; 1 KB to align the base to 1024 bytes
  return (size_t)2 * (DP * kWgBQ + 2 * kWgBK * (DP + DPV)) + 1024;
}

// two blocks an SM where the registers allow it (note at the top); a
// NARROW variant (dv < dh) with as many V panels as Q/K panels holds dv in
// one more register than 128 leave, so it takes one, and so does a CROSS
// variant (Sk of its own) with 128 V columns (64 registers of O)
template <int DP, int DPV, bool NARROW, bool CAP, bool CROSS>
constexpr int wg_min_blocks() {
  return DP <= 128 && !CAP && !(NARROW && DPV == DP) && !(CROSS && DPV == 128) ? 2 : 1;
}

template <int DP, int DPV, bool NARROW, bool CAP, bool CROSS>
__global__ void __launch_bounds__(kWgThreads, (wg_min_blocks<DP, DPV, NARROW, CAP, CROSS>()))
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                   int H, int KV, int S, int Sk_arg, int dh, int dv_arg, float scale, float cap,
                   int causal, int window, int chunk_local, int aligned) {
  const int dv = NARROW ? dv_arg : dh;  // not NARROW: dv == dh, no register of its own
  const int Sk = CROSS ? Sk_arg : S;    // keys: the queries' S unless CROSS
  constexpr int NP = DP / 64;                    // 64-column panels of Q and K
  constexpr int NPV = DPV / 64;                  // of V and O
  constexpr int Q_BYTES = NP * kWgBQ * 128;
  constexpr int T_BYTES = NP * kWgBK * 128;      // one K tile
  constexpr int V_BYTES = NPV * kWgBK * 128;     // one V tile
  constexpr int STAGE = T_BYTES + V_BYTES;
  constexpr uint32_t PANEL_Q = kWgBQ * 128, PANEL_KV = kWgBK * 128;
  const int nq = (S + kWgBQ - 1) / kWgBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - blockIdx.x % nq;  // heaviest causal blocks first
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qi * kWgBQ;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int qw = q0 + 64 * wg;  // this warpgroup's first row

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* kv_s = base + Q_BYTES;  // stage st: K at kv_s + st STAGE, V after it

  const bf16* qb = q + (size_t)bh * S * dh;
  const bf16* kb = k + (size_t)(b * KV + kvh) * Sk * dh;
  const bf16* vb = v + (size_t)(b * KV + kvh) * Sk * dv;

  // the key tiles the block needs: a contiguous range for these masks
  const int nk = (Sk + kWgBK - 1) / kWgBK;
  int t_lo = 0, t_hi = nk;
  while (t_lo < t_hi &&
         !tile_needed(q0, kWgBQ, t_lo * kWgBK, kWgBK, causal, window, chunk_local))
    ++t_lo;
  while (t_hi > t_lo &&
         !tile_needed(q0, kWgBQ, (t_hi - 1) * kWgBK, kWgBK, causal, window, chunk_local))
    --t_hi;

  const bool al = aligned != 0;
  load_tile<kWgBQ, DP>(q_s, qb, q0, S, dh, al, tid);
  if (t_lo < t_hi) {
    load_tile<kWgBK, DP>(kv_s, kb, t_lo * kWgBK, Sk, dh, al, tid);
    load_tile<kWgBK, DPV>(kv_s + T_BYTES, vb, t_lo * kWgBK, Sk, dv, al, tid);
  }
  cp_async_commit();

  float o[NPV][32];
#pragma unroll
  for (int p = 0; p < NPV; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  // a thread holds rows ra and ra + 8 of its warpgroup's 64
  const int ra = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  const uint32_t q_addr = smem_u32(q_s) + 64 * 128 * wg;

  for (int j = t_lo; j < t_hi; ++j) {
    const int st = (j - t_lo) & 1;
    if (j + 1 < t_hi) {  // the next tile into the other stage
      unsigned char* nxt = kv_s + (st ^ 1) * STAGE;
      load_tile<kWgBK, DP>(nxt, kb, (j + 1) * kWgBK, Sk, dh, al, tid);
      load_tile<kWgBK, DPV>(nxt + T_BYTES, vb, (j + 1) * kWgBK, Sk, dv, al, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q and tile j have landed
    fence_proxy_async();
    __syncthreads();

    const int k0 = j * kWgBK;
    if (qw < S && tile_needed(qw, 64, k0, kWgBK, causal, window, chunk_local)) {
      const uint32_t k_addr = smem_u32(kv_s + st * STAGE);
      const uint32_t v_addr = k_addr + T_BYTES;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      fence_regs(s);
      wg_fence();
      // K-major: LBO unused (16 bytes); a k16 step is 32 bytes into a panel
      const uint32_t qd = desc_lo(q_addr, 16), kd = desc_lo(k_addr, 16);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t qoff = ((kk >> 2) * PANEL_Q + (kk & 3) * 32) >> 4;
        const uint32_t koff = ((kk >> 2) * PANEL_KV + (kk & 3) * 32) >> 4;
        wgmma_ss(s, qd + qoff, kd + koff, kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(s);

      // the scaled (capped) scores, masked on a tile that crosses an edge
      const int k1 = k0 + kWgBK - 1, qe = qw + 63;
      bool interior = k1 < Sk && (!causal || k1 <= qw);
      if (window > 0)
        interior = interior && (chunk_local ? (k0 / window == k1 / window &&
                                               qw / window == qe / window &&
                                               k0 / window == qw / window)
                                            : k0 > qe - window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = CAP ? tanhf(s[i] * scale / cap) * cap : s[i] * scale;
        if (!interior) {
          const int qp = qw + ra + ((i & 2) ? 8 : 0);
          const int kp = k0 + 8 * (i >> 2) + cq + (i & 1);
          bool ok = true;
          if (causal) ok = kp <= qp;
          if (window > 0) {
            if (chunk_local) ok = ok && (kp / window == qp / window);
            else ok = ok && (kp > qp - window);
          }
          x = kp >= Sk ? -INFINITY : (ok ? x : kNeg);
        }
        s[i] = x;
      }

      // online softmax on the fragments: s[4j + 0/1] row ra, s[4j + 2/3] row ra + 8
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f((m0 - mn0) * kLog2e), alpha1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[4 * jj] = exp2f((s[4 * jj] - mn0) * kLog2e);
        s[4 * jj + 1] = exp2f((s[4 * jj + 1] - mn0) * kLog2e);
        s[4 * jj + 2] = exp2f((s[4 * jj + 2] - mn1) * kLog2e);
        s[4 * jj + 3] = exp2f((s[4 * jj + 3] - mn1) * kLog2e);
        sum0 += s[4 * jj] + s[4 * jj + 1];
        sum1 += s[4 * jj + 2] + s[4 * jj + 3];
      }
      l0 = l0 * alpha0 + sum0;  // a partial over this thread's columns
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int p = 0; p < NPV; ++p) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[p][4 * jj] *= alpha0;
          o[p][4 * jj + 1] *= alpha0;
          o[p][4 * jj + 2] *= alpha1;
          o[p][4 * jj + 3] *= alpha1;
        }
      }

      // P as bf16 pairs hi + lo in wgmma's A fragments: k step kk covers
      // keys 16 kk .. 16 kk + 15
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], a_hi[kk][e], a_lo[kk][e]);
      // MN-major V: LBO = one 64-column panel (kWgBK rows of 128 bytes)
      const uint32_t vd = desc_lo(v_addr, PANEL_KV);
#pragma unroll
      for (int p = 0; p < NPV; ++p) fence_regs(o[p]);
      wg_fence();
#pragma unroll
      for (int p = 0; p < NPV; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t vk = vd + ((p * PANEL_KV + kk * 16 * 128) >> 4);
          wgmma_rs(o[p], a_hi[kk], vk);
          wgmma_rs(o[p], a_lo[kk], vk);
        }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int p = 0; p < NPV; ++p) fence_regs(o[p]);
    }
    __syncthreads();  // every reader is done with stage st before it is refilled
  }

  // the row sums over the four threads that share a row
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = qw + ra + 8 * half;
    if (qp >= S) continue;
    const float inv = half ? inv1 : inv0;
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * S + qp] = half ? m1 + logf(l1) : m0 + logf(l0);
    bf16* orow = out + ((size_t)bh * S + qp) * dv;
#pragma unroll
    for (int p = 0; p < NPV; ++p) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = 64 * p + 8 * jj + cq;
        const float x0 = o[p][4 * jj + 2 * half] * inv, x1 = o[p][4 * jj + 2 * half + 1] * inv;
        if (d + 1 < dv && (dv & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < dv) orow[d] = __float2bfloat16_rn(x0);
          if (d + 1 < dv) orow[d + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

template <int DP, int DPV, bool NARROW, bool CROSS>
int launch_wg(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
              int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal,
              int window, int chunk_local, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<DP, DPV>();
  auto kern = cap > 0.0f ? flash_wgmma_kernel<DP, DPV, NARROW, true, CROSS>
                         : flash_wgmma_kernel<DP, DPV, NARROW, false, CROSS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((S + kWgBQ - 1) / kWgBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int aligned = dh % 8 == 0 && dv % 8 == 0 &&
                      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  kern<<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, lse, H, KV, S, Sk, dh, dv,
      scale, cap, causal, window, chunk_local, aligned);
  return (int)cudaGetLastError();
}

// V's panels by dv, at most Q/K's DP; dv == dh takes the variant without dv
template <int DP, bool CROSS>
int launch_dp(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
              int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal,
              int window, int chunk_local, cudaStream_t st) {
  if (dv == dh)
    return launch_wg<DP, DP, false, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap,
                                           causal, window, chunk_local, st);
  if (dv <= 64)
    return launch_wg<DP, 64, true, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap,
                                          causal, window, chunk_local, st);
  if constexpr (DP >= 128) {
    if (dv <= 128)
      return launch_wg<DP, 128, true, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap,
                                             causal, window, chunk_local, st);
  }
  if constexpr (DP >= 256) {
    if (dv <= 256)
      return launch_wg<DP, 256, true, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap,
                                             causal, window, chunk_local, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool CROSS>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
                int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal,
                int window, int chunk_local, cudaStream_t st) {
  if (dh <= 64)
    return launch_dp<64, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap, causal,
                                window, chunk_local, st);
  if (dh <= 128)
    return launch_dp<128, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap, causal,
                                 window, chunk_local, st);
  if (dh <= 256)
    return launch_dp<256, CROSS>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap, causal,
                                 window, chunk_local, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); cap <= 0:
// no logit cap; lse_out: null, or a float32 [B,H,S] that receives each
// row's log-sum-exp m + log(l) of the masked scores (the backward's P); dv: V's head dim, 0 < dv <= dh; S queries against Sk keys,
// Sk != S only without the causal and window masks (cross-attention), where
// the CROSS variants take the key count as an argument of its own. Shapes
// are checked by the Python wrapper.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse_out, int B, int H, int KV, int S, int Sk, int dh,
                                      int dv, float scale, float cap, int causal, int window,
                                      int chunk_local, int dtype, void* stream) {
  if (B == 0 || H == 0 || S == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || dh <= 0 || dv <= 0 || dv > dh || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const bool cross = Sk != S;
  if (cross && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 0)
    return cross ? launch_f32<true>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap, causal,
                                    window, chunk_local, st)
                 : launch_f32<false>(q, k, v, out, lse, B, H, KV, S, S, dh, dv, scale, cap, causal,
                                     window, chunk_local, st);
  if (dtype == 1)
    return cross ? launch_bf16<true>(q, k, v, out, lse, B, H, KV, S, Sk, dh, dv, scale, cap, causal,
                                     window, chunk_local, st)
                 : launch_bf16<false>(q, k, v, out, lse, B, H, KV, S, S, dh, dv, scale, cap, causal,
                                      window, chunk_local, st);
  return (int)cudaErrorInvalidValue;
}
