// The backward of the causal / sliding-window / chunk-local GQA prefill
// attention (csrc/flash_attention.cu), for Hopper (sm_90a).
//
// Replaces the gradient that the reference computes by autodiff through its
// plain `chunked_attention` (src/repro/models/attention.py:36; jax.value_and_grad
// at src/repro/models/model.py:46): the TPU kernel it stands beside,
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention, has no
// backward, since src/repro has no custom_vjp. The forward's function is
//   s[i, j] = cap(q_i . k_j * scale), cap(x) = tanh(x / c) * c (c > 0) or x
//   P = softmax_j(where(mask(i, j), s, -1e30)),  O = P . V
// and, with dO given and lse the row log-sum-exp of the masked scores, which
// the forward kernel writes beside O when it runs under a gradient,
//   P[i, j] = exp(s[i, j] - lse[i]) where mask(i, j), else 0
//   D[i]    = rowsum(dO ∘ O)[i]                  (= rowsum(P ∘ dP))
//   dV      = Pᵀ · dO
//   dP      = dO · Vᵀ
//   dS      = P ∘ (dP - D), times (1 - tanh²) under the cap
//   dQ      = dS · K · scale,   dK = dSᵀ · Q · scale
// summed over the G query heads of a KV head for dK and dV. q [B,H,S,dh],
// k [B,KV,Sk,dh], v [B,KV,Sk,dv], o and dO [B,H,S,dv] (dv <= dh; Sk != S only
// without the causal and window masks: cross-attention), all float32 or all
// bfloat16, and lse float32 [B,H,S]; dq, dk, dv in that type, every sum in
// float32.
//
// flash_attention_bwd_launch runs, on the caller's stream:
// 0. `bwd_delta_kernel`, one warp a row: D into a float32 [B,H,S] slice of
//    the workspace (a bandwidth pass; S is never recomputed for lse).
// then one of two routes, by dtype:
//
// bfloat16 (every call of the training path), on wgmma (wgmma.cuh): a dK /
// dV kernel and a dQ kernel that recomputes S and dP (rather than summing
// dQ across key tiles through device memory), seven products a (64-query,
// 64-key) tile pair (Sᵀ, dPᵀ, dV, dK; S, dP, dQ), no atomics: every output
// element is summed by one thread in a fixed order, so two calls give the
// same bits. Blocks are two
// warpgroups; K / V or Q / dO stay in shared memory as 128-byte-swizzled
// 64-column panels while the other side's 64-row tiles (and their lse / D
// rows) arrive through a two-stage cp.async ring, issued one tile ahead. P
// and dS enter the dV / dK / dQ products as bf16 A fragments from registers
// (the accumulator's layout is the A operand's), as FA2 rounds them; every
// sum stays float32. Exponentials are ex2.approx on a fused exponent, the
// cap's tanh is 1 - 2 / (exp(2x) + 1) (~1e-7 of tanhf); a pair that the
// mask leaves whole skips the per-element mask (`tile_full`); blocks are
// numbered heaviest first. Two shapes, by head dim:
// - dh <= 128, the pair kernels: a warpgroup owns 64 rows and both of their
//   accumulators (dK and dV: 128 registers a thread at dh 128).
//   `bwd_dkdv_pair_kernel`, one block per (b·kv head, 128 keys, split of
//   the G query heads), reads each needed (query head, 64-query) item's Q
//   and dO once for its two warpgroups; a warpgroup issues Sᵀ = K·Qᵀ and
//   dPᵀ = V·dOᵀ together, forms P (from the forward's lse) while dPᵀ runs,
//   issues dV += Pᵀ·dO, forms dSᵀ = P ∘ (dPᵀ - D) while dV runs, then
//   dK += dSᵀ·Q. `bwd_dq_pair_kernel`, one block per (b·h, 128 queries),
//   the same for S = Q·Kᵀ, dP = dO·Vᵀ and dQ += dS·K over the needed key
//   tiles. The warpgroups never wait for each other inside an item.
// - dh 256 (recurrentgemma-9b), the split kernels: a 64 x 256 float32
//   accumulator takes 128 registers a thread, so dK and dV go to separate
//   warpgroups of one 64-key block (`bwd_dkdv_wgmma_kernel`): warpgroup 0
//   forms Sᵀ and P (to shared memory as float32) and accumulates dV,
//   warpgroup 1 forms dPᵀ and, once P is there, dSᵀ and accumulates dK; S,
//   P and dS are formed once a pair. `bwd_dq_wgmma_kernel` (per b·h, 64
//   queries): warpgroup 0 forms P, warpgroup 1 dP and dS, handed back as
//   bf16 A fragments through shared memory, and dQ's four 64-column panels
//   are split two and two.
// The dK / dV blocks split a KV head's G query heads when B·KV·(Sk / keys a
// block) would leave fewer than 256 blocks (recurrentgemma's MQA: 64 blocks
// of 16 heads become 256 of four): each split writes float32 dK / dV
// partials to the workspace and `bwd_sum_kernel` adds them in split order
// and rounds to bf16. Head dims are padded to 64, 128 or 256 columns in
// shared memory only (V and dO to Q / K's: dv < dh is MLA's narrow V, off
// the timed path), zero past dh and dv; S and Sk are taken as they are, the
// ragged edges masked. No branch sits between a wgmma stage's fence and
// commit, and branches around stages test the warp-uniform `warpgroup()`:
// ptxas would otherwise serialize every wgmma of the kernel (C7520).
//
// float32 (chip_smoke.py's 1e-4 checks; TF32 would keep ~3 digits): on the
// CUDA cores, kernels 2-3 below: `bwd_dkdv_kernel` (per (b·kv head, 32-key
// tile), walking the G query heads and their needed 64-query tiles,
// recomputing P and dS, dK / dV in registers) and `bwd_dq_kernel` (per
// (b·h, query tile)). Tiles are staged as the type they are in device
// memory with a row stride of an odd number of 4-byte words; 16 row groups x
// 8 column lanes, the eight lanes of a row reducing with shuffles.
//
// Bound: 2·(3·dh + 2·dv) flops per unmasked (query, key) pair of a head
// (five products: P's recompute, dP, dV, dQ, dK) against the tensors' bytes;
// at llama3.2-3b's training shape ([2, 2048, 24/8, 128], causal, bf16) ~1.3e11
// flops to ~134 MB: the tensor cores' rate bounds it (0.13 ms at 989
// TFLOP/s); at recurrentgemma-9b's ([2, 2048, 16/1, 256], window 2048, cap
// 50) 1.72e11 flops, 0.174 ms. The bf16 route does seven products, S and dP
// twice; what holds it back from the bound (PERF.md): one block of eight
// warps an SM, so the per-element softmax and the per-item barriers expose
// their latency, and at dh 256 the two warpgroups' elementwise phases run
// one after the other.
//
// Built with -fmad=false like every kernel of the port: products use fmaf.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"  // the swizzled tiles, descriptors, cp.async and wgmma

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kBK = 64;        // keys a tile in kernel 3
constexpr int kBKV = 32;       // keys a block in kernel 2
constexpr int kBQ2 = 64;       // queries a tile in kernel 2

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Row stride (elements) of a staged tile: an odd number of 4-byte words for
// every even d.
template <typename T>
__host__ __device__ int row_stride(int d) {
  return d + 4 / (int)sizeof(T);
}

// The forward's block predicate: does a block of bq queries from q0 need
// the bk keys from k0?
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

__device__ __forceinline__ bool allowed(int qp, int kp, int causal, int window,
                                        int chunk_local) {
  bool ok = true;
  if (causal) ok = kp <= qp;
  if (window > 0) {
    if (chunk_local) ok = ok && (kp / window == qp / window);
    else ok = ok && (kp > qp - window);
  }
  return ok;
}

// Kernel 0: D = rowsum(dO ∘ O), one warp a row, its lanes over the columns.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 long long rows, int dv) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // the whole warp
  const T* orow = o + r * dv;
  const T* grow = dout + r * dv;
  float acc = 0.0f;
  for (int d = lane; d < dv; d += 32) acc = fmaf(ld(orow + d), ld(grow + d), acc);
#pragma unroll
  for (int w = 1; w < 32; w <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[r] = acc;
}

// A tile of `rows` rows of d elements from row r0 of src (n rows in all)
// into dst with row stride ts; rows past n are zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int r0, int rows, int n, int d,
                                           int ts) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    dst[r * ts + c] = r0 + r < n ? src[(size_t)(r0 + r) * d + c] : T(0.0f);
  }
}

// Kernel 2 (float32): dK and dV of kBKV keys of one KV head, over its G
// query heads.
template <typename T, int DMAX, bool CAP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dvo, int H,
                int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal,
                int window, int chunk_local) {
  constexpr int RK = kBKV / 16;  // key rows per thread
  constexpr int ND = DMAX / 8;   // dK / dV columns per thread
  constexpr int PS = kBQ2 + 1;   // row stride of the P and dS tiles
  const int nk = (Sk + kBKV - 1) / kBKV;
  const int bkv = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * kBKV;  // the first key tiles need the most queries
  const int b = bkv / KV, kvh = bkv % KV;
  const int G = H / KV;
  const int ts = row_stride<T>(dh), tv = row_stride<T>(dv);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* p_s = reinterpret_cast<float*>(smem_raw);  // [kBKV][PS]
  float* ds_s = p_s + kBKV * PS;                     // [kBKV][PS]
  float* lse_s = ds_s + kBKV * PS;                   // [kBQ2]
  float* dl_s = lse_s + kBQ2;                        // [kBQ2]
  T* k_s = reinterpret_cast<T*>(dl_s + kBQ2);        // [kBKV][ts]
  T* v_s = k_s + kBKV * ts;                          // [kBKV][tv]
  T* q_s = v_s + kBKV * tv;                          // [kBQ2][ts]
  T* do_s = q_s + kBQ2 * ts;                         // [kBQ2][tv]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  stage_tile(k_s, k + (size_t)bkv * Sk * dh, k0, kBKV, Sk, dh, ts);
  stage_tile(v_s, v + (size_t)bkv * Sk * dv, k0, kBKV, Sk, dv, tv);

  float adk[RK][ND], adv[RK][ND];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) adk[i][j] = adv[i][j] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int bh = b * H + kvh * G + g;
    for (int q0 = 0; q0 < S; q0 += kBQ2) {
      if (!tile_needed(q0, kBQ2, k0, kBKV, causal, window, chunk_local)) continue;
      __syncthreads();  // the previous tile's readers are done with the tiles
      stage_tile(q_s, q + (size_t)bh * S * dh, q0, kBQ2, S, dh, ts);
      stage_tile(do_s, dout + (size_t)bh * S * dv, q0, kBQ2, S, dv, tv);
      for (int r = tid; r < kBQ2; r += kThreads) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse[(size_t)bh * S + q0 + r] : 0.0f;
        dl_s[r] = in ? delta[(size_t)bh * S + q0 + r] : 0.0f;
      }
      __syncthreads();

      // sᵀ: key rows ty * RK + i, query columns tx + 8 j
      float s[RK][8], t[RK][8];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < dh; ++d) {
        float qx[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) qx[j] = ld(q_s + (tx + 8 * j) * ts + d);
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const float kx = ld(k_s + (ty * RK + i) * ts + d);
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(kx, qx[j], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int kp = k0 + ty * RK + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qc = tx + 8 * j, qp = q0 + qc;
          float p = 0.0f;
          t[i][j] = 0.0f;
          if (kp < Sk && qp < S && allowed(qp, kp, causal, window, chunk_local)) {
            float x;
            if (CAP) {
              t[i][j] = tanhf(s[i][j] * scale / cap);
              x = t[i][j] * cap;
            } else {
              x = s[i][j] * scale;
            }
            p = expf(x - lse_s[qc]);
          }
          s[i][j] = p;
          p_s[(ty * RK + i) * PS + qc] = p;
        }
      }
      // dPᵀ = V · dOᵀ, then dSᵀ
      float dp[RK][8];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < dv; ++d) {
        float gx[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) gx[j] = ld(do_s + (tx + 8 * j) * tv + d);
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const float vx = ld(v_s + (ty * RK + i) * tv + d);
#pragma unroll
          for (int j = 0; j < 8; ++j) dp[i][j] = fmaf(vx, gx[j], dp[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qc = tx + 8 * j;
          float ds = s[i][j] * (dp[i][j] - dl_s[qc]);
          if (CAP) ds = ds * (1.0f - t[i][j] * t[i][j]);
          ds_s[(ty * RK + i) * PS + qc] = ds;
        }
      __syncthreads();

      // dV += Pᵀ · dO, dK += dSᵀ · Q over the tile's queries
#pragma unroll 2
      for (int qq = 0; qq < kBQ2; ++qq) {
        float gx[ND], qx[ND];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int d = tx + 8 * j;
          gx[j] = d < dv ? ld(do_s + qq * tv + d) : 0.0f;
          qx[j] = d < dh ? ld(q_s + qq * ts + d) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const float pv = p_s[(ty * RK + i) * PS + qq];
          const float dsv = ds_s[(ty * RK + i) * PS + qq];
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            adv[i][j] = fmaf(pv, gx[j], adv[i][j]);
            adk[i][j] = fmaf(dsv, qx[j], adk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kp = k0 + ty * RK + i;
    if (kp >= Sk) continue;
    T* krow = dk + ((size_t)bkv * Sk + kp) * dh;
    T* vrow = dvo + ((size_t)bkv * Sk + kp) * dv;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 8 * j;
      if (d < dh) st(krow + d, adk[i][j] * scale);
      if (d < dv) st(vrow + d, adv[i][j]);
    }
  }
}

// Kernel 3 (float32): dQ of BQ query rows of one head.
template <typename T, int BQ, int DMAX, bool CAP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H, int KV, int S, int Sk,
              int dh, int dv, float scale, float cap, int causal, int window, int chunk_local) {
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int ND = DMAX / 8;  // dQ columns per thread
  constexpr int PS = kBK + 1;   // row stride of the dS tile
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;  // heaviest causal blocks first
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int ts = row_stride<T>(dh), tv = row_stride<T>(dv);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ds_s = reinterpret_cast<float*>(smem_raw);  // [BQ][PS]
  T* q_s = reinterpret_cast<T*>(ds_s + BQ * PS);     // [BQ][ts]
  T* do_s = q_s + BQ * ts;                           // [BQ][tv]
  T* k_s = do_s + BQ * tv;                           // [64][ts]
  T* v_s = k_s + kBK * ts;                           // [64][tv]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const T* kb = k + (size_t)(b * KV + kvh) * Sk * dh;
  const T* vb = v + (size_t)(b * KV + kvh) * Sk * dv;
  stage_tile(q_s, q + (size_t)bh * S * dh, q0, BQ, S, dh, ts);
  stage_tile(do_s, dout + (size_t)bh * S * dv, q0, BQ, S, dv, tv);
  float lr[RQ], dr[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    lr[i] = qp < S ? lse[(size_t)bh * S + qp] : 0.0f;
    dr[i] = qp < S ? delta[(size_t)bh * S + qp] : 0.0f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    if (!tile_needed(q0, BQ, k0, kBK, causal, window, chunk_local)) continue;
    __syncthreads();  // the previous tile's readers are done with k_s, v_s, ds_s
    stage_tile(k_s, kb, k0, kBK, Sk, dh, ts);
    stage_tile(v_s, vb, k0, kBK, Sk, dv, tv);
    __syncthreads();

    float s[RQ][8], t[RQ][8];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float kx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kx[j] = ld(k_s + (tx + 8 * j) * ts + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float qx = ld(q_s + (ty * RQ + i) * ts + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qx, kx[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        float p = 0.0f;
        t[i][j] = 0.0f;
        if (kp < Sk && qp < S && allowed(qp, kp, causal, window, chunk_local)) {
          float x;
          if (CAP) {
            t[i][j] = tanhf(s[i][j] * scale / cap);
            x = t[i][j] * cap;
          } else {
            x = s[i][j] * scale;
          }
          p = expf(x - lr[i]);
        }
        s[i][j] = p;
      }
    }
    float dp[RQ][8];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dv; ++d) {
      float vx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vx[j] = ld(v_s + (tx + 8 * j) * tv + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float gx = ld(do_s + (ty * RQ + i) * tv + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) dp[i][j] = fmaf(gx, vx[j], dp[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds = s[i][j] * (dp[i][j] - dr[i]);
        if (CAP) ds = ds * (1.0f - t[i][j] * t[i][j]);
        ds_s[(ty * RQ + i) * PS + tx + 8 * j] = ds;
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float kx[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = tx + 8 * j;
        kx[j] = d < dh ? ld(k_s + kk * ts + d) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float dsv = ds_s[(ty * RQ + i) * PS + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(dsv, kx[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    if (qp >= S) continue;
    T* row = dq + ((size_t)bh * S + qp) * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 8 * j;
      if (d < dh) st(row + d, acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma (design at the top)
// ---------------------------------------------------------------------------

constexpr long long kTargetBlocks = 256;  // split the query heads below this many dK/dV blocks

// The keys a dK / dV block holds: 64 (the split kernel, DP 256) or 128 (the
// pair kernel, DP <= 128).
constexpr int dkdv_keys(int DP) { return DP > 128 ? 64 : 128; }

// The splits of a KV head's G query heads over dK / dV blocks of `keys`
// keys: as many as it takes to reach kTargetBlocks blocks, each split a run
// of whole heads.
__host__ __device__ inline int dkdv_splits(int B, int KV, int Sk, int G, int keys) {
  const long long units = (long long)B * KV * ((Sk + keys - 1) / keys);
  long long want = (kTargetBlocks + units - 1) / units;
  if (want > G) want = G;
  if (want < 1) want = 1;
  const int per = (int)((G + want - 1) / want);  // heads a split
  return (G + per - 1) / per;
}

// Is every pair of the 64 x 64 tile from (q0, k0) inside the keys and
// queries and allowed? The allowed keys of a query are one interval whose
// ends grow with the query, so the four corners decide.
__device__ __forceinline__ bool tile_full(int q0, int k0, int S, int Sk, int causal, int window,
                                          int chunk_local) {
  const int q1 = q0 + kT - 1, k1 = k0 + kT - 1;
  return q1 < S && k1 < Sk && allowed(q0, k0, causal, window, chunk_local) &&
         allowed(q0, k1, causal, window, chunk_local) &&
         allowed(q1, k0, causal, window, chunk_local) &&
         allowed(q1, k1, causal, window, chunk_local);
}

// The first item i >= from of [0, n) that `need` takes, else n.
template <typename F>
__device__ __forceinline__ int next_needed(int from, int n, F need) {
  while (from < n && !need(from)) ++from;
  return from;
}

// tanh(x) = 1 - 2 / (exp(2x) + 1) by __expf and __fdividef: within ~1e-7
// absolute of tanhf (|x| large: exactly ±1), a few instructions where the
// accurate tanhf takes tens; the cap's 50 makes that ~5e-6 in a score.
__device__ __forceinline__ float tanh_exp(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22;
// 0 for x far below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P = exp(s - lse) of one raw score x where `ok`, else 0: s = x·scale, or
// under CAP tanh(x·scale·icap)·cap (icap = 1 / cap); sl2 = scale·log2(e),
// l2 = the row's lse·log2(e). pc (returned): P, times 1 - tanh² under the
// cap, what dS multiplies.
template <bool CAP>
__device__ __forceinline__ float p_of(float& x, bool ok, float scale, float cap, float icap,
                                      float sl2, float l2) {
  float p = 0.0f, pc = 0.0f;
  if (ok) {
    if (CAP) {
      const float t = tanh_exp(x * scale * icap);
      p = ex2(fmaf(t * cap, kLog2e, -l2));
      pc = p * (1.0f - t * t);
    } else {
      p = ex2(fmaf(x, sl2, -l2));
      pc = p;
    }
  }
  x = p;
  return pc;
}

template <int DP>
constexpr size_t dkdv_smem() {
  // K, V and two stages of Q and dO (DP x 128 bytes each), P (64 x 64
  // float32), two stages of lse and D, 1 KB to align the base
  return (size_t)6 * DP * 128 + 64 * 64 * 4 + 2 * 2 * 64 * 4 + 1024;
}

// Kernel 1: dK (warpgroup 1) and dV (warpgroup 0) of 64 keys of one KV head
// over one split of its query heads.
template <int DP, bool CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dvo, float* __restrict__ part,
                      int B, int H, int KV, int S, int Sk, int dh, int dv, float scale, float cap,
                      int causal, int window, int chunk_local, int nsplit, int aligned) {
  constexpr int NP = DP / 64;
  constexpr int T_BYTES = NP * kT * 128;  // one tile
  const int G = H / KV, nqt = (S + kT - 1) / kT;
  const int nunits = B * KV * nsplit;
  // the first key tiles of every head, which need the most queries, first
  const int unit = blockIdx.x % nunits, k0 = blockIdx.x / nunits * kT;
  const int bkv = unit / nsplit, sp = unit % nsplit;
  const int b = bkv / KV, kvh = bkv % KV;
  const int per = (G + nsplit - 1) / nsplit, g0 = sp * per, g1 = min(G, g0 + per);
  const int n_it = (g1 - g0) * nqt;  // item it: query head g0 + it / nqt, tile it % nqt
  const int tid = threadIdx.x, wg = warpgroup(), t = tid & 127;
  const int ra = 16 * (t >> 5) + ((tid & 31) >> 2), cq = 2 * (tid & 3);
  const float icap = CAP ? 1.0f / cap : 0.0f, sl2 = scale * kLog2e;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = base;
  unsigned char* v_s = base + T_BYTES;
  unsigned char* st_s = base + 2 * T_BYTES;  // stage s: Q at st_s + 2 s T_BYTES, dO after it
  float* p_s = reinterpret_cast<float*>(base + 6 * T_BYTES);  // [32][128]: warpgroup 0's P
  float* r_s = p_s + 32 * 128;  // stage s: lse at r_s + 128 s, D at r_s + 128 s + 64

  const bool al = aligned != 0;
  auto need = [&](int it) {
    return tile_needed((it % nqt) * kT, kT, k0, kT, causal, window, chunk_local);
  };
  auto issue = [&](int it, int s) {
    const size_t bh = (size_t)b * H + kvh * G + g0 + it / nqt;
    const int q0 = (it % nqt) * kT;
    load_tile<kT, DP>(st_s + 2 * s * T_BYTES, q + bh * S * dh, q0, S, dh, al, tid);
    load_tile<kT, DP>(st_s + (2 * s + 1) * T_BYTES, dout + bh * S * dv, q0, S, dv, al, tid);
    load_row64(r_s + 128 * s, lse + bh * S, q0, S, tid);
    load_row64(r_s + 128 * s + 64, delta + bh * S, q0, S, tid);
  };
  load_tile<kT, DP>(k_s, k + (size_t)bkv * Sk * dh, k0, Sk, dh, al, tid);
  load_tile<kT, DP>(v_s, v + (size_t)bkv * Sk * dv, k0, Sk, dv, al, tid);
  int cur = next_needed(0, n_it, need);
  if (cur < n_it) issue(cur, 0);
  cp_async_commit();

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  // warpgroup 0: Sᵀ = K·Qᵀ, then dV += Pᵀ·dO; warpgroup 1: dPᵀ = V·dOᵀ,
  // then dK += dSᵀ·Q
  const uint32_t a_addr = smem_u32(wg == 0 ? k_s : v_s);
  const int cols_o = wg == 0 ? dv : dh;

  for (int s = 0; cur < n_it; s ^= 1) {
    const int nxt = next_needed(cur + 1, n_it, need), q0 = (cur % nqt) * kT;
    if (nxt < n_it) issue(nxt, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: item cur (and K, V) have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t q_addr = smem_u32(st_s + 2 * s * T_BYTES), g_addr = q_addr + T_BYTES;
    const float* rows = r_s + 128 * s;

    float x[32];
    scores<DP>(x, a_addr, wg == 0 ? q_addr : g_addr);
    if (wg == 0) {  // P: key rows k0 + ra (+ 8), query columns q0 + 8 jj + cq (+ 1)
      const bool full = tile_full(q0, k0, S, Sk, causal, window, chunk_local);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + ra + ((i & 2) ? 8 : 0), qc = 8 * (i >> 2) + cq + (i & 1);
        const int qp = q0 + qc;
        const bool ok = full || (kp < Sk && qp < S && allowed(qp, kp, causal, window,
                                                              chunk_local));
        p_s[i * 128 + t] = p_of<CAP>(x[i], ok, scale, cap, icap, sl2, rows[qc] * kLog2e);
      }
    } else {  // dPᵀ - D while warpgroup 0 forms P
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] -= rows[64 + 8 * (i >> 2) + cq + (i & 1)];
    }
    __syncthreads();  // P in shared memory
    if (wg == 1) {    // dSᵀ = P ∘ (dPᵀ - D)
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] *= p_s[i * 128 + t];
    }
    uint32_t a[4][4];
    to_a(a, x);
    accumulate<NP>(acc, a, wg == 0 ? g_addr : q_addr, 0);
    __syncthreads();  // every reader is done with stage s and with p_s
    cur = nxt;
  }
  cp_async_wait<0>();

  // warpgroup 0 holds dV, warpgroup 1 dK (times scale); split partials are
  // float32 planes [nsplit][B·KV·Sk·dh] of dK, then [nsplit][B·KV·Sk·dv] of dV
  float* pp = nullptr;
  if (nsplit > 1) {
    const size_t nk_el = (size_t)B * KV * Sk * dh, nv_el = (size_t)B * KV * Sk * dv;
    pp = wg == 1 ? part + sp * nk_el : part + nsplit * nk_el + sp * nv_el;
  }
  store_rows<NP>(acc, wg == 1 ? dk : dvo, pp, (size_t)bkv * Sk, k0, Sk, 0, cols_o,
                 wg == 1 ? scale : 1.0f, ra, cq);
}

// Kernel 2: the split partials of kernel 1 added in split order, as bf16.
__global__ void __launch_bounds__(256)
bwd_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out, long long n, int nsplit) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    float s = 0.0f;
    for (int sp = 0; sp < nsplit; ++sp) s += part[sp * n + i];
    out[i] = __float2bfloat16_rn(s);
  }
}

template <int DP>
constexpr size_t dq_smem() {
  // Q, dO and two stages of K and V (DP x 128 bytes each), P (64 x 64
  // float32), dS as bf16 A fragments (64 x 64 x 2 bytes), 1 KB to align
  return (size_t)6 * DP * 128 + 64 * 64 * 4 + 64 * 64 * 2 + 1024;
}

// Kernel 3: dQ of 64 query rows of one head; warpgroup 0 forms P,
// warpgroup 1 dP and dS, and the dQ panels are split between them.
template <int DP, bool CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int KV, int S, int Sk, int dh, int dv,
                    float scale, float cap, int causal, int window, int chunk_local,
                    int aligned) {
  constexpr int NP = DP / 64;
  constexpr int NPW = NP > 1 ? NP / 2 : 1;  // dQ panels a warpgroup accumulates
  constexpr int T_BYTES = NP * kT * 128;
  const int nq = (S + kT - 1) / kT, nk = (Sk + kT - 1) / kT, nbh = gridDim.x / nq;
  // the last query tiles of every head, the heaviest under a causal mask, first
  const int bh = blockIdx.x % nbh, q0 = (nq - 1 - blockIdx.x / nbh) * kT;
  const int b = bh / H, kvh = (bh % H) / (H / KV);
  const int tid = threadIdx.x, wg = warpgroup(), t = tid & 127;
  const int ra = 16 * (t >> 5) + ((tid & 31) >> 2), cq = 2 * (tid & 3);
  const float icap = CAP ? 1.0f / cap : 0.0f, sl2 = scale * kLog2e;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* g_s = base + T_BYTES;       // dO
  unsigned char* st_s = base + 2 * T_BYTES;  // stage s: K at st_s + 2 s T_BYTES, V after it
  float* p_s = reinterpret_cast<float*>(base + 6 * T_BYTES);  // [32][128]: warpgroup 0's P
  uint32_t* ds_s = reinterpret_cast<uint32_t*>(p_s + 32 * 128);  // [16][128]: dS fragments

  const bool al = aligned != 0;
  const bf16* kb = k + (size_t)(b * KV + kvh) * Sk * dh;
  const bf16* vb = v + (size_t)(b * KV + kvh) * Sk * dv;
  auto need = [&](int j) { return tile_needed(q0, kT, j * kT, kT, causal, window, chunk_local); };
  auto issue = [&](int j, int s) {
    load_tile<kT, DP>(st_s + 2 * s * T_BYTES, kb, j * kT, Sk, dh, al, tid);
    load_tile<kT, DP>(st_s + (2 * s + 1) * T_BYTES, vb, j * kT, Sk, dv, al, tid);
  };
  load_tile<kT, DP>(q_s, q + (size_t)bh * S * dh, q0, S, dh, al, tid);
  load_tile<kT, DP>(g_s, dout + (size_t)bh * S * dv, q0, S, dv, al, tid);
  int cur = next_needed(0, nk, need);
  if (cur < nk) issue(cur, 0);
  cp_async_commit();

  // warpgroup 0 reads its rows' lse, warpgroup 1 their D
  const float* rsrc = (wg == 0 ? lse : delta) + (size_t)bh * S;
  float rv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = q0 + ra + 8 * half;
    rv[half] = qp < S ? rsrc[qp] : 0.0f;
  }
  float acc[NPW][32];
#pragma unroll
  for (int p = 0; p < NPW; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  const uint32_t a_addr = smem_u32(wg == 0 ? q_s : g_s);
  // the dQ panels: [0, NP / 2) warpgroup 0, the rest warpgroup 1; at NP 1
  // both accumulate the one panel (no branch around a wgmma stage) and
  // warpgroup 1 stores it
  const int p0 = NP > 1 ? wg * NPW : 0;

  for (int s = 0; cur < nk; s ^= 1) {
    const int nxt = next_needed(cur + 1, nk, need), k0 = cur * kT;
    if (nxt < nk) issue(nxt, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t k_addr = smem_u32(st_s + 2 * s * T_BYTES), v_addr = k_addr + T_BYTES;

    float x[32];
    scores<DP>(x, a_addr, wg == 0 ? k_addr : v_addr);
    if (wg == 0) {  // P: query rows q0 + ra (+ 8), key columns k0 + 8 jj + cq (+ 1)
      const bool full = tile_full(q0, k0, S, Sk, causal, window, chunk_local);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qp = q0 + ra + ((i & 2) ? 8 : 0), kp = k0 + 8 * (i >> 2) + cq + (i & 1);
        const bool ok = full || (kp < Sk && qp < S && allowed(qp, kp, causal, window,
                                                              chunk_local));
        p_s[i * 128 + t] = p_of<CAP>(x[i], ok, scale, cap, icap, sl2, rv[(i >> 1) & 1] * kLog2e);
      }
    } else {  // dP - D while warpgroup 0 forms P
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] -= rv[(i >> 1) & 1];
    }
    __syncthreads();  // P in shared memory
    uint32_t a[4][4];
    if (wg == 1) {  // dS = P ∘ (dP - D), to bf16 fragments for both warpgroups
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] *= p_s[i * 128 + t];
      to_a(a, x);
#pragma unroll
      for (int i = 0; i < 16; ++i) ds_s[i * 128 + t] = a[i >> 2][i & 3];
    }
    __syncthreads();  // dS in shared memory
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i >> 2][i & 3] = ds_s[i * 128 + t];
    }
    accumulate<NPW>(acc, a, k_addr, p0);
    __syncthreads();  // every reader is done with stage s, p_s and ds_s
    cur = nxt;
  }
  cp_async_wait<0>();
  if (NP > 1 || wg == 1)
    store_rows<NPW>(acc, dq, nullptr, (size_t)bh * S, q0, S, p0, dh, scale, ra, cq);
}

// ---- dh <= 128: a warpgroup a 64-row tile of its own ---------------------
//
// At DP <= 128 one warpgroup holds both accumulators of its rows (dK and dV:
// 128 registers a thread at DP 128), so the two warpgroups of a block take
// 64 rows each and share the other side's tiles: a dK / dV block holds 128
// keys and reads each (head, 64-query) item's Q and dO once for both, a dQ
// block 128 queries and each key tile's K and V once. The warpgroups do not
// wait for each other inside an item, so one's softmax runs while the
// other's products keep the tensor cores busy, and inside a warpgroup the
// groups overlap: Sᵀ and dPᵀ are issued together, P is formed while dPᵀ
// runs, dV while dS is formed.

template <int DP>
constexpr size_t pair_smem() {
  // eight 64-row tiles (DP x 128 bytes each), two stages of 128 row
  // statistics, 1 KB to align the base
  return (size_t)8 * DP * 128 + 2 * 128 * 4 + 1024;
}

// Kernel 1 at DP <= 128: dK and dV of 128 keys (64 a warpgroup) of one KV
// head over one split of its query heads.
template <int DP, bool CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dkdv_pair_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dvo, float* __restrict__ part,
                     int B, int H, int KV, int S, int Sk, int dh, int dv, float scale, float cap,
                     int causal, int window, int chunk_local, int nsplit, int aligned) {
  constexpr int NP = DP / 64;
  constexpr int T_BYTES = NP * kT * 128;  // one 64-row tile
  const int G = H / KV, nqt = (S + kT - 1) / kT;
  const int nunits = B * KV * nsplit;
  // the first key tiles of every head, which need the most queries, first
  const int unit = blockIdx.x % nunits, k0 = blockIdx.x / nunits * 2 * kT;
  const int bkv = unit / nsplit, sp = unit % nsplit;
  const int b = bkv / KV, kvh = bkv % KV;
  const int per = (G + nsplit - 1) / nsplit, g0 = sp * per, g1 = min(G, g0 + per);
  const int n_it = (g1 - g0) * nqt;  // item it: query head g0 + it / nqt, tile it % nqt
  const int tid = threadIdx.x, wg = warpgroup(), t = tid & 127;
  const int ra = 16 * (t >> 5) + ((tid & 31) >> 2), cq = 2 * (tid & 3);
  const float icap = CAP ? 1.0f / cap : 0.0f, sl2 = scale * kLog2e;
  const int kw = k0 + kT * wg;  // this warpgroup's first key

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = base + wg * T_BYTES;      // this warpgroup's K; V two tiles on
  unsigned char* st_s = base + 4 * T_BYTES;      // stage s: Q at st_s + 2 s T_BYTES, dO after
  float* r_s = reinterpret_cast<float*>(base + 8 * T_BYTES);  // stage s: lse, D at 128 s

  const bool al = aligned != 0;
  auto need = [&](int it) {
    return tile_needed((it % nqt) * kT, kT, k0, 2 * kT, causal, window, chunk_local);
  };
  auto issue = [&](int it, int s) {
    const size_t bh = (size_t)b * H + kvh * G + g0 + it / nqt;
    const int q0 = (it % nqt) * kT;
    load_tile<kT, DP>(st_s + 2 * s * T_BYTES, q + bh * S * dh, q0, S, dh, al, tid);
    load_tile<kT, DP>(st_s + (2 * s + 1) * T_BYTES, dout + bh * S * dv, q0, S, dv, al, tid);
    load_row64(r_s + 128 * s, lse + bh * S, q0, S, tid);
    load_row64(r_s + 128 * s + 64, delta + bh * S, q0, S, tid);
  };
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    load_tile<kT, DP>(base + w * T_BYTES, k + (size_t)bkv * Sk * dh, k0 + kT * w, Sk, dh, al,
                      tid);
    load_tile<kT, DP>(base + (2 + w) * T_BYTES, v + (size_t)bkv * Sk * dv, k0 + kT * w, Sk, dv,
                      al, tid);
  }
  int cur = next_needed(0, n_it, need);
  if (cur < n_it) issue(cur, 0);
  cp_async_commit();

  float adv[NP][32], adk[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) adv[p][i] = adk[p][i] = 0.0f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = k_addr + 2 * T_BYTES;

  for (int s = 0; cur < n_it; s ^= 1) {
    const int nxt = next_needed(cur + 1, n_it, need), q0 = (cur % nqt) * kT;
    if (nxt < n_it) issue(nxt, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: item cur (and K, V) have landed
    fence_proxy_async();
    __syncthreads();
    if (kw < Sk && tile_needed(q0, kT, kw, kT, causal, window, chunk_local)) {
      const uint32_t q_addr = smem_u32(st_s + 2 * s * T_BYTES), g_addr = q_addr + T_BYTES;
      const float* rows = r_s + 128 * s;
      float x[32], dp[32];
      scores_issue<DP>(x, k_addr, q_addr);   // Sᵀ = K·Qᵀ
      scores_issue<DP>(dp, v_addr, g_addr);  // dPᵀ = V·dOᵀ
      wg_wait<1>();
      fence_regs(x);
      // P: key rows kw + ra (+ 8), query columns q0 + 8 jj + cq (+ 1); x
      // becomes P (times 1 - tanh² under the cap), aP its bf16 fragments
      const bool full = tile_full(q0, kw, S, Sk, causal, window, chunk_local);
      uint32_t aP[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int kp = kw + ra + ((i & 2) ? 8 : 0), qc = 8 * (i >> 2) + cq;
        float pc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = q0 + qc + e;
          const bool ok = full || (kp < Sk && qp < S && allowed(qp, kp, causal, window,
                                                                chunk_local));
          pc[e] = p_of<CAP>(x[i + e], ok, scale, cap, icap, sl2, rows[qc + e] * kLog2e);
        }
        aP[i >> 3][(i >> 1) & 3] = pack_bf16(x[i], x[i + 1]);
        x[i] = pc[0];
        x[i + 1] = pc[1];
      }
      accumulate_issue<NP>(adv, aP, g_addr, 0);  // dV += Pᵀ·dO
      wg_wait<1>();
      fence_regs(dp);
      uint32_t aS[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = x[i] * (dp[i] - rows[64 + 8 * (i >> 2) + cq + (i & 1)]);
      to_a(aS, dp);
      accumulate_issue<NP>(adk, aS, q_addr, 0);  // dK += dSᵀ·Q
      wg_wait0();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        fence_regs(adv[p]);
        fence_regs(adk[p]);
      }
    }
    __syncthreads();  // every reader is done with stage s
    cur = nxt;
  }
  cp_async_wait<0>();

  float* pk = nullptr;
  float* pv = nullptr;
  if (nsplit > 1) {
    const size_t nk_el = (size_t)B * KV * Sk * dh, nv_el = (size_t)B * KV * Sk * dv;
    pk = part + sp * nk_el;
    pv = part + nsplit * nk_el + sp * nv_el;
  }
  store_rows<NP>(adv, dvo, pv, (size_t)bkv * Sk, kw, Sk, 0, dv, 1.0f, ra, cq);
  store_rows<NP>(adk, dk, pk, (size_t)bkv * Sk, kw, Sk, 0, dh, scale, ra, cq);
}

// Kernel 3 at DP <= 128: dQ of 128 query rows (64 a warpgroup) of one head.
template <int DP, bool CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dq_pair_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int H, int KV, int S, int Sk, int dh, int dv,
                   float scale, float cap, int causal, int window, int chunk_local, int aligned) {
  constexpr int NP = DP / 64;
  constexpr int T_BYTES = NP * kT * 128;
  const int nq = (S + 2 * kT - 1) / (2 * kT), nk = (Sk + kT - 1) / kT, nbh = gridDim.x / nq;
  // the last query tiles of every head, the heaviest under a causal mask, first
  const int bh = blockIdx.x % nbh, q0 = (nq - 1 - blockIdx.x / nbh) * 2 * kT;
  const int b = bh / H, kvh = (bh % H) / (H / KV);
  const int tid = threadIdx.x, wg = warpgroup(), t = tid & 127;
  const int ra = 16 * (t >> 5) + ((tid & 31) >> 2), cq = 2 * (tid & 3);
  const float icap = CAP ? 1.0f / cap : 0.0f, sl2 = scale * kLog2e;
  const int qw = q0 + kT * wg;  // this warpgroup's first query

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* st_s = base + 4 * T_BYTES;  // stage s: K at st_s + 2 s T_BYTES, V after it

  const bool al = aligned != 0;
  const bf16* kb = k + (size_t)(b * KV + kvh) * Sk * dh;
  const bf16* vb = v + (size_t)(b * KV + kvh) * Sk * dv;
  auto need = [&](int j) {
    return tile_needed(q0, 2 * kT, j * kT, kT, causal, window, chunk_local);
  };
  auto issue = [&](int j, int s) {
    load_tile<kT, DP>(st_s + 2 * s * T_BYTES, kb, j * kT, Sk, dh, al, tid);
    load_tile<kT, DP>(st_s + (2 * s + 1) * T_BYTES, vb, j * kT, Sk, dv, al, tid);
  };
#pragma unroll
  for (int w = 0; w < 2; ++w) {  // Q of warpgroup w, then its dO two tiles on
    load_tile<kT, DP>(base + w * T_BYTES, q + (size_t)bh * S * dh, q0 + kT * w, S, dh, al, tid);
    load_tile<kT, DP>(base + (2 + w) * T_BYTES, dout + (size_t)bh * S * dv, q0 + kT * w, S, dv,
                      al, tid);
  }
  int cur = next_needed(0, nk, need);
  if (cur < nk) issue(cur, 0);
  cp_async_commit();

  float l2[2], dr[2];  // this warpgroup's rows' lse·log2(e) and D
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = qw + ra + 8 * half;
    l2[half] = qp < S ? lse[(size_t)bh * S + qp] * kLog2e : 0.0f;
    dr[half] = qp < S ? delta[(size_t)bh * S + qp] : 0.0f;
  }
  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  const uint32_t q_addr = smem_u32(base + wg * T_BYTES), g_addr = q_addr + 2 * T_BYTES;

  for (int s = 0; cur < nk; s ^= 1) {
    const int nxt = next_needed(cur + 1, nk, need), k0 = cur * kT;
    if (nxt < nk) issue(nxt, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (qw < S && tile_needed(qw, kT, k0, kT, causal, window, chunk_local)) {
      const uint32_t k_addr = smem_u32(st_s + 2 * s * T_BYTES), v_addr = k_addr + T_BYTES;
      float x[32], dp[32];
      scores_issue<DP>(x, q_addr, k_addr);   // S = Q·Kᵀ
      scores_issue<DP>(dp, g_addr, v_addr);  // dP = dO·Vᵀ
      wg_wait<1>();
      fence_regs(x);
      // P: query rows qw + ra (+ 8), key columns k0 + 8 jj + cq (+ 1)
      const bool full = tile_full(qw, k0, S, Sk, causal, window, chunk_local);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qp = qw + ra + ((i & 2) ? 8 : 0), kp = k0 + 8 * (i >> 2) + cq + (i & 1);
        const bool ok = full || (kp < Sk && qp < S && allowed(qp, kp, causal, window,
                                                              chunk_local));
        x[i] = p_of<CAP>(x[i], ok, scale, cap, icap, sl2, l2[(i >> 1) & 1]);
      }
      wg_wait0();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = x[i] * (dp[i] - dr[(i >> 1) & 1]);
      uint32_t a[4][4];
      to_a(a, dp);
      accumulate<NP>(acc, a, k_addr, 0);  // dQ += dS·K
    }
    __syncthreads();  // every reader is done with stage s
    cur = nxt;
  }
  cp_async_wait<0>();
  store_rows<NP>(acc, dq, nullptr, (size_t)bh * S, qw, S, 0, dh, scale, ra, cq);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, long long rows, int dv,
                 cudaStream_t st) {
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bwd_delta_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(static_cast<const T*>(o),
                                                        static_cast<const T*>(dout), delta, rows,
                                                        dv);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX, bool CAP>
int launch_all(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
               void* dvo, const float* lse, const float* delta, int B, int H, int KV, int S,
               int Sk, int dh, int dv, float scale, float cap, int causal, int window,
               int chunk_local, cudaStream_t st) {
  constexpr int BQ = DMAX > 128 ? 32 : 64;  // query rows a block in kernel 3
  const size_t ts = row_stride<T>(dh), tv = row_stride<T>(dv);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int nq = (S + BQ - 1) / BQ, nk = (Sk + kBKV - 1) / kBKV;
  cudaError_t err;

  const size_t sm_kv = sizeof(float) * (2 * kBKV * (kBQ2 + 1) + 2 * kBQ2) +
                       sizeof(T) * ((kBKV + kBQ2) * ts + (kBKV + kBQ2) * tv);
  if ((err = prepare(bwd_dkdv_kernel<T, DMAX, CAP>, sm_kv)) != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<T, DMAX, CAP><<<B * KV * nk, kThreads, sm_kv, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dvo), H, KV, S, Sk, dh,
      dv, scale, cap, causal, window, chunk_local);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t sm_q = sizeof(float) * BQ * (kBK + 1) + sizeof(T) * ((BQ + kBK) * (ts + tv));
  if ((err = prepare(bwd_dq_kernel<T, BQ, DMAX, CAP>, sm_q)) != cudaSuccess) return (int)err;
  bwd_dq_kernel<T, BQ, DMAX, CAP><<<B * H * nq, kThreads, sm_q, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), H, KV, S, Sk, dh, dv, scale, cap, causal,
      window, chunk_local);
  return (int)cudaGetLastError();
}

template <typename T, bool CAP>
int launch_dh(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
              void* dvo, const float* lse, const float* delta, int B, int H, int KV, int S,
              int Sk, int dh, int dv, float scale, float cap, int causal, int window,
              int chunk_local, cudaStream_t st) {
  if (dh <= 64)
    return launch_all<T, 64, CAP>(q, k, v, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk, dh,
                                  dv, scale, cap, causal, window, chunk_local, st);
  if (dh <= 128)
    return launch_all<T, 128, CAP>(q, k, v, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk, dh,
                                   dv, scale, cap, causal, window, chunk_local, st);
  return launch_all<T, 256, CAP>(q, k, v, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk, dh, dv,
                                 scale, cap, causal, window, chunk_local, st);
}

template <int DP, bool CAP>
int launch_wg(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
              void* dvo, const float* lse, const float* delta, float* part, int B, int H, int KV,
              int S, int Sk, int dh, int dv, float scale, float cap, int causal, int window,
              int chunk_local, int aligned, cudaStream_t st) {
  constexpr bool PAIR = DP <= 128;
  constexpr int KEYS = dkdv_keys(DP), QUERIES = PAIR ? 2 * kT : kT;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  const int nq = (S + QUERIES - 1) / QUERIES, nk = (Sk + KEYS - 1) / KEYS;
  const int nsplit = dkdv_splits(B, KV, Sk, H / KV, KEYS);
  const long long kv_blocks = (long long)B * KV * nsplit * nk, q_blocks = (long long)B * H * nq;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dvo);
  bf16* dqt = static_cast<bf16*>(dq);
  cudaError_t err;

  if constexpr (PAIR) {
    constexpr size_t sm = pair_smem<DP>();
    if ((err = prepare(bwd_dkdv_pair_kernel<DP, CAP>, sm)) != cudaSuccess) return (int)err;
    bwd_dkdv_pair_kernel<DP, CAP><<<(unsigned)kv_blocks, kWgThreads, sm, st>>>(
        qt, kt, vt, gt, lse, delta, dkt, dvt, part, B, H, KV, S, Sk, dh, dv, scale, cap, causal,
        window, chunk_local, nsplit, aligned);
  } else {
    constexpr size_t sm = dkdv_smem<DP>();
    if ((err = prepare(bwd_dkdv_wgmma_kernel<DP, CAP>, sm)) != cudaSuccess) return (int)err;
    bwd_dkdv_wgmma_kernel<DP, CAP><<<(unsigned)kv_blocks, kWgThreads, sm, st>>>(
        qt, kt, vt, gt, lse, delta, dkt, dvt, part, B, H, KV, S, Sk, dh, dv, scale, cap, causal,
        window, chunk_local, nsplit, aligned);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nsplit > 1) {
    const long long nk_el = (long long)B * KV * Sk * dh, nv_el = (long long)B * KV * Sk * dv;
    bwd_sum_kernel<<<1024, 256, 0, st>>>(part, dkt, nk_el, nsplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_sum_kernel<<<1024, 256, 0, st>>>(part + nsplit * nk_el, dvt, nv_el, nsplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  if constexpr (PAIR) {
    constexpr size_t sm = pair_smem<DP>();
    if ((err = prepare(bwd_dq_pair_kernel<DP, CAP>, sm)) != cudaSuccess) return (int)err;
    bwd_dq_pair_kernel<DP, CAP><<<(unsigned)q_blocks, kWgThreads, sm, st>>>(
        qt, kt, vt, gt, lse, delta, dqt, H, KV, S, Sk, dh, dv, scale, cap, causal, window,
        chunk_local, aligned);
  } else {
    constexpr size_t sm = dq_smem<DP>();
    if ((err = prepare(bwd_dq_wgmma_kernel<DP, CAP>, sm)) != cudaSuccess) return (int)err;
    bwd_dq_wgmma_kernel<DP, CAP><<<(unsigned)q_blocks, kWgThreads, sm, st>>>(
        qt, kt, vt, gt, lse, delta, dqt, H, KV, S, Sk, dh, dv, scale, cap, causal, window,
        chunk_local, aligned);
  }
  return (int)cudaGetLastError();
}

template <bool CAP>
int launch_wg_dh(const void* q, const void* k, const void* v, const void* dout, void* dq,
                 void* dk, void* dvo, const float* lse, const float* delta, float* part, int B,
                 int H, int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal,
                 int window, int chunk_local, int aligned, cudaStream_t st) {
  if (dh <= 64)
    return launch_wg<64, CAP>(q, k, v, dout, dq, dk, dvo, lse, delta, part, B, H, KV, S, Sk, dh,
                              dv, scale, cap, causal, window, chunk_local, aligned, st);
  if (dh <= 128)
    return launch_wg<128, CAP>(q, k, v, dout, dq, dk, dvo, lse, delta, part, B, H, KV, S, Sk, dh,
                               dv, scale, cap, causal, window, chunk_local, aligned, st);
  return launch_wg<256, CAP>(q, k, v, dout, dq, dk, dvo, lse, delta, part, B, H, KV, S, Sk, dh,
                             dv, scale, cap, causal, window, chunk_local, aligned, st);
}

// The workspace's float32 slices: D [B·H·S], then (bf16 with split query
// heads) the dK and dV partials.
size_t delta_floats(int B, int H, int S) { return ((size_t)B * H * S + 63) / 64 * 64; }

size_t part_floats(int B, int H, int KV, int Sk, int dh, int dv, int dtype) {
  if (dtype != 1 || KV <= 0 || H % KV != 0) return 0;
  const int nsplit = dkdv_splits(B, KV, Sk, H / KV, dkdv_keys(dh <= 128 ? 128 : 256));
  return nsplit > 1 ? (size_t)nsplit * B * KV * Sk * (dh + dv) : 0;
}

}  // namespace

// Bytes of the workspace a call of flash_attention_bwd_launch needs.
extern "C" long long flash_attention_bwd_workspace_bytes(int B, int H, int KV, int S, int Sk,
                                                         int dh, int dv, int dtype) {
  return (long long)(sizeof(float) *
                     (delta_floats(B, H, S) + part_floats(B, H, KV, Sk, dh, dv, dtype)));
}

// q [B,H,S,dh], k [B,KV,Sk,dh], v [B,KV,Sk,dv], o and dout [B,H,S,dv], lse
// float32 [B,H,S] (the forward's) -> dq [B,H,S,dh], dk [B,KV,Sk,dh], dv
// [B,KV,Sk,dv]; ws holds flash_attention_bwd_workspace_bytes. dtype 0:
// float32, 1: bfloat16 (every tensor of the call but lse and ws).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dvo, void* ws, int B, int H,
                                          int KV, int S, int Sk, int dh, int dv, float scale,
                                          float cap, int causal, int window, int chunk_local,
                                          int dtype, void* stream) {
  if (B == 0 || H == 0 || S == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || dh <= 0 || dh > 256 || dv <= 0 || dv > dh || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (Sk != S && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = static_cast<const float*>(lse);
  float* delta = static_cast<float*>(ws);
  float* part = delta + delta_floats(B, H, S);
  const long long rows = (long long)B * H * S;
  int err;
  if (dtype == 0) {
    if ((err = launch_delta<float>(o, dout, delta, rows, dv, st)) != 0) return err;
    if (cap > 0.0f)
      return launch_dh<float, true>(q, k, v, dout, dq, dk, dvo, l, delta, B, H, KV, S, Sk, dh,
                                    dv, scale, cap, causal, window, chunk_local, st);
    return launch_dh<float, false>(q, k, v, dout, dq, dk, dvo, l, delta, B, H, KV, S, Sk, dh, dv,
                                   scale, cap, causal, window, chunk_local, st);
  }
  if (dtype == 1) {
    if ((err = launch_delta<bf16>(o, dout, delta, rows, dv, st)) != 0) return err;
    const int aligned = dh % 8 == 0 && dv % 8 == 0 &&
                        ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
    if (cap > 0.0f)
      return launch_wg_dh<true>(q, k, v, dout, dq, dk, dvo, l, delta, part, B, H, KV, S, Sk, dh,
                                dv, scale, cap, causal, window, chunk_local, aligned, st);
    return launch_wg_dh<false>(q, k, v, dout, dq, dk, dvo, l, delta, part, B, H, KV, S, Sk, dh,
                               dv, scale, cap, causal, window, chunk_local, aligned, st);
  }
  return (int)cudaErrorInvalidValue;
}
