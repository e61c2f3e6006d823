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
// and, with dO given and lse the row log-sum-exp of the masked scores,
//   P[i, j] = exp(s[i, j] - lse[i]) where mask(i, j), else 0
//   D[i]    = rowsum(dO ∘ O)[i]                  (= rowsum(P ∘ dP))
//   dV      = Pᵀ · dO
//   dP      = dO · Vᵀ
//   dS      = P ∘ (dP - D), times (1 - tanh²) under the cap
//   dQ      = dS · K · scale,   dK = dSᵀ · Q · scale
// summed over the G query heads of a KV head for dK and dV. q [B,H,S,dh],
// k [B,KV,Sk,dh], v [B,KV,Sk,dv], o and dO [B,H,S,dv] (dv <= dh; Sk != S only
// without the causal and window masks: cross-attention), all float32 or all
// bfloat16; dq, dk, dv in that type, every sum in float32.
//
// Three kernels, launched in turn on the caller's stream by
// flash_attention_bwd_launch, in one of two routes:
// - bfloat16 with dh <= 128 (the training path's every call): on the tensor
//   cores, mma.sync m16n8k16 with float32 accumulation (kernels 1m-3m
//   below; their own comment has the design);
// - float32, and bfloat16 with dh > 128: on the CUDA cores in float32
//   (kernels 1-3), as follows.
// 1. `bwd_pre_kernel`, one block per (b·h, query tile): the row lse by the
//    forward's online max / sum (masked scores the finite -1e30, keys past Sk
//    -inf, so a row whose first needed tile is all masked loses those terms
//    to alpha = 0 as in the forward) and D from O and dO, into two float32
//    [B,H,S] workspaces. The forward kernel stays as it is: an lse output
//    from the forward is a later saving.
// 2. `bwd_dkdv_kernel`, one block per (b·kv head, 32-key tile): the K and V
//    tiles stay in shared memory, the block walks the G query heads of its
//    group and, for each, the query tiles of 64 its keys are needed by (the
//    forward's block predicate), recomputing P and dS for the tile
//    ([32 keys][64 queries], 2 x 8 a thread) and accumulating dK and dV in
//    registers (2 key rows x dh / 8 columns a thread).
// 3. `bwd_dq_kernel`, one block per (b·h, query tile): Q, dO, lse and D stay,
//    the block walks the needed 64-key tiles, recomputes P and dS and
//    accumulates dQ in registers.
// No atomics: each output element is summed by one thread in a fixed order,
// so two calls give the same bits. P and dS are recomputed by both kernels 2
// and 3: 8 products of S x Sk x d a head where a kernel with atomics on dQ
// would do 5 (FA2).
//
// Tiles are staged in shared memory as the type they are in device memory
// (half the bytes for bf16), with a row stride of an odd number of 4-byte
// words, so the threads of a warp that read different rows hit different
// banks. The thread layout is the float32 forward kernel's: 16 row groups x
// 8 column lanes; the eight lanes of a row reduce with shuffles.
//
// Bound: 2·(3·dh + 2·dv) flops per unmasked (query, key) pair of a head
// (five products: P's recompute, dP, dV, dQ, dK) against the tensors'
// bytes; at llama3.2-3b's training shape ([2, 2048, 24/8, 128], causal,
// bf16) that is ~1.3e11 flops to ~134 MB: the tensor cores' rate bounds it
// (0.13 ms at 989 TFLOP/s). Both routes recompute P and dS twice and S a
// third time for the lse, 8 products where FA2 with atomics does 5.
//
// Built with -fmad=false like every kernel of the port: products use fmaf.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"  // the mma.sync kernels' fragments, tiles and cp.async

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kBK = 64;        // keys a tile in kernels 1 and 3
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

// A tile of `rows` rows of d elements from row r0 of src (n rows in all)
// into dst with row stride ts; rows past n are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int rows, int n, int d,
                                          int ts) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    dst[r * ts + c] = r0 + r < n ? src[(size_t)(r0 + r) * d + c] : T(0.0f);
  }
}

// Kernel 1: lse and D of BQ query rows.
template <typename T, int BQ, bool CAP>
__global__ void __launch_bounds__(kThreads)
bwd_pre_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
               const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
               int H, int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal,
               int window, int chunk_local) {
  constexpr int RQ = BQ / 16;
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * BQ;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int ts = row_stride<T>(dh);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BQ][ts]
  T* k_s = q_s + BQ * ts;                   // [64][ts]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const T* kb = k + (size_t)(b * KV + kvh) * Sk * dh;
  load_tile(q_s, q + (size_t)bh * S * dh, q0, BQ, S, dh, ts);

  // D = rowsum(dO ∘ O), each row's dv products split over its 8 lanes
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    float acc = 0.0f;
    if (qp < S) {
      const T* orow = o + ((size_t)bh * S + qp) * dv;
      const T* grow = dout + ((size_t)bh * S + qp) * dv;
      for (int d = tx; d < dv; d += 8) acc = fmaf(ld(orow + d), ld(grow + d), acc);
    }
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (qp < S && tx == 0) delta[(size_t)bh * S + qp] = acc;
  }

  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
  }
  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    if (!tile_needed(q0, BQ, k0, kBK, causal, window, chunk_local)) continue;
    __syncthreads();  // the previous tile's readers are done with k_s
    load_tile(k_s, kb, k0, kBK, Sk, dh, ts);
    __syncthreads();
    float s[RQ][8];
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
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        float x = -INFINITY;  // past the end of the keys: no term
        if (kp < Sk) {
          const float sc = CAP ? tanhf(s[i][j] * scale / cap) * cap : s[i][j] * scale;
          x = allowed(qp, kp, causal, window, chunk_local) ? sc : kNeg;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(s[i][j] - m_new);
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = fmaf(l[i], expf(m[i] - m_new), sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    if (qp < S && tx == 0) lse[(size_t)bh * S + qp] = m[i] + logf(l[i]);
  }
}

// Kernel 2: dK and dV of kBKV keys of one KV head, over its G query heads.
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
  load_tile(k_s, k + (size_t)bkv * Sk * dh, k0, kBKV, Sk, dh, ts);
  load_tile(v_s, v + (size_t)bkv * Sk * dv, k0, kBKV, Sk, dv, tv);

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
      load_tile(q_s, q + (size_t)bh * S * dh, q0, kBQ2, S, dh, ts);
      load_tile(do_s, dout + (size_t)bh * S * dv, q0, kBQ2, S, dv, tv);
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

// Kernel 3: dQ of BQ query rows of one head.
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
  load_tile(q_s, q + (size_t)bh * S * dh, q0, BQ, S, dh, ts);
  load_tile(do_s, dout + (size_t)bh * S * dv, q0, BQ, S, dv, tv);
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
    load_tile(k_s, kb, k0, kBK, Sk, dh, ts);
    load_tile(v_s, vb, k0, kBK, Sk, dv, tv);
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
// bfloat16 with dh <= 128: the same three kernels on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 accumulate). A block is four warps;
// each warp owns 16 rows of the block's tile (queries in kernels 1m and 3m,
// keys in kernel 2m) and walks 64-row tiles of the other side. Tiles are
// staged as bf16 [rows][DP + 8] (DP = dh rounded up to 64 or 128, the pad
// columns zero; the 16-byte row pad puts the eight rows of an ldmatrix in
// distinct banks) and read into fragments with ldmatrix (.trans where the
// product's k index is the tile's row). A product's C fragment becomes the
// next product's A fragment in registers: P and dS are rounded to bf16 for
// dV += Pᵀ·dO, dK += dSᵀ·Q and dQ += dS·K, as FA2 does; every sum stays in
// float32 and no element is summed by two threads, so two calls give the
// same bits. A tile that the mask leaves whole skips the per-pair mask
// (`tile_full`); blocks are numbered heaviest tile first across all heads,
// so the long causal blocks start in the first wave; exp is __expf.
// Kernel 1m, one block per (b·h, 64 queries): lse and D as kernel 1;
// kernel 2m, one per (b·kv head, 64 keys): dK and dV over the G query heads
// and needed query tiles; kernel 3m, one per (b·h, 64 queries): dQ.

// Is every pair of the 64 x 64 tile from (q0, k0) inside the keys and
// queries and allowed? The allowed keys of a query are one interval whose
// ends grow with the query, so the four corners decide.
__device__ __forceinline__ bool tile_full(int q0, int k0, int S, int Sk, int causal, int window,
                                          int chunk_local) {
  const int q1 = q0 + kMmaRows - 1, k1 = k0 + kMmaRows - 1;
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

// A warp's 16 x 64 scores s (query rows qr and qr + 8, keys from k0) as
// the forward's softmax sees them: capped and scaled; masked pairs the
// finite kNeg, keys past Sk -inf (no term). Without MASK every pair is in.
template <bool CAP, bool MASK>
__device__ __forceinline__ void masked_scores(float (*s)[4], int qr, int k0, int Sk, float scale,
                                              float cap, int causal, int window,
                                              int chunk_local) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = qr + 8 * (e >> 1), kp = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
      const float v = s[j][e];
      const float sc = CAP ? tanhf(v * scale / cap) * cap : v * scale;
      if (MASK) s[j][e] = kp < Sk ? (allowed(qp, kp, causal, window, chunk_local) ? sc : kNeg)
                                  : -INFINITY;
      else s[j][e] = sc;
    }
}

// Each kernel walks its tiles through two buffers: the copies of the next
// needed tile are issued before the current one is used, so they fly while
// the tensor cores work (one cp.async group a tile; the first group also
// holds the block's own tiles).

// Kernel 1m: lse and D of 64 query rows.
template <int DP, bool CAP>
__global__ void __launch_bounds__(kMmaThreads)
bwd_pre_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                   float* __restrict__ lse, float* __restrict__ delta, int H, int KV, int S,
                   int Sk, int dh, int dv, float scale, float cap, int causal, int window,
                   int chunk_local, int vec) {
  constexpr int LD = DP + 8, BQ = kMmaRows, BK = kMmaRows, TILE = kMmaRows * LD;
  const int nq = (S + BQ - 1) / BQ, nk = (Sk + BK - 1) / BK, nbh = gridDim.x / nq;
  // the last query tiles of every head, the heaviest under a causal mask, first
  const int bh = blockIdx.x % nbh;
  const int q0 = (nq - 1 - blockIdx.x / nbh) * BQ;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int nk16 = (dh + 15) / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* k_s = q_s + TILE;                                   // [2][64][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* kb = k + (size_t)(b * KV + kvh) * Sk * dh;
  auto need = [&](int t) { return tile_needed(q0, BQ, t * BK, BK, causal, window, chunk_local); };
  load_tile_mma<DP>(q_s, q + (size_t)bh * S * dh, q0, BQ, S, dh, vec);
  int cur = next_needed(0, nk, need);
  if (cur < nk) load_tile_mma<DP>(k_s, kb, cur * BK, BK, Sk, dh, vec);
  cp_async_commit();

  // D = rowsum(dO ∘ O), while the first tiles land: a warp's 16 rows, its
  // lanes over the columns
  for (int r = 0; r < 16; ++r) {
    const int qp = q0 + warp * 16 + r;
    float acc = 0.0f;
    if (qp < S) {
      const __nv_bfloat16* orow = o + ((size_t)bh * S + qp) * dv;
      const __nv_bfloat16* grow = dout + ((size_t)bh * S + qp) * dv;
      for (int d = lane; d < dv; d += 32) acc = fmaf(ld(orow + d), ld(grow + d), acc);
    }
#pragma unroll
    for (int w = 1; w < 32; w <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (qp < S && lane == 0) delta[(size_t)bh * S + qp] = acc;
  }

  const int qr = q0 + warp * 16 + (lane >> 2);  // rows qr and qr + 8
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  for (int buf = 0; cur < nk; buf ^= 1) {
    const int nxt = next_needed(cur + 1, nk, need), k0 = cur * BK;
    if (nxt < nk) load_tile_mma<DP>(k_s + (buf ^ 1) * TILE, kb, nxt * BK, BK, Sk, dh, vec);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    mma_abt<DP>(s, q_s + warp * 16 * LD, k_s + buf * TILE, nk16);
    if (tile_full(q0, k0, S, Sk, causal, window, chunk_local))
      masked_scores<CAP, false>(s, qr, k0, Sk, scale, cap, causal, window, chunk_local);
    else
      masked_scores<CAP, true>(s, qr, k0, Sk, scale, cap, causal, window, chunk_local);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum += __expf(s[j][2 * hf] - m_new) + __expf(s[j][2 * hf + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hf] = fmaf(l[hf], __expf(m[hf] - m_new), sum);
      m[hf] = m_new;
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    cur = nxt;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = qr + 8 * hf;
    if (qp < S && (lane & 3) == 0) lse[(size_t)bh * S + qp] = m[hf] + logf(l[hf]);
  }
}

// P and dS of one C element from its score s and dP: p = exp(x - lse)
// where the pair is allowed, ds = p·(dP - D), times 1 - tanh² under the cap.
template <bool CAP>
__device__ __forceinline__ void p_ds(float& s, float& dp, bool ok, float scale, float cap,
                                     float lse_r, float d_r) {
  float p = 0.0f, ds = 0.0f;
  if (ok) {
    float t = 0.0f, x;
    if (CAP) {
      t = tanhf(s * scale / cap);
      x = t * cap;
    } else {
      x = s * scale;
    }
    p = __expf(x - lse_r);
    ds = p * (dp - d_r);
    if (CAP) ds = ds * (1.0f - t * t);
  }
  s = p;
  dp = ds;
}

// p_ds over a warp's 16 x 64 tiles: rows r0 + lane / 4 and + 8, columns
// c0 + 8 j + 2 (lane % 4) + {0, 1}; KEYS: the rows are keys (kernel 2m, lse
// and D a column, in shared memory), else queries (kernel 3m, lse and D a
// row, in registers). Without MASK every pair is in.
template <bool CAP, bool MASK, bool KEYS>
__device__ __forceinline__ void p_ds_tile(float (*s)[4], float (*dp)[4], int r0, int c0, int S,
                                          int Sk, float scale, float cap, int causal, int window,
                                          int chunk_local, const float* lse_x,
                                          const float* d_x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (lane >> 2) + 8 * (e >> 1), cc = j * 8 + (lane & 3) * 2 + (e & 1);
      const int qp = KEYS ? c0 + cc : r, kp = KEYS ? r : c0 + cc;
      const bool ok = !MASK || (kp < Sk && qp < S && allowed(qp, kp, causal, window, chunk_local));
      const int x = KEYS ? cc : e >> 1;
      p_ds<CAP>(s[j][e], dp[j][e], ok, scale, cap, lse_x[x], d_x[x]);
    }
}

// Kernel 2m: dK and dV of 64 keys of one KV head (a warp's 16), over its G
// query heads and their needed 64-query tiles.
template <int DP, bool CAP>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dvo, int H,
                    int KV, int S, int Sk, int dh, int dv, float scale, float cap, int causal,
                    int window, int chunk_local, int vec) {
  constexpr int LD = DP + 8, BK = kMmaRows, BQ = kMmaRows, TILE = kMmaRows * LD;
  const int nk = (Sk + BK - 1) / BK, nqt = (S + BQ - 1) / BQ, nbkv = gridDim.x / nk;
  // the first key tiles of every head, which need the most queries, first
  const int bkv = blockIdx.x % nbkv;
  const int k0 = blockIdx.x / nbkv * BK;
  const int b = bkv / KV, kvh = bkv % KV;
  const int G = H / KV, n_it = G * nqt;  // item it: query head it / nqt, tile it % nqt
  const int nh16 = (dh + 15) / 16, nv16 = (dv + 15) / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lse_s = reinterpret_cast<float*>(smem_raw);                     // [2][64]
  float* dl_s = lse_s + 2 * BQ;                                          // [2][64]
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(dl_s + 2 * BQ);  // [64][LD]
  __nv_bfloat16* v_s = k_s + TILE;                                       // [64][LD]
  __nv_bfloat16* q_s = v_s + TILE;                                       // [2][64][LD]
  __nv_bfloat16* do_s = q_s + 2 * TILE;                                  // [2][64][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto need = [&](int it) {
    return tile_needed((it % nqt) * BQ, BQ, k0, BK, causal, window, chunk_local);
  };
  auto issue = [&](int it, int buf) {
    const int bh = b * H + kvh * G + it / nqt, q0 = (it % nqt) * BQ;
    load_tile_mma<DP>(q_s + buf * TILE, q + (size_t)bh * S * dh, q0, BQ, S, dh, vec);
    load_tile_mma<DP>(do_s + buf * TILE, dout + (size_t)bh * S * dv, q0, BQ, S, dv, vec);
    load_rows_async(lse_s + buf * BQ, lse + (size_t)bh * S, q0, S);
    load_rows_async(dl_s + buf * BQ, delta + (size_t)bh * S, q0, S);
  };
  load_tile_mma<DP>(k_s, k + (size_t)bkv * Sk * dh, k0, BK, Sk, dh, vec);
  load_tile_mma<DP>(v_s, v + (size_t)bkv * Sk * dv, k0, BK, Sk, dv, vec);
  int cur = next_needed(0, n_it, need);
  if (cur < n_it) issue(cur, 0);
  cp_async_commit();
  const int kr = k0 + warp * 16 + (lane >> 2);  // key rows kr and kr + 8

  float adk[DP / 8][4], adv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.0f;

  for (int buf = 0; cur < n_it; buf ^= 1) {
    const int nxt = next_needed(cur + 1, n_it, need), q0 = (cur % nqt) * BQ;
    if (nxt < n_it) issue(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const __nv_bfloat16* qb = q_s + buf * TILE;
    const __nv_bfloat16* gb = do_s + buf * TILE;

    // sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: key rows, query columns
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    mma_abt<DP>(s, k_s + warp * 16 * LD, qb, nh16);
    mma_abt<DP>(dp, v_s + warp * 16 * LD, gb, nv16);
    if (tile_full(q0, k0, S, Sk, causal, window, chunk_local))
      p_ds_tile<CAP, false, true>(s, dp, k0 + warp * 16, q0, S, Sk, scale, cap, causal, window,
                                  chunk_local, lse_s + buf * BQ, dl_s + buf * BQ);
    else
      p_ds_tile<CAP, true, true>(s, dp, k0 + warp * 16, q0, S, Sk, scale, cap, causal, window,
                                 chunk_local, lse_s + buf * BQ, dl_s + buf * BQ);
    // dV += Pᵀ·dO, dK += dSᵀ·Q over the tile's queries
    mma_xb<DP, DP>(adv, s, gb, 0, nv16);
    mma_xb<DP, DP>(adk, dp, qb, 0, nh16);
    __syncthreads();  // every warp is done with this buffer before it is refilled
    cur = nxt;
  }

#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = kr + 8 * (e >> 1), d = j * 8 + (lane & 3) * 2 + (e & 1);
      if (kp >= Sk) continue;
      if (d < dh) st(dk + ((size_t)bkv * Sk + kp) * dh + d, adk[j][e] * scale);
      if (d < dv) st(dvo + ((size_t)bkv * Sk + kp) * dv + d, adv[j][e]);
    }
}

// Kernel 3m: dQ of 64 query rows of one head (a warp's 16).
template <int DP, bool CAP>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int H, int KV, int S, int Sk, int dh, int dv,
                  float scale, float cap, int causal, int window, int chunk_local, int vec) {
  constexpr int LD = DP + 8, BQ = kMmaRows, BK = kMmaRows, TILE = kMmaRows * LD;
  const int nq = (S + BQ - 1) / BQ, nk = (Sk + BK - 1) / BK;
  const int nbh = gridDim.x / nq;
  // the last query tiles of every head, the heaviest under a causal mask, first
  const int bh = blockIdx.x % nbh;
  const int q0 = (nq - 1 - blockIdx.x / nbh) * BQ;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int nh16 = (dh + 15) / 16, nv16 = (dv + 15) / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* do_s = q_s + TILE;                                  // [64][LD]
  __nv_bfloat16* k_s = do_s + TILE;                                  // [2][64][LD]
  __nv_bfloat16* v_s = k_s + 2 * TILE;                               // [2][64][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* kb = k + (size_t)(b * KV + kvh) * Sk * dh;
  const __nv_bfloat16* vb = v + (size_t)(b * KV + kvh) * Sk * dv;
  auto need = [&](int t) { return tile_needed(q0, BQ, t * BK, BK, causal, window, chunk_local); };
  auto issue = [&](int t, int buf) {
    load_tile_mma<DP>(k_s + buf * TILE, kb, t * BK, BK, Sk, dh, vec);
    load_tile_mma<DP>(v_s + buf * TILE, vb, t * BK, BK, Sk, dv, vec);
  };
  load_tile_mma<DP>(q_s, q + (size_t)bh * S * dh, q0, BQ, S, dh, vec);
  load_tile_mma<DP>(do_s, dout + (size_t)bh * S * dv, q0, BQ, S, dv, vec);
  int cur = next_needed(0, nk, need);
  if (cur < nk) issue(cur, 0);
  cp_async_commit();
  const int qr = q0 + warp * 16 + (lane >> 2);  // rows qr and qr + 8
  float lr[2], dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = qr + 8 * hf;
    lr[hf] = qp < S ? lse[(size_t)bh * S + qp] : 0.0f;
    dr[hf] = qp < S ? delta[(size_t)bh * S + qp] : 0.0f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int buf = 0; cur < nk; buf ^= 1) {
    const int nxt = next_needed(cur + 1, nk, need), k0 = cur * BK;
    if (nxt < nk) issue(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const __nv_bfloat16* kt = k_s + buf * TILE;

    // s = Q·Kᵀ and dP = dO·Vᵀ: query rows, key columns
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    mma_abt<DP>(s, q_s + warp * 16 * LD, kt, nh16);
    mma_abt<DP>(dp, do_s + warp * 16 * LD, v_s + buf * TILE, nv16);
    if (tile_full(q0, k0, S, Sk, causal, window, chunk_local))
      p_ds_tile<CAP, false, false>(s, dp, q0 + warp * 16, k0, S, Sk, scale, cap, causal, window,
                                   chunk_local, lr, dr);
    else
      p_ds_tile<CAP, true, false>(s, dp, q0 + warp * 16, k0, S, Sk, scale, cap, causal, window,
                                  chunk_local, lr, dr);
    // dQ += dS·K over the tile's keys
    mma_xb<DP, DP>(acc, dp, kt, 0, nh16);
    __syncthreads();  // every warp is done with this buffer before it is refilled
    cur = nxt;
  }

#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = qr + 8 * (e >> 1), d = j * 8 + (lane & 3) * 2 + (e & 1);
      if (qp < S && d < dh) st(dq + ((size_t)bh * S + qp) * dh + d, acc[j][e] * scale);
    }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DMAX, bool CAP>
int launch_all(const void* q, const void* k, const void* v, const void* o, const void* dout,
               void* dq, void* dk, void* dvo, float* lse, float* delta, int B, int H, int KV,
               int S, int Sk, int dh, int dv, float scale, float cap, int causal, int window,
               int chunk_local, cudaStream_t st) {
  constexpr int BQ = DMAX > 128 ? 32 : 64;  // query rows a block in kernels 1 and 3
  const size_t ts = row_stride<T>(dh), tv = row_stride<T>(dv);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* gt = static_cast<const T*>(dout);
  const int nq = (S + BQ - 1) / BQ, nk = (Sk + kBKV - 1) / kBKV;
  cudaError_t err;

  const size_t sm_pre = sizeof(T) * (BQ + kBK) * ts;
  if ((err = prepare(bwd_pre_kernel<T, BQ, CAP>, sm_pre)) != cudaSuccess) return (int)err;
  bwd_pre_kernel<T, BQ, CAP><<<B * H * nq, kThreads, sm_pre, st>>>(
      qt, kt, ot, gt, lse, delta, H, KV, S, Sk, dh, dv, scale, cap, causal, window, chunk_local);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

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
int launch_dh(const void* q, const void* k, const void* v, const void* o, const void* dout,
              void* dq, void* dk, void* dvo, float* lse, float* delta, int B, int H, int KV,
              int S, int Sk, int dh, int dv, float scale, float cap, int causal, int window,
              int chunk_local, cudaStream_t st) {
  if (dh <= 64)
    return launch_all<T, 64, CAP>(q, k, v, o, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk,
                                  dh, dv, scale, cap, causal, window, chunk_local, st);
  if (dh <= 128)
    return launch_all<T, 128, CAP>(q, k, v, o, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk,
                                   dh, dv, scale, cap, causal, window, chunk_local, st);
  return launch_all<T, 256, CAP>(q, k, v, o, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk, dh,
                                 dv, scale, cap, causal, window, chunk_local, st);
}

template <int DP, bool CAP>
int launch_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
               void* dq, void* dk, void* dvo, float* lse, float* delta, int B, int H, int KV,
               int S, int Sk, int dh, int dv, float scale, float cap, int causal, int window,
               int chunk_local, int vec, cudaStream_t st) {
  typedef __nv_bfloat16 T;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* gt = static_cast<const T*>(dout);
  const size_t tile = sizeof(T) * kMmaRows * (DP + 8);
  const int nq = (S + kMmaRows - 1) / kMmaRows, nk = (Sk + kMmaRows - 1) / kMmaRows;
  cudaError_t err;

  if ((err = prepare(bwd_pre_mma_kernel<DP, CAP>, 3 * tile)) != cudaSuccess) return (int)err;
  bwd_pre_mma_kernel<DP, CAP><<<B * H * nq, kMmaThreads, 3 * tile, st>>>(
      qt, kt, ot, gt, lse, delta, H, KV, S, Sk, dh, dv, scale, cap, causal, window, chunk_local,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t sm_kv = sizeof(float) * 4 * kMmaRows + 6 * tile;
  if ((err = prepare(bwd_dkdv_mma_kernel<DP, CAP>, sm_kv)) != cudaSuccess) return (int)err;
  bwd_dkdv_mma_kernel<DP, CAP><<<B * KV * nk, kMmaThreads, sm_kv, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dvo), H, KV, S, Sk, dh,
      dv, scale, cap, causal, window, chunk_local, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = prepare(bwd_dq_mma_kernel<DP, CAP>, 6 * tile)) != cudaSuccess) return (int)err;
  bwd_dq_mma_kernel<DP, CAP><<<B * H * nq, kMmaThreads, 6 * tile, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), H, KV, S, Sk, dh, dv, scale, cap, causal,
      window, chunk_local, vec);
  return (int)cudaGetLastError();
}

template <bool CAP>
int launch_mma_dh(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  void* dq, void* dk, void* dvo, float* lse, float* delta, int B, int H, int KV,
                  int S, int Sk, int dh, int dv, float scale, float cap, int causal, int window,
                  int chunk_local, int vec, cudaStream_t st) {
  if (dh <= 64)
    return launch_mma<64, CAP>(q, k, v, o, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk, dh,
                               dv, scale, cap, causal, window, chunk_local, vec, st);
  return launch_mma<128, CAP>(q, k, v, o, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk, dh,
                              dv, scale, cap, causal, window, chunk_local, vec, st);
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, const void* o, const void* dout,
                void* dq, void* dk, void* dvo, float* lse, float* delta, int B, int H, int KV,
                int S, int Sk, int dh, int dv, float scale, float cap, int causal, int window,
                int chunk_local, cudaStream_t st) {
  if (cap > 0.0f)
    return launch_dh<T, true>(q, k, v, o, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk, dh, dv,
                              scale, cap, causal, window, chunk_local, st);
  return launch_dh<T, false>(q, k, v, o, dout, dq, dk, dvo, lse, delta, B, H, KV, S, Sk, dh, dv,
                             scale, cap, causal, window, chunk_local, st);
}

}  // namespace

// q [B,H,S,dh], k [B,KV,Sk,dh], v [B,KV,Sk,dv], o and dout [B,H,S,dv] ->
// dq [B,H,S,dh], dk [B,KV,Sk,dh], dv [B,KV,Sk,dv]; lse and delta are float32
// [B,H,S] workspaces. dtype 0: float32, 1: bfloat16 (every tensor of the call).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq, void* dk,
                                          void* dvo, void* lse, void* delta, int B, int H, int KV,
                                          int S, int Sk, int dh, int dv, float scale, float cap,
                                          int causal, int window, int chunk_local, int dtype,
                                          void* stream) {
  if (B == 0 || H == 0 || S == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || dh <= 0 || dh > 256 || dv <= 0 || dv > dh || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (Sk != S && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_type<float>(q, k, v, o, dout, dq, dk, dvo, l, dl, B, H, KV, S, Sk, dh, dv,
                              scale, cap, causal, window, chunk_local, st);
  if (dtype == 1 && dh <= 128) {
    const int vec = dh % 8 == 0 && dv % 8 == 0 &&
                    ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
    if (cap > 0.0f)
      return launch_mma_dh<true>(q, k, v, o, dout, dq, dk, dvo, l, dl, B, H, KV, S, Sk, dh, dv,
                                 scale, cap, causal, window, chunk_local, vec, st);
    return launch_mma_dh<false>(q, k, v, o, dout, dq, dk, dvo, l, dl, B, H, KV, S, Sk, dh, dv,
                                scale, cap, causal, window, chunk_local, vec, st);
  }
  if (dtype == 1 && cap > 0.0f)  // dh > 128: the CUDA cores
    return launch_all<__nv_bfloat16, 256, true>(q, k, v, o, dout, dq, dk, dvo, l, dl, B, H, KV,
                                                S, Sk, dh, dv, scale, cap, causal, window,
                                                chunk_local, st);
  if (dtype == 1)
    return launch_all<__nv_bfloat16, 256, false>(q, k, v, o, dout, dq, dk, dvo, l, dl, B, H, KV,
                                                 S, Sk, dh, dv, scale, cap, causal, window,
                                                 chunk_local, st);
  return (int)cudaErrorInvalidValue;
}
