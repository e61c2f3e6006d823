// The backward of the stabilized parallel mLSTM (csrc/mlstm_chunk.cu) for
// Hopper (sm_90a).
//
// Replaces the gradient that the reference takes by autodiff of its plain
// `mlstm_parallel` (src/repro/models/xlstm.py:33, differentiated by jax.grad
// in src/repro/models/stack.py:298): the TPU kernel it stands beside,
// src/repro/kernels/mlstm/mlstm.py::mlstm_chunk, has no backward. With the
// forward's
//   D~[i, j] = F_i - F_j + logi_j (j <= i),   m_i = max_j D~[i, j]
//   C_ij = s q_i . k_j (s = dh^-0.5),   E_ij = exp(D~_ij - m_i),   W = C E
//   σ_i = Σ_j W_ij,   n_i = max(|σ_i|, exp(-m_i)),   h_i = Σ_j W_ij v_j / n_i
// and dh the output's gradient, a_i = [|σ_i| > exp(-m_i)] and
// δ_i = dh_i . h_i:
//   dW_ij = (dh_i . v_j - a_i sign(σ_i) δ_i) / n_i
//   dv_j  = Σ_i W_ij dh_i / n_i,   dC = dW E,   dq = s dC k,   dk = s dCᵀ q
//   dD~   = dW W,   dlogi_j = Σ_i dD~_ij,   dF_i = Σ_j dD~_ij - dlogi_i
// (m is a constant: h does not depend on it in either branch of n). q, k,
// v, h, dh [B,H,S,dh] (float32 or bfloat16, one type), F and logi [B,H,S]
// float32 (F the forward's own cumsum, so F_i - F_j is the same difference
// of large sums), and the forward's row statistics m and n [B,H,S] float32
// (the forward kernel writes them beside h when it runs under a gradient; n
// carries σ's sign where |σ| sets it, so a_i = [|n_i| > max(exp(-m_i),
// 1e-30)] and sign(σ_i) = sign(n_i)) -> dq, dk, dv in that type, dlogi and
// dF float32; every sum in float32. The wrapper turns dF into dlogf by a
// reverse cumsum.
//
// mlstm_chunk_bwd_launch runs, on the caller's stream:
// 0. `mlstm_bwd_c_kernel`, one warp a row: c_i = a_i sign(σ_i) δ_i and
//    1 / |n_i| into a float32 [2, B,H,S] workspace (a row pass: m, n and
//    σ's sign come from the forward, so nothing is recomputed).
// then one of two routes, by dtype:
//
// bfloat16 (every call of the training path), on wgmma (wgmma.cuh), in the
// shape of the flash backward's dh-256 kernels (csrc/flash_attention_bwd.cu):
// a dK / dV / dlogi kernel and a dQ / dF kernel that recomputes C and dh·Vᵀ
// (rather than summing dQ across key tiles through device memory), seven
// products a (query tile, key tile) pair, no atomics: every output element
// is summed by one thread in a fixed order, so two calls give the same
// bits.
// 1. `mlstm_bwd_dkdv_wgmma_kernel`, one block of two warpgroups per (b·h,
//    64-key tile), walking the 64-query tiles from the diagonal to S through
//    a ring of two stages of Q, dh and the tile's F, m, 1 / |n|, c (cp.async
//    one tile ahead); K, V and the keys' gates stay. A tile pair:
//    - warpgroup 0: Cᵀ = s K·Qᵀ, E and W (once), W to shared memory as
//      float32, then dV += (W / n)ᵀ·dh, W / n as bf16 A fragments;
//    - warpgroup 1, at the same time: (dh·Vᵀ)ᵀ = V·dhᵀ and dW, then, once W
//      is there, dC = dW E (E recomputed from the gates) and dD~ = dW W;
//      dK += dCᵀ·Q and dlogi as dD~'s column sum, in registers across the
//      tiles.
//    Each warpgroup holds one 64 x DP accumulator (128 registers a thread
//    at dh 256).
// 2. `mlstm_bwd_dq_wgmma_kernel`, one block of two warpgroups per (b·h,
//    64-query tile), walking the key tiles up to the diagonal: warpgroup 0
//    forms C and W, warpgroup 1 dh·Vᵀ and dW, then dC and dF's row sum of
//    dD~, and hands dC to warpgroup 0 as bf16 A fragments through shared
//    memory; dQ += dC·K is split by 64-column panels between the two. dF_i =
//    that sum - dlogi_i (kernel 1's output, earlier on the stream).
// W / n and dC enter the dV / dK / dQ products rounded to bf16, as FA2
// rounds P and dS; every sum and the elementwise math (D~, E, W, dW, dD~)
// stay float32, E by __expf (its argument is <= 0) and the division by n a
// product with the row pass's 1 / |n|. Head dims are padded to 64, 128 or
// 256 in shared memory only; S is taken as it is, the ragged edge masked
// (kp <= qp < S). No branch sits between a wgmma stage's fence and commit
// (ptxas would serialize every wgmma of the kernel).
//
// float32: on the CUDA cores in float32 (kernels 2-3 below, the flash
// backward's CUDA-core shape): `mlstm_bwd_dkdv_kernel`, one block per (b·h,
// 32-key tile), walking the 64-query tiles from the diagonal to S,
// recomputing W and dh·v and accumulating dK, dV (2 key rows x dh / 8
// columns a thread) and dlogi in registers; `mlstm_bwd_dq_kernel`, one
// block per (b·h, query tile), dQ and dF. Tiles are staged in shared memory
// with a row stride of an odd number of 4-byte words; 16 row groups x 8
// column lanes, the eight lanes of a row reducing with shuffles.
//
// Bound: five products of 2·dh flops per (query, key <= query) pair (W's
// recompute, dh·v, dV, dQ, dK) against 8·dh·itemsize bytes a position (q,
// k, v, h, dh read; dq, dk, dv written) and 16 bytes of gates; at
// xlstm-350m's training shape ([2, 4, 2048, 256] bf16) ~4.3e10 flops, the
// tensor cores' rate bounds it (0.044 ms at 989 TFLOP/s). The bf16 route
// does seven such products, C and dh·v twice; one block of eight warps an
// SM, whose two warpgroups' elementwise phases run one after the other,
// holds it back from the bound (PERF.md).
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

// `rows` float32 values from p + r0 into dst, 0 past n.
__device__ __forceinline__ void load_row(float* dst, const float* p, int r0, int rows, int n) {
  for (int i = threadIdx.x; i < rows; i += kThreads) dst[i] = r0 + i < n ? p[r0 + i] : 0.0f;
}

// Kernel 0: c_i = a_i sign(σ_i) δ_i from the forward's m and signed n, and
// 1 / |n_i| (what the bf16 kernels multiply by), one warp a row, its lanes
// over δ's columns.
template <typename T>
__global__ void __launch_bounds__(256)
mlstm_bwd_c_kernel(const T* __restrict__ h, const T* __restrict__ dh,
                   const float* __restrict__ m, const float* __restrict__ n,
                   float* __restrict__ c, float* __restrict__ rn, long long rows, int d) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // the whole warp
  const T* hr = h + r * d;
  const T* gr = dh + r * d;
  float acc = 0.0f;
  for (int j = lane; j < d; j += 32) acc = fmaf(ld(hr + j), ld(gr + j), acc);
#pragma unroll
  for (int w = 1; w < 32; w <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const float nn = n[r], fl = fmaxf(expf(-m[r]), 1e-30f);
    c[r] = fabsf(nn) > fl ? (nn > 0.0f ? acc : -acc) : 0.0f;
    rn[r] = 1.0f / fabsf(nn);
  }
}

// Kernel 2 (float32): dK, dV and dlogi of kBKV keys of one head.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dh,
                      const float* __restrict__ F, const float* __restrict__ logi,
                      const float* __restrict__ m_in, const float* __restrict__ n_in,
                      const float* __restrict__ c_in, T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dlogi, int S, int d, float scale) {
  constexpr int RK = kBKV / 16;  // key rows per thread
  constexpr int ND = DMAX / 8;   // dK / dV columns per thread
  constexpr int PS = kBQ2 + 1;   // row stride of the W / n and dC tiles
  const int nk = (S + kBKV - 1) / kBKV;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * kBKV;  // the first key tiles need the most queries
  const int ts = row_stride<T>(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // [kBKV][PS] W / n
  float* dc_s = w_s + kBKV * PS;                     // [kBKV][PS] dC
  float* fq_s = dc_s + kBKV * PS;                    // [kBQ2] the query tile's F
  float* m_s = fq_s + kBQ2;                          // [kBQ2] m
  float* n_s = m_s + kBQ2;                           // [kBQ2] n
  float* c_s = n_s + kBQ2;                           // [kBQ2] c
  T* k_s = reinterpret_cast<T*>(c_s + kBQ2);         // [kBKV][ts]
  T* v_s = k_s + kBKV * ts;                          // [kBKV][ts]
  T* q_s = v_s + kBKV * ts;                          // [kBQ2][ts]
  T* g_s = q_s + kBQ2 * ts;                          // [kBQ2][ts] dh

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const size_t row0 = (size_t)bh * S;
  stage_tile(k_s, k + row0 * d, k0, kBKV, S, d, ts);
  stage_tile(v_s, v + row0 * d, k0, kBKV, S, d, ts);
  float fk[RK], lk[RK], dli[RK], adk[RK][ND], adv[RK][ND];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kp = k0 + ty * RK + i;
    fk[i] = kp < S ? F[row0 + kp] : 0.0f;
    lk[i] = kp < S ? logi[row0 + kp] : 0.0f;
    dli[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < ND; ++j) adk[i][j] = adv[i][j] = 0.0f;
  }

  for (int q0 = (k0 / kBQ2) * kBQ2; q0 < S; q0 += kBQ2) {
    __syncthreads();  // the previous tile's readers are done with the tiles
    stage_tile(q_s, q + row0 * d, q0, kBQ2, S, d, ts);
    stage_tile(g_s, dh + row0 * d, q0, kBQ2, S, d, ts);
    load_row(fq_s, F + row0, q0, kBQ2, S);
    load_row(m_s, m_in + row0, q0, kBQ2, S);
    load_row(n_s, n_in + row0, q0, kBQ2, S);
    load_row(c_s, c_in + row0, q0, kBQ2, S);
    __syncthreads();

    // key rows ty * RK + i, query columns tx + 8 j: sᵀ = K · Qᵀ, then dPᵀ = V · dhᵀ
    float s[RK][8], dp[RK][8];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) qx[j] = ld(q_s + (tx + 8 * j) * ts + c);
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float kx = ld(k_s + (ty * RK + i) * ts + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(kx, qx[j], s[i][j]);
      }
    }
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float gx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) gx[j] = ld(g_s + (tx + 8 * j) * ts + c);
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float vx = ld(v_s + (ty * RK + i) * ts + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) dp[i][j] = fmaf(vx, gx[j], dp[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int kp = k0 + ty * RK + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = tx + 8 * j, qp = q0 + qc;
        float wn = 0.0f, dc = 0.0f;
        if (kp <= qp && qp < S) {
          const float e = expf(fq_s[qc] - fk[i] + lk[i] - m_s[qc]);
          const float w = s[i][j] * scale * e;
          const float nn = fabsf(n_s[qc]);
          const float dw = (dp[i][j] - c_s[qc]) / nn;
          wn = w / nn;
          dc = dw * e;
          dli[i] += dw * w;
        }
        w_s[(ty * RK + i) * PS + qc] = wn;
        dc_s[(ty * RK + i) * PS + qc] = dc;
      }
    }
    __syncthreads();

    // dV += (W / n)ᵀ · dh, dK += dCᵀ · Q over the tile's queries
#pragma unroll 2
    for (int qq = 0; qq < kBQ2; ++qq) {
      float gx[ND], qx[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int c = tx + 8 * j;
        gx[j] = c < d ? ld(g_s + qq * ts + c) : 0.0f;
        qx[j] = c < d ? ld(q_s + qq * ts + c) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float wv = w_s[(ty * RK + i) * PS + qq];
        const float dcv = dc_s[(ty * RK + i) * PS + qq];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          adv[i][j] = fmaf(wv, gx[j], adv[i][j]);
          adk[i][j] = fmaf(dcv, qx[j], adk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    float sum = dli[i];
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    const int kp = k0 + ty * RK + i;
    if (kp >= S) continue;
    if (tx == 0) dlogi[row0 + kp] = sum;
    T* krow = dk + (row0 + kp) * d;
    T* vrow = dv + (row0 + kp) * d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = tx + 8 * j;
      if (c < d) {
        st(krow + c, adk[i][j] * scale);
        st(vrow + c, adv[i][j]);
      }
    }
  }
}

// Kernel 3 (float32): dQ and dF of BQ query rows of one head.
template <typename T, int BQ, int DMAX>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dh,
                    const float* __restrict__ F, const float* __restrict__ logi,
                    const float* __restrict__ m_in, const float* __restrict__ n_in,
                    const float* __restrict__ c_in, const float* __restrict__ dlogi,
                    T* __restrict__ dq, float* __restrict__ dF, int S, int d, float scale) {
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int ND = DMAX / 8;  // dQ columns per thread
  constexpr int PS = kBK + 1;   // row stride of the dC tile
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;  // the longest rows first
  const int ts = row_stride<T>(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dc_s = reinterpret_cast<float*>(smem_raw);  // [BQ][PS]
  float* fk_s = dc_s + BQ * PS;                      // [64] F of the key tile
  float* lk_s = fk_s + kBK;                          // [64] logi of the key tile
  T* q_s = reinterpret_cast<T*>(lk_s + kBK);         // [BQ][ts]
  T* g_s = q_s + BQ * ts;                            // [BQ][ts] dh
  T* k_s = g_s + BQ * ts;                            // [64][ts]
  T* v_s = k_s + kBK * ts;                           // [64][ts]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const size_t row0 = (size_t)bh * S;
  const T* kb = k + row0 * d;
  const T* vb = v + row0 * d;
  stage_tile(q_s, q + row0 * d, q0, BQ, S, d, ts);
  stage_tile(g_s, dh + row0 * d, q0, BQ, S, d, ts);
  float fq[RQ], mr[RQ], nr[RQ], cr[RQ], rsum[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    const bool in = qp < S;
    fq[i] = in ? F[row0 + qp] : 0.0f;
    mr[i] = in ? m_in[row0 + qp] : 0.0f;
    nr[i] = in ? fabsf(n_in[row0 + qp]) : 1.0f;
    cr[i] = in ? c_in[row0 + qp] : 0.0f;
    rsum[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.0f;
  }

  const int k_end = min(q0 + BQ, S);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with k_s, v_s, dc_s
    stage_tile(k_s, kb, k0, kBK, S, d, ts);
    stage_tile(v_s, vb, k0, kBK, S, d, ts);
    load_row(fk_s, F + row0, k0, kBK, S);
    load_row(lk_s, logi + row0, k0, kBK, S);
    __syncthreads();

    float s[RQ][8], dp[RQ][8];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float kx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kx[j] = ld(k_s + (tx + 8 * j) * ts + c);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float qx = ld(q_s + (ty * RQ + i) * ts + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qx, kx[j], s[i][j]);
      }
    }
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float vx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vx[j] = ld(v_s + (tx + 8 * j) * ts + c);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float gx = ld(g_s + (ty * RQ + i) * ts + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) dp[i][j] = fmaf(gx, vx[j], dp[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = tx + 8 * j, kp = k0 + kc;
        float dc = 0.0f;
        if (kp <= qp && qp < S) {
          const float e = expf(fq[i] - fk_s[kc] + lk_s[kc] - mr[i]);
          const float w = s[i][j] * scale * e;
          const float dw = (dp[i][j] - cr[i]) / nr[i];
          dc = dw * e;
          rsum[i] += dw * w;
        }
        dc_s[(ty * RQ + i) * PS + kc] = dc;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float kx[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int c = tx + 8 * j;
        kx[j] = c < d ? ld(k_s + kk * ts + c) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float dcv = dc_s[(ty * RQ + i) * PS + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(dcv, kx[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float sum = rsum[i];
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    const int qp = q0 + ty * RQ + i;
    if (qp >= S) continue;
    if (tx == 0) dF[row0 + qp] = sum - dlogi[row0 + qp];
    T* row = dq + (row0 + qp) * d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = tx + 8 * j;
      if (c < d) st(row + c, acc[i][j] * scale);
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DMAX>
int launch_all(const void* q, const void* k, const void* v, const void* dh, const float* F,
               const float* logi, const float* m, const float* nn, const float* c, void* dq,
               void* dk, void* dv, float* dlogi, float* dF, int BH, int S, int d, float scale,
               cudaStream_t st) {
  constexpr int BQ = DMAX > 128 ? 32 : 64;  // query rows a block in kernel 3
  const size_t ts = row_stride<T>(d);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dh);
  const long long nq = (S + BQ - 1) / BQ, nk = (S + kBKV - 1) / kBKV;
  if ((long long)BH * (nq > nk ? nq : nk) > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err;

  const size_t sm_kv =
      sizeof(float) * (2 * kBKV * (kBQ2 + 1) + 4 * kBQ2) + sizeof(T) * 2 * (kBKV + kBQ2) * ts;
  if ((err = prepare(mlstm_bwd_dkdv_kernel<T, DMAX>, sm_kv)) != cudaSuccess) return (int)err;
  mlstm_bwd_dkdv_kernel<T, DMAX><<<(unsigned)(BH * nk), kThreads, sm_kv, st>>>(
      qt, kt, vt, gt, F, logi, m, nn, c, static_cast<T*>(dk), static_cast<T*>(dv), dlogi, S, d,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t sm_q = sizeof(float) * (BQ * (kBK + 1) + 2 * kBK) + sizeof(T) * 2 * (BQ + kBK) * ts;
  if ((err = prepare(mlstm_bwd_dq_kernel<T, BQ, DMAX>, sm_q)) != cudaSuccess) return (int)err;
  mlstm_bwd_dq_kernel<T, BQ, DMAX><<<(unsigned)(BH * nq), kThreads, sm_q, st>>>(
      qt, kt, vt, gt, F, logi, m, nn, c, dlogi, static_cast<T*>(dq), dF, S, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* dh, const float* F,
              const float* logi, const float* m, const float* n, const float* c, void* dq,
              void* dk, void* dv, float* dlogi, float* dF, int BH, int S, int d, float scale,
              cudaStream_t st) {
  if (d <= 64)
    return launch_all<T, 64>(q, k, v, dh, F, logi, m, n, c, dq, dk, dv, dlogi, dF, BH, S, d,
                             scale, st);
  if (d <= 128)
    return launch_all<T, 128>(q, k, v, dh, F, logi, m, n, c, dq, dk, dv, dlogi, dF, BH, S, d,
                              scale, st);
  return launch_all<T, 256>(q, k, v, dh, F, logi, m, n, c, dq, dk, dv, dlogi, dF, BH, S, d,
                            scale, st);
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma (design at the top)
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t wg_dkdv_smem() {
  // K, V and two stages of Q and dh (DP x 128 bytes each), W (64 x 64
  // float32), two stages of the query tile's F, m, n and c, 1 KB to align
  return (size_t)6 * DP * 128 + 64 * 64 * 4 + 2 * 4 * 64 * 4 + 1024;
}

// Kernel 1: dK (warpgroup 1), dV (warpgroup 0) and dlogi (warpgroup 1) of
// 64 keys of one head.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
mlstm_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dh,
                            const float* __restrict__ F, const float* __restrict__ logi,
                            const float* __restrict__ m_in, const float* __restrict__ rn_in,
                            const float* __restrict__ c_in, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, float* __restrict__ dlogi, int BH, int S,
                            int d, float scale, int aligned) {
  constexpr int NP = DP / 64;
  constexpr int T_BYTES = NP * kT * 128;  // one tile
  const int nq = (S + kT - 1) / kT;
  // the first key tiles of every head, which need the most queries, first
  const int bh = blockIdx.x % BH, kt = blockIdx.x / BH, k0 = kt * kT;
  const int tid = threadIdx.x, wg = warpgroup(), t = tid & 127;
  const int ra = 16 * (t >> 5) + ((tid & 31) >> 2), cq = 2 * (tid & 3);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = base;
  unsigned char* v_s = base + T_BYTES;
  unsigned char* st_s = base + 2 * T_BYTES;  // stage s: Q at st_s + 2 s T_BYTES, dh after it
  float* w_s = reinterpret_cast<float*>(base + 6 * T_BYTES);  // [32][128]: warpgroup 0's W
  float* r_s = w_s + 32 * 128;  // stage s: F, m, 1 / |n|, c of the query tile at r_s + 256 s + 64 i

  const size_t row0 = (size_t)bh * S;
  const bool al = aligned != 0;
  auto issue = [&](int tq, int s) {
    const int q0 = tq * kT;
    load_tile<kT, DP>(st_s + 2 * s * T_BYTES, q + row0 * d, q0, S, d, al, tid);
    load_tile<kT, DP>(st_s + (2 * s + 1) * T_BYTES, dh + row0 * d, q0, S, d, al, tid);
    float* rb = r_s + 256 * s;
    load_row64(rb, F + row0, q0, S, tid);
    load_row64(rb + 64, m_in + row0, q0, S, tid);
    load_row64(rb + 128, rn_in + row0, q0, S, tid);
    load_row64(rb + 192, c_in + row0, q0, S, tid);
  };
  load_tile<kT, DP>(k_s, k + row0 * d, k0, S, d, al, tid);
  load_tile<kT, DP>(v_s, v + row0 * d, k0, S, d, al, tid);
  issue(kt, 0);  // the query tiles from the diagonal on need these keys
  cp_async_commit();

  float fk[2], lk[2], dli[2] = {0.0f, 0.0f};  // key rows k0 + ra and k0 + ra + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = k0 + ra + 8 * hf;
    fk[hf] = kp < S ? F[row0 + kp] : 0.0f;
    lk[hf] = kp < S ? logi[row0 + kp] : 0.0f;
  }
  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  // warpgroup 0: Cᵀ = K·Qᵀ, then dV += (W / n)ᵀ·dh; warpgroup 1: V·dhᵀ,
  // then dK += dCᵀ·Q
  const uint32_t a_addr = smem_u32(wg == 0 ? k_s : v_s);

  for (int tq = kt, s = 0; tq < nq; ++tq, s ^= 1) {
    if (tq + 1 < nq) issue(tq + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile tq (and K, V) have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t q_addr = smem_u32(st_s + 2 * s * T_BYTES), g_addr = q_addr + T_BYTES;
    const float* fq = r_s + 256 * s;
    const float* mq = fq + 64;
    const float* rq = fq + 128;  // 1 / |n|
    const float* cq_ = fq + 192;
    const int q0 = tq * kT;
    const bool interior = k0 + kT - 1 <= q0 && q0 + kT - 1 < S;

    float x[32];
    scores<DP>(x, a_addr, wg == 0 ? q_addr : g_addr);
    // element i: key row k0 + ra (+ 8 when i & 2), query column 8 (i / 4) + cq + (i & 1);
    // E = exp(D~ - m) <= 1 by __expf, 1 / |n| the c pass's
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hf = (i >> 1) & 1, kp = k0 + ra + 8 * hf;
        const int qc = 8 * (i >> 2) + cq + (i & 1), qp = q0 + qc;
        float w = 0.0f, wn = 0.0f;
        if (interior || (kp <= qp && qp < S)) {
          w = x[i] * scale * __expf(fq[qc] - fk[hf] + lk[hf] - mq[qc]);
          wn = w * rq[qc];
        }
        w_s[i * 128 + t] = w;
        x[i] = wn;
      }
    } else {  // dW = (dh·v - c) / |n| while warpgroup 0 forms W
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i >> 2) + cq + (i & 1);
        x[i] = (x[i] - cq_[qc]) * rq[qc];
      }
    }
    __syncthreads();  // W in shared memory
    if (wg == 1) {  // dC = dW E, dlogi's column sum of dD~ = dW W
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hf = (i >> 1) & 1, kp = k0 + ra + 8 * hf;
        const int qc = 8 * (i >> 2) + cq + (i & 1), qp = q0 + qc;
        float dc = 0.0f;
        if (interior || (kp <= qp && qp < S)) {
          dc = x[i] * __expf(fq[qc] - fk[hf] + lk[hf] - mq[qc]);
          dli[hf] += x[i] * w_s[i * 128 + t];
        }
        x[i] = dc;
      }
    }
    uint32_t a[4][4];
    to_a(a, x);
    accumulate<NP>(acc, a, wg == 0 ? g_addr : q_addr, 0);
    __syncthreads();  // every reader is done with stage s and with w_s
  }
  cp_async_wait<0>();

  if (wg == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sum = dli[hf];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int kp = k0 + ra + 8 * hf;
      if (kp < S && (tid & 3) == 0) dlogi[row0 + kp] = sum;
    }
  }
  store_rows<NP>(acc, wg == 1 ? dk : dv, nullptr, row0, k0, S, 0, d, wg == 1 ? scale : 1.0f, ra,
                 cq);
}

template <int DP>
constexpr size_t wg_dq_smem() {
  // Q, dh and two stages of K and V (DP x 128 bytes each), W (64 x 64
  // float32), dC as bf16 A fragments (64 x 64 x 2 bytes), two stages of
  // the key tile's F and logi, 1 KB to align
  return (size_t)6 * DP * 128 + 64 * 64 * 4 + 64 * 64 * 2 + 2 * 2 * 64 * 4 + 1024;
}

// Kernel 2: dQ and dF of 64 query rows of one head; warpgroup 0 forms W,
// warpgroup 1 dW, dC and dF, and the dQ panels are split between them.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
mlstm_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dh,
                          const float* __restrict__ F, const float* __restrict__ logi,
                          const float* __restrict__ m_in, const float* __restrict__ rn_in,
                          const float* __restrict__ c_in, const float* __restrict__ dlogi,
                          bf16* __restrict__ dq, float* __restrict__ dF, int BH, int S, int d,
                          float scale, int aligned) {
  constexpr int NP = DP / 64;
  constexpr int NPW = NP > 1 ? NP / 2 : 1;  // dQ panels a warpgroup accumulates
  constexpr int T_BYTES = NP * kT * 128;
  const int nq = (S + kT - 1) / kT;
  // the last query tiles of every head, the longest rows, first
  const int bh = blockIdx.x % BH, q0 = (nq - 1 - blockIdx.x / BH) * kT;
  const int nt = (min(q0 + kT, S) + kT - 1) / kT;  // the key tiles up to the diagonal
  const int tid = threadIdx.x, wg = warpgroup(), t = tid & 127;
  const int ra = 16 * (t >> 5) + ((tid & 31) >> 2), cq = 2 * (tid & 3);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* g_s = base + T_BYTES;       // dh
  unsigned char* st_s = base + 2 * T_BYTES;  // stage s: K at st_s + 2 s T_BYTES, V after it
  float* w_s = reinterpret_cast<float*>(base + 6 * T_BYTES);  // [32][128]: warpgroup 0's W
  uint32_t* dc_s = reinterpret_cast<uint32_t*>(w_s + 32 * 128);  // [16][128]: dC fragments
  float* gk_s = reinterpret_cast<float*>(dc_s + 16 * 128);  // stage s: F, logi at 128 s, + 64

  const size_t row0 = (size_t)bh * S;
  const bool al = aligned != 0;
  auto issue = [&](int j, int s) {
    load_tile<kT, DP>(st_s + 2 * s * T_BYTES, k + row0 * d, j * kT, S, d, al, tid);
    load_tile<kT, DP>(st_s + (2 * s + 1) * T_BYTES, v + row0 * d, j * kT, S, d, al, tid);
    load_row64(gk_s + 128 * s, F + row0, j * kT, S, tid);
    load_row64(gk_s + 128 * s + 64, logi + row0, j * kT, S, tid);
  };
  load_tile<kT, DP>(q_s, q + row0 * d, q0, S, d, al, tid);
  load_tile<kT, DP>(g_s, dh + row0 * d, q0, S, d, al, tid);
  issue(0, 0);
  cp_async_commit();

  float fq[2], mr[2], nr[2], cr[2], rs[2] = {0.0f, 0.0f};  // rows q0 + ra and q0 + ra + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = q0 + ra + 8 * hf;
    const bool in = qp < S;
    fq[hf] = in ? F[row0 + qp] : 0.0f;
    mr[hf] = in ? m_in[row0 + qp] : 0.0f;
    nr[hf] = in ? rn_in[row0 + qp] : 1.0f;  // 1 / |n|
    cr[hf] = in ? c_in[row0 + qp] : 0.0f;
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

  for (int j = 0, s = 0; j < nt; ++j, s ^= 1) {
    if (j + 1 < nt) issue(j + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t k_addr = smem_u32(st_s + 2 * s * T_BYTES), v_addr = k_addr + T_BYTES;
    const float* fk = gk_s + 128 * s;
    const float* lk = fk + 64;
    const int k0 = j * kT;
    const bool interior = k0 + kT - 1 <= q0 && q0 + kT - 1 < S;

    float x[32];
    scores<DP>(x, a_addr, wg == 0 ? k_addr : v_addr);
    // element i: query row q0 + ra (+ 8 when i & 2), key column 8 (i / 4) + cq + (i & 1)
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hf = (i >> 1) & 1, qp = q0 + ra + 8 * hf;
        const int kc = 8 * (i >> 2) + cq + (i & 1), kp = k0 + kc;
        float w = 0.0f;
        if (interior || (kp <= qp && qp < S))
          w = x[i] * scale * __expf(fq[hf] - fk[kc] + lk[kc] - mr[hf]);
        w_s[i * 128 + t] = w;
      }
    } else {  // dW = (dh·v - c) / |n| while warpgroup 0 forms W
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = (x[i] - cr[(i >> 1) & 1]) * nr[(i >> 1) & 1];
    }
    __syncthreads();  // W in shared memory
    uint32_t a[4][4];
    if (wg == 1) {  // dC = dW E, dF's row sum of dD~ = dW W; dC to bf16 fragments for both
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hf = (i >> 1) & 1, qp = q0 + ra + 8 * hf;
        const int kc = 8 * (i >> 2) + cq + (i & 1), kp = k0 + kc;
        float dc = 0.0f;
        if (interior || (kp <= qp && qp < S)) {
          dc = x[i] * __expf(fq[hf] - fk[kc] + lk[kc] - mr[hf]);
          rs[hf] += x[i] * w_s[i * 128 + t];
        }
        x[i] = dc;
      }
      to_a(a, x);
#pragma unroll
      for (int i = 0; i < 16; ++i) dc_s[i * 128 + t] = a[i >> 2][i & 3];
    }
    __syncthreads();  // dC in shared memory
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i >> 2][i & 3] = dc_s[i * 128 + t];
    }
    accumulate<NPW>(acc, a, k_addr, p0);
    __syncthreads();  // every reader is done with stage s, w_s and dc_s
  }
  cp_async_wait<0>();

  if (wg == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sum = rs[hf];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int qp = q0 + ra + 8 * hf;
      if (qp < S && (tid & 3) == 0) dF[row0 + qp] = sum - dlogi[row0 + qp];
    }
  }
  if (NP > 1 || wg == 1) store_rows<NPW>(acc, dq, nullptr, row0, q0, S, p0, d, scale, ra, cq);
}

template <int DP>
int launch_wg(const void* q, const void* k, const void* v, const void* dh, const float* F,
              const float* logi, const float* m, const float* rn, const float* c, void* dq,
              void* dk, void* dv, float* dlogi, float* dF, int BH, int S, int d, float scale,
              cudaStream_t st) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dh);
  const int aligned =
      d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dh) % 16 == 0;
  const long long blocks = (long long)BH * ((S + kT - 1) / kT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err;

  constexpr size_t sm_kv = wg_dkdv_smem<DP>();
  if ((err = prepare(mlstm_bwd_dkdv_wgmma_kernel<DP>, sm_kv)) != cudaSuccess) return (int)err;
  mlstm_bwd_dkdv_wgmma_kernel<DP><<<(unsigned)blocks, kWgThreads, sm_kv, st>>>(
      qt, kt, vt, gt, F, logi, m, rn, c, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dlogi,
      BH, S, d, scale, aligned);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  constexpr size_t sm_q = wg_dq_smem<DP>();
  if ((err = prepare(mlstm_bwd_dq_wgmma_kernel<DP>, sm_q)) != cudaSuccess) return (int)err;
  mlstm_bwd_dq_wgmma_kernel<DP><<<(unsigned)blocks, kWgThreads, sm_q, st>>>(
      qt, kt, vt, gt, F, logi, m, rn, c, dlogi, static_cast<bf16*>(dq), dF, BH, S, d, scale,
      aligned);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dh, const float* F,
                const float* logi, const float* m, const float* rn, const float* c, void* dq,
                void* dk, void* dv, float* dlogi, float* dF, int BH, int S, int d, float scale,
                cudaStream_t st) {
  if (d <= 64)
    return launch_wg<64>(q, k, v, dh, F, logi, m, rn, c, dq, dk, dv, dlogi, dF, BH, S, d, scale,
                         st);
  if (d <= 128)
    return launch_wg<128>(q, k, v, dh, F, logi, m, rn, c, dq, dk, dv, dlogi, dF, BH, S, d, scale,
                          st);
  return launch_wg<256>(q, k, v, dh, F, logi, m, rn, c, dq, dk, dv, dlogi, dF, BH, S, d, scale,
                        st);
}

template <typename T>
int launch_c(const void* h, const void* dh, const float* m, const float* n, float* c, float* rn,
             long long rows, int d, cudaStream_t st) {
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  mlstm_bwd_c_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(dh), m, n, c, rn, rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the float32 workspace (c and 1 / |n| of every row) a call needs.
extern "C" long long mlstm_chunk_bwd_workspace_bytes(int BH, int S) {
  return 2LL * BH * S * (long long)sizeof(float);
}

// q, k, v, h (the forward's output), dh (its gradient) [BH, S, d] ->
// dq, dk, dv [BH, S, d]; F, logi and the forward's m and n [BH, S] float32
// -> dlogi, dF [BH, S] float32; ws holds
// mlstm_chunk_bwd_workspace_bytes(BH, S). dtype 0: float32, 1: bfloat16 (q,
// k, v, h, dh, dq, dk, dv). Shapes are checked by the Python wrapper.
extern "C" int mlstm_chunk_bwd_launch(const void* q, const void* k, const void* v,
                                      const void* h, const void* dh, const void* F,
                                      const void* logi, const void* m, const void* n, void* dq,
                                      void* dk, void* dv, void* dlogi, void* dF, void* ws, int BH,
                                      int S, int d, float scale, int dtype, void* stream) {
  if (BH == 0 || S == 0) return (int)cudaGetLastError();
  if (d <= 0 || d > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* f = static_cast<const float*>(F);
  const float* li = static_cast<const float*>(logi);
  const float* mm = static_cast<const float*>(m);
  const float* nn = static_cast<const float*>(n);
  float* dl = static_cast<float*>(dlogi);
  float* df = static_cast<float*>(dF);
  const long long rows = (long long)BH * S;
  float* c = static_cast<float*>(ws);
  float* rn = c + rows;
  int err;
  if (dtype == 0) {
    if ((err = launch_c<float>(h, dh, mm, nn, c, rn, rows, d, st)) != 0) return err;
    return launch_dh<float>(q, k, v, dh, f, li, mm, nn, c, dq, dk, dv, dl, df, BH, S, d, scale,
                            st);
  }
  if (dtype == 1) {
    if ((err = launch_c<bf16>(h, dh, mm, nn, c, rn, rows, d, st)) != 0) return err;
    return launch_bf16(q, k, v, dh, f, li, mm, rn, c, dq, dk, dv, dl, df, BH, S, d, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
