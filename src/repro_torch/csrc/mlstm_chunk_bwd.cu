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
// of large sums) -> dq, dk, dv in that type, dlogi and dF float32; every sum
// in float32. The wrapper turns dF into dlogf by a reverse cumsum.
//
// Three kernels, launched in turn on the caller's stream by
// mlstm_chunk_bwd_launch, in one of two routes chosen by dtype:
// - bfloat16 (every call of the training path): on the tensor cores,
//   mma.sync m16n8k16 with float32 accumulation (kernels 1m-3m below; their
//   own comment has the design);
// - float32: on the CUDA cores in float32 (kernels 1-3), in the shape of
//   the flash backward's CUDA-core route (csrc/flash_attention_bwd.cu):
// 1. `mlstm_bwd_pre_kernel`, one block per (b·h, query tile): m_i as the
//    forward takes it (the running max of the same rounded D~, so the same
//    bits), then σ_i = Σ_j W_ij with that m, δ_i from h and dh; it writes
//    m_i, n_i = max(|σ_i|, exp(-m_i), 1e-30) (the forward's floor) and
//    c_i = a_i sign(σ_i) δ_i into three float32 [B,H,S] workspaces.
// 2. `mlstm_bwd_dkdv_kernel`, one block per (b·h, 32-key tile): K, V and
//    the keys' gates stay; the block walks the 64-query tiles from the
//    diagonal to S, recomputes W and dh·v for the tile ([32 keys][64
//    queries], 2 x 8 a thread), keeps W / n and dC in shared memory and
//    accumulates dK, dV (2 key rows x dh / 8 columns a thread) and dlogi in
//    registers.
// 3. `mlstm_bwd_dq_kernel`, one block per (b·h, query tile): Q, dh and the
//    rows' m, n, c stay; the block walks the key tiles up to the diagonal,
//    recomputes W and dW, accumulates dQ and the row sum of dD~, and writes
//    dF_i = that sum - dlogi_i (kernel 2's output, earlier on the stream).
// No atomics: each output element is summed by one thread in a fixed order,
// so two calls give the same bits. Masks are explicit (kp <= qp < S), so S
// and dh are taken as they are and the ragged edges are zeros.
//
// Bound: five products of 2·dh flops per (query, key <= query) pair (W's
// recompute, dh·v, dV, dQ, dK) against 8·dh·itemsize bytes a position (q,
// k, v, h, dh read; dq, dk, dv written) and 16 bytes of gates; at
// xlstm-350m's training shape ([2, 4, 2048, 256] bf16) ~4.3e10 flops, the
// tensor cores' rate bounds it (0.044 ms at 989 TFLOP/s). Both routes
// recompute W in all three kernels and dh·v in two: eight such products
// (ten at dh 256 on the tensor cores, whose dK / dV and dQ blocks take half
// the columns each and recompute their tile's two products).
//
// The CUDA-core kernels stage tiles in shared memory with a row stride of
// an odd number of 4-byte words; their thread layout is the forward's
// float32 kernel's: 16 row groups x 8 column lanes, the eight lanes of a row
// reducing with shuffles. Built with -fmad=false like every kernel of the
// port: products use fmaf.
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

// `rows` float32 values from p + r0 into dst, 0 past n.
__device__ __forceinline__ void load_row(float* dst, const float* p, int r0, int rows, int n) {
  for (int i = threadIdx.x; i < rows; i += kThreads) dst[i] = r0 + i < n ? p[r0 + i] : 0.0f;
}

// Kernel 1: m, n and c of BQ query rows.
template <typename T, int BQ>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_pre_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ h, const T* __restrict__ dh,
                     const float* __restrict__ F, const float* __restrict__ logi,
                     float* __restrict__ m_out, float* __restrict__ n_out,
                     float* __restrict__ c_out, int S, int d, float scale) {
  constexpr int RQ = BQ / 16;
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;
  const int ts = row_stride<T>(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fk_s = reinterpret_cast<float*>(smem_raw);  // [64] F of the key tile
  float* lk_s = fk_s + kBK;                          // [64] logi of the key tile
  T* q_s = reinterpret_cast<T*>(lk_s + kBK);         // [BQ][ts]
  T* k_s = q_s + BQ * ts;                            // [64][ts]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const size_t row0 = (size_t)bh * S;
  const T* kb = k + row0 * d;
  const float* Fb = F + row0;
  const float* lb = logi + row0;
  load_tile(q_s, q + row0 * d, q0, BQ, S, d, ts);

  float delta[RQ], fq[RQ], m[RQ], sg[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    float acc = 0.0f;
    if (qp < S) {
      const T* hr = h + (row0 + qp) * d;
      const T* gr = dh + (row0 + qp) * d;
      for (int c = tx; c < d; c += 8) acc = fmaf(ld(hr + c), ld(gr + c), acc);
    }
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    delta[i] = acc;
    fq[i] = qp < S ? Fb[qp] : 0.0f;
    m[i] = kNeg;
    sg[i] = 0.0f;
  }

  const int k_end = min(q0 + BQ, S);  // keys past the block's last row are all masked
  // m: the forward's running max of the rounded D~ (order-free: the same bits)
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_row(fk_s, Fb, k0, kBK, S);
    load_row(lk_s, lb, k0, kBK, S);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty * RQ + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        if (k0 + c <= qp && k0 + c < S) mx = fmaxf(mx, fq[i] - fk_s[c] + lk_s[c]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      m[i] = fmaxf(m[i], mx);
    }
  }
  // σ with that m
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_tile(k_s, kb, k0, kBK, S, d, ts);
    load_row(fk_s, Fb, k0, kBK, S);
    load_row(lk_s, lb, k0, kBK, S);
    __syncthreads();
    float s[RQ][8];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
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
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty * RQ + i;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        if (k0 + c <= qp && k0 + c < S)
          sum += s[i][j] * scale * expf(fq[i] - fk_s[c] + lk_s[c] - m[i]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      sg[i] += sum;
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    if (qp >= S || tx != 0) continue;
    const float floor = fmaxf(expf(-m[i]), 1e-30f);
    const float mag = fabsf(sg[i]);
    m_out[row0 + qp] = m[i];
    n_out[row0 + qp] = fmaxf(mag, floor);
    c_out[row0 + qp] = mag > floor ? (sg[i] > 0.0f ? delta[i] : -delta[i]) : 0.0f;
  }
}

// Kernel 2: dK, dV and dlogi of kBKV keys of one head.
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
  load_tile(k_s, k + row0 * d, k0, kBKV, S, d, ts);
  load_tile(v_s, v + row0 * d, k0, kBKV, S, d, ts);
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
    load_tile(q_s, q + row0 * d, q0, kBQ2, S, d, ts);
    load_tile(g_s, dh + row0 * d, q0, kBQ2, S, d, ts);
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
          const float dw = (dp[i][j] - c_s[qc]) / n_s[qc];
          wn = w / n_s[qc];
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

// Kernel 3: dQ and dF of BQ query rows of one head.
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
  load_tile(q_s, q + row0 * d, q0, BQ, S, d, ts);
  load_tile(g_s, dh + row0 * d, q0, BQ, S, d, ts);
  float fq[RQ], mr[RQ], nr[RQ], cr[RQ], rsum[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    const bool in = qp < S;
    fq[i] = in ? F[row0 + qp] : 0.0f;
    mr[i] = in ? m_in[row0 + qp] : 0.0f;
    nr[i] = in ? n_in[row0 + qp] : 1.0f;
    cr[i] = in ? c_in[row0 + qp] : 0.0f;
    rsum[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.0f;
  }

  const int k_end = min(q0 + BQ, S);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with k_s, v_s, dc_s
    load_tile(k_s, kb, k0, kBK, S, d, ts);
    load_tile(v_s, vb, k0, kBK, S, d, ts);
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
int launch_all(const void* q, const void* k, const void* v, const void* h, const void* dh,
               const float* F, const float* logi, void* dq, void* dk, void* dv, float* dlogi,
               float* dF, float* ws, int BH, int S, int d, float scale, cudaStream_t st) {
  constexpr int BQ = DMAX > 128 ? 32 : 64;  // query rows a block in kernels 1 and 3
  const size_t ts = row_stride<T>(d);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ht = static_cast<const T*>(h);
  const T* gt = static_cast<const T*>(dh);
  const size_t n = (size_t)BH * S;
  float* m = ws;
  float* nn = ws + n;
  float* c = ws + 2 * n;
  const long long nq = (S + BQ - 1) / BQ, nk = (S + kBKV - 1) / kBKV;
  if ((long long)BH * (nq > nk ? nq : nk) > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err;

  const size_t sm_pre = sizeof(float) * 2 * kBK + sizeof(T) * (BQ + kBK) * ts;
  if ((err = prepare(mlstm_bwd_pre_kernel<T, BQ>, sm_pre)) != cudaSuccess) return (int)err;
  mlstm_bwd_pre_kernel<T, BQ><<<(unsigned)(BH * nq), kThreads, sm_pre, st>>>(
      qt, kt, ht, gt, F, logi, m, nn, c, S, d, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

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
int launch_dh(const void* q, const void* k, const void* v, const void* h, const void* dh,
              const float* F, const float* logi, void* dq, void* dk, void* dv, float* dlogi,
              float* dF, float* ws, int BH, int S, int d, float scale, cudaStream_t st) {
  if (d <= 64)
    return launch_all<T, 64>(q, k, v, h, dh, F, logi, dq, dk, dv, dlogi, dF, ws, BH, S, d, scale,
                             st);
  if (d <= 128)
    return launch_all<T, 128>(q, k, v, h, dh, F, logi, dq, dk, dv, dlogi, dF, ws, BH, S, d,
                              scale, st);
  return launch_all<T, 256>(q, k, v, h, dh, F, logi, dq, dk, dv, dlogi, dF, ws, BH, S, d, scale,
                            st);
}

// ---------------------------------------------------------------------------
// bfloat16: the same three kernels on the tensor cores
// ---------------------------------------------------------------------------
//
// mma.sync m16n8k16 (bf16 in, float32 accumulate) through mma_sync.cuh, in
// the shape of the flash backward's tensor-core kernels
// (csrc/flash_attention_bwd.cu): a warp owns 16 rows of the block's 64
// (queries in kernels 1m and 3m, keys in kernel 2m) and walks 64-row tiles
// of the other side through two cp.async buffers, each filled while the
// other is used. C = q·k and dh·v are float32 sums of exact bf16 products;
// the elementwise math (D~, E, W, dW, dD~ and its row and column sums:
// dlogi, dF) is float32 as in the CUDA-core kernels; W / n and dC are
// rounded to bf16 as the A operand of dV += (W / n)ᵀ·dh, dK += dCᵀ·Q and
// dQ += dC·K, as FA2 rounds P and dS. A block of kernels 2m and 3m
// accumulates kMmaCols (128) columns of its output: at dh 256 two blocks
// share a tile and each recomputes its two products, so dK, dV or dQ take
// 64 float32 registers a thread for each output.
// 1m: m (the running max of the forward's D~), σ rescaled as m moves, δ;
// 2m: dK, dV and dlogi of 64 keys (the first column block writes dlogi);
// 3m: dQ and dF of 64 queries (the first column block writes dF).

constexpr int kMmaCols = 128;  // output columns a block of kernels 2m and 3m accumulates

template <int N>
__device__ __forceinline__ void zero(float (*x)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
}

// Kernel 1m: m, n and c of 64 query rows (a warp's 16).
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
mlstm_bwd_pre_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ h, const bf16* __restrict__ dh,
                         const float* __restrict__ F, const float* __restrict__ logi,
                         float* __restrict__ m_out, float* __restrict__ n_out,
                         float* __restrict__ c_out, int S, int d, float scale, int vec) {
  constexpr int LD = DP + 8, TILE = kMmaRows * LD;
  const int nq = (S + kMmaRows - 1) / kMmaRows, nbh = gridDim.x / nq;
  // the last query tiles of every head, the longest rows, first
  const int bh = blockIdx.x % nbh;
  const int q0 = (nq - 1 - blockIdx.x / nbh) * kMmaRows;
  const int nk16 = (d + 15) / 16;
  const int nt = (min(q0 + kMmaRows, S) + kMmaRows - 1) / kMmaRows;  // the key tiles needed

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* g_s = reinterpret_cast<float*>(smem_raw);  // [2][2][64] F, logi of a key tile
  float* dl_s = g_s + 4 * kMmaRows;                  // [64] δ of the block's rows
  bf16* q_s = reinterpret_cast<bf16*>(dl_s + kMmaRows);  // [64][LD]
  bf16* k_s = q_s + TILE;                                 // [2][64][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)bh * S;
  const bf16* kb = k + row0 * d;
  const float* Fb = F + row0;
  const float* lb = logi + row0;
  auto issue = [&](int t, int buf) {
    load_tile_mma<DP>(k_s + buf * TILE, kb, t * kMmaRows, kMmaRows, S, d, vec);
    load_rows_async(g_s + buf * 2 * kMmaRows, Fb, t * kMmaRows, S);
    load_rows_async(g_s + buf * 2 * kMmaRows + kMmaRows, lb, t * kMmaRows, S);
  };
  load_tile_mma<DP>(q_s, q + row0 * d, q0, kMmaRows, S, d, vec);
  issue(0, 0);
  cp_async_commit();

  // δ = dh · h while the first tiles land: a warp's 16 rows, its lanes over
  // the columns
  for (int r = 0; r < 16; ++r) {
    const int qp = q0 + warp * 16 + r;
    float acc = 0.0f;
    if (qp < S) {
      const bf16* hr = h + (row0 + qp) * d;
      const bf16* gr = dh + (row0 + qp) * d;
      for (int c = lane; c < d; c += 32) acc = fmaf(ld(hr + c), ld(gr + c), acc);
    }
#pragma unroll
    for (int w = 1; w < 32; w <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) dl_s[warp * 16 + r] = acc;
  }
  __syncwarp();

  const int qr = q0 + warp * 16 + (lane >> 2);  // rows qr and qr + 8
  float fq[2], m[2] = {kNeg, kNeg}, sg[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) fq[hf] = qr + 8 * hf < S ? Fb[qr + 8 * hf] : 0.0f;
  for (int t = 0, buf = 0; t < nt; ++t, buf ^= 1) {
    if (t + 1 < nt) issue(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int k0 = t * kMmaRows;
    const float* fk = g_s + buf * 2 * kMmaRows;
    const float* lk = fk + kMmaRows;
    float s[8][4];
    zero<8>(s);
    mma_abt<DP>(s, q_s + warp * 16 * LD, k_s + buf * TILE, nk16);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qp = qr + 8 * hf;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + (lane & 3) * 2 + e;
          if (k0 + c <= qp) mx = fmaxf(mx, fq[hf] - fk[c] + lk[c]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + (lane & 3) * 2 + e;
          if (k0 + c <= qp)
            sum += s[j][2 * hf + e] * scale * expf(fq[hf] - fk[c] + lk[c] - m_new);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sg[hf] = sg[hf] * expf(m[hf] - m_new) + sum;
      m[hf] = m_new;
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = qr + 8 * hf;
    if (qp >= S || (lane & 3) != 0) continue;
    const float floor = fmaxf(expf(-m[hf]), 1e-30f);
    const float mag = fabsf(sg[hf]), delta = dl_s[warp * 16 + (lane >> 2) + 8 * hf];
    m_out[row0 + qp] = m[hf];
    n_out[row0 + qp] = fmaxf(mag, floor);
    c_out[row0 + qp] = mag > floor ? (sg[hf] > 0.0f ? delta : -delta) : 0.0f;
  }
}

// Kernel 2m: dK, dV and dlogi of 64 keys (a warp's 16) of one head, output
// columns [c0, c0 + COLS).
template <int DP, int COLS>
__global__ void __launch_bounds__(kMmaThreads)
mlstm_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dh,
                          const float* __restrict__ F, const float* __restrict__ logi,
                          const float* __restrict__ m_in, const float* __restrict__ n_in,
                          const float* __restrict__ c_in, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, float* __restrict__ dlogi, int S, int d,
                          float scale, int vec) {
  constexpr int LD = DP + 8, TILE = kMmaRows * LD;
  const int nk = (S + kMmaRows - 1) / kMmaRows, ns = (d + COLS - 1) / COLS;
  const int nbh = gridDim.x / (nk * ns);
  const int cs = blockIdx.x % ns, rest = blockIdx.x / ns;
  // the first key tiles of every head, which need the most queries, first
  const int bh = rest % nbh;
  const int k0 = rest / nbh * kMmaRows, c0 = cs * COLS;
  const int nk16 = (d + 15) / 16, nn16 = (min(COLS, d - c0) + 15) / 16;
  const int nq = (S + kMmaRows - 1) / kMmaRows;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* r_s = reinterpret_cast<float*>(smem_raw);  // [2][4][64] F, m, n, c of a query tile
  bf16* k_s = reinterpret_cast<bf16*>(r_s + 8 * kMmaRows);  // [64][LD]
  bf16* v_s = k_s + TILE;                                    // [64][LD]
  bf16* q_s = v_s + TILE;                                    // [2][64][LD]
  bf16* g_s = q_s + 2 * TILE;                                // [2][64][LD] dh

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)bh * S;
  auto issue = [&](int t, int buf) {
    const int q0 = t * kMmaRows;
    load_tile_mma<DP>(q_s + buf * TILE, q + row0 * d, q0, kMmaRows, S, d, vec);
    load_tile_mma<DP>(g_s + buf * TILE, dh + row0 * d, q0, kMmaRows, S, d, vec);
    float* rb = r_s + buf * 4 * kMmaRows;
    load_rows_async(rb, F + row0, q0, S);
    load_rows_async(rb + kMmaRows, m_in + row0, q0, S);
    load_rows_async(rb + 2 * kMmaRows, n_in + row0, q0, S);
    load_rows_async(rb + 3 * kMmaRows, c_in + row0, q0, S);
  };
  load_tile_mma<DP>(k_s, k + row0 * d, k0, kMmaRows, S, d, vec);
  load_tile_mma<DP>(v_s, v + row0 * d, k0, kMmaRows, S, d, vec);
  const int t0 = k0 / kMmaRows;  // the query tiles from the diagonal on need these keys
  issue(t0, 0);
  cp_async_commit();
  const int kr = k0 + warp * 16 + (lane >> 2);  // key rows kr and kr + 8
  float fk[2], lk[2], dli[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    fk[hf] = kr + 8 * hf < S ? F[row0 + kr + 8 * hf] : 0.0f;
    lk[hf] = kr + 8 * hf < S ? logi[row0 + kr + 8 * hf] : 0.0f;
  }
  float adk[COLS / 8][4], adv[COLS / 8][4];
  zero<COLS / 8>(adk);
  zero<COLS / 8>(adv);

  for (int t = t0, buf = 0; t < nq; ++t, buf ^= 1) {
    if (t + 1 < nq) issue(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int q0 = t * kMmaRows;
    const bf16* qb = q_s + buf * TILE;
    const bf16* gb = g_s + buf * TILE;
    const float* fq = r_s + buf * 4 * kMmaRows;
    const float* mq = fq + kMmaRows;
    const float* nq_ = mq + kMmaRows;
    const float* cq = nq_ + kMmaRows;

    // sᵀ = K·Qᵀ and dPᵀ = V·dhᵀ: key rows, query columns
    float s[8][4], dp[8][4];
    zero<8>(s);
    zero<8>(dp);
    mma_abt<DP>(s, k_s + warp * 16 * LD, qb, nk16);
    mma_abt<DP>(dp, v_s + warp * 16 * LD, gb, nk16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, kp = kr + 8 * hf;
        const int qc = j * 8 + (lane & 3) * 2 + (e & 1), qp = q0 + qc;
        float wn = 0.0f, dc = 0.0f;
        if (kp <= qp && qp < S) {
          const float ef = expf(fq[qc] - fk[hf] + lk[hf] - mq[qc]);
          const float w = s[j][e] * scale * ef;
          const float dw = (dp[j][e] - cq[qc]) / nq_[qc];
          wn = w / nq_[qc];
          dc = dw * ef;
          dli[hf] += dw * w;
        }
        s[j][e] = wn;
        dp[j][e] = dc;
      }
    // dV += (W / n)ᵀ·dh, dK += dCᵀ·Q over the tile's queries
    mma_xb<DP, COLS>(adv, s, gb, c0, nn16);
    mma_xb<DP, COLS>(adk, dp, qb, c0, nn16);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = dli[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int kp = kr + 8 * hf;
    if (cs == 0 && kp < S && (lane & 3) == 0) dlogi[row0 + kp] = sum;
  }
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = kr + 8 * (e >> 1), c = c0 + j * 8 + (lane & 3) * 2 + (e & 1);
      if (kp >= S || c >= d) continue;
      st(dk + (row0 + kp) * d + c, adk[j][e] * scale);
      st(dv + (row0 + kp) * d + c, adv[j][e]);
    }
}

// Kernel 3m: dQ and dF of 64 query rows (a warp's 16) of one head, output
// columns [c0, c0 + COLS).
template <int DP, int COLS>
__global__ void __launch_bounds__(kMmaThreads)
mlstm_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dh,
                        const float* __restrict__ F, const float* __restrict__ logi,
                        const float* __restrict__ m_in, const float* __restrict__ n_in,
                        const float* __restrict__ c_in, const float* __restrict__ dlogi,
                        bf16* __restrict__ dq, float* __restrict__ dF, int S, int d,
                        float scale, int vec) {
  constexpr int LD = DP + 8, TILE = kMmaRows * LD;
  const int nq = (S + kMmaRows - 1) / kMmaRows, ns = (d + COLS - 1) / COLS;
  const int nbh = gridDim.x / (nq * ns);
  const int cs = blockIdx.x % ns, rest = blockIdx.x / ns;
  // the last query tiles of every head, the longest rows, first
  const int bh = rest % nbh;
  const int q0 = (nq - 1 - rest / nbh) * kMmaRows, c0 = cs * COLS;
  const int nk16 = (d + 15) / 16, nn16 = (min(COLS, d - c0) + 15) / 16;
  const int nt = (min(q0 + kMmaRows, S) + kMmaRows - 1) / kMmaRows;  // the key tiles needed

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* g_s = reinterpret_cast<float*>(smem_raw);  // [2][2][64] F, logi of a key tile
  bf16* q_s = reinterpret_cast<bf16*>(g_s + 4 * kMmaRows);  // [64][LD]
  bf16* d_s = q_s + TILE;                                    // [64][LD] dh
  bf16* k_s = d_s + TILE;                                    // [2][64][LD]
  bf16* v_s = k_s + 2 * TILE;                                // [2][64][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)bh * S;
  auto issue = [&](int t, int buf) {
    load_tile_mma<DP>(k_s + buf * TILE, k + row0 * d, t * kMmaRows, kMmaRows, S, d, vec);
    load_tile_mma<DP>(v_s + buf * TILE, v + row0 * d, t * kMmaRows, kMmaRows, S, d, vec);
    load_rows_async(g_s + buf * 2 * kMmaRows, F + row0, t * kMmaRows, S);
    load_rows_async(g_s + buf * 2 * kMmaRows + kMmaRows, logi + row0, t * kMmaRows, S);
  };
  load_tile_mma<DP>(q_s, q + row0 * d, q0, kMmaRows, S, d, vec);
  load_tile_mma<DP>(d_s, dh + row0 * d, q0, kMmaRows, S, d, vec);
  issue(0, 0);
  cp_async_commit();
  const int qr = q0 + warp * 16 + (lane >> 2);  // rows qr and qr + 8
  float fq[2], mr[2], nr[2], cr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = qr + 8 * hf;
    const bool in = qp < S;
    fq[hf] = in ? F[row0 + qp] : 0.0f;
    mr[hf] = in ? m_in[row0 + qp] : 0.0f;
    nr[hf] = in ? n_in[row0 + qp] : 1.0f;
    cr[hf] = in ? c_in[row0 + qp] : 0.0f;
  }
  float acc[COLS / 8][4];
  zero<COLS / 8>(acc);

  for (int t = 0, buf = 0; t < nt; ++t, buf ^= 1) {
    if (t + 1 < nt) issue(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int k0 = t * kMmaRows;
    const bf16* kt = k_s + buf * TILE;
    const float* fk = g_s + buf * 2 * kMmaRows;
    const float* lk = fk + kMmaRows;

    // s = Q·Kᵀ and dP = dh·Vᵀ: query rows, key columns
    float s[8][4], dp[8][4];
    zero<8>(s);
    zero<8>(dp);
    mma_abt<DP>(s, q_s + warp * 16 * LD, kt, nk16);
    mma_abt<DP>(dp, d_s + warp * 16 * LD, v_s + buf * TILE, nk16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, qp = qr + 8 * hf;
        const int kc = j * 8 + (lane & 3) * 2 + (e & 1), kp = k0 + kc;
        float dc = 0.0f;
        if (kp <= qp && qp < S) {
          const float ef = expf(fq[hf] - fk[kc] + lk[kc] - mr[hf]);
          const float w = s[j][e] * scale * ef;
          const float dw = (dp[j][e] - cr[hf]) / nr[hf];
          dc = dw * ef;
          rs[hf] += dw * w;
        }
        dp[j][e] = dc;
      }
    // dQ += dC·K over the tile's keys
    mma_xb<DP, COLS>(acc, dp, kt, c0, nn16);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = rs[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qp = qr + 8 * hf;
    if (cs == 0 && qp < S && (lane & 3) == 0) dF[row0 + qp] = sum - dlogi[row0 + qp];
  }
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = qr + 8 * (e >> 1), c = c0 + j * 8 + (lane & 3) * 2 + (e & 1);
      if (qp < S && c < d) st(dq + (row0 + qp) * d + c, acc[j][e] * scale);
    }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* h, const void* dh,
               const float* F, const float* logi, void* dq, void* dk, void* dv, float* dlogi,
               float* dF, float* ws, int BH, int S, int d, float scale, cudaStream_t st) {
  constexpr int COLS = DP < kMmaCols ? DP : kMmaCols;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ht = static_cast<const bf16*>(h);
  const bf16* gt = static_cast<const bf16*>(dh);
  const int vec =
      d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dh) % 16 == 0;
  const size_t n = (size_t)BH * S;
  float* m = ws;
  float* nn = ws + n;
  float* c = ws + 2 * n;
  const long long nt = (S + kMmaRows - 1) / kMmaRows, ns = (d + COLS - 1) / COLS;
  if ((long long)BH * nt * ns > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t tile = sizeof(bf16) * kMmaRows * (DP + 8);
  cudaError_t err;

  const size_t sm_pre = sizeof(float) * 5 * kMmaRows + 3 * tile;
  if ((err = prepare(mlstm_bwd_pre_mma_kernel<DP>, sm_pre)) != cudaSuccess) return (int)err;
  mlstm_bwd_pre_mma_kernel<DP><<<(unsigned)(BH * nt), kMmaThreads, sm_pre, st>>>(
      qt, kt, ht, gt, F, logi, m, nn, c, S, d, scale, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t sm_kv = sizeof(float) * 8 * kMmaRows + 6 * tile;
  if ((err = prepare(mlstm_bwd_dkdv_mma_kernel<DP, COLS>, sm_kv)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_dkdv_mma_kernel<DP, COLS><<<(unsigned)(BH * nt * ns), kMmaThreads, sm_kv, st>>>(
      qt, kt, vt, gt, F, logi, m, nn, c, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dlogi,
      S, d, scale, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t sm_q = sizeof(float) * 4 * kMmaRows + 6 * tile;
  if ((err = prepare(mlstm_bwd_dq_mma_kernel<DP, COLS>, sm_q)) != cudaSuccess) return (int)err;
  mlstm_bwd_dq_mma_kernel<DP, COLS><<<(unsigned)(BH * nt * ns), kMmaThreads, sm_q, st>>>(
      qt, kt, vt, gt, F, logi, m, nn, c, dlogi, static_cast<bf16*>(dq), dF, S, d, scale, vec);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const void* h, const void* dh,
                const float* F, const float* logi, void* dq, void* dk, void* dv, float* dlogi,
                float* dF, float* ws, int BH, int S, int d, float scale, cudaStream_t st) {
  if (d <= 64)
    return launch_mma<64>(q, k, v, h, dh, F, logi, dq, dk, dv, dlogi, dF, ws, BH, S, d, scale,
                          st);
  if (d <= 128)
    return launch_mma<128>(q, k, v, h, dh, F, logi, dq, dk, dv, dlogi, dF, ws, BH, S, d, scale,
                           st);
  return launch_mma<256>(q, k, v, h, dh, F, logi, dq, dk, dv, dlogi, dF, ws, BH, S, d, scale,
                         st);
}


}  // namespace

// Bytes of the float32 workspace (m, n and c of every row) a call needs.
extern "C" long long mlstm_chunk_bwd_workspace_bytes(int BH, int S) {
  return 3LL * BH * S * (long long)sizeof(float);
}

// q, k, v, h (the forward's output), dh (its gradient) [BH, S, d] ->
// dq, dk, dv [BH, S, d]; F and logi [BH, S] float32 -> dlogi, dF [BH, S]
// float32; ws holds mlstm_chunk_bwd_workspace_bytes(BH, S). dtype 0: float32,
// 1: bfloat16 (q, k, v, h, dh, dq, dk, dv). Shapes are checked by the Python
// wrapper.
extern "C" int mlstm_chunk_bwd_launch(const void* q, const void* k, const void* v,
                                      const void* h, const void* dh, const void* F,
                                      const void* logi, void* dq, void* dk, void* dv,
                                      void* dlogi, void* dF, void* ws, int BH, int S, int d,
                                      float scale, int dtype, void* stream) {
  if (BH == 0 || S == 0) return (int)cudaGetLastError();
  if (d <= 0 || d > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* f = static_cast<const float*>(F);
  const float* li = static_cast<const float*>(logi);
  float* dl = static_cast<float*>(dlogi);
  float* df = static_cast<float*>(dF);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, h, dh, f, li, dq, dk, dv, dl, df, w, BH, S, d, scale, st);
  if (dtype == 1)
    return launch_bf16(q, k, v, h, dh, f, li, dq, dk, dv, dl, df, w, BH, S, d, scale, st);
  return (int)cudaErrorInvalidValue;
}
