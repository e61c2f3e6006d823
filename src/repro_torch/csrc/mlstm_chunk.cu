// Chunkwise mLSTM (xLSTM's stabilized parallel matrix memory) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mlstm/mlstm.py::mlstm_chunk
// (`_kernel`, a Pallas grid (B*H, S/bq, S/bk) whose third dimension walks the
// keys in order with (acc, s, m) in VMEM scratch):
//   D~[i, j] = F_i - F_j + logi_j for j <= i, else -1e30   (F = cumsum(logf))
//   m_i      = max_j D~[i, j]
//   w_ij     = (q_i . k_j / sqrt(dh)) * exp(D~[i, j] - m_i)
//   out_i    = (sum_j w_ij v_j) / max(max(|sum_j w_ij|, exp(-m_i)), 1e-30)
// q/k/v [B,H,S,dh] (float32 or bfloat16, one type) and F, logi [B,H,S]
// float32 (the wrapper forms F, as the TPU wrapper does) -> out [B,H,S,dh]
// in v's type; arithmetic in float32.
//
// Bound: 4·dh flops per (query, key) pair with j <= i (q.k and w.v) against
// 4·dh·itemsize bytes a position. At xlstm-350m's prefill (B = 8, H = 4,
// S = 2048, dh = 256) that is 6.87e10 flops: in bfloat16 (the serving
// path's type) ~510 flops a byte, bounded by the tensor cores at 0.0695 ms
// (989 TFLOP/s); in float32 1.03 ms on the CUDA cores (67 TFLOP/s).
//
// Two kernels, chosen by dtype in mlstm_chunk_launch, as flash_attention.cu
// chooses:
//
// bfloat16 (every launch of the serving path): `mlstm_wgmma_kernel`, both
// products on the tensor cores, flash's wgmma machinery (wgmma.cuh). One
// block of two warpgroups per (b·h, 128 queries); each warpgroup owns 64
// query rows, wgmma's M, and walks the 64-key tiles up to its diagonal.
// - Shared memory holds the Q tile (loaded once) and a ring of two stages of
//   K and V tiles as 128-byte-swizzled 64-column panels (K-major Q and K,
//   MN-major V), with the key tile's F and logi beside them; cp.async
//   (16 bytes for the tiles, 4 for the gates) fills the next stage while
//   the current one is multiplied, zero past S and past dh: S is taken as
//   it is, the ragged edge masked, and head dims are padded to 64, 128 or
//   256 in shared memory only. At dh 256 that is 194 KB: one block an SM.
// - q·kᵀ is dh/16 wgmma.m64n64k16 (A and B from shared memory). While it
//   runs, each thread takes the row max of D~ over its fragment's 16 keys
//   (two rows a thread; the four threads sharing a row reduce with two
//   shuffles): m is a running max of the rounded D~, computed as the plain
//   version does, and the accumulator and the signed row sum are rescaled
//   by exp(m_old - m_new) when it moves. Because exp(-m) enters the norm, m
//   is part of the result, not only a stabiliser. Then D~ is computed again
//   from shared memory (not kept: 32 more registers a thread at dh 256),
//   and w = (s * scale) * exp(D~ - m) replaces the score in its register.
// - w·V takes w as a bf16 pair hi + lo from registers (w is float32 and
//   not bf16-exact: hi + lo keeps ~16 bits), two wgmma a k16 step, into
//   dh_pad/2 float32 accumulators a thread (128 at dh 256).
// - The row sum is signed and kept apart from m, per thread until the end;
//   norm = max(|sum w|, exp(-m), 1e-30). Masks are the finite -1e30 and m
//   starts at -1e30; the first key tile always holds key 0 <= i, so no row
//   ends with m = -1e30. Exponentials are the accurate expf.
//
// float32 (the checks of chip_smoke.py and the float32 model path; TF32
// tensor cores keep ~3 digits, short of the 2e-5 those checks hold):
// `mlstm_kernel`, on the CUDA cores, flash attention's float32 shape
// (csrc/flash_attention.cu): one block of 128 threads per (b·h, block of 64
// queries; 32 for dh > 128) loops over blocks of 64 keys up to the diagonal
// (the TPU kernel's skip `k0 <= q0 + bq - 1`): the loop replaces the Pallas
// grid's sequential third dimension, and the running max m, the signed row
// sum and the output accumulator stay in registers across it. A thread owns
// RQ query rows x 8 key columns of each score tile and RQ rows x dh/8 output
// columns; the 8 threads that share a row sit in one warp and reduce its max
// and sum with shuffles. Tiles are staged in shared memory with an odd word
// stride; the key tile's F and logi sit beside them. At dh = 256 the tiles
// take 169 KB, so the block asks for dynamic shared memory above 48 KB and
// one block fits an SM.
//
// Both write, under a gradient, each row's m and its normaliser n =
// max(|σ|, exp(-m), 1e-30), signed as σ where |σ| sets it, into two float32
// [B,H,S] buffers the wrapper passes (null without a gradient): the
// backward (csrc/mlstm_chunk_bwd.cu) reads a_i and sign(σ_i) from them
// instead of recomputing σ. Both keep the TPU kernel's numerics: m starts
// at -1e30, masked entries are
// the finite -1e30 (exp(-1e30 - m) = 0 once a real key has set m), the row
// sum is signed and kept apart from the stabiliser m, and
// w = ((q.k) * scale) * D. The library is built with -fmad=false: products
// use fmaf explicitly.
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

template <typename T, int BQ>
size_t smem_bytes(int dh) {
  const int ts = tile_stride<T>(dh);
  return sizeof(T) * ((size_t)BQ * ts + (size_t)kBK * ts + (size_t)kBK * dh) +
         sizeof(float) * ((size_t)BQ * (kBK + 1) + 2 * kBK);
}

template <typename T, int BQ, int DMAX>
__global__ void __launch_bounds__(kThreads)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ F, const float* __restrict__ logi, T* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ n_out, int S, int dh, float scale) {
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int ND = DMAX / 8;  // output columns per thread
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - blockIdx.x % nq;  // the longest rows first
  const int q0 = qi * BQ;
  const int ts = tile_stride<T>(dh);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BQ][ts]
  T* k_s = q_s + BQ * ts;                   // [64][ts]
  T* v_s = k_s + kBK * ts;                  // [64][dh]
  float* w_s = reinterpret_cast<float*>(v_s + kBK * dh);  // [BQ][65]
  float* fk_s = w_s + BQ * (kBK + 1);                     // [64] F of the key block
  float* li_s = fk_s + kBK;                               // [64] logi of the key block

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const size_t base = (size_t)bh * S;
  const T* qb = q + base * dh;
  const T* kb = k + base * dh;
  const T* vb = v + base * dh;
  const float* Fb = F + base;
  const float* lb = logi + base;

  for (int i = tid; i < BQ * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    q_s[r * ts + d] = q0 + r < S ? qb[(size_t)(q0 + r) * dh + d] : T(0.0f);
  }

  float m[RQ], rs[RQ], fq[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    m[i] = kNeg;
    rs[i] = 0.0f;
    fq[i] = qp < S ? Fb[qp] : 0.0f;  // a row past the end is computed, never stored
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.0f;
  }

  const int k_end = min(q0 + BQ, S);  // keys past the block's last row are all masked
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous block's readers are done with k_s, v_s, w_s
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      const bool in = k0 + r < S;
      k_s[r * ts + d] = in ? kb[(size_t)(k0 + r) * dh + d] : T(0.0f);
      v_s[r * dh + d] = in ? vb[(size_t)(k0 + r) * dh + d] : T(0.0f);
    }
    if (tid < kBK) {
      const bool in = k0 + tid < S;
      fk_s[tid] = in ? Fb[k0 + tid] : 0.0f;
      li_s[tid] = in ? lb[k0 + tid] : 0.0f;
    }
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
      for (int j = 0; j < 8; ++j) kx[j] = to_f32(k_s[(tx + 8 * j) * ts + d]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float qx = to_f32(q_s[(ty * RQ + i) * ts + d]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qx, kx[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty * RQ + i;
      float dt[8];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        dt[j] = k0 + c <= qp ? fq[i] - fk_s[c] + li_s[c] : kNeg;
        mx = fmaxf(mx, dt[j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float w = s[i][j] * scale * expf(dt[j] - m_new);
        w_s[(ty * RQ + i) * (kBK + 1) + tx + 8 * j] = w;
        sum += w;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      rs[i] = rs[i] * alpha + sum;
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
        vx[j] = d < dh ? to_f32(v_s[kk * dh + d]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float w = w_s[(ty * RQ + i) * (kBK + 1) + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(w, vx[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    if (qp >= S) continue;
    const float fl = fmaxf(expf(-m[i]), 1e-30f);
    const float norm = fmaxf(fabsf(rs[i]), fl);
    if (m_out != nullptr && tx == 0) {  // n signed by σ where |σ| sets it
      m_out[base + qp] = m[i];
      n_out[base + qp] = fabsf(rs[i]) > fl ? rs[i] : fl;
    }
    T* orow = out + (base + qp) * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 8 * j;
      if (d < dh) store(orow + d, acc[i][j] / norm);
    }
  }
}

template <typename T, int BQ, int DMAX>
int launch(const void* q, const void* k, const void* v, const float* F, const float* logi,
           void* out, float* m_out, float* n_out, int BH, int S, int dh, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BQ>(dh);
  auto kern = mlstm_kernel<T, BQ, DMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, F,
                                                     logi, (T*)out, m_out, n_out, S, dh, scale);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const float* F, const float* logi,
               void* out, float* m, float* n, int BH, int S, int dh, float scale,
               cudaStream_t st) {
  if (dh <= 64) return launch<float, 64, 64>(q, k, v, F, logi, out, m, n, BH, S, dh, scale, st);
  if (dh <= 128)
    return launch<float, 64, 128>(q, k, v, F, logi, out, m, n, BH, S, dh, scale, st);
  if (dh <= 256)
    return launch<float, 32, 256>(q, k, v, F, logi, out, m, n, BH, S, dh, scale, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;  // queries a block: two warpgroups of 64 rows
constexpr int kWgBK = 64;   // keys a tile

// F and logi of keys [k0, k0 + 64) into g (F at g, logi at g + 64), 0 past S
__device__ __forceinline__ void load_gates(float* g, const float* __restrict__ Fb,
                                           const float* __restrict__ lb, int k0, int S,
                                           int tid) {
  if (tid < 2 * kWgBK) {
    const int c = tid & (kWgBK - 1);
    const bool in = k0 + c < S;
    const float* src = (tid < kWgBK ? Fb : lb) + (in ? k0 + c : 0);
    cp_async4(smem_u32(g + tid), src, in ? 4 : 0);
  }
}

// D~ of a query row (its F, its position) and key column c of the tile at
// k0: (F_row - F_key) + logi_key for key <= row, else -1e30; `interior`:
// every key of the tile is <= every row of the warpgroup
__device__ __forceinline__ float dtilde(float f_row, int row, const float* fk, const float* lk,
                                        int k0, int c, bool interior) {
  const float d = f_row - fk[c] + lk[c];
  return interior || k0 + c <= row ? d : kNeg;
}

template <int DP>
constexpr size_t wg_smem_bytes() {
  // Q, two stages of K and V, two stages of the key tile's F and logi; 1 KB
  // to align the base to 1024 bytes
  return (size_t)DP * 2 * (kWgBQ + 2 * 2 * kWgBK) + 2 * 2 * kWgBK * sizeof(float) + 1024;
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
mlstm_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ F,
                   const float* __restrict__ logi, bf16* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ n_out, int S, int dh,
                   float scale, int aligned) {
  constexpr int NP = DP / 64;                    // 64-column panels
  constexpr int Q_BYTES = NP * kWgBQ * 128;
  constexpr int T_BYTES = NP * kWgBK * 128;      // one K or V tile
  constexpr uint32_t PANEL_Q = kWgBQ * 128, PANEL_KV = kWgBK * 128;
  const int nq = (S + kWgBQ - 1) / kWgBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - blockIdx.x % nq;  // the longest rows first
  const int q0 = qi * kWgBQ;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int qw = q0 + 64 * wg;  // this warpgroup's first row

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* kv_s = base + Q_BYTES;  // stage st: K at kv_s + 2 st T_BYTES, V after it
  float* g_s = reinterpret_cast<float*>(kv_s + 4 * T_BYTES);  // stage st: F, logi at 2 st 64

  const size_t row0 = (size_t)bh * S;
  const bf16* qb = q + row0 * dh;
  const bf16* kb = k + row0 * dh;
  const bf16* vb = v + row0 * dh;
  const float* Fb = F + row0;
  const float* lb = logi + row0;

  // the key tiles up to the block's last row (the TPU kernel's skip)
  const int nt = (min(q0 + kWgBQ, S) + kWgBK - 1) / kWgBK;
  const bool al = aligned != 0;
  load_tile<kWgBQ, DP>(q_s, qb, q0, S, dh, al, tid);
  load_tile<kWgBK, DP>(kv_s, kb, 0, S, dh, al, tid);
  load_tile<kWgBK, DP>(kv_s + T_BYTES, vb, 0, S, dh, al, tid);
  load_gates(g_s, Fb, lb, 0, S, tid);
  cp_async_commit();

  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  // a thread holds rows r0 = qw + ra and r1 = r0 + 8 of the fragments
  const int ra = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const int r0 = qw + ra, r1 = r0 + 8;
  const float fq0 = r0 < S ? Fb[r0] : 0.0f;  // a row past the end is computed, never stored
  const float fq1 = r1 < S ? Fb[r1] : 0.0f;
  float m0 = kNeg, m1 = kNeg, rs0 = 0.0f, rs1 = 0.0f;
  const uint32_t q_addr = smem_u32(q_s) + 64 * 128 * wg;

  for (int j = 0; j < nt; ++j) {
    const int st = j & 1;
    if (j + 1 < nt) {  // the next tile into the other stage
      unsigned char* nxt = kv_s + 2 * (st ^ 1) * T_BYTES;
      load_tile<kWgBK, DP>(nxt, kb, (j + 1) * kWgBK, S, dh, al, tid);
      load_tile<kWgBK, DP>(nxt + T_BYTES, vb, (j + 1) * kWgBK, S, dh, al, tid);
      load_gates(g_s + 2 * (st ^ 1) * kWgBK, Fb, lb, (j + 1) * kWgBK, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q and tile j have landed
    fence_proxy_async();
    __syncthreads();

    const int k0 = j * kWgBK;
    if (qw < S && k0 <= qw + 63) {
      const uint32_t k_addr = smem_u32(kv_s + 2 * st * T_BYTES);
      const uint32_t v_addr = k_addr + T_BYTES;
      const float* fk = g_s + 2 * st * kWgBK;
      const float* lk = fk + kWgBK;
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

      // while q.k runs: the row max of D~ over the tile. s[4 jj + 0/1] is
      // row r0, s[4 jj + 2/3] row r1, key columns 8 jj + cq + 0/1
      const bool interior = k0 + kWgBK - 1 <= qw;
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jj + cq + e;
          mx0 = fmaxf(mx0, dtilde(fq0, r0, fk, lk, k0, c, interior));
          mx1 = fmaxf(mx1, dtilde(fq1, r1, fk, lk, k0, c, interior));
        }
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      wg_wait0();
      fence_regs(s);  // its memory clobber also makes D~ below read shared memory again

      // w = (s * scale) * exp(D~ - m) in place, and its signed row sums
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jj + cq + e;
          float& w0 = s[4 * jj + e];
          float& w1 = s[4 * jj + 2 + e];
          w0 = w0 * scale * expf(dtilde(fq0, r0, fk, lk, k0, c, interior) - mn0);
          w1 = w1 * scale * expf(dtilde(fq1, r1, fk, lk, k0, c, interior) - mn1);
          sum0 += w0;
          sum1 += w1;
        }
      }
      rs0 = rs0 * alpha0 + sum0;  // a partial over this thread's columns
      rs1 = rs1 * alpha1 + sum1;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[p][4 * jj] *= alpha0;
          o[p][4 * jj + 1] *= alpha0;
          o[p][4 * jj + 2] *= alpha1;
          o[p][4 * jj + 3] *= alpha1;
        }
      }

      // w as bf16 pairs hi + lo in wgmma's A fragments: k step kk covers
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
      for (int p = 0; p < NP; ++p) fence_regs(o[p]);
      wg_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t vk = vd + ((p * PANEL_KV + kk * 16 * 128) >> 4);
          wgmma_rs(o[p], a_hi[kk], vk);
          wgmma_rs(o[p], a_lo[kk], vk);
        }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(o[p]);
    }
    __syncthreads();  // every reader is done with stage st before it is refilled
  }

  // the signed row sums over the four threads that share a row
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, o_);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, o_);
  }
  const float floor0 = fmaxf(expf(-m0), 1e-30f), floor1 = fmaxf(expf(-m1), 1e-30f);
  const float norm0 = fmaxf(fabsf(rs0), floor0), norm1 = fmaxf(fabsf(rs1), floor1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = half ? r1 : r0;
    if (qp >= S) continue;
    const float norm = half ? norm1 : norm0;
    if (m_out != nullptr && (lane & 3) == 0) {  // n signed by σ where |σ| sets it
      const float rs = half ? rs1 : rs0, fl = half ? floor1 : floor0;
      m_out[row0 + qp] = half ? m1 : m0;
      n_out[row0 + qp] = fabsf(rs) > fl ? rs : fl;
    }
    bf16* orow = out + (row0 + qp) * dh;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = 64 * p + 8 * jj + cq;
        const float x0 = o[p][4 * jj + 2 * half] / norm;
        const float x1 = o[p][4 * jj + 2 * half + 1] / norm;
        if (d + 1 < dh && (dh & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < dh) orow[d] = __float2bfloat16_rn(x0);
          if (d + 1 < dh) orow[d + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

template <int DP>
int launch_wg(const void* q, const void* k, const void* v, const float* F, const float* logi,
              void* out, float* m, float* n, int BH, int S, int dh, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<DP>();
  auto kern = mlstm_wgmma_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + kWgBQ - 1) / kWgBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int aligned = dh % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  kern<<<(unsigned)blocks, kWgThreads, smem, stream>>>((const bf16*)q, (const bf16*)k,
                                                       (const bf16*)v, F, logi, (bf16*)out, m,
                                                       n, S, dh, scale, aligned);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const float* F, const float* logi,
                void* out, float* m, float* n, int BH, int S, int dh, float scale,
                cudaStream_t st) {
  if (dh <= 64) return launch_wg<64>(q, k, v, F, logi, out, m, n, BH, S, dh, scale, st);
  if (dh <= 128) return launch_wg<128>(q, k, v, F, logi, out, m, n, BH, S, dh, scale, st);
  if (dh <= 256) return launch_wg<256>(q, k, v, F, logi, out, m, n, BH, S, dh, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores) for q, k, v
// and out; F and logi float32. m_out, n_out: both null, or float32 [BH, S]
// that receive each row's m and its normaliser n = max(|σ|, exp(-m),
// 1e-30), signed as σ where |σ| sets it (what the backward needs of σ).
// Shapes are checked by the Python wrapper.
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v, const void* F,
                                  const void* logi, void* out, void* m_out, void* n_out, int BH,
                                  int S, int dh, float scale, int dtype, void* stream) {
  if (BH == 0 || S == 0) return (int)cudaGetLastError();
  if (dh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* f = (const float*)F;
  const float* li = (const float*)logi;
  float* m = static_cast<float*>(m_out);
  float* n = static_cast<float*>(n_out);
  if (dtype == 0) return launch_f32(q, k, v, f, li, out, m, n, BH, S, dh, scale, st);
  if (dtype == 1) return launch_bf16(q, k, v, f, li, out, m, n, BH, S, dh, scale, st);
  return (int)cudaErrorInvalidValue;
}
