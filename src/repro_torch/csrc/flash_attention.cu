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
// q [B,H,S,dh], k/v [B,KV,S,dh] (float32 or bfloat16, all one type) ->
// out [B,H,S,dh] in q's type; arithmetic in float32.
//
// Bound: 4·dh flops per unmasked (query, key) pair against 2·dh·(2H + 2KV)
// bytes a position, so at the serving path's prefill (B = 8, H = 24, KV = 8,
// S = 2048, dh = 128, causal, bf16) it does ~770 flops a byte: the tensor
// cores' rate bounds it (2·B·H·S²·dh = 2.06e11 flops, 0.21 ms at 989
// TFLOP/s bf16).
//
// Design (simple, right first): this kernel runs on the CUDA cores in
// float32, not on the tensor cores (wgmma/TMA are later work), so it sits
// far above that bound. One block of 128 threads per (b·h, block of 64
// queries; 32 for dh > 128) loops over blocks of 64 keys inside the block:
// the loop replaces the Pallas grid's sequential third dimension, and the
// running (m, l) and the output accumulator stay in registers across it. A
// thread owns RQ query rows x 8 key columns of each score tile and RQ rows x
// dh/8 output columns; the 8 threads that share a row sit in one warp and
// reduce its max and sum with shuffles. Tiles are staged in shared memory in
// the input type with an odd word stride, so the threads of a warp reading
// different rows hit different banks. Key blocks that the mask empties are
// skipped with the TPU kernel's block predicate (flash_attention.py:55-64);
// the heaviest query blocks of a causal row are launched first. Sizes not a
// multiple of a block are masked at the ragged edge, never padded. The logit
// cap (which the TPU kernel lacks; the reference model applies it after the
// scale and before the mask) is a template flag: the uncapped variant is the
// plain kernel (a per-score `cap > 0 ?` select cost 9% at llama's prefill),
// the capped one scales and caps each score tile in a loop of tanhf.
//
// Masked scores are the finite -1e30 of the TPU kernel, never -inf: a row
// whose first needed tile is all masked adds exp(0) = 1 terms that the next
// real key wipes out through alpha = exp(-1e30 - m_new) = 0, where -inf
// would give NaN. Keys past the end of the sequence are -inf (no term). The
// products use fmaf explicitly: the library is built with -fmad=false.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kBK = 64;        // keys per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Row stride (elements) of a Q/K tile: an odd number of 4-byte words.
template <typename T>
__host__ __device__ int tile_stride(int dh) {
  return dh + 4 / (int)sizeof(T);
}

__device__ __forceinline__ bool block_needed(int q0, int k0, int bq, int causal, int window,
                                             int chunk_local) {
  bool need = true;
  if (causal) need = k0 <= q0 + bq - 1;
  if (window > 0 && !chunk_local) need = need && (k0 + kBK - 1 > q0 - window);
  if (window > 0 && chunk_local) {
    need = need && ((k0 + kBK - 1) / window >= q0 / window);
    need = need && (k0 / window <= (q0 + bq - 1) / window);
  }
  return need;
}

template <typename T, int BQ>
size_t smem_bytes(int dh) {
  const int ts = tile_stride<T>(dh);
  return sizeof(T) * ((size_t)BQ * ts + (size_t)kBK * ts + (size_t)kBK * dh) +
         sizeof(float) * (size_t)BQ * (kBK + 1);
}

template <typename T, int BQ, int DMAX, bool CAP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int KV, int S, int dh, float scale, float cap,
             int causal, int window, int chunk_local) {
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
  T* v_s = k_s + kBK * ts;                  // [64][dh]
  float* p_s = reinterpret_cast<float*>(v_s + kBK * dh);  // [BQ][65]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const T* qb = q + (size_t)bh * S * dh;
  const T* kb = k + (size_t)(b * KV + kvh) * S * dh;
  const T* vb = v + (size_t)(b * KV + kvh) * S * dh;

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

  for (int k0 = 0; k0 < S; k0 += kBK) {
    if (!block_needed(q0, k0, BQ, causal, window, chunk_local)) continue;
    __syncthreads();  // the previous block's readers are done with k_s, v_s, p_s
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      const bool in = k0 + r < S;
      k_s[r * ts + d] = in ? kb[(size_t)(k0 + r) * dh + d] : T(0.0f);
      v_s[r * dh + d] = in ? vb[(size_t)(k0 + r) * dh + d] : T(0.0f);
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
        float x = -INFINITY;  // past the end of the sequence: no term
        if (kp < S) {
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
        vx[j] = d < dh ? to_f32(v_s[kk * dh + d]) : 0.0f;
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
    T* orow = out + ((size_t)bh * S + qp) * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 8 * j;
      if (d < dh) store(orow + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int BQ, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV, int S,
           int dh, float scale, float cap, int causal, int window, int chunk_local,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BQ>(dh);
  auto kern = cap > 0.0f ? flash_kernel<T, BQ, DMAX, true> : flash_kernel<T, BQ, DMAX, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((S + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                     (T*)out, H, KV, S, dh, scale, cap,
                                                     causal, window, chunk_local);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
              int S, int dh, float scale, float cap, int causal, int window, int chunk_local,
              cudaStream_t st) {
  if (dh <= 64)
    return launch<T, 64, 64>(q, k, v, out, B, H, KV, S, dh, scale, cap, causal, window,
                               chunk_local, st);
  if (dh <= 128)
    return launch<T, 64, 128>(q, k, v, out, B, H, KV, S, dh, scale, cap, causal, window,
                               chunk_local, st);
  if (dh <= 256)
    return launch<T, 32, 256>(q, k, v, out, B, H, KV, S, dh, scale, cap, causal, window,
                               chunk_local, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cap <= 0: no logit cap. Shapes are
// checked by the Python wrapper.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KV, int S, int dh, float scale,
                                      float cap, int causal, int window, int chunk_local,
                                      int dtype, void* stream) {
  if (B == 0 || H == 0 || S == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || dh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, B, H, KV, S, dh, scale, cap, causal, window,
                            chunk_local, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, B, H, KV, S, dh, scale, cap, causal, window,
                                    chunk_local, st);
  return (int)cudaErrorInvalidValue;
}
