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
// 4·dh·itemsize bytes a position, so at xlstm-350m's prefill (B = 8, H = 4,
// S = 2048, dh = 256, float32) it does ~250 flops a byte and the float32
// rate bounds it: 6.87e10 flops, 1.03 ms at 67 TFLOP/s on the CUDA cores
// (0.14 ms on the TF32 tensor cores, which would round the inputs to 10
// mantissa bits).
//
// Design (simple, right first), flash attention's shape
// (csrc/flash_attention.cu): one block of 128 threads per (b·h, block of 64
// queries; 32 for dh > 128) loops over blocks of 64 keys up to the diagonal
// (the TPU kernel's skip `k0 <= q0 + bq - 1`): the loop replaces the Pallas
// grid's sequential third dimension, and the running max m, the signed row
// sum and the output accumulator stay in registers across it. A thread owns
// RQ query rows x 8 key columns of each score tile and RQ rows x dh/8 output
// columns; the 8 threads that share a row sit in one warp and reduce its max
// and sum with shuffles. Tiles are staged in shared memory in the input type
// with an odd word stride; the key tile's F and logi sit beside them. At
// dh = 256 in float32 the tiles take 169 KB, so the block asks for dynamic
// shared memory above 48 KB and one block fits an SM. S is taken as it is:
// the ragged edge is masked, never padded (the TPU wrapper's halving of bq
// until it divides S is a TPU artefact).
//
// Numerics are the TPU kernel's: m starts at -1e30, masked entries are the
// finite -1e30 (exp(-1e30 - m) = 0 once a real key has set m; the first key
// block always holds key 0 <= i), the row sum is signed and kept apart from
// the stabiliser m, and w = ((q.k) * scale) * D. The products use fmaf
// explicitly: the library is built with -fmad=false.
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
             int S, int dh, float scale) {
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
    const float norm = fmaxf(fmaxf(fabsf(rs[i]), expf(-m[i])), 1e-30f);
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
           void* out, int BH, int S, int dh, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BQ>(dh);
  auto kern = mlstm_kernel<T, BQ, DMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, F,
                                                     logi, (T*)out, S, dh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const float* F, const float* logi,
              void* out, int BH, int S, int dh, float scale, cudaStream_t st) {
  if (dh <= 64) return launch<T, 64, 64>(q, k, v, F, logi, out, BH, S, dh, scale, st);
  if (dh <= 128) return launch<T, 64, 128>(q, k, v, F, logi, out, BH, S, dh, scale, st);
  if (dh <= 256) return launch<T, 32, 256>(q, k, v, F, logi, out, BH, S, dh, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); F and logi float32.
// Shapes are checked by the Python wrapper.
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v, const void* F,
                                  const void* logi, void* out, int BH, int S, int dh,
                                  float scale, int dtype, void* stream) {
  if (BH == 0 || S == 0) return (int)cudaGetLastError();
  if (dh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* f = (const float*)F;
  const float* li = (const float*)logi;
  if (dtype == 0) return launch_dh<float>(q, k, v, f, li, out, BH, S, dh, scale, st);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(q, k, v, f, li, out, BH, S, dh, scale, st);
  return (int)cudaErrorInvalidValue;
}
