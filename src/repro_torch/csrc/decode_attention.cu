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
// Bound: decode reads the whole (valid part of the) cache once and does 4
// flops per cache element and query head, so at the serving path's shapes
// (B = 8, Sc = 4096, KV = 8, G = 3, dh = 128, bf16) it does ~1.5 flop per
// byte read: far below the card's ~295 flops a byte, so bytes bound it
// (K + V, 134 MB with every slot valid: 0.040 ms at 3.35 TB/s).
//
// Design (simple, right first): one block of 8 warps per (b, kv head)
// holds the G = H / KV query rows that share that head (the TPU kernel's
// grouping). The Pallas grid's sequential third dimension becomes a loop
// over chunks of 32 cache slots inside the block. Each warp owns one query
// row and a share of the chunks (8 / G warps a row when G < 8), with the
// row's online-softmax state (m, l and its slice of the output) in
// registers, so the loop has no block barrier: a lane holds every 32nd
// element of the head dim, the warp reads each slot's K and V row with
// neighbouring lanes on neighbouring addresses, a butterfly of shuffles
// turns the lanes' partial dot products into one score per lane, and each
// slot's probability is broadcast to the lanes for the P.V update. The
// warps of a row then merge their (m, l, acc) through shared memory. A chunk
// whose 32 slots are all invalid is skipped when the row has any valid
// slot: it would add exp(-1e30 - m) = 0 terms, exactly. A row with no
// valid slot at all walks every chunk, as the TPU kernel does, and gives
// the mean of v. At B = 1 this launches KV = 8 blocks and leaves most of
// the 132 SMs idle; splitting the cache over blocks is later work.
// The logit cap (which the TPU kernel lacks; the reference model applies it
// after the scale and before the mask) is one tanhf per valid slot and row.
//
// Masked scores are the finite -1e30 of the TPU kernel, never -inf: a row
// whose first chunk is all masked adds exp(0) = 1 terms that the next valid
// slot wipes out through alpha = exp(-1e30 - m_new) = 0, where -inf would
// give exp(-inf + inf) = NaN. Slots past the end of a ragged last chunk are
// -inf (no term at all). The products use fmaf explicitly, since the
// library is built with -fmad=false for the geo_schedule kernel.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// One stage of a butterfly reduce-scatter over the lanes: each lane keeps
// the half of part[0 .. 2*O) its bit O selects, summed with its partner's.
// O is a template parameter so every index is a constant and part stays in
// registers.
template <int O>
__device__ __forceinline__ void fold(float* part, int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? part[i] : part[i + O];
    const float keep = upper ? part[i + O] : part[i];
    part[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

__device__ __forceinline__ float softcap(float x, float cap) {
  return cap > 0.0f ? tanhf(x / cap) * cap : x;
}

__host__ __device__ int warps_per_row(int g) { return g < kWarps ? kWarps / g : 1; }

size_t smem_bytes(int g, int dh) {
  // each (row, warp of the row): m, l and the dh accumulators
  return sizeof(float) * (size_t)g * warps_per_row(g) * (dh + 2);
}

// NE = elements of a head-dim row per lane (dh <= 32 * NE)
template <typename T, int NE>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const uint8_t* __restrict__ valid, T* __restrict__ out, int H, int KV,
              int Sc, int dh, float scale, float cap) {
  const int b = blockIdx.x / KV, kv = blockIdx.x % KV;
  const int G = H / KV;
  const int splits = warps_per_row(G);  // warps sharing a row
  const int rows = kWarps / splits;                // rows in flight at once
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sp = warp % splits;
  extern __shared__ float smem[];
  float* pm = smem;                // [G][splits]
  float* pl = pm + G * splits;     // [G][splits]
  float* pacc = pl + G * splits;   // [G][splits][dh]

  const uint8_t* vb = valid + (size_t)b * Sc;
  int any = 0;
  for (int j = threadIdx.x; j < Sc; j += kThreads) any |= vb[j];
  const bool skip_masked = __syncthreads_or(any) != 0;

  const size_t slot = (size_t)KV * dh;  // elements between two cache slots
  const T* kb = k + (size_t)b * Sc * slot + (size_t)kv * dh;
  const T* vbase = v + (size_t)b * Sc * slot + (size_t)kv * dh;
  const int nchunks = (Sc + 31) / 32;

  for (int g = warp / splits; g < G; g += rows) {
    const T* qr = q + ((size_t)b * H + (size_t)kv * G + g) * dh;
    float qv[NE], acc[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      qv[e] = d < dh ? to_f32(qr[d]) : 0.0f;
      acc[e] = 0.0f;
    }
    float m = kNeg, l = 0.0f;
    for (int c = sp; c < nchunks; c += splits) {
      const int j0 = 32 * c;
      const bool in = j0 + lane < Sc;
      const bool ok = in && vb[j0 + lane] != 0;
      if (skip_masked && !__any_sync(kFull, ok)) continue;
      // partial dot products of this lane's slice with the chunk's 32 keys.
      // Slot and element indices are clamped into the cache instead of
      // branched on, so every load of the chunk can be in flight at once:
      // a clamped element meets qv = 0, a clamped slot is masked below.
      float part[32];
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const T* kr = kb + (size_t)min(j0 + jj, Sc - 1) * slot;
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < NE; ++e) s = fmaf(qv[e], to_f32(kr[min(lane + 32 * e, dh - 1)]), s);
        part[jj] = s;
      }
      // butterfly reduce-scatter: afterwards part[0] of lane L is key j0 + L's dot
      fold<16>(part, lane);
      fold<8>(part, lane);
      fold<4>(part, lane);
      fold<2>(part, lane);
      fold<1>(part, lane);
      // past the end: no term; masked: the TPU kernel's finite -1e30
      const float sc = !in ? -INFINITY : (ok ? softcap(part[0] * scale, cap) : kNeg);
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      const float p = expf(sc - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l = l * alpha + sum;
      m = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[e] *= alpha;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        // a clamped slot has p = 0; a clamped element's sum is never stored
        const float pj = __shfl_sync(kFull, p, jj);
        const T* vr = vbase + (size_t)min(j0 + jj, Sc - 1) * slot;
#pragma unroll
        for (int e = 0; e < NE; ++e)
          acc[e] = fmaf(pj, to_f32(vr[min(lane + 32 * e, dh - 1)]), acc[e]);
      }
    }
    const int at = g * splits + sp;
    if (lane == 0) {
      pm[at] = m;
      pl[at] = l;
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < dh) pacc[(size_t)at * dh + d] = acc[e];
    }
  }
  __syncthreads();

  // merge the warps of each row: rescale each to the row's max, then sum
  for (int i = threadIdx.x; i < G * dh; i += kThreads) {
    const int g = i / dh, d = i - g * dh;
    float mm = kNeg;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, pm[g * splits + s]);
    float ll = 0.0f, aa = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(pm[g * splits + s] - mm);
      ll += pl[g * splits + s] * w;
      aa += pacc[(size_t)(g * splits + s) * dh + d] * w;
    }
    store(out + ((size_t)b * H + (size_t)kv * G + g) * dh + d, aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int NE>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
           int H, int KV, int Sc, int dh, float scale, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, dh);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, NE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T, NE><<<B * KV, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)valid, (T*)out, H, KV, Sc, dh,
      scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
              int H, int KV, int Sc, int dh, float scale, float cap, cudaStream_t st) {
  if (dh <= 64) return launch<T, 2>(q, k, v, valid, out, B, H, KV, Sc, dh, scale, cap, st);
  if (dh <= 128) return launch<T, 4>(q, k, v, valid, out, B, H, KV, Sc, dh, scale, cap, st);
  if (dh <= 256) return launch<T, 8>(q, k, v, valid, out, B, H, KV, Sc, dh, scale, cap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cap <= 0: no logit cap. Shapes are
// checked by the Python wrapper.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, int B, int H, int KV,
                                       int Sc, int dh, float scale, float cap, int dtype,
                                       void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || Sc <= 0 || dh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dh<float>(q, k, v, valid, out, B, H, KV, Sc, dh, scale, cap, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, valid, out, B, H, KV, Sc, dh, scale, cap, st);
  return (int)cudaErrorInvalidValue;
}
