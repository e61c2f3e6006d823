// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru/rglru.py::rglru_scan
// (`_kernel`, a Pallas grid (B, E/bE, S/cs) whose chunk dimension runs in
// order with the carry h in VMEM scratch):
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = 0
// log_a [B,S,E] float32 and b [B,S,E] (float32 or bfloat16) -> h [B,S,E] in
// b's type; the carry is float32.
//
// Bound: bytes. Each element of log_a and b is read once and each h written
// once, with 3 flops (exp, mul, add) per element, so at recurrentgemma-9b's
// prefill ([4, 4096, 4096] float32) the kernel moves 805 MB: 0.240 ms at
// 3.35 TB/s.
//
// Design (simple, right first): one thread per (b, channel) walks t in order
// with the carry in a register, which is the recurrence's own order, so no
// cross-thread combine is needed. Neighbouring threads take neighbouring
// channels, so every load and store of a warp is one contiguous segment.
// The loads do not depend on h, so each thread reads kU steps of log_a and b
// into registers before it computes them, keeping kU loads in flight. At
// B·E = 16,384 threads (128 blocks of 128, one per SM) the card runs far
// below its bandwidth: a chunked two-pass scan over t is later work.
//
// The library is built with -fmad=false, so h = exp(la) * h + b rounds the
// product before the sum, as the plain version (a mul, then an add) does.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kU = 8;  // steps of t whose loads are in flight at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ log_a, const T* __restrict__ b, T* __restrict__ out,
             int S, int E, long long n) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const long long bi = idx / E;
  const size_t col = (size_t)bi * S * E + (size_t)(idx - bi * E);
  const float* la = log_a + col;
  const T* bb = b + col;
  T* ob = out + col;
  float h = 0.0f;
  int t = 0;
  for (; t + kU <= S; t += kU) {
    float la_r[kU], b_r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const size_t off = (size_t)(t + u) * E;
      la_r[u] = la[off];
      b_r[u] = to_f32(bb[off]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h = expf(la_r[u]) * h + b_r[u];
      store(ob + (size_t)(t + u) * E, h);
    }
  }
  for (; t < S; ++t) {
    const size_t off = (size_t)t * E;
    h = expf(la[off]) * h + to_f32(bb[off]);
    store(ob + off, h);
  }
}

template <typename T>
int launch(const float* log_a, const void* b, void* out, int B, int S, int E,
           cudaStream_t stream) {
  const long long n = (long long)B * E;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rglru_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(log_a, (const T*)b, (T*)out, S, E,
                                                             n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (b and out); log_a float32. Shapes are
// checked by the Python wrapper.
extern "C" int rglru_scan_launch(const void* log_a, const void* b, void* out, int B, int S,
                                 int E, int dtype, void* stream) {
  if (B == 0 || S == 0 || E == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const float* la = (const float*)log_a;
  if (dtype == 0) return launch<float>(la, b, out, B, S, E, st);
  if (dtype == 1) return launch<__nv_bfloat16>(la, b, out, B, S, E, st);
  return (int)cudaErrorInvalidValue;
}
