// The backward of the RG-LRU diagonal linear recurrence (csrc/rglru_scan.cu)
// for Hopper (sm_90a).
//
// Replaces the gradient that the reference takes by autodiff of its plain
// scan (src/repro/models/rglru.py::rglru_scan, differentiated by jax.grad in
// src/repro/models/stack.py:298): the TPU kernel it stands beside,
// src/repro/kernels/rglru/rglru.py::rglru_scan, has no backward. With the
// forward h_t = a_t h_{t-1} + b_t (a = exp(log_a), h_{-1} = h0 or 0) and dh
// the output's gradient, the reverse scan
//   g_t = dh_t + a_{t+1} g_{t+1},   g_{S-1} = dh_{S-1}
// gives db_t = g_t, dlog_a_t = g_t a_t h_{t-1} and dh0 = a_0 g_0. Two entry
// points, as the forward's:
// - `rglru_scan_bwd_launch(log_a, b, h, dh, ...)`: the contract's gradient
//   (dlog_a, db);
// - `rglru_bwd_launch(log_a, gx, h, dh, h0, ...)`: the fused op's, where
//   b = sqrt(clip(1 - a², 0, 1)) gx: dgx = g sqrt(1 - a²), and inside the
//   clip (0 < 1 - a² < 1) dlog_a gains -g gx a² / sqrt(1 - a²); dh0 when
//   the forward had a carry h0.
// log_a, dlog_a, h0 and dh0 are float32; b (or gx), h, dh and db (or dgx)
// float32 or bfloat16, one type. h_{t-1} is read from the forward's output h
// (the training path's is float32: gx = i · x is formed in float32).
//
// Bound: bytes. Each of log_a, x, h and dh is read once and dlog_a and dx
// written once, with a handful of flops per element: at recurrentgemma-9b's
// training shape ([2, 2048, 4096] float32) the fused entry moves 403 MB,
// 0.120 ms at 3.35 TB/s.
//
// Design (the first, simple one): one thread a (b, e) channel walks t from
// S - 1 down to 0, the threads of a block on consecutive channels, so every
// load and store of a step is coalesced along E. The loads of kU steps are
// issued together into registers (they do not depend on the carry g), then
// the chain walks them: one mul and one add a step on g. The forward's
// chained look-back over chunks of t, run in reverse, is the later
// redesign: at B·E = 8,192 channels this runs 128 blocks of 64 threads,
// under one block an SM. Each output is written by one thread in a fixed
// order, so two calls give the same bits. Built with -fmad=false like every
// kernel of the port: each product and sum is rounded on its own, in the
// plain version's order.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;  // channels a block
constexpr int kU = 16;        // steps of t whose loads are issued together

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// FUSE: x is gx and b's formation is differentiated; else x is b (unread).
template <typename T, bool FUSE>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const float* __restrict__ log_a, const T* __restrict__ x,
                 const T* __restrict__ h, const T* __restrict__ dh,
                 const float* __restrict__ h0, float* __restrict__ dlog_a, T* __restrict__ dx,
                 float* __restrict__ dh0, int S, int E) {
  const int bi = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const size_t base = (size_t)bi * S * E + e;  // element (bi, 0, e)
  const float first = h0 != nullptr ? h0[(size_t)bi * E + e] : 0.0f;
  float g = 0.0f, a_next = 0.0f;  // g_{t+1} and a_{t+1}; both 0 past the end
  for (int t1 = S; t1 > 0; t1 -= kU) {
    float la[kU], gv[kU], xv[kU], hp[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t1 - 1 - u;
      if (t >= 0) {
        const size_t o = base + (size_t)t * E;
        la[u] = log_a[o];
        gv[u] = to_f32(dh[o]);
        xv[u] = FUSE ? to_f32(x[o]) : 0.0f;
        hp[u] = t > 0 ? to_f32(h[o - E]) : first;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t1 - 1 - u;
      if (t < 0) break;
      const size_t o = base + (size_t)t * E;
      const float a = expf(la[u]);
      g = gv[u] + a_next * g;
      float dla = g * a * hp[u];
      if (FUSE) {
        const float y = 1.0f - a * a;
        const float s = sqrtf(y < 0.0f ? 0.0f : (y > 1.0f ? 1.0f : y));
        if (y > 0.0f && y < 1.0f) dla = dla + -g * xv[u] * (a * a) / s;
        store(dx + o, g * s);
      } else {
        store(dx + o, g);
      }
      dlog_a[o] = dla;
      a_next = a;
    }
  }
  if (dh0 != nullptr) dh0[(size_t)bi * E + e] = a_next * g;
}

template <typename T, bool FUSE>
int launch(const void* log_a, const void* x, const void* h, const void* dh, const void* h0,
           void* dlog_a, void* dx, void* dh0, int B, int S, int E, void* stream) {
  if (B == 0 || S == 0 || E == 0) return (int)cudaGetLastError();
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((E + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<T, FUSE><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const T*)x, (const T*)h, (const T*)dh, (const float*)h0,
      (float*)dlog_a, (T*)dx, (float*)dh0, S, E);
  return (int)cudaGetLastError();
}

}  // namespace

// The contract's gradient: (dlog_a, db) from log_a, the forward's output h
// and its gradient dh. dtype: 0 = float32, 1 = bfloat16 (b, h, dh, db);
// log_a and dlog_a float32. Shapes are checked by the Python wrapper.
extern "C" int rglru_scan_bwd_launch(const void* log_a, const void* b, const void* h,
                                     const void* dh, void* dlog_a, void* db, int B, int S, int E,
                                     int dtype, void* stream) {
  if (dtype == 0)
    return launch<float, false>(log_a, b, h, dh, nullptr, dlog_a, db, nullptr, B, S, E, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(log_a, b, h, dh, nullptr, dlog_a, db, nullptr, B, S, E,
                                        stream);
  return (int)cudaErrorInvalidValue;
}

// The fused op's gradient: (dlog_a, dgx, dh0) from log_a, gx, the forward's
// output h and its gradient dh; h0 and dh0 float32 [B,E], both null when the
// forward had no carry. dtype as above, for gx, h, dh and dgx.
extern "C" int rglru_bwd_launch(const void* log_a, const void* gx, const void* h, const void* dh,
                                const void* h0, void* dlog_a, void* dgx, void* dh0, int B, int S,
                                int E, int dtype, void* stream) {
  if (dtype == 0)
    return launch<float, true>(log_a, gx, h, dh, h0, dlog_a, dgx, dh0, B, S, E, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(log_a, gx, h, dh, h0, dlog_a, dgx, dh0, B, S, E, stream);
  return (int)cudaErrorInvalidValue;
}
