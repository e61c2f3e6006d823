// RG-LRU diagonal linear recurrence for Hopper (sm_90a), with the RG-LRU
// op's input formation fused in.
//
// Replaces the TPU kernel src/repro/kernels/rglru/rglru.py::rglru_scan
// (`_kernel`, a Pallas grid (B, E/bE, S/cs) whose chunk dimension runs in
// order with the carry h in VMEM scratch):
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = h0 (or 0)
// log_a [B,S,E] float32 and b [B,S,E] (float32 or bfloat16) -> h [B,S,E] in
// b's type; the carry is float32. Two entry points run the one kernel:
// - `rglru_scan_launch(log_a, b, ...)`, the TPU kernel's contract (h0 = 0);
// - `rglru_launch(log_a, gx, h0, ...)`, the reference op
//   src/repro/kernels/rglru/ops.py::rglru: b = sqrt(clip(1 - a², 0, 1)) · gx
//   with a = exp(log_a), formed in float32 and rounded to gx's type, then
//   the scan from an optional float32 carry h0 [B,E] (decode's one step).
//
// Bound: bytes. Each element of log_a and b (or gx) is read once and each h
// written once, with a handful of flops per element, so at
// recurrentgemma-9b's prefill ([4, 4096, 4096] float32) either entry moves
// 805 MB: 0.240 ms at 3.35 TB/s.
//
// Design: a chained single pass over t. A block owns a tile of kTE channels
// of one batch row (one thread a channel; a "column") and a chunk of kTC
// steps of t. It stages the tile's log_a and b in shared memory with 16-byte
// cp.async copies, coalesced along E, then computes exp(log_a) (and, fused,
// b) for its whole chunk off the dependent chain. Only then does it wait for
// the carry: the chunk before it in the same column publishes its final h,
// the block walks its chunk from that h (one mul and one add a step on the
// chain), writes every h_t and publishes its own final h. There is no
// second pass and no combination of partial products: every h_t is computed
// from the true h_{t-1} by expf, a rounded mul and an add (the library is
// built with -fmad=false), as a sequential loop computes it.
//
// Handoff, forward progress and workspace: rglru_chain.cuh. A chunk's
// place in its column's chain is its index c: chunk c waits for the final h
// of chunk c - 1.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rglru_chain.cuh"
#include "wgmma.cuh"  // smem_u32, cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kTC = 64;  // steps of t a block (kTE channels: rglru_chain.cuh)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// FUSE: x is gx and b is formed here; else x is b. VEC: 16-byte cp.async
// staging (E a multiple of the 16-byte chunk, pointers 16-byte aligned);
// else each thread loads its own channel.
template <typename T, bool FUSE, bool VEC>
__global__ void __launch_bounds__(kTE)
rglru_chain_kernel(const float* __restrict__ log_a, const T* __restrict__ x,
                   const float* __restrict__ h0, T* __restrict__ out,
                   unsigned* __restrict__ ticket, unsigned long long* __restrict__ carry, int S,
                   int E, int n_cols, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);                  // [kTC][kTE] log_a, then a
  T* b_s = reinterpret_cast<T*>(smem + kTC * kTE * sizeof(float));  // [kTC][kTE] b (or gx)
  const int j = threadIdx.x;
  const unsigned tile = take_ticket(ticket);
  const int chunk = (int)(tile / (unsigned)n_cols);
  const int col = (int)(tile % (unsigned)n_cols);
  const int tiles_e = (E + kTE - 1) / kTE;
  const int bi = col / tiles_e, e0 = (col % tiles_e) * kTE;
  const int t0 = chunk * kTC;
  const int rows = min(kTC, S - t0);
  const int width = min(kTE, E - e0);
  const size_t base = ((size_t)bi * S + t0) * E + e0;  // element (bi, t0, e0)

  if (VEC) {
    constexpr int va = 16 / sizeof(float), vb = 16 / sizeof(T);  // elements a chunk
    constexpr int ca = kTE / va, cb = kTE / vb;                   // chunks a tile row
    for (int i = j; i < rows * ca; i += kTE) {
      const int r = i / ca, c = (i % ca) * va;
      if (c < width)
        cp_async16(smem_u32(a_s + r * kTE + c), log_a + base + (size_t)r * E + c, 16);
    }
    for (int i = j; i < rows * cb; i += kTE) {
      const int r = i / cb, c = (i % cb) * vb;
      if (c < width) cp_async16(smem_u32(b_s + r * kTE + c), x + base + (size_t)r * E + c, 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  } else if (j < width) {
    for (int r = 0; r < rows; ++r) {
      a_s[r * kTE + j] = log_a[base + (size_t)r * E + j];
      b_s[r * kTE + j] = x[base + (size_t)r * E + j];
    }
  }
  if (j >= width) return;  // no barrier follows

  // off the chain: a = exp(log_a) and, fused, b, for the whole chunk; from
  // here on each thread touches only its own channel of the tile
  for (int r = 0; r < rows; ++r) {
    const float a = expf(a_s[r * kTE + j]);
    a_s[r * kTE + j] = a;
    if (FUSE) {
      float y = 1.0f - a * a;
      y = y < 0.0f ? 0.0f : (y > 1.0f ? 1.0f : y);  // clamp, NaN passes through
      b_s[r * kTE + j] = from_f32<T>(sqrtf(y) * to_f32(b_s[r * kTE + j]));
    }
  }

  unsigned long long* slot = carry + (size_t)col * kTE + j;
  float h;
  if (chunk == 0) {
    h = h0 != nullptr ? h0[(size_t)bi * E + e0 + j] : 0.0f;
  } else {
    h = wait_carry(slot, chunk);
  }
  T* o = out + base + j;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    h = a_s[r * kTE + j] * h + to_f32(b_s[r * kTE + j]);
    o[(size_t)r * E] = from_f32<T>(h);
  }
  if (chunk + 1 < n_chunks) put_carry(slot, chunk + 1, h);
}

template <typename T, bool FUSE, bool VEC>
int launch_variant(const float* log_a, const void* x, const float* h0, void* out, void* ws,
                   int B, int S, int E, cudaStream_t stream) {
  auto kern = rglru_chain_kernel<T, FUSE, VEC>;
  const int smem = kTC * kTE * (int)(sizeof(float) + sizeof(T));
  static bool configured[kMaxDevices] = {};
  if (const int err = allow_smem(kern, smem, configured)) return err;
  const long long n_cols = chain_columns(B, E);
  const long long n_chunks = (S + kTC - 1) / kTC;
  const long long blocks = n_cols * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  unsigned* ticket;
  unsigned long long* carry;
  cudaError_t e = reset_chain(ws, B, E, stream, &ticket, &carry);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)blocks, kTE, smem, stream>>>(log_a, (const T*)x, h0, (T*)out, ticket, carry,
                                                 S, E, (int)n_cols, (int)n_chunks);
  return (int)cudaGetLastError();
}

template <typename T, bool FUSE>
int launch(const void* log_a, const void* x, const void* h0, void* out, void* ws, int B, int S,
           int E, void* stream) {
  if (B == 0 || S == 0 || E == 0) return (int)cudaGetLastError();
  // 16-byte chunks of x's rows (of 4 or 8 elements) are chunks of log_a's too
  const bool vec = E % (16 / sizeof(T)) == 0 && ((uintptr_t)log_a | (uintptr_t)x) % 16 == 0;
  const float* la = (const float*)log_a;
  const float* hp = (const float*)h0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) return launch_variant<T, FUSE, true>(la, x, hp, out, ws, B, S, E, st);
  return launch_variant<T, FUSE, false>(la, x, hp, out, ws, B, S, E, st);
}

}  // namespace

// Bytes of the workspace a launch at (B, E) needs.
extern "C" long long rglru_workspace_bytes(int B, int E) {
  return (long long)chain_workspace_bytes(B, E);
}

// The TPU kernel's contract: h from b, h_{-1} = 0. dtype: 0 = float32,
// 1 = bfloat16 (b and out); log_a float32. Shapes are checked by the
// Python wrapper; ws holds rglru_workspace_bytes(B, E) bytes.
extern "C" int rglru_scan_launch(const void* log_a, const void* b, void* out, void* ws, int B,
                                 int S, int E, int dtype, void* stream) {
  if (dtype == 0) return launch<float, false>(log_a, b, nullptr, out, ws, B, S, E, stream);
  if (dtype == 1) return launch<__nv_bfloat16, false>(log_a, b, nullptr, out, ws, B, S, E, stream);
  return (int)cudaErrorInvalidValue;
}

// The reference op: b formed from gx in the kernel, the scan from h0
// (float32 [B,E], or null for 0). dtype as above, for gx and out.
extern "C" int rglru_launch(const void* log_a, const void* gx, const void* h0, void* out, void* ws,
                            int B, int S, int E, int dtype, void* stream) {
  if (dtype == 0) return launch<float, true>(log_a, gx, h0, out, ws, B, S, E, stream);
  if (dtype == 1) return launch<__nv_bfloat16, true>(log_a, gx, h0, out, ws, B, S, E, stream);
  return (int)cudaErrorInvalidValue;
}
