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
// Bound: bytes. Each of log_a, h and dh (and gx, fused) is read once and
// dlog_a and dx written once, with a handful of flops per element: at
// recurrentgemma-9b's training shape ([2, 2048, 4096] float32) the fused
// entry moves 403 MB, 0.120 ms at 3.35 TB/s; the contract 336 MB, 0.100 ms.
//
// Design: the forward's chained single pass, run in reverse
// (rglru_chain.cuh: the ticket, the carry words, the workspace). A block
// owns a column (kTE channels of one batch row, one thread a channel) and a
// chunk of kTC steps of t, and its place in the column's chain counts from
// the last chunk: chunk c waits for the carry g_{t0 + rows} of chunk c + 1.
// - It stages its tile's rows of log_a (one row past the chunk as well: the
//   chain needs a_{t0 + rows}), dh, h_{t-1} (h's rows t0 - 1 .. t0 + rows - 2)
//   and, fused, gx in shared memory with 16-byte cp.async copies, coalesced
//   along E (each thread loads its own channel where a row is not 16-byte
//   aligned, E % (16 / sizeof(T)) != 0).
// - Before it waits it computes what does not depend on the carry: a =
//   expf(log_a) for every row and, fused, s = sqrt(clip(1 - a², 0, 1)) and
//   whether 1 - a² lies inside the clip; a and dh go to registers.
// - Then it waits for the carry, walks the chain alone (one mul and one add
//   a step, g = dh + a_next * g, in registers), and publishes g_{t0} to
//   chunk c - 1 before it forms any output, so the next block's wait is as
//   short as the walk.
//   The block holding chunk 0 writes dh0 = a_0 g_0.
// - Last, from the walk's g_t kept in registers, it writes dlog_a and dx.
// Shared memory: (kTC + 1) rows of float32 log_a and kTC rows of each staged
// stream. At kTC = 32 the fused float32 entry takes 66 KB, so three blocks
// are resident an SM (two at 64 steps would take 130 KB: one block an SM,
// four warps); at [2, 2048, 4096] a column then has 64 chunks, 64 handoffs.
//
// Exactness: every product and sum is rounded on its own in the plain
// version's order (the library is built with -fmad=false): g = dh + a_next
// * g; dla = g * a * hp; fused, inside the clip, dla + ((-g * x) * (a * a))
// / s; dx = g * s (or g). The chain gives each g_t from the true g_{t+1}, as
// the sequential loop does, and each output is written by one thread, so two
// calls give the same bits and the results equal the one-thread-a-channel
// loop's bit for bit.
//
// Plain C interface (loaded with ctypes): returns the first cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rglru_chain.cuh"
#include "wgmma.cuh"  // smem_u32, cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kTC = 32;  // steps of t a chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, bool FUSE>
constexpr int smem_bytes() {
  return (kTC + 1) * kTE * (int)sizeof(float) + (FUSE ? 3 : 2) * kTC * kTE * (int)sizeof(T);
}

// FUSE: x is gx and b's formation is differentiated; else x is b (unread).
// VEC: 16-byte cp.async staging (E a multiple of the 16-byte chunk, pointers
// 16-byte aligned); else each thread loads its own channel.
template <typename T, bool FUSE, bool VEC>
__global__ void __launch_bounds__(kTE)
rglru_bwd_chain_kernel(const float* __restrict__ log_a, const T* __restrict__ x,
                       const T* __restrict__ h, const T* __restrict__ dh,
                       const float* __restrict__ h0, float* __restrict__ dlog_a,
                       T* __restrict__ dx, float* __restrict__ dh0,
                       unsigned* __restrict__ ticket, unsigned long long* __restrict__ carry,
                       int S, int E, int n_cols, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);  // [kTC + 1][kTE] log_a, then s (fused)
  T* d_s = reinterpret_cast<T*>(a_s + (kTC + 1) * kTE);  // [kTC][kTE] dh
  T* p_s = d_s + kTC * kTE;  // [kTC][kTE] h_{t-1}: row r holds h_{t0 + r - 1}
  T* x_s = p_s + kTC * kTE;  // [kTC][kTE] gx (FUSE)
  const int j = threadIdx.x;
  const unsigned tile = take_ticket(ticket);
  const int pos = (int)(tile / (unsigned)n_cols);  // from the last chunk
  const int col = (int)(tile % (unsigned)n_cols);
  const int chunk = n_chunks - 1 - pos;
  const int tiles_e = (E + kTE - 1) / kTE;
  const int bi = col / tiles_e, e0 = (col % tiles_e) * kTE;
  const int t0 = chunk * kTC;
  const int rows = min(kTC, S - t0);
  const int arows = rows + (pos > 0);  // log_a's rows, with a_{t0 + rows} when a chunk follows
  const int hr0 = t0 == 0 ? 1 : 0;     // h_{-1} is h0 (or 0), not staged
  const int width = min(kTE, E - e0);
  const size_t base = ((size_t)bi * S + t0) * E + e0;  // element (bi, t0, e0)

  if (VEC) {
    constexpr int va = 16 / sizeof(float), vt = 16 / sizeof(T);  // elements a 16-byte chunk
    constexpr int ca = kTE / va, ct = kTE / vt;                   // chunks a tile row
    for (int i = j; i < arows * ca; i += kTE) {
      const int r = i / ca, c = (i % ca) * va;
      if (c < width)
        cp_async16(smem_u32(a_s + r * kTE + c), log_a + base + (size_t)r * E + c, 16);
    }
    for (int i = j; i < rows * ct; i += kTE) {
      const int r = i / ct, c = (i % ct) * vt;
      if (c >= width) continue;
      const size_t o = base + (size_t)r * E + c;
      cp_async16(smem_u32(d_s + r * kTE + c), dh + o, 16);
      if (r >= hr0) cp_async16(smem_u32(p_s + r * kTE + c), h + o - E, 16);
      if (FUSE) cp_async16(smem_u32(x_s + r * kTE + c), x + o, 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  } else if (j < width) {
    for (int r = 0; r < arows; ++r) a_s[r * kTE + j] = log_a[base + (size_t)r * E + j];
    for (int r = 0; r < rows; ++r) {
      const size_t o = base + (size_t)r * E + j;
      d_s[r * kTE + j] = dh[o];
      if (r >= hr0) p_s[r * kTE + j] = h[o - E];
      if (FUSE) x_s[r * kTE + j] = x[o];
    }
  }
  if (j >= width) return;  // no barrier follows

  // off the chain, before the wait: a and dh of every row in registers, a_{t0
  // + rows}, and, fused, s (in a's place in shared memory) and the clip
  float av[kTC], gv[kTC];  // a_r; dh_r, then g_r
  uint64_t inside = 0;     // bit r: 0 < 1 - a_r² < 1
#pragma unroll
  for (int r = 0; r < kTC; ++r) {
    if (r < rows) {
      const float a = expf(a_s[r * kTE + j]);
      av[r] = a;
      gv[r] = to_f32(d_s[r * kTE + j]);
      if (FUSE) {
        const float y = 1.0f - a * a;
        a_s[r * kTE + j] = sqrtf(y < 0.0f ? 0.0f : (y > 1.0f ? 1.0f : y));  // NaN passes
        if (y > 0.0f && y < 1.0f) inside |= 1ull << r;
      }
    }
  }
  // the chain: g_{t0 + rows} (0 past the end, where a_next is 0 as well),
  // then one mul and one add a step, in registers
  unsigned long long* slot = carry + (size_t)col * kTE + j;
  float g = 0.0f, a_next = 0.0f;
  if (pos > 0) {
    a_next = expf(a_s[rows * kTE + j]);
    g = wait_carry(slot, pos);
  }
#pragma unroll
  for (int r = kTC - 1; r >= 0; --r) {
    if (r < rows) {
      g = gv[r] + a_next * g;
      gv[r] = g;
      a_next = av[r];
    }
  }
  if (chunk > 0) put_carry(slot, pos + 1, g);  // g_{t0} for chunk c - 1
  if (chunk == 0 && dh0 != nullptr) dh0[(size_t)bi * E + e0 + j] = a_next * g;

  // the outputs, from the walk's g_t
  const float first = h0 != nullptr ? h0[(size_t)bi * E + e0 + j] : 0.0f;
  float* dl = dlog_a + base + j;
  T* dxo = dx + base + j;
#pragma unroll
  for (int r = 0; r < kTC; ++r) {
    if (r < rows) {
      const float gg = gv[r], a = av[r];
      const float hp = r < hr0 ? first : to_f32(p_s[r * kTE + j]);
      float dla = gg * a * hp;
      if (FUSE) {
        const float s = a_s[r * kTE + j];
        const float xv = to_f32(x_s[r * kTE + j]);
        if ((inside >> r) & 1u) dla = dla + -gg * xv * (a * a) / s;
        store(dxo + (size_t)r * E, gg * s);
      } else {
        store(dxo + (size_t)r * E, gg);
      }
      dl[(size_t)r * E] = dla;
    }
  }
}

template <typename T, bool FUSE, bool VEC>
int launch_variant(const float* log_a, const T* x, const T* h, const T* dh, const float* h0,
                   float* dlog_a, T* dx, float* dh0, void* ws, int B, int S, int E,
                   cudaStream_t stream) {
  auto kern = rglru_bwd_chain_kernel<T, FUSE, VEC>;
  constexpr int smem = smem_bytes<T, FUSE>();
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
  kern<<<(unsigned)blocks, kTE, smem, stream>>>(log_a, x, h, dh, h0, dlog_a, dx, dh0, ticket,
                                                 carry, S, E, (int)n_cols, (int)n_chunks);
  return (int)cudaGetLastError();
}

template <typename T, bool FUSE>
int launch(const void* log_a, const void* x, const void* h, const void* dh, const void* h0,
           void* dlog_a, void* dx, void* dh0, void* ws, int B, int S, int E, void* stream) {
  if (B == 0 || S == 0 || E == 0) return (int)cudaGetLastError();
  // 16-byte chunks of a T row (4 or 8 elements) are chunks of log_a's rows too
  const uintptr_t ptrs = (uintptr_t)log_a | (uintptr_t)h | (uintptr_t)dh |
                         (FUSE ? (uintptr_t)x : (uintptr_t)0);
  const bool vec = E % (16 / sizeof(T)) == 0 && ptrs % 16 == 0;
  auto variant = vec ? launch_variant<T, FUSE, true> : launch_variant<T, FUSE, false>;
  return variant((const float*)log_a, (const T*)x, (const T*)h, (const T*)dh, (const float*)h0,
                 (float*)dlog_a, (T*)dx, (float*)dh0, ws, B, S, E, (cudaStream_t)stream);
}

}  // namespace

// Bytes of the workspace a launch at (B, E) needs.
extern "C" long long rglru_bwd_workspace_bytes(int B, int E) {
  return (long long)chain_workspace_bytes(B, E);
}

// The contract's gradient: (dlog_a, db) from log_a, the forward's output h
// and its gradient dh. dtype: 0 = float32, 1 = bfloat16 (b, h, dh, db);
// log_a and dlog_a float32; ws holds rglru_bwd_workspace_bytes(B, E) bytes.
// Shapes are checked by the Python wrapper.
extern "C" int rglru_scan_bwd_launch(const void* log_a, const void* b, const void* h,
                                     const void* dh, void* dlog_a, void* db, void* ws, int B,
                                     int S, int E, int dtype, void* stream) {
  if (dtype == 0)
    return launch<float, false>(log_a, b, h, dh, nullptr, dlog_a, db, nullptr, ws, B, S, E,
                                stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(log_a, b, h, dh, nullptr, dlog_a, db, nullptr, ws, B,
                                        S, E, stream);
  return (int)cudaErrorInvalidValue;
}

// The fused op's gradient: (dlog_a, dgx, dh0) from log_a, gx, the forward's
// output h and its gradient dh; h0 and dh0 float32 [B,E], both null when the
// forward had no carry. dtype and ws as above, for gx, h, dh and dgx.
extern "C" int rglru_bwd_launch(const void* log_a, const void* gx, const void* h, const void* dh,
                                const void* h0, void* dlog_a, void* dgx, void* dh0, void* ws,
                                int B, int S, int E, int dtype, void* stream) {
  if (dtype == 0)
    return launch<float, true>(log_a, gx, h, dh, h0, dlog_a, dgx, dh0, ws, B, S, E, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(log_a, gx, h, dh, h0, dlog_a, dgx, dh0, ws, B, S, E,
                                       stream);
  return (int)cudaErrorInvalidValue;
}
