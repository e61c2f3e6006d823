// Batched GeoTP scheduler kernel for Hopper (sm_90a): Eq.(8) + Eq.(9).
//
// Replaces the TPU kernel src/repro/kernels/geo_schedule/geo_schedule.py::_kernel
// (a Pallas pass over [bN, D] + [bN, K] row blocks). For each of N rows:
//   off[n, j] = max(rowmax_{inv}(tau + lel) - (tau[n, j] + lel[n, j]), 0), 0 where !inv
//   p[n]      = 1 - exp(sum_{k valid} max(a-1, 0) * log clip((c+1)/(t+1), 1e-6, 1))
// Rows with inv / valid all false give off = 0 and p = 0 (the TPU kernel's
// zero-padded rows); the kernel masks row < N itself, so nothing is padded.
//
// Bound: at the lockstep engine's shapes (N = B lanes ~ 16, D = 4, K = 5)
// a row reads 9D + 13K ~ 100 bytes (tau, lel int32 + inv uint8; c, t, a int32
// + valid uint8) and writes 4D + 4, under 2 KB a launch: far under a
// microsecond of HBM time at 3.35 TB/s, so launch latency bounds it, not
// bytes or FLOPs. The design is therefore the simplest correct one: one
// thread per row, 128 threads a block, loops over D and K in registers.
// A later step folds this work into a fused or graph-captured engine step
// rather than tuning the kernel itself.
//
// Float order: the log-sum runs in index order k = 0..K-1 in float32 with
// logf / expf and IEEE division; build with -fmad=false and without
// --use_fast_math so no multiply-add is contracted. The engine draws
// admission as u01 < p, so the order is kept as the plain version's.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void geo_schedule_kernel(const int32_t* __restrict__ tau,
                                    const int32_t* __restrict__ lel,
                                    const uint8_t* __restrict__ inv,
                                    const int32_t* __restrict__ c_cnt,
                                    const int32_t* __restrict__ t_cnt,
                                    const int32_t* __restrict__ a_cnt,
                                    const uint8_t* __restrict__ valid,
                                    int32_t* __restrict__ off,
                                    float* __restrict__ p,
                                    int n, int d, int k) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const size_t rd = (size_t)row * d;
  const size_t rk = (size_t)row * k;

  // Eq.(8): int32 with wrap-around adds, as the plain version's int32 tensors
  int32_t cmax = 0;
  for (int j = 0; j < d; ++j) {
    const int32_t cost = (int32_t)((uint32_t)tau[rd + j] + (uint32_t)lel[rd + j]);
    const int32_t m = inv[rd + j] ? cost : -1;  // max over where(inv, cost, -1)
    if (j == 0 || m > cmax) cmax = m;
  }
  for (int j = 0; j < d; ++j) {
    const int32_t cost = (int32_t)((uint32_t)tau[rd + j] + (uint32_t)lel[rd + j]);
    int32_t o = inv[rd + j] ? (int32_t)((uint32_t)cmax - (uint32_t)cost) : 0;
    off[rd + j] = o > 0 ? o : 0;
  }

  // Eq.(9): float32, index order
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float t = fmaxf((float)t_cnt[rk + j], 0.0f) + 1.0f;
    const float c = fminf(fmaxf((float)c_cnt[rk + j] + 1.0f, 0.0f), t);
    const float ratio = fminf(fmaxf(c / t, 1e-6f), 1.0f);
    const float expo = fmaxf((float)a_cnt[rk + j] - 1.0f, 0.0f);
    const float lp = valid[rk + j] ? expo * logf(ratio) : 0.0f;
    acc = acc + lp;
  }
  p[row] = 1.0f - expf(acc);
}

extern "C" int geo_schedule_launch(const void* tau, const void* lel, const void* inv,
                                   const void* c_cnt, const void* t_cnt,
                                   const void* a_cnt, const void* valid, void* off,
                                   void* p, int n, int d, int k, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    geo_schedule_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tau, (const int32_t*)lel, (const uint8_t*)inv,
        (const int32_t*)c_cnt, (const int32_t*)t_cnt, (const int32_t*)a_cnt,
        (const uint8_t*)valid, (int32_t*)off, (float*)p, n, d, k);
  }
  return (int)cudaGetLastError();
}
