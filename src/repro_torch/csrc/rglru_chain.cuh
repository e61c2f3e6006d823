// The chained single pass over t that the RG-LRU scan (rglru_scan.cu) and
// its backward (rglru_scan_bwd.cu) share: a block's ticket, the carry words
// that pass between the chunks of a column, and the workspace that holds
// both.
//
// A column is a tile of kTE channels of one batch row; it is cut into chunks
// of t, and the chunks of a column form a chain: the forward's chunk c needs
// the carry of chunk c - 1, the backward's chunk c that of chunk c + 1.
// "pos" below is a chunk's place in its chain (the forward: c; the backward:
// n_chunks - 1 - c), so a chunk at pos p > 0 waits for the one at p - 1.
//
// Ticket. A block takes (pos, column) from an atomicAdd ticket, pos-major
// (ticket = pos * n_cols + column), not from blockIdx. The chunk at pos p
// waits only for pos p - 1 of its column, whose ticket is smaller by n_cols:
// it was taken earlier, so by a block that is already running and stays
// resident until it finishes. That block waits only for a smaller ticket
// again, down to pos 0, which waits for nothing. So every waiting block waits
// for a running block, whatever the number of blocks resident.
//
// Carry. Each channel's carry is one 64-bit word: the pos that may read it
// in the high half (never 0, so the zeroed workspace matches no reader), the
// float32 value in the low half, written by one store. A naturally aligned
// 64-bit access is single-copy atomic, so a reader that sees its pos also
// sees the value of the same store; no other data passes between blocks (the
// outputs are read by no block), so no fence is needed. Loads and stores are
// .relaxed.gpu, which bypasses the non-coherent L1.
//
// Workspace. A ticket, then one carry word a channel of every column. The
// wrapper allocates it with torch.empty and the C entry zeroes it with a
// cudaMemsetAsync on the launch stream before the kernel, so a word left by
// an earlier launch is never read, the host never synchronises, and a
// captured stream records both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTE = 128;  // channels a column tile, one thread each
constexpr size_t kTicketBytes = 16;
constexpr int kMaxDevices = 64;

long long chain_columns(int B, int E) { return (long long)B * ((E + kTE - 1) / kTE); }

size_t chain_workspace_bytes(int B, int E) {
  return kTicketBytes + (size_t)chain_columns(B, E) * kTE * sizeof(unsigned long long);
}

// Thread 0 takes the block's ticket; every thread of the block returns it.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  __shared__ unsigned tile;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1u);
  __syncthreads();
  return tile;
}

__device__ __forceinline__ unsigned long long load_carry(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The carry that the chunk at pos - 1 published for the reader at `pos`.
__device__ __forceinline__ float wait_carry(const unsigned long long* slot, int pos) {
  unsigned long long v = load_carry(slot);
  while ((unsigned)(v >> 32) != (unsigned)pos) {
    __nanosleep(32);
    v = load_carry(slot);
  }
  return __uint_as_float((unsigned)v);
}

// Publish x for the reader at `pos`.
__device__ __forceinline__ void put_carry(unsigned long long* slot, int pos, float x) {
  const unsigned long long v = ((unsigned long long)(unsigned)pos << 32) | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(slot), "l"(v) : "memory");
}

// Allow `bytes` of dynamic shared memory to kern, once a device (`done`, a
// static of the caller's per kernel), at its first launch (before any
// capture records one).
template <typename K>
int allow_smem(K kern, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

// Zero the workspace on the stream and return the ticket and the carries.
inline cudaError_t reset_chain(void* ws, int B, int E, cudaStream_t stream, unsigned** ticket,
                               unsigned long long** carry) {
  *ticket = (unsigned*)ws;
  *carry = (unsigned long long*)((char*)ws + kTicketBytes);
  return cudaMemsetAsync(ws, 0, chain_workspace_bytes(B, E), stream);
}

}  // namespace
