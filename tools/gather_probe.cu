// Random 4-byte gathers from a table of 2^k words, for the sector model of
// src/repro_torch/kernels/csrc/edge_hook.cu: each gather touches its own
// 32-byte sector, so gathers per second are sectors per second. From a table
// that fits the 50 MB L2 this is the L2's rate; from one far past it, device
// memory's. tools/edge_hook_ab.py builds, launches and times it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGathers = 16;  // independent gathers in flight a thread

__device__ __forceinline__ unsigned mix(unsigned h) {
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  h *= 0x846ca68bu;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(kThreads)
    probe(const unsigned* __restrict__ table, unsigned mask,
          unsigned* __restrict__ out, long long threads) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= threads) return;
  unsigned idx[kGathers];
#pragma unroll
  for (int k = 0; k < kGathers; ++k) {
    idx[k] = mix(static_cast<unsigned>(t) * kGathers + k) & mask;
  }
  unsigned v[kGathers];
#pragma unroll
  for (int k = 0; k < kGathers; ++k) v[k] = table[idx[k]];
  unsigned x = 0;
#pragma unroll
  for (int k = 0; k < kGathers; ++k) x ^= v[k];
  out[t] = x;
}

}  // namespace

// threads * 16 gathers from table[0, 2^log2_words); out holds `threads` words.
extern "C" int gather_probe(const void* table, int log2_words, void* out,
                            long long threads, void* stream) {
  const unsigned mask = log2_words >= 32 ? 0xffffffffu : (1u << log2_words) - 1u;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  probe<<<static_cast<unsigned>(blocks), kThreads, 0,
          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(table), mask, static_cast<unsigned*>(out),
      threads);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_probe_per_thread() { return kGathers; }
