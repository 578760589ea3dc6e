// Weighted pointer jumping over a p-node list (random-splitter phase RS4), for
// Hopper.
//
// Replaces src/repro/kernels/pointer_jump/pointer_jump.py::_pointer_jump_kernel
// (driver pointer_jump_pallas). It runs `iters` synchronous steps of
//
//   rank[i] += rank[nxt[i]];  nxt[i] = nxt[nxt[i]]
//
// and returns (rank, nxt). Every step reads the state of the step before, as
// the functional fori_loop of the reference does.
//
// Bound on this card: latency, not bytes. The call moves only 16*p bytes, but
// its `iters` steps are a chain of dependent gathers with a barrier between
// them. The TPU kernel kept the whole list in VMEM for all steps; here, for p
// up to kSharedLimit, one block of 1024 threads keeps both arrays in shared
// memory (2 * 4096 int32 = 32 KB of the static 48 KB) and runs every step in
// one launch: each thread computes the new values of its strided elements into
// registers, __syncthreads(), writes them back, __syncthreads() again. Above
// the limit the wrapper calls pointer_jump_step once per step, each launch
// reading one pair of global buffers and writing the other.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSharedLimit = 4096;  // SHARED_LIMIT of pointer_jump/ops.py
constexpr int kPerThread = kSharedLimit / kThreads;
constexpr int kStepThreads = 256;
constexpr int kStepMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
    jump_shared(const int* __restrict__ nxt, const int* __restrict__ w,
                int* __restrict__ rank_out, int* __restrict__ nxt_out, int p,
                int iters) {
  __shared__ int r_s[kSharedLimit];
  __shared__ int n_s[kSharedLimit];
  for (int i = threadIdx.x; i < p; i += kThreads) {
    r_s[i] = w[i];
    n_s[i] = nxt[i];
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    int r_new[kPerThread];
    int n_new[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < p) {
        const int j = n_s[i];
        r_new[k] = r_s[i] + r_s[j];
        n_new[k] = n_s[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < p) {
        r_s[i] = r_new[k];
        n_s[i] = n_new[k];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < p; i += kThreads) {
    rank_out[i] = r_s[i];
    nxt_out[i] = n_s[i];
  }
}

// jump_shared without its gathers: the same launch, loads, stores and
// barrier steps, each element read and written in its own place. Its time is
// the latency floor of the one-launch path, which chip_smoke.py prints beside
// the kernel's; it computes nothing the port uses.
__global__ void __launch_bounds__(kThreads)
    jump_floor(const int* __restrict__ nxt, const int* __restrict__ w,
               int* __restrict__ rank_out, int* __restrict__ nxt_out, int p,
               int iters) {
  __shared__ int r_s[kSharedLimit];
  __shared__ int n_s[kSharedLimit];
  for (int i = threadIdx.x; i < p; i += kThreads) {
    r_s[i] = w[i];
    n_s[i] = nxt[i];
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    int r_new[kPerThread];
    int n_new[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < p) {
        r_new[k] = r_s[i] + 1;
        n_new[k] = n_s[i] ^ it;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < p) {
        r_s[i] = r_new[k];
        n_s[i] = n_new[k];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < p; i += kThreads) {
    rank_out[i] = r_s[i];
    nxt_out[i] = n_s[i];
  }
}

__global__ void jump_step(const int* __restrict__ rank, const int* __restrict__ nxt,
                          int* __restrict__ rank_out, int* __restrict__ nxt_out,
                          int p) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p; i += stride) {
    const int j = nxt[i];
    rank_out[i] = rank[i] + rank[j];
    nxt_out[i] = nxt[j];
  }
}

}  // namespace

// All `iters` steps in one launch; p must be in [1, kSharedLimit].
extern "C" int pointer_jump_shared(const void* nxt, const void* w, void* rank_out,
                                   void* nxt_out, int p, int iters,
                                   void* stream) {
  if (p < 1 || p > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  jump_shared<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nxt), static_cast<const int*>(w),
      static_cast<int*>(rank_out), static_cast<int*>(nxt_out), p, iters);
  return static_cast<int>(cudaGetLastError());
}

// jump_floor's launch, with pointer_jump_shared's arguments and limits.
extern "C" int pointer_jump_floor(const void* nxt, const void* w, void* rank_out,
                                  void* nxt_out, int p, int iters, void* stream) {
  if (p < 1 || p > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  jump_floor<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nxt), static_cast<const int*>(w),
      static_cast<int*>(rank_out), static_cast<int*>(nxt_out), p, iters);
  return static_cast<int>(cudaGetLastError());
}

// One step from (rank, nxt) into (rank_out, nxt_out); the buffers must not
// overlap.
extern "C" int pointer_jump_step(const void* rank, const void* nxt, void* rank_out,
                                 void* nxt_out, int p, void* stream) {
  if (p < 1) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (p + kStepThreads - 1) / kStepThreads;
  if (blocks > kStepMaxBlocks) blocks = kStepMaxBlocks;
  jump_step<<<blocks, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rank), static_cast<const int*>(nxt),
      static_cast<int*>(rank_out), static_cast<int*>(nxt_out), p);
  return static_cast<int>(cudaGetLastError());
}
