// Slot-order segmented fold (PageRank's ADD monoid), for Hopper.
//
// Port-only: the reference has no Pallas kernel for it. Its ADD monoid
// (src/repro/core/operators.py, `ADD`) is a scatter-add that XLA's CPU and
// TPU backends fold in edge-slot order; that order is what keeps PageRank
// bit-equal to its numpy oracle (np.add.at). On the card index_add_ folds
// through atomics in no fixed order. Given slots sorted stably by target
// (`perm`, with the slots of target v at perm[row_ptr[v] .. row_ptr[v+1])),
// this kernel computes for every target v
//
//   out[v] = (((base[v] + values[perm[s]]) + values[perm[s+1]]) + ...)
//
// with every add an explicit __fadd_rn: round to nearest, each add on its
// own, in slot order. The kernel does no multiply, so nothing can be
// contracted into an FMA whatever -fmad says.
//
// Bound on this card: memory, 8 bytes an arc (perm and values, each read
// once) and 12 a node (row_ptr, base and the output). This first design gives
// each target one thread, which walks its range in order; the loads of
// kBatch slots are issued before their adds so that the gathers of a batch
// overlap, while the adds stay one dependent chain. A hub therefore folds
// serially: a target with 2^20 arcs is 2^20 dependent adds in one thread.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kThreads)
    fold_kernel(const float* __restrict__ base, const int* __restrict__ row_ptr,
                const int* __restrict__ perm, const float* __restrict__ values,
                float* __restrict__ out, int n) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  int s = row_ptr[v];
  const int end = row_ptr[v + 1];
  float acc = base[v];
  for (; s + kBatch <= end; s += kBatch) {
    float x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) x[k] = __ldg(values + __ldg(perm + s + k));
#pragma unroll
    for (int k = 0; k < kBatch; ++k) acc = __fadd_rn(acc, x[k]);
  }
  for (; s < end; ++s) acc = __fadd_rn(acc, __ldg(values + __ldg(perm + s)));
  out[v] = acc;
}

}  // namespace

// n >= 1 targets; row_ptr has n + 1 entries.
extern "C" int ordered_fold_run(const void* base, const void* row_ptr,
                                const void* perm, const void* values, void* out,
                                int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks =
      static_cast<int>((static_cast<long long>(n) + kThreads - 1) / kThreads);
  fold_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int*>(row_ptr),
      static_cast<const int*>(perm), static_cast<const float*>(values),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
