// Random-splitter rank aggregation (phase RS5), for Hopper.
//
// Replaces src/repro/kernels/splitter_aggregate/splitter_aggregate.py::_agg_kernel
// (driver splitter_aggregate_pallas). For every list node j:
//
//   rank[j] = sprank[owner[j]] - local[j]
//
// over the (n, 2) int32 rows [local, owner].
//
// Bound on this card: memory, 12*n + 4*p bytes per call (each row read once,
// each rank written once, the splitter table read once). The rows stream in
// order, each thread reading one row as a single 8-byte int2 load (the
// paper's 64-bit packed pair, guideline G5). The one irregular access, the
// table lookup, goes to shared memory: each block stages the p-entry table
// once (16 KB at p = 4096) and then walks its share of the rows in a
// grid-stride loop, as the TPU kernel held the table in VMEM for every tile.
// A table above 48 KB raises the block's dynamic shared-memory limit, up to
// the 227 KB a block can have; a larger one is read from global memory
// through the read-only cache.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 132 * 4;
constexpr int kDefaultShared = 48 * 1024;
constexpr int kMaxShared = 232448;

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void aggregate_shared(const int2* __restrict__ packed,
                                 const int* __restrict__ sprank,
                                 int* __restrict__ out, long long n, int p) {
  extern __shared__ int table[];
  for (int i = threadIdx.x; i < p; i += blockDim.x) table[i] = sprank[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const int2 row = packed[j];
    out[j] = table[row.y] - row.x;
  }
}

__global__ void aggregate_global(const int2* __restrict__ packed,
                                 const int* __restrict__ sprank,
                                 int* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const int2 row = packed[j];
    out[j] = __ldg(sprank + row.y) - row.x;
  }
}

}  // namespace

// packed must be 8-byte aligned; n >= 1, p >= 1.
extern "C" int splitter_aggregate_run(const void* packed, const void* sprank,
                                      void* out, int n, int p, void* stream) {
  if (n < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto rows = static_cast<const int2*>(packed);
  const auto table = static_cast<const int*>(sprank);
  const auto dst = static_cast<int*>(out);
  const long long bytes = static_cast<long long>(p) * sizeof(int);
  if (bytes <= kMaxShared) {
    if (bytes > kDefaultShared) {
      const cudaError_t err = cudaFuncSetAttribute(
          aggregate_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    aggregate_shared<<<grid_for(n), kThreads, bytes, st>>>(rows, table, dst, n, p);
  } else {
    aggregate_global<<<grid_for(n), kThreads, 0, st>>>(rows, table, dst, n);
  }
  return static_cast<int>(cudaGetLastError());
}
