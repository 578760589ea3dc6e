// Fused Shiloach-Vishkin hook phases SV2 and SV3 over all edges, for Hopper.
//
// Replaces src/repro/kernels/edge_hook/edge_hook.py::_edge_hook_kernel (driver
// edge_hook_pallas). Each phase gathers labels at both ends of every oriented
// edge, tests the phase's hook condition, and min-scatters the smaller label
// into the slot of the larger one:
//
//   sv2: where Dprev[a] == D[a] and D[b] < D[a]: D_out[D[a]] min= D[b] and
//        Q_out[D[b]] = s
//   sv3: where D[D[a]] == D[a], Q[D[a]] < s and D[a] != D[b]:
//        D_out[D[a]] min= D[b]; also live[e] = (D[a] != D[b]) for every edge,
//        the frontier mask the round body would otherwise recompute.
//
// Every gather reads the input labels D; the scatters go to D_out, a copy the
// wrapper makes before the launch. That is what the Pallas body does (it reads
// lab_ref while it writes lab_out_ref), and it keeps labels and round counts
// identical to the reference: an atomicMin into the array being gathered would
// let later edges read half-hooked labels. atomicMin is order-free, and every
// Q stamp writes the same s, so the result does not depend on thread order.
//
// Bound on this card: memory. Per call sv2 moves 8*m2 + 20*n bytes and sv3
// 9*m2 + 12*n (edges read once, labels and stamps read and written once,
// counting the wrapper's copies). The edge arrays stream coalesced; the label
// gathers are random. The TPU kernel kept labels in VMEM; here they stay in
// device memory and the 50 MB L2 holds them for n up to about 12M. One thread
// per edge with a grid-stride loop keeps enough loads in flight to cover the
// gather latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

int grid_for(long long m2) {
  long long blocks = (m2 + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void sv2_kernel(const int* __restrict__ a, const int* __restrict__ b,
                           const int* __restrict__ D,
                           const int* __restrict__ Dprev,
                           int* __restrict__ D_out, int* __restrict__ Q_out,
                           long long m2, int s) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < m2; e += stride) {
    const int ia = a[e];
    const int ib = b[e];
    const int Da = D[ia];
    const int Db = D[ib];
    if (Dprev[ia] == Da && Db < Da) {
      atomicMin(D_out + Da, Db);
      Q_out[Db] = s;
    }
  }
}

__global__ void sv3_kernel(const int* __restrict__ a, const int* __restrict__ b,
                           const int* __restrict__ D, const int* __restrict__ Q,
                           int* __restrict__ D_out,
                           unsigned char* __restrict__ live, long long m2,
                           int s) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < m2; e += stride) {
    const int ia = a[e];
    const int ib = b[e];
    const int Da = D[ia];
    const int Db = D[ib];
    const bool differ = Da != Db;
    live[e] = differ;
    if (differ && Q[Da] < s && D[Da] == Da) {
      atomicMin(D_out + Da, Db);
    }
  }
}

}  // namespace

extern "C" int edge_hook_sv2(const void* a, const void* b, const void* D,
                             const void* Dprev, void* D_out, void* Q_out,
                             int m2, int s, void* stream) {
  if (m2 <= 0) return 0;
  sv2_kernel<<<grid_for(m2), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<const int*>(D), static_cast<const int*>(Dprev),
      static_cast<int*>(D_out), static_cast<int*>(Q_out), m2, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int edge_hook_sv3(const void* a, const void* b, const void* D,
                             const void* Q, void* D_out, void* live, int m2,
                             int s, void* stream) {
  if (m2 <= 0) return 0;
  sv3_kernel<<<grid_for(m2), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<const int*>(D), static_cast<const int*>(Q),
      static_cast<int*>(D_out), static_cast<unsigned char*>(live), m2, s);
  return static_cast<int>(cudaGetLastError());
}
