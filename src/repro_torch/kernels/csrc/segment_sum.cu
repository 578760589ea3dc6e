// Sorted segment sum for Hopper: out[s] = the sum of data[i] over every row i
// with ids[i] == s, for rows already sorted by id.
//
// Replaces src/repro/kernels/segment_sum/segment_sum.py::_segsum_kernel (launched
// by segment_sum_sorted_pallas, wrapper kernels/segment_sum/ops.py::
// segment_sum_sorted). The TPU kernel turns the scatter into a one-hot matrix
// product on the MXU over scalar-prefetched ranges of edge blocks, because a
// TPU has no cheap scatter. Here the reduction is CSR-style: the wrapper finds
// the row pointers ptr[s] = first row with id >= s (torch.searchsorted, the
// counterpart of the Pallas wrapper's own searchsorted), and each segment has
// one owner, a warp, that walks its rows [ptr[s], ptr[s+1]), sums in float32
// registers and writes its output row once (0 for an empty segment). Rows
// before ptr[0] (negative ids) and after ptr[num_segments] (sentinels) are
// never read.
//
// No atomics: every output element is summed by one warp in a fixed order
// (rows in order within each lane, then a fixed butterfly of shuffles), so the
// result is identical from run to run.
//
// Layout of a warp: C lanes over the columns (C, a power of two, is the
// narrowest that covers d, at most 32) and R = 32 / C rows in flight, so
// narrow rows (GAT's 1- and 8-column messages) keep every lane busy. Each lane
// holds kChunks columns, C apart; wider rows take several passes.
//
// Bound on this card: memory. A call moves m*d*itemsize (data, read once) +
// 4m (ids, read by the wrapper's binary search) + n*d*itemsize (output) +
// 4(n+1) (row pointers) bytes. The rows of a segment are contiguous, so a
// warp's loads are coalesced; kUnroll row steps are loaded before any is
// added, to keep enough bytes in flight to cover the memory latency. Offsets
// are 64-bit: m*d passes 2^31 at ogb_products' widths. A hub segment is summed
// by one warp alone, serially; an edge-balanced (merge-path) split is later
// work. Loads are 4 or 2 bytes a lane: rows of 47 floats are not 16-byte
// aligned, so no vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps, and so segments, per block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 4;  // columns a lane holds per pass, C apart
constexpr int kUnroll = 4;  // row steps loaded before they are added

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // rounded once, to nearest even
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    segsum_kernel(const T* __restrict__ data, const int* __restrict__ ptr,
                  T* __restrict__ out, long long num_segments, int d) {
  constexpr int R = 32 / C;
  const long long seg =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (seg >= num_segments) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int col = lane % C;
  const int sub = lane / C;
  const long long begin = ptr[seg];
  const long long end = ptr[seg + 1];
  T* dst = out + seg * d;
  for (int c0 = 0; c0 < d; c0 += C * kChunks) {
    float acc[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) acc[k] = 0.f;
    for (long long i = begin + sub; i < end;
         i += static_cast<long long>(R) * kUnroll) {
      float v[kUnroll][kChunks];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = i + static_cast<long long>(u) * R;
        const T* src = data + row * d;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int c = c0 + col + k * C;
          v[u][k] = (row < end && c < d) ? to_float(src[c]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kChunks; ++k) acc[k] += v[u][k];
      }
    }
    // Sum the R row groups: lanes with the same column differ in the bits
    // from C up.
#pragma unroll
    for (int off = C; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
    }
    if (sub == 0) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = c0 + col + k * C;
        if (c < d) store(dst + c, acc[k]);
      }
    }
  }
}

template <typename T>
int launch(const void* data, const void* ptr, void* out, long long n, int d,
           cudaStream_t stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* x = static_cast<const T*>(data);
  const int* p = static_cast<const int*>(ptr);
  T* y = static_cast<T*>(out);
  if (d <= 1) {
    segsum_kernel<T, 1><<<grid, kThreads, 0, stream>>>(x, p, y, n, d);
  } else if (d <= 2) {
    segsum_kernel<T, 2><<<grid, kThreads, 0, stream>>>(x, p, y, n, d);
  } else if (d <= 4) {
    segsum_kernel<T, 4><<<grid, kThreads, 0, stream>>>(x, p, y, n, d);
  } else if (d <= 8) {
    segsum_kernel<T, 8><<<grid, kThreads, 0, stream>>>(x, p, y, n, d);
  } else if (d <= 16) {
    segsum_kernel<T, 16><<<grid, kThreads, 0, stream>>>(x, p, y, n, d);
  } else {
    segsum_kernel<T, 32><<<grid, kThreads, 0, stream>>>(x, p, y, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: (m, d) rows sorted by id, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// ptr: (num_segments + 1,) int32 row pointers; out: (num_segments, d) of
// data's type. Returns the cudaGetLastError() after the launch.
extern "C" int segment_sum_run(const void* data, const void* ptr, void* out,
                               long long num_segments, int d, int bf16,
                               void* stream) {
  if (num_segments <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(data, ptr, out, num_segments, d, s);
  return launch<float>(data, ptr, out, num_segments, d, s);
}
