// Slot-order segmented fold (PageRank's ADD monoid), for Hopper.
//
// Port-only: the reference has no Pallas kernel for it. Its ADD monoid
// (src/repro/core/operators.py:95-97, `ADD`) is a scatter-add that XLA's CPU
// and TPU backends fold in edge-slot order; that order is what keeps PageRank
// bit-equal to its numpy oracle (np.add.at). On the card index_add_ folds
// through atomics in no fixed order. Given slots sorted stably by target (the
// slots of target v are [row_ptr[v], row_ptr[v+1])), this kernel computes for
// every target v, with s running over its slots in order,
//
//   x_s    = node[idx[s]]
//   x_s    = __fmul_rn(scale, __fmul_rn(x_s, weight[s]))   (scaled fold only)
//   out[v] = ((base[v] + x_s0) + x_s1) + ...               (every add __fadd_rn)
//
// The generic fold is node = values, idx = perm (plain). PageRank's mass step
// passes node = out (one value a node), idx = the arcs' sources and weight =
// their weights, both in slot order, and scale = the damping (scaled): the
// same two roundings as the reference's dmp * (out[a] * w2), with no m2-long
// intermediate. Every multiply and add is an explicit _rn intrinsic, so
// nothing depends on -fmad. No atomics: two calls are bit-equal.
//
// Bounds on this card, and what the design does about each (PageRank's mass
// step: n = 2^20 targets, m2 = 8,388,600 slots; H100 80GB HBM3 at 700 W):
//
// * Bytes: 8 B a slot (idx, and values or weight) and 12 a target (row_ptr,
//   base, out) generic, 16 a target fused (node is read once more): 0.0238
//   and 0.0250 ms at 3.35 TB/s. idx and weight are streamed with evict-first
//   loads (__ldcs), coalesced: one warp owns 32 consecutive targets and walks
//   the union of their slot ranges in chunks of kChunk slots, lane i loading
//   slots i, i + 32, ... of the chunk.
// * L2's random-sector rate: every slot gathers one 4-byte value at random,
//   from an m2-long array generic (32 MB: 9.9e10 sectors/s, 0.085 ms) or an
//   n-long one fused (4 MB: 1.37e11 sectors/s, 0.061 ms), by
//   tools/ordered_fold_ab.py's probe. This bound, not bytes, sets the time.
//   A lane issues its kPerLane gathers of a chunk together, and a warp
//   gathers chunk k+1 and loads the indices of chunk k+2 before it folds
//   chunk k, so each warp has two chunks of loads in flight while it adds.
// * The add chain: a left fold cannot be split and stay bit-exact, so a
//   target of degree d takes at least d dependent __fadd_rn, 2.12 ns each
//   (ordered_fold_chain_floor: 2.22 ms for 2^20). Lane i folds target v0 + i
//   from the warp's shared-memory chunk, 4 values a load, carrying its sum in
//   a register from chunk to chunk. Within a warp, targets whose slots fall in
//   one chunk fold side by side; a target with more than `heavy` slots would
//   serialise its neighbours behind it, so it is skipped by its warp and gets
//   a warp of its own: the warp that owns the first multiple of `heavy` in its
//   range (found by a 32-ary search of row_ptr). Heavy warps come first in the
//   grid, so the longest chains start first; a hub's warp just walks more
//   chunks, its loads spread over 32 lanes, and only the adds are serial.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 16;            // slots each lane loads a chunk
constexpr int kChunk = 32 * kPerLane;   // slots a warp walks a chunk

struct Span {
  int lo, hi;  // slots [lo, hi), the same in every lane
};

// The warp's next chunk at or after slot c: the ranges of the lanes that
// `skip` (heavy targets, folded by warps of their own) are jumped over, and a
// chunk ends where one of them starts. Empty (lo == hi == end) at the end.
__device__ __forceinline__ Span next_chunk(int c, int lo, int hi, bool skip, int end) {
  for (;;) {
    const unsigned at = __ballot_sync(kFull, skip && lo == c);
    if (at == 0) break;
    c = __shfl_sync(kFull, hi, __ffs(at) - 1);
  }
  const int gap = __reduce_min_sync(kFull, skip && lo >= c ? lo : end);
  return {c, gap - c > kChunk ? c + kChunk : gap};
}

__device__ __forceinline__ void load_index(const int* __restrict__ idx, Span ch, int lane,
                                           int (&ix)[kPerLane]) {
  const int len = ch.hi - ch.lo;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int o = lane + 32 * j;
    ix[j] = o < len ? __ldcs(idx + ch.lo + o) : 0;
  }
}

template <bool kScaled>
__device__ __forceinline__ void gather(const float* __restrict__ node,
                                       const float* __restrict__ weight, Span ch, int lane,
                                       const int (&ix)[kPerLane], float (&x)[kPerLane],
                                       float (&w)[kPerLane]) {
  const int len = ch.hi - ch.lo;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int o = lane + 32 * j;
    x[j] = o < len ? __ldg(node + ix[j]) : 0.f;
    if (kScaled) w[j] = o < len ? __ldcs(weight + ch.lo + o) : 0.f;
  }
}

// Slot lo + o of the chunk goes to buf[o], after its multiplies.
template <bool kScaled>
__device__ __forceinline__ void stage(float* buf, int lane, float sc, const float (&x)[kPerLane],
                                      const float (&w)[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    buf[lane + 32 * j] = kScaled ? __fmul_rn(sc, __fmul_rn(x[j], w[j])) : x[j];
  }
}

__device__ __forceinline__ float add4(float acc, float4 q) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, q.x), q.y), q.z), q.w);
}

// Adds this lane's slots of the staged chunk onto acc, in slot order: 8 a
// step from two 16-byte loads, the next step's loads issued before this
// step's adds, so the chain waits on the adds more than on shared memory.
__device__ __forceinline__ float fold(const float* buf, Span ch, int lo, int hi, float acc) {
  int s = max(lo, ch.lo) - ch.lo;
  const int e = min(hi, ch.hi) - ch.lo;
  for (; s < e && (s & 3) != 0; ++s) acc = __fadd_rn(acc, buf[s]);
  if (s >= e) return acc;
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  int q = s >> 2;
  const int qe = e >> 2;  // whole float4s end here
  if (q + 2 <= qe) {
    float4 c0 = b4[q], c1 = b4[q + 1];
    for (q += 2; q + 2 <= qe; q += 2) {
      const float4 n0 = b4[q], n1 = b4[q + 1];
      acc = add4(add4(acc, c0), c1);
      c0 = n0;
      c1 = n1;
    }
    acc = add4(add4(acc, c0), c1);
  }
  if (q < qe) acc = add4(acc, b4[q++]);
  for (s = q << 2; s < e; ++s) acc = __fadd_rn(acc, buf[s]);
  return acc;
}

// One warp walks slots [start, end) in chunks; each lane folds its own range
// [lo, hi) onto acc. Chunk k+1's gathers and chunk k+2's index loads are in
// flight while chunk k is folded.
template <bool kScaled>
__device__ float walk(const int* __restrict__ idx, const float* __restrict__ node,
                      const float* __restrict__ weight, float sc, float* buf, int lane, int lo,
                      int hi, bool skip, int start, int end, float acc) {
  Span a = next_chunk(start, lo, hi, skip, end);
  if (a.lo == a.hi) return acc;
  Span b = next_chunk(a.hi, lo, hi, skip, end);
  int ix[kPerLane];
  float x[kPerLane], w[kPerLane];
  load_index(idx, a, lane, ix);
  gather<kScaled>(node, weight, a, lane, ix, x, w);
  load_index(idx, b, lane, ix);
  for (;;) {
    __syncwarp();
    stage<kScaled>(buf, lane, sc, x, w);
    __syncwarp();
    const Span c = next_chunk(b.hi, lo, hi, skip, end);
    gather<kScaled>(node, weight, b, lane, ix, x, w);
    load_index(idx, c, lane, ix);
    acc = fold(buf, a, lo, hi, acc);
    if (b.lo == b.hi) return acc;
    a = b;
    b = c;
  }
}

// The target whose range holds slot s: the largest v in [0, n] with
// row_ptr[v] <= s, by a 32-ary search (each lane probes one point a step);
// -1 when row_ptr[0] > s. n when s lies past every group.
__device__ __forceinline__ int owner_of(const int* __restrict__ row_ptr, int n, int s, int lane) {
  if (__ldg(row_ptr) > s) return -1;
  int lo = 0, hi = n + 1;  // row_ptr[lo] <= s < row_ptr[hi] (row_ptr[n + 1] = inf)
  while (hi - lo > 1) {
    const int p = lo + static_cast<int>((static_cast<long long>(hi - lo) * lane) >> 5);
    const unsigned le = __ballot_sync(kFull, __ldg(row_ptr + p) <= s);
    const int last = 31 - __clz(le);
    const int next_lo = __shfl_sync(kFull, p, last);
    const int next_hi = __shfl_sync(kFull, p, min(last + 1, 31));
    if (last < 31) hi = next_hi;
    lo = next_lo;
  }
  return lo;
}

template <bool kScaled>
__global__ void __launch_bounds__(kThreads, 2)
    fold_kernel(const float* __restrict__ base, const int* __restrict__ row_ptr,
                const int* __restrict__ idx, const float* __restrict__ node,
                const float* __restrict__ weight, const float* __restrict__ scale,
                float* __restrict__ out, int n, int m, int heavy, int heavy_warps) {
  __shared__ __align__(16) float bufs[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  float* buf = bufs[threadIdx.x >> 5];
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const float sc = kScaled ? __ldg(scale) : 1.f;
  if (gw < heavy_warps) {
    // A heavy task: the target (if any) with more than `heavy` slots whose
    // first multiple of `heavy` is slot gw * heavy.
    const long long s64 = gw * heavy;
    if (s64 >= m) return;
    const int s = static_cast<int>(s64);
    const int v = owner_of(row_ptr, n, s, lane);
    if (v < 0 || v >= n) return;
    const int lo = __ldg(row_ptr + v), hi = __ldg(row_ptr + v + 1);
    if (hi - lo <= heavy || lo <= s - heavy) return;
    float acc = lane == 0 ? __ldg(base + v) : 0.f;
    acc = walk<kScaled>(idx, node, weight, sc, buf, lane, lane == 0 ? lo : hi, hi, false, lo,
                        hi, acc);
    if (lane == 0) out[v] = acc;
    return;
  }
  // A light task: targets v0 .. v0 + 31, skipping the heavy ones.
  const long long v0 = (gw - heavy_warps) * 32;
  if (v0 >= n) return;
  const int v = static_cast<int>(v0) + lane;
  const bool valid = v < n;
  const int lo = __ldg(row_ptr + min(v, n));
  const int hi = valid ? __ldg(row_ptr + v + 1) : lo;
  const bool skip = hi - lo > heavy;
  float acc = valid ? __ldg(base + v) : 0.f;
  const int start = __shfl_sync(kFull, lo, 0), end = __shfl_sync(kFull, hi, 31);
  acc = walk<kScaled>(idx, node, weight, sc, buf, lane, lo, hi, skip, start, end, acc);
  if (valid && !skip) out[v] = acc;
}

// One thread, `adds` dependent __fadd_rn from registers: the chain floor of a
// target with that many slots.
__global__ void chain_floor_kernel(const float* __restrict__ in, float* __restrict__ out,
                                   int adds) {
  const float r0 = in[0], r1 = in[1], r2 = in[2], r3 = in[3];
  float acc = in[4];
#pragma unroll 8
  for (int i = 0; i < adds; i += 4)
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, r0), r1), r2), r3);
  out[0] = acc;
}

}  // namespace

// n >= 1 targets (row_ptr has n + 1 entries), m >= 1 slots (idx and weight
// have m). scaled: 0 plain (weight and scale unused), 1 scaled (scale is one
// float on the card). `chunk` must be this file's kChunk and `heavy` at least
// that: the wrapper states both, and a plan that does not fit is refused.
extern "C" int ordered_fold_run(const void* base, const void* row_ptr, const void* idx,
                                const void* node, const void* weight, const void* scale,
                                void* out, int n, int m, int scaled, int chunk, int heavy,
                                void* stream) {
  if (n < 1 || n > 0x7ffffffe || m < 1 || scaled < 0 || scaled > 1 || chunk != kChunk ||
      heavy < kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long heavy_warps =
      (static_cast<long long>(m) + heavy - 1) / heavy + kWarps - 1;
  const long long heavy_blocks = heavy_warps / kWarps;
  const long long light_blocks = ((static_cast<long long>(n) + 31) / 32 + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(heavy_blocks + light_blocks);
  const int hw = static_cast<int>(heavy_blocks * kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* kernel = scaled ? fold_kernel<true> : fold_kernel<false>;
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(base), static_cast<const int*>(row_ptr),
      static_cast<const int*>(idx), static_cast<const float*>(node),
      static_cast<const float*>(weight), static_cast<const float*>(scale),
      static_cast<float*>(out), n, m, heavy, hw);
  return static_cast<int>(cudaGetLastError());
}

// The chain floor: in holds 5 floats, out 1; `adds` a multiple of 4.
extern "C" int ordered_fold_chain_floor(const void* in, void* out, int adds, void* stream) {
  if (adds < 4 || adds % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  chain_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), adds);
  return static_cast<int>(cudaGetLastError());
}
