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
// Every gather reads the input labels; the scatters go to D_out. That is what
// the Pallas body does (it reads lab_ref while it writes lab_out_ref), and it
// keeps labels and round counts identical to the reference. min is order-free
// and every stamp is the same s, so the result does not depend on thread order.
//
// Bound on this card: memory. Read once and written once, sv2 moves
// 8*m2 + 20*n bytes and sv3 9*m2 + 12*n (the edges; labels, Dprev and stamps
// read, labels and stamps written; sv3's live bytes).
//
// The sector model. A random 4-byte gather touches its own 32-byte sector: on
// an H100 about 136e9 such sectors a second come from L2 and 32e9 from device
// memory (tools/edge_hook_ab.py's probe). The oriented edges come sorted by
// one end (dedup_edges returns np.unique rows), so in each half of the edge
// list one end ascends and the other is random: about one random gather an
// edge, plus a random atomic (and the read before it) for each edge that
// hooks. At n = 2^22 the label arrays are 16.8 MB each; a kernel that
// gathers D[a], Dprev[a] and D[b] and scatters into D_out and Q_out, four
// such arrays against the 50 MB L2 with the 60 MB of edges streaming through
// it, moves about one device-memory sector a random gather.
//
// What the design does about it:
//   * Two paths per phase, chosen by the wrapper from m2 and n
//     (ops.py::packed_path). Packed, for m2 >= 3n/2, where a node pass that
//     moves more than a plain copy pays: sv2's node pass writes D_out and
//     P[i] = D[i] | (D[i] == Dprev[i]) << 31 (labels lie in [0, n), n < 2^31,
//     so bit 31 is free), and its edge pass gathers P at both ends, so Dprev
//     leaves the working set; its stamps go to a byte a node, 4 MB at
//     n = 2^22, which a last node pass turns into Q_out. sv3's node pass
//     writes D_out and one bit a node, set for a stagnant root (Q[i] < s and
//     D[i] == i), so a live edge's two root tests at D[a] read one bit of a
//     0.5 MB array that the read-only cache keeps, not a sector each of D and
//     Q. Direct, for fewer edges: one copy kernel writes D_out (and Q_out),
//     and the edge pass gathers the labels, Dprev[a] only where D[b] < D[a],
//     and D[D[a]] and Q[D[a]] only for a live edge.
//   * Cache policy per instruction: the edges stream with evict-first loads
//     and the live mask with streaming stores; the labels are gathered (and
//     sv2's packed words written) with an L2 evict_last policy (createpolicy),
//     so they outlast the streams (an evict_normal policy was slower). No
//     access-policy window is set: it would stay on the stream for every later
//     kernel.
//   * Edges by warp: slot j of a lane is edge 32j + lane of its warp's range,
//     so each load is 128 coalesced bytes and an ascending end gathers whole
//     lines. Four slots a thread keep eight gathers in flight where the grid
//     still fills every SM; a smaller call takes one slot a thread, so its
//     random gathers spread over more SMs.
//   * Hot roots: a thread first merges its slots that hook the same target,
//     then the target of the warp's first hooking lane takes the minimum of
//     every lane that hooks into it (ballot, shfl, redux: no __match_any_sync),
//     and every atomic and every stamp comes after a read that shows it would
//     change the word (D_out only falls, a stamp is only set, so any value
//     read is safe to test).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // nodes a thread in the node passes
constexpr unsigned kFlag = 0x80000000u;
constexpr unsigned kLabel = 0x7fffffffu;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// A label word gathered with an L2 policy.
__device__ __forceinline__ unsigned gather(const void* p, uint64_t policy) {
  unsigned v;
  asm volatile("ld.global.L2::cache_hint.b32 %0, [%1], %2;"
               : "=r"(v)
               : "l"(p), "l"(policy));
  return v;
}

// Four label words stored with an L2 policy; p is 16-byte aligned.
__device__ __forceinline__ void store4(void* p, uint4 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
               : "memory");
}

// The node passes take nodes 4q..4q+3 a thread, with 16-byte loads and stores
// (every node array is 16-byte aligned); the thread past the last full quad
// takes the n % 4 nodes left, one at a time.
__device__ __forceinline__ long long node_quad() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ int4 load4(const int* p, long long q) {
  return __ldcs(reinterpret_cast<const int4*>(p) + q);
}

__device__ __forceinline__ uint4 as_u4(int4 v) {
  return make_uint4(v.x, v.y, v.z, v.w);
}

// A thread's hooks, its slots with equal targets merged into the first of
// them (the others dropped), so a hot root takes one atomic a thread.
template <int kSlots>
__device__ __forceinline__ void merge_slots(const unsigned (&Da)[kSlots],
                                            unsigned (&Db)[kSlots],
                                            bool (&hook)[kSlots]) {
#pragma unroll
  for (int j = 1; j < kSlots; ++j) {
#pragma unroll
    for (int k = 0; k < j; ++k) {
      if (hook[j] && hook[k] && Da[j] == Da[k]) {
        Db[k] = min(Db[k], Db[j]);
        hook[j] = false;
      }
    }
  }
}

// D_out[Da] min= Db for one slot of a warp's hooks. Every lane of the warp
// calls it. The target of the warp's first hooking lane takes the minimum of
// every lane that hooks into it, in one atomic; every atomic comes after a
// read that shows it would lower the word (D_out only falls, so any value read
// is at least the current one).
__device__ __forceinline__ void hook_min(int* D_out, unsigned Da, unsigned Db,
                                         bool hook, unsigned lane) {
  const unsigned hooks = __ballot_sync(kFull, hook);
  if (hooks == 0) return;
  const unsigned lead = __ffs(hooks) - 1;
  const unsigned target = __shfl_sync(kFull, Da, lead);
  const bool shared = hook && Da == target;
  const unsigned low =
      __reduce_min_sync(kFull, shared ? Db : static_cast<unsigned>(INT_MAX));
  if (lane == lead) {
    Da = target;
    Db = low;
  } else if (shared) {
    return;
  }
  if (hook && static_cast<int>(Db) < __ldcg(D_out + Da)) {
    atomicMin(D_out + Da, static_cast<int>(Db));
  }
}

// Plain copies of one or two node arrays: the direct paths' output labels
// (and sv2's output stamps).
__global__ void __launch_bounds__(kThreads)
    copy_nodes(const int* __restrict__ x, int* __restrict__ x_out,
               const int* __restrict__ y, int* __restrict__ y_out, int n) {
  const long long q = node_quad();
  const long long i0 = q * kVec;
  if (i0 + kVec <= n) {
    reinterpret_cast<int4*>(x_out)[q] = reinterpret_cast<const int4*>(x)[q];
    if (y) reinterpret_cast<int4*>(y_out)[q] = reinterpret_cast<const int4*>(y)[q];
  }
  if (i0 == n - n % kVec) {
    for (long long i = n - n % kVec; i < n; ++i) {
      x_out[i] = x[i];
      if (y) y_out[i] = y[i];
    }
  }
}

// Packed sv2's prologue: D_out = D, P[i] = D[i] | (D[i] == Dprev[i]) << 31,
// the stamp bytes cleared; D_out and P kept in L2 for the edge pass.
__global__ void __launch_bounds__(kThreads)
    sv2_prologue(const int* __restrict__ D, const int* __restrict__ Dprev,
                 int* __restrict__ D_out, unsigned* __restrict__ P,
                 unsigned char* __restrict__ stamped, int n) {
  const long long q = node_quad();
  const long long i0 = q * kVec;
  const uint64_t keep = evict_last();
  if (i0 + kVec <= n) {
    const int4 d = load4(D, q);
    const int4 p = load4(Dprev, q);
    store4(reinterpret_cast<uint4*>(D_out) + q, as_u4(d), keep);
    store4(reinterpret_cast<uint4*>(P) + q,
           make_uint4(d.x | (d.x == p.x ? kFlag : 0u), d.y | (d.y == p.y ? kFlag : 0u),
                      d.z | (d.z == p.z ? kFlag : 0u), d.w | (d.w == p.w ? kFlag : 0u)),
           keep);
    reinterpret_cast<unsigned*>(stamped)[q] = 0u;
  }
  if (i0 == n - n % kVec) {
    for (long long i = n - n % kVec; i < n; ++i) {
      D_out[i] = D[i];
      P[i] = D[i] | (D[i] == Dprev[i] ? kFlag : 0u);
      stamped[i] = 0;
    }
  }
}

// Packed sv2's epilogue: Q_out[i] = s where node i was stamped, else Q[i].
__global__ void __launch_bounds__(kThreads)
    sv2_epilogue(const unsigned char* __restrict__ stamped,
                 const int* __restrict__ Q, int* __restrict__ Q_out, int n, int s) {
  const long long q = node_quad();
  const long long i0 = q * kVec;
  if (i0 + kVec <= n) {
    const unsigned st = __ldcs(reinterpret_cast<const unsigned*>(stamped) + q);
    const int4 v = load4(Q, q);
    __stcs(reinterpret_cast<int4*>(Q_out) + q,
           make_int4(st & 0xffu ? s : v.x, st & 0xff00u ? s : v.y,
                     st & 0xff0000u ? s : v.z, st & 0xff000000u ? s : v.w));
  }
  if (i0 == n - n % kVec) {
    for (long long i = n - n % kVec; i < n; ++i) Q_out[i] = stamped[i] ? s : Q[i];
  }
}

// Packed sv3's prologue: D_out = D, and bit i of R set where Q[i] < s and
// D[i] == i (a stagnant root), one 32-bit word per 32 nodes: each lane packs
// its four nodes' bits and each group of 8 lanes ORs its nibbles into a word.
// Every lane of the warp takes part, also past n.
__global__ void __launch_bounds__(kThreads)
    sv3_prologue(const int* __restrict__ D, const int* __restrict__ Q,
                 int* __restrict__ D_out, unsigned* __restrict__ R, int n, int s) {
  const unsigned lane = threadIdx.x & 31u;
  const long long q = node_quad();
  const long long i0 = q * kVec;
  unsigned nibble = 0;
  if (i0 + kVec <= n) {
    const int4 d = reinterpret_cast<const int4*>(D)[q];
    const int4 t = load4(Q, q);
    const int i = static_cast<int>(i0);
    reinterpret_cast<int4*>(D_out)[q] = d;
    nibble = (d.x == i && t.x < s) | (d.y == i + 1 && t.y < s) << 1 |
             (d.z == i + 2 && t.z < s) << 2 | (d.w == i + 3 && t.w < s) << 3;
  } else if (i0 < n) {
    for (long long i = i0; i < n; ++i) {
      D_out[i] = D[i];
      nibble |= static_cast<unsigned>(D[i] == i && Q[i] < s) << (i - i0);
    }
  }
  const unsigned word =
      __reduce_or_sync(0xffu << (lane & 24u), nibble << (4 * (lane & 7u)));
  if ((lane & 7u) == 0 && i0 < n) R[q >> 3] = word;
}

// The edges of a thread: slot j of lane l of warp w is edge
// 32 * kSlots * w + 32 * j + l, so each load of a slot is 128 consecutive
// bytes of a and of b, streamed.
template <int kSlots>
__device__ __forceinline__ long long first_edge(unsigned lane) {
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  return warp * 32 * kSlots + lane;
}

// sv2 over the edges. Packed: gathers P at both ends; a hook sets its stamp
// byte. Direct: gathers D at both ends and Dprev[a] where D[b] < D[a]; a hook
// stores s into Q_out. A stamp is read first and written only where unset.
template <bool kPacked, int kSlots>
__global__ void __launch_bounds__(kThreads)
    sv2_edges(const int* __restrict__ a, const int* __restrict__ b,
              const unsigned* __restrict__ words, const int* __restrict__ Dprev,
              int* D_out, int* Q_out, unsigned char* stamped, long long m2, int s) {
  const unsigned lane = threadIdx.x & 31u;
  const long long e0 = first_edge<kSlots>(lane);
  const uint64_t keep = evict_last();
  int ia[kSlots];
  unsigned wa[kSlots], wb[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const long long e = e0 + 32 * j;
    ia[j] = e < m2 ? __ldcs(a + e) : 0;
    const int ib = e < m2 ? __ldcs(b + e) : 0;
    wa[j] = e < m2 ? gather(words + ia[j], keep) : 0u;
    wb[j] = e < m2 ? gather(words + ib, keep) : 0u;
  }
  unsigned Da[kSlots], Db[kSlots];
  bool hook[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    Da[j] = wa[j] & kLabel;
    Db[j] = wb[j] & kLabel;
    const bool cand = e0 + 32 * j < m2 && Db[j] < Da[j];
    if (kPacked) {
      hook[j] = cand && (wa[j] & kFlag);
    } else {
      hook[j] = cand && gather(Dprev + ia[j], keep) == wa[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (!hook[j]) continue;
    if (kPacked) {
      if (!__ldcg(stamped + Db[j])) stamped[Db[j]] = 1;
    } else if (__ldcg(Q_out + Db[j]) != s) {
      Q_out[Db[j]] = s;
    }
  }
  merge_slots(Da, Db, hook);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) hook_min(D_out, Da[j], Db[j], hook[j], lane);
}

// sv3 over the edges: gathers D at both ends and, for a live edge, its root
// test at D[a]. Packed: bit D[a] of R, a 0.5 MB array at n = 2^22 that the
// read-only cache keeps. Direct: D[D[a]] and Q[D[a]].
template <bool kPacked, int kSlots>
__global__ void __launch_bounds__(kThreads)
    sv3_edges(const int* __restrict__ a, const int* __restrict__ b,
              const int* __restrict__ D, const int* __restrict__ Q,
              const unsigned* __restrict__ R, int* D_out,
              unsigned char* __restrict__ live, long long m2, int s) {
  const unsigned lane = threadIdx.x & 31u;
  const long long e0 = first_edge<kSlots>(lane);
  const uint64_t keep = evict_last();
  unsigned Da[kSlots], Db[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const long long e = e0 + 32 * j;
    Da[j] = e < m2 ? gather(D + __ldcs(a + e), keep) : 0u;
    Db[j] = e < m2 ? gather(D + __ldcs(b + e), keep) : 0u;
  }
  bool root[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const long long e = e0 + 32 * j;
    const bool differ = e < m2 && Da[j] != Db[j];
    if (e < m2) __stcs(live + e, static_cast<unsigned char>(differ));
    if (kPacked) {
      root[j] = differ && ((__ldg(R + (Da[j] >> 5)) >> (Da[j] & 31u)) & 1u);
    } else {
      root[j] = differ && gather(D + Da[j], keep) == Da[j] &&
                static_cast<int>(gather(Q + Da[j], keep)) < s;
    }
  }
  merge_slots(Da, Db, root);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) hook_min(D_out, Da[j], Db[j], root[j], lane);
}

unsigned node_blocks(int n) {
  const long long quads = (static_cast<long long>(n) + kVec - 1) / kVec;
  return static_cast<unsigned>((quads + kThreads - 1) / kThreads);
}

// Four edges a thread where that still fills every SM with 8 blocks; one
// where it would not, so that a small call's random gathers spread over more
// SMs.
constexpr long long kFourSlotEdges = 132LL * 8 * kThreads * 4;

unsigned edge_blocks(long long m2, int slots) {
  return static_cast<unsigned>((m2 + kThreads * slots - 1) / (kThreads * slots));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One sv2 phase on `stream`. a and b hold m2 int32; D, Dprev, Q, D_out and
// Q_out hold n int32 at 16-byte aligned addresses. With `packed`, P (n int32,
// aligned) and stamped (n bytes, aligned) are scratch; without it they are
// not read.
extern "C" int edge_hook_sv2(const void* a, const void* b, const void* D,
                             const void* Dprev, const void* Q, void* D_out,
                             void* Q_out, void* P, void* stamped, int m2, int n,
                             int s, int packed, void* stream) {
  if (m2 <= 0 || n <= 0) return 0;
  for (const void* p : {D, Dprev, Q, static_cast<const void*>(D_out),
                        static_cast<const void*>(Q_out)}) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (packed && (!aligned16(P) || !aligned16(stamped))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ai = static_cast<const int*>(a);
  const auto* bi = static_cast<const int*>(b);
  const auto* Di = static_cast<const int*>(D);
  const auto* Dp = static_cast<const int*>(Dprev);
  const auto* Qi = static_cast<const int*>(Q);
  auto* Do = static_cast<int*>(D_out);
  auto* Qo = static_cast<int*>(Q_out);
  auto* Pw = static_cast<unsigned*>(P);
  auto* sb = static_cast<unsigned char*>(stamped);
  if (packed) {
    sv2_prologue<<<node_blocks(n), kThreads, 0, st>>>(Di, Dp, Do, Pw, sb, n);
    if (m2 >= kFourSlotEdges) {
      sv2_edges<true, 4><<<edge_blocks(m2, 4), kThreads, 0, st>>>(ai, bi, Pw, Dp, Do, Qo,
                                                                  sb, m2, s);
    } else {
      sv2_edges<true, 1><<<edge_blocks(m2, 1), kThreads, 0, st>>>(ai, bi, Pw, Dp, Do, Qo,
                                                                  sb, m2, s);
    }
    sv2_epilogue<<<node_blocks(n), kThreads, 0, st>>>(sb, Qi, Qo, n, s);
  } else {
    copy_nodes<<<node_blocks(n), kThreads, 0, st>>>(Di, Do, Qi, Qo, n);
    const auto* Dw = reinterpret_cast<const unsigned*>(Di);
    if (m2 >= kFourSlotEdges) {
      sv2_edges<false, 4><<<edge_blocks(m2, 4), kThreads, 0, st>>>(ai, bi, Dw, Dp, Do, Qo,
                                                                   sb, m2, s);
    } else {
      sv2_edges<false, 1><<<edge_blocks(m2, 1), kThreads, 0, st>>>(ai, bi, Dw, Dp, Do, Qo,
                                                                   sb, m2, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// One sv3 phase on `stream`. a, b and live hold m2 entries; D, Q and D_out
// hold n int32 at 16-byte aligned addresses. With `packed`, R (4 words per
// 128 nodes) is scratch; without it, it is not read.
extern "C" int edge_hook_sv3(const void* a, const void* b, const void* D,
                             const void* Q, void* D_out, void* live, void* R,
                             int m2, int n, int s, int packed, void* stream) {
  if (m2 <= 0 || n <= 0) return 0;
  for (const void* p : {D, Q, static_cast<const void*>(D_out)}) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ai = static_cast<const int*>(a);
  const auto* bi = static_cast<const int*>(b);
  const auto* Di = static_cast<const int*>(D);
  const auto* Qi = static_cast<const int*>(Q);
  auto* Do = static_cast<int*>(D_out);
  auto* Rw = static_cast<unsigned*>(R);
  auto* lv = static_cast<unsigned char*>(live);
  if (packed) {
    sv3_prologue<<<node_blocks(n), kThreads, 0, st>>>(Di, Qi, Do, Rw, n, s);
  } else {
    copy_nodes<<<node_blocks(n), kThreads, 0, st>>>(Di, Do, nullptr, nullptr, n);
  }
  if (m2 >= kFourSlotEdges) {
    auto edges = packed ? sv3_edges<true, 4> : sv3_edges<false, 4>;
    edges<<<edge_blocks(m2, 4), kThreads, 0, st>>>(ai, bi, Di, Qi, Rw, Do, lv, m2, s);
  } else {
    auto edges = packed ? sv3_edges<true, 1> : sv3_edges<false, 1>;
    edges<<<edge_blocks(m2, 1), kThreads, 0, st>>>(ai, bi, Di, Qi, Rw, Do, lv, m2, s);
  }
  return static_cast<int>(cudaGetLastError());
}
