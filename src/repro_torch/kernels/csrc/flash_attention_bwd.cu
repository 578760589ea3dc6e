// Backward of blocked attention for Hopper: dq, dk and dv of attention_ref.
//
// Replaces no TPU kernel: the reference takes this VJP by autodiff through
// src/repro/kernels/flash_attention/flash_attention.py::_attn_kernel's
// caller (repro/train/loop.py -> models/transformer/attention.py), and the
// port's rule is that no card path runs the plain version. It computes the
// exact VJP of attention_ref for the scores
//
//   s(i, j) = q[b, h, i] . k[b, h / group, j] * scale,  scale = 1/sqrt(D),
//   P = softmax_j(s) with masked scores at -1e30 (causal: j > i; window:
//       i - j >= w; keys past Sk do not exist),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dO o O)),
//   dQ = scale dS K,  dK = scale dS^T Q,
//
// with dK and dV of a KV head summed in float32 over its Hq / Hkv query
// heads before they are rounded. A masked score is a constant in the
// reference (masked_fill), so it gets no gradient. A row with no live key
// (only with a window and Sq >= Sk + window) weighs every key 1/Sk, as the
// reference's softmax of all -1e30 gives: it adds dO / Sk to every dV row
// and nothing to dQ or dK.
//
// Bound on this card: operations. The five S^2 D products (two of them
// Dv wide), causal-halved, at qwen3-4b's training shape (B=1, Hq=32, Hkv=8,
// S=4096, D=128) are 3.4e11 FLOPs, 0.35 ms at 989 TFLOP/s; the bytes
// (q, k, v, out, dout read, dq, dk, dv written) take 0.03 ms at 3.35 TB/s.
// This first kernel is simple and right, not fast: it runs eight S^2 D
// products, not five, on wmma (mma.sync) tiles that go through shared
// memory, and its time against the bound is in PERF.md.
//
// Schedule (FlashAttention-2's, without atomics: two calls give the same
// bits):
//   1. attn_bwd_dq_kernel, one block a (b, h, query tile of BQ rows): loads
//      Q, dO and O's rows, takes D_i = rowsum(dO o O); sweeps the K tiles
//      that hold a live key for the tile's rows to get each row's
//      log-sum-exp; sweeps K and V again for dS and dQ += dS K. Writes dq,
//      and the rows' lse and D_i for pass 2 (lse = +inf marks a row with
//      no live key).
//   2. attn_bwd_dkdv_kernel, one block a (b, KV head, key tile of BK keys):
//      keeps K and V and the float32 dK, dV accumulators in shared memory
//      and walks the group's query heads and the query tiles that hold a
//      row with a live key in the tile (all of them where a row has no live
//      key): S = Q K^T and dP = dO V^T again, P and dS from lse and D_i,
//      dV += P^T dO, dK += dS^T Q. Writes dk and dv.
// Each product is block_mm: a block's warps share the 16 x 16 output tiles
// of C += op(A) op(B), all three in shared memory. In bfloat16 a tile is
// wmma m16n16k16 (bf16 operands, float32 accumulators; P and dS are
// rounded to bf16 as operands, as FlashAttention does); in float32 it is
// FMA (TF32 would break the 2e-3 tolerance), with tiles of 16.
//
// Inputs: q, k, v, out, dout as (B, H, S, D) with any strides whose last
// is 1, 16-byte aligned (the wrapper copies what is not); outputs dq, dk,
// dv contiguous (B, H, S, D) in the inputs' type. bfloat16: D = Dv in
// {16, 32, 64, 96, 128, 256} and (D, Dv) = (192, 128); float32: D = Dv in
// the same six.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B, Hq, Sq): each row's log-sum-exp, +inf with no live key
  float* delta;  // (B, Hq, Sq): rowsum(dout o out)
  // Element strides (batch, head, row) of q, k, v, out and dout.
  long long st[15];
  int hq, hkv, sq, sk, causal, window;
  float scale;
};

// Tiles and shared-memory pitches. Rows are padded by 16 bytes, and every
// buffer starts on 128 bytes, so each wmma fragment starts on 32 bytes and
// each 16-byte load lands aligned.
template <typename T, int D, int DV>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int BQ = kBf16 ? 64 : 16;                      // query rows a tile
  static constexpr int BK = kBf16 ? (D > 192 || DV > 192 ? 32 : 64) : 16;  // keys a tile
  static constexpr int TPR = kThreads / BQ;                       // threads a row
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDD = D + PAD;   // q, k tiles
  static constexpr int LDV = DV + PAD;  // v, dout tiles
  static constexpr int LDS = BK + 4;    // float scores and dP (BQ x BK)
  static constexpr int LDP = BK + PAD;  // P and dS in T (BQ x BK)
  static constexpr int LDA = D + 4;     // float dQ, dK accumulators
  static constexpr int LDAV = DV + 4;   // float dV accumulator
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row's threads are lanes of one warp");
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims are multiples of 16");
};

__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// Carves consecutive 128-byte-aligned buffers out of dynamic shared memory.
struct Carver {
  unsigned char* base;
  size_t used = 0;
  template <typename U>
  __device__ U* take(size_t count) {
    U* out = reinterpret_cast<U*>(base + used);
    used += align128(count * sizeof(U));
    return out;
  }
};

template <typename T, int D, int DV>
constexpr size_t dq_smem_bytes() {
  using C = Cfg<T, D, DV>;
  return align128(C::BQ * C::LDD * sizeof(T)) + align128(C::BQ * C::LDV * sizeof(T)) +
         align128(C::BK * C::LDD * sizeof(T)) + align128(C::BK * C::LDV * sizeof(T)) +
         2 * align128(C::BQ * C::LDS * sizeof(float)) + align128(C::BQ * C::LDP * sizeof(T)) +
         align128(C::BQ * C::LDA * sizeof(float));
}

template <typename T, int D, int DV>
constexpr size_t dkdv_smem_bytes() {
  using C = Cfg<T, D, DV>;
  return align128(C::BQ * C::LDD * sizeof(T)) + align128(C::BQ * C::LDV * sizeof(T)) +
         align128(C::BK * C::LDD * sizeof(T)) + align128(C::BK * C::LDV * sizeof(T)) +
         2 * align128(C::BQ * C::LDS * sizeof(float)) +
         2 * align128(C::BQ * C::LDP * sizeof(T)) + align128(C::BK * C::LDA * sizeof(float)) +
         align128(C::BK * C::LDAV * sizeof(float)) + 2 * align128(C::BQ * sizeof(float));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ bool live(const Params& p, int i, int key) {
  return key < p.sk && !(p.causal && key > i) &&
         !(p.window > 0 && static_cast<long long>(i) - key >= p.window);
}

template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + R) of one (b, h) slice (row stride rs elements) into a
// shared tile of pitch ld, in 16-byte pieces; rows at or past s are zeros.
template <typename T, int R, int W>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* base, long long rs, int r0,
                                          int s) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = W / V;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < s) val = *reinterpret_cast<const uint4*>(base + (r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// C (M x N float, pitch ldc) = (acc ? C : 0) + op(A) op(B), op(A) M x K and
// op(B) K x N, all in shared memory. A is stored M x K (TA false) or K x M
// (TA true: op(A) = A^T), B is stored K x N (TB false) or N x K (TB true).
template <typename T, int M, int N, int K, bool TA, bool TB>
__device__ __forceinline__ void block_mm(float* C, int ldc, const T* A, int lda, const T* B,
                                         int ldb, bool acc) {
  if constexpr (std::is_same<T, bf16>::value) {
    using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
    constexpr int TN = N / 16;
    constexpr int TILES = (M / 16) * TN;
    for (int t = threadIdx.x / 32; t < TILES; t += kWarps) {
      const int tm = t / TN, tn = t % TN;
      float* cp = C + tm * 16 * ldc + tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (acc) {
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
#pragma unroll 4
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, TA ? A + kk * lda + tm * 16 : A + tm * 16 * lda + kk, lda);
        wmma::load_matrix_sync(b, TB ? B + tn * 16 * ldb + kk : B + kk * ldb + tn * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < M * N; e += kThreads) {
      const int m = e / N, n = e % N;
      float s = acc ? C[m * ldc + n] : 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const float a = TA ? A[kk * lda + m] : A[m * lda + kk];
        const float b = TB ? B[n * ldb + kk] : B[kk * ldb + n];
        s = fmaf(a, b, s);
      }
      C[m * ldc + n] = s;
    }
  }
}

// The K tiles [lo, hi] that hold a live key for a row of [q0, q1].
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int q1, int bk, int& lo,
                                          int& hi) {
  lo = 0;
  hi = (p.sk + bk - 1) / bk - 1;
  if (p.causal) hi = min(hi, q1 / bk);
  if (p.window > 0 && q0 - p.window + 1 > 0) lo = (q0 - p.window + 1) / bk;
}

// Pass 1: one block a (b * Hq + h, query tile); the longest causal rows
// first.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dq_kernel(const Params p) {
  using C = Cfg<T, D, DV>;
  constexpr int BQ = C::BQ, BK = C::BK, TPR = C::TPR;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver carve{smem};
  T* sQ = carve.take<T>(BQ * C::LDD);
  T* sdO = carve.take<T>(BQ * C::LDV);
  T* sK = carve.take<T>(BK * C::LDD);
  T* sV = carve.take<T>(BK * C::LDV);
  float* sS = carve.take<float>(BQ * C::LDS);
  float* sdP = carve.take<float>(BQ * C::LDS);
  T* sdS = carve.take<T>(BQ * C::LDP);
  float* sdQ = carve.take<float>(BQ * C::LDA);

  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long* st = p.st;
  const T* qg = static_cast<const T*>(p.q) + b * st[0] + h * st[1];
  const T* kg = static_cast<const T*>(p.k) + b * st[3] + hk * st[4];
  const T* vg = static_cast<const T*>(p.v) + b * st[6] + hk * st[7];
  const T* og = static_cast<const T*>(p.o) + b * st[9] + h * st[10];
  const T* dog = static_cast<const T*>(p.dout) + b * st[12] + h * st[13];

  load_tile<T, BQ, D>(sQ, C::LDD, qg, st[2], q0, p.sq);
  load_tile<T, BQ, DV>(sdO, C::LDV, dog, st[14], q0, p.sq);
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) sdQ[(i / D) * C::LDA + i % D] = 0.f;
  __syncthreads();

  const int r = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int row = q0 + r;
  float delta = 0.f;
  if (row < p.sq) {
    for (int d = g; d < DV; d += TPR) {
      delta += to_float(sdO[r * C::LDV + d]) * to_float(og[row * st[11] + d]);
    }
  }
  delta = row_sum<TPR>(delta);

  int lo, hi;
  key_tiles(p, q0, min(q0 + BQ, p.sq) - 1, BK, lo, hi);

  // Sweep 1: each row's log-sum-exp over its live keys.
  float m = -INFINITY, l = 0.f;
  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // sK and sS are free
    load_tile<T, BK, D>(sK, C::LDD, kg, st[5], k0, p.sk);
    __syncthreads();
    block_mm<T, BQ, BK, D, false, true>(sS, C::LDS, sQ, C::LDD, sK, C::LDD, false);
    __syncthreads();
    float tmax = -INFINITY;
    for (int c = g; c < BK; c += TPR) {
      if (live(p, row, k0 + c)) tmax = fmaxf(tmax, sS[r * C::LDS + c] * p.scale);
    }
    tmax = row_max<TPR>(tmax);
    const float mnew = fmaxf(m, tmax);
    // A row with no live key yet keeps m = -inf; the shuffles below run on
    // every lane all the same (a warp holds several rows).
    float s = 0.f;
    if (mnew > -INFINITY) {
      for (int c = g; c < BK; c += TPR) {
        if (live(p, row, k0 + c)) s += expf(sS[r * C::LDS + c] * p.scale - mnew);
      }
    }
    s = row_sum<TPR>(s);
    if (mnew > -INFINITY) {
      l = l * expf(m - mnew) + s;
      m = mnew;
    }
  }
  const float lse = m == -INFINITY ? INFINITY : m + logf(l);
  if (row < p.sq && g == 0) {
    const long long at = static_cast<long long>(bh) * p.sq + row;
    p.lse[at] = lse;
    p.delta[at] = delta;
  }

  // Sweep 2: dQ += dS K over the same tiles (a row with no live key adds 0).
  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // sK, sV and sdS are free
    load_tile<T, BK, D>(sK, C::LDD, kg, st[5], k0, p.sk);
    load_tile<T, BK, DV>(sV, C::LDV, vg, st[8], k0, p.sk);
    __syncthreads();
    block_mm<T, BQ, BK, D, false, true>(sS, C::LDS, sQ, C::LDD, sK, C::LDD, false);
    block_mm<T, BQ, BK, DV, false, true>(sdP, C::LDS, sdO, C::LDV, sV, C::LDV, false);
    __syncthreads();
    for (int c = g; c < BK; c += TPR) {
      float ds = 0.f;
      if (row < p.sq && lse != INFINITY && live(p, row, k0 + c)) {
        const float pr = expf(sS[r * C::LDS + c] * p.scale - lse);
        ds = pr * (sdP[r * C::LDS + c] - delta) * p.scale;
      }
      sdS[r * C::LDP + c] = from_float<T>(ds);
    }
    __syncthreads();
    block_mm<T, BQ, D, BK, false, false>(sdQ, C::LDA, sdS, C::LDP, sK, C::LDD, true);
  }
  __syncthreads();
  T* dqg = static_cast<T*>(p.dq) + (static_cast<long long>(bh) * p.sq + q0) * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int rr = i / D;
    if (q0 + rr < p.sq) dqg[i] = from_float<T>(sdQ[rr * C::LDA + i % D]);
  }
}

// Pass 2: one block a (b * Hkv + KV head, key tile); the first key tiles
// (the longest causal columns) first.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dkdv_kernel(const Params p) {
  using C = Cfg<T, D, DV>;
  constexpr int BQ = C::BQ, BK = C::BK, TPR = C::TPR;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver carve{smem};
  T* sQ = carve.take<T>(BQ * C::LDD);
  T* sdO = carve.take<T>(BQ * C::LDV);
  T* sK = carve.take<T>(BK * C::LDD);
  T* sV = carve.take<T>(BK * C::LDV);
  float* sS = carve.take<float>(BQ * C::LDS);
  float* sdP = carve.take<float>(BQ * C::LDS);
  T* sP = carve.take<T>(BQ * C::LDP);
  T* sdS = carve.take<T>(BQ * C::LDP);
  float* sdK = carve.take<float>(BK * C::LDA);
  float* sdV = carve.take<float>(BK * C::LDAV);
  float* sLse = carve.take<float>(BQ);
  float* sDelta = carve.take<float>(BQ);

  const int bhk = blockIdx.x;
  const int b = bhk / p.hkv, hk = bhk % p.hkv;
  const int group = p.hq / p.hkv;
  const int k0 = blockIdx.y * BK;
  const int k1 = min(k0 + BK, p.sk) - 1;
  const long long* st = p.st;
  const T* kg = static_cast<const T*>(p.k) + b * st[3] + hk * st[4];
  const T* vg = static_cast<const T*>(p.v) + b * st[6] + hk * st[7];

  load_tile<T, BK, D>(sK, C::LDD, kg, st[5], k0, p.sk);
  load_tile<T, BK, DV>(sV, C::LDV, vg, st[8], k0, p.sk);
  for (int i = threadIdx.x; i < BK * D; i += kThreads) sdK[(i / D) * C::LDA + i % D] = 0.f;
  for (int i = threadIdx.x; i < BK * DV; i += kThreads) sdV[(i / DV) * C::LDAV + i % DV] = 0.f;

  // Query tiles with a row that has a live key in [k0, k1], or, where some
  // row has no live key at all, every tile from the first.
  const bool dead_rows =
      p.window > 0 && static_cast<long long>(p.sq) - 1 >= static_cast<long long>(p.sk) + p.window - 1;
  const int qt_lo = p.causal ? k0 / BQ : 0;
  int qt_hi = (p.sq - 1) / BQ;
  if (p.window > 0 && !dead_rows) {
    const long long last = min(static_cast<long long>(p.sq) - 1,
                               static_cast<long long>(k1) + p.window - 1);
    qt_hi = static_cast<int>(last / BQ);
  }
  const float uniform = 1.f / static_cast<float>(p.sk);
  const int r = threadIdx.x / TPR, g = threadIdx.x % TPR;

  for (int hg = 0; hg < group; ++hg) {
    const int h = hk * group + hg;
    const long long bh = static_cast<long long>(b) * p.hq + h;
    const T* qg = static_cast<const T*>(p.q) + b * st[0] + h * st[1];
    const T* dog = static_cast<const T*>(p.dout) + b * st[12] + h * st[13];
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every tile of the last step is read
      load_tile<T, BQ, D>(sQ, C::LDD, qg, st[2], q0, p.sq);
      load_tile<T, BQ, DV>(sdO, C::LDV, dog, st[14], q0, p.sq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < p.sq;
        sLse[i] = in ? p.lse[bh * p.sq + q0 + i] : NAN;
        sDelta[i] = in ? p.delta[bh * p.sq + q0 + i] : 0.f;
      }
      __syncthreads();
      block_mm<T, BQ, BK, D, false, true>(sS, C::LDS, sQ, C::LDD, sK, C::LDD, false);
      block_mm<T, BQ, BK, DV, false, true>(sdP, C::LDS, sdO, C::LDV, sV, C::LDV, false);
      __syncthreads();
      const int row = q0 + r;
      const float lse = sLse[r], delta = sDelta[r];
      for (int c = g; c < BK; c += TPR) {
        const int key = k0 + c;
        float pr = 0.f, ds = 0.f;
        if (row < p.sq) {
          if (lse == INFINITY) {
            pr = key < p.sk ? uniform : 0.f;
          } else if (live(p, row, key)) {
            pr = expf(sS[r * C::LDS + c] * p.scale - lse);
            ds = pr * (sdP[r * C::LDS + c] - delta) * p.scale;
          }
        }
        sP[r * C::LDP + c] = from_float<T>(pr);
        sdS[r * C::LDP + c] = from_float<T>(ds);
      }
      __syncthreads();
      block_mm<T, BK, DV, BQ, true, false>(sdV, C::LDAV, sP, C::LDP, sdO, C::LDV, true);
      block_mm<T, BK, D, BQ, true, false>(sdK, C::LDA, sdS, C::LDP, sQ, C::LDD, true);
    }
  }
  __syncthreads();
  T* dkg = static_cast<T*>(p.dk) + (static_cast<long long>(bhk) * p.sk + k0) * D;
  T* dvg = static_cast<T*>(p.dv) + (static_cast<long long>(bhk) * p.sk + k0) * DV;
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    if (k0 + i / D < p.sk) dkg[i] = from_float<T>(sdK[(i / D) * C::LDA + i % D]);
  }
  for (int i = threadIdx.x; i < BK * DV; i += kThreads) {
    if (k0 + i / DV < p.sk) dvg[i] = from_float<T>(sdV[(i / DV) * C::LDAV + i % DV]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const Params& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int DV>
int run(const Params& p, int batch, cudaStream_t stream) {
  using C = Cfg<T, D, DV>;
  static_assert(dq_smem_bytes<T, D, DV>() <= 232448, "pass 1 fits a block's shared memory");
  static_assert(dkdv_smem_bytes<T, D, DV>() <= 232448, "pass 2 fits a block's shared memory");
  const dim3 grid_q(batch * p.hq, (p.sq + C::BQ - 1) / C::BQ);
  int err = launch(attn_bwd_dq_kernel<T, D, DV>, dq_smem_bytes<T, D, DV>(), grid_q, p, stream);
  if (err != 0) return err;
  const dim3 grid_k(batch * p.hkv, (p.sk + C::BK - 1) / C::BK);
  return launch(attn_bwd_dkdv_kernel<T, D, DV>, dkdv_smem_bytes<T, D, DV>(), grid_k, p, stream);
}

template <typename T>
int run_square(int d, const Params& p, int batch, cudaStream_t stream) {
  switch (d) {
    case 16: return run<T, 16, 16>(p, batch, stream);
    case 32: return run<T, 32, 32>(p, batch, stream);
    case 64: return run<T, 64, 64>(p, batch, stream);
    case 96: return run<T, 96, 96>(p, batch, stream);
    case 128: return run<T, 128, 128>(p, batch, stream);
    case 256: return run<T, 256, 256>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: the head dim of q and k, dvd: that
// of v, out and dout. window: 0 for none. st: the element strides (batch,
// head, row) of q, k, v, out and dout, in that order. lse and delta are
// float32 scratch of B * Hq * Sq each. dq, dk and dv are contiguous.
// Returns the cudaGetLastError() after the launches
// (cudaErrorInvalidValue for head dims or a dtype without an instance).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                                   void* delta, int dtype, int batch, int hq, int hkv, int sq,
                                   int sk, int d, int dvd, int causal, int window,
                                   const long long* st, void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sq <= 0 || sk <= 0 || batch <= 0) return 0;
  Params p{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse), static_cast<float*>(delta),
           {}, hq, hkv, sq, sk, causal, window, 1.0f / sqrtf(static_cast<float>(d))};
  for (int i = 0; i < 15; ++i) p.st[i] = st[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (dvd != d) {
      if (d == 192 && dvd == 128) return run<bf16, 192, 128>(p, batch, s);
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return run_square<bf16>(d, p, batch, s);
  }
  if (dvd != d) return static_cast<int>(cudaErrorInvalidValue);
  return run_square<float>(d, p, batch, s);
}
