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
// P is never rebuilt from the scores' row maxima: the forward wrote each
// row's log-sum-exp (flash_attention.cu, row_lse; +inf for a row with no
// live key) and P = exp(s - lse). So each pass recomputes S = Q K^T and
// dP = dO V^T and runs its own products: seven S^2 D products in all, where
// the least work is five.
//
// Bound on this card: operations. The five products, causal-halved, at
// qwen3-4b's training shape (B=1, Hq=32, Hkv=8, S=4096, D=128) are 3.4e11
// FLOPs, 0.35 ms at 989 TFLOP/s (the seven run: 0.49 ms); the bytes (q, k,
// v, out, dout read, dq, dk, dv written) take 0.03 ms at 3.35 TB/s. At MLA's
// training shape (B=1, H=128, S=2048, (D, Dv) = (192, 128)) the five are
// 4.5e11 FLOPs, 0.45 ms; at gemma-2b's (B=1, Hq=8, Hkv=1, S=4096, D=256)
// 1.7e11 FLOPs, 0.17 ms. Its times against the bounds are in PERF.md.
//
// Two designs, chosen in flash_attention_bwd below (ops.py::bwd_design
// states the same choice). No atomics in either: every call gives the same
// bits.
//
// "wgmma": bfloat16 with D = Dv in {16, 32, 64, 96, 128, 256} and MLA's (D,
// Dv) = (192, 128), the forward's warp-specialised shape
// (hopper_attention.cuh): a producer warpgroup feeds a TMA ring on
// mbarriers, two consumer warpgroups (setmaxnreg 24/240) run wgmma with
// float32 accumulators in registers; a head dim below a multiple of 64 loads
// as the next multiple (TMA fills zeros). D's and Dv's widths are separate
// template arguments (TcBwd<DP, DVP>, whose comment reckons each instance's
// registers and shared memory).
//   1. attn_bwd_dq_tc, one block a (b * Hq + h, query tile of 128 rows), on
//      the forward's 1-D grid (ops.py::block_order: KV head by KV head, the
//      longest causal rows first inside one), so the blocks in flight read
//      the K and V of a few KV heads, which stay in L2. The producer loads
//      Q and dO once and streams K and V tiles of BK1 keys (128; 64 at
//      (192, 128) and 48 at 256: dQ's 96 or 128 registers leave too few for
//      wider S and dP) on
//      kv_tile_range, the forward's schedule. Each consumer owns 64 rows: it
//      takes D_i = rowsum(dO o O) over Dv and the rows' lse in its prologue
//      (and writes both for pass 2, the lse in log2 units), then per tile S =
//      Q K^T and dP = dO V^T (both operands in shared memory), P = 2^(S
//      scale log2(e) - lse log2(e)) and dS = P o (dP - D_i) scale in
//      registers, and dQ += dS K with dS as the register A operand and K
//      read MN-major (as the forward reads V). Three products.
//   2. attn_bwd_dkdv_tc, one block a (b * Hkv + KV head, group of the KV
//      head's query heads, key tile), the first key tiles first over every
//      KV head. (KV head by KV head, as pass 1, it was no faster at (192,
//      128), whose Q/dO streams do not bound it, and slower at D = 128,
//      where 256 blocks on 132 SMs left a tail.) K and V stay resident;
//      the producer streams tiles of RK query rows of Q and dO (64; 32 at
//      (192, 128)), with their (lse, D_i), for each query head
//      of the block's group and each query tile that holds a live pair for
//      the key tile (bwd_tile_plan in ops.py). S^T = K Q^T and dP^T = V dO^T
//      from shared memory, P^T and dS^T in registers with lse and D_i indexed
//      by column, dV += P^T dO and dK += dS^T Q with Q and dO read MN-major;
//      dK and dV stay in float32 registers across the group's heads. Four
//      products. The block's keys, 128 or 64, are split between the
//      consumers in one of two ways:
//      - by rows (D <= 192): each consumer owns 64 keys and runs all four
//        products on them. At (192, 128) a step's S^T and dP^T are issued
//        right behind the last step's dK product, a six-stage ring ahead.
//      - by product (D = 256, where dK and dV alone would take 256 of a
//        consumer's 240 registers): both consumers own the block's 64 keys.
//        Consumer 0 holds dV and runs S^T, P^T and dV += P^T dO; consumer
//        1 holds dK and runs dP^T, dS^T and dK += dS^T Q. P^T reaches
//        consumer 1 in float32 through a double-buffered exchange in shared
//        memory, on named barriers (bar.sync / bar.arrive over the two
//        warpgroups), so dS^T is the same function as in the row split.
//        Two products a step on each consumer.
//      With G head groups (ops.py::bwd_head_groups: G > 1 where one KV
//      head's query heads would make the longest block walk more than 1.1
//      times the mean per SM, as MQA does), each block writes float32
//      partial dK and dV to a scratch that the wrapper allocates, and
//   3. attn_bwd_sum_groups adds the G partials in group order and writes
//      dk and dv in bf16. With G = 1 pass 2 writes them itself.
//   Only the tiles that need it take the mask: one crossing the causal
//   diagonal, one at the window's lower edge, one holding key Sk - 1. Rows
//   past Sq read zeros and an lse of +inf, so they add nothing unmasked.
//
// "fma" (the first design, kept for float32 at every head dim):
// FlashAttention-2's schedule on 256-thread blocks whose products are
// block_mm, float32 FMA through shared memory (TF32 would break the 2e-3
// tolerance).
//   1. attn_bwd_dq_kernel, one block a (b, h, query tile of BQ rows): loads
//      Q, dO and O's rows, takes D_i; sweeps the K and V tiles that hold a
//      live key for the tile's rows for dS and dQ += dS K. Writes dq and D_i.
//   2. attn_bwd_dkdv_kernel, one block a (b, KV head, key tile of BK keys):
//      keeps K and V and the float32 dK, dV accumulators in shared memory
//      and walks the group's query heads and the query tiles that hold a
//      row with a live key in the tile (all of them where a row has no live
//      key): S and dP again, P and dS from lse and D_i, dV += P^T dO,
//      dK += dS^T Q. Writes dk and dv.
//
// Inputs: q, k, v, out, dout as (B, H, S, D) with any strides whose last
// is 1, 16-byte aligned (the wrapper copies what is not); the forward's lse
// (B, Hq, Sq) float32; outputs dq, dk, dv contiguous (B, H, S, D) in the
// inputs' type. bfloat16: D = Dv in {16, 32, 64, 96, 128, 256} and (D, Dv)
// = (192, 128); float32: D = Dv in the same six.

#include "hopper_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// "fma": float32
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  const float* lse;  // (B, Hq, Sq): the forward's log-sum-exp, +inf with no live key
  float* delta;      // (B, Hq, Sq): rowsum(dout o out), written by pass 1
  // Element strides (batch, head, row) of q, k, v, out and dout.
  long long st[15];
  int hq, hkv, sq, sk, causal, window;
  float scale;
};

// Tiles and shared-memory pitches. Rows are padded by 16 bytes, and every
// buffer starts on 128 bytes, so each 16-byte load lands aligned.
template <int D>
struct Cfg {
  static constexpr int BQ = 16;             // query rows a tile
  static constexpr int BK = 16;             // keys a tile
  static constexpr int TPR = kThreads / BQ;  // threads a row
  static constexpr int PAD = 4;
  static constexpr int LDD = D + PAD;  // q, k, v, dout tiles
  static constexpr int LDS = BK + 4;   // scores and dP (BQ x BK)
  static constexpr int LDP = BK + PAD;  // P and dS (BQ x BK)
  static constexpr int LDA = D + 4;    // dQ, dK, dV accumulators
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row's threads are lanes of one warp");
  static_assert(D % 16 == 0, "head dims are multiples of 16");
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

template <int D>
constexpr size_t dq_smem_bytes() {
  using C = Cfg<D>;
  return 2 * align128(C::BQ * C::LDD * 4) + 2 * align128(C::BK * C::LDD * 4) +
         2 * align128(C::BQ * C::LDS * 4) + align128(C::BQ * C::LDP * 4) +
         align128(C::BQ * C::LDA * 4);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  using C = Cfg<D>;
  return 2 * align128(C::BQ * C::LDD * 4) + 2 * align128(C::BK * C::LDD * 4) +
         2 * align128(C::BQ * C::LDS * 4) + 2 * align128(C::BQ * C::LDP * 4) +
         2 * align128(C::BK * C::LDA * 4) + 2 * align128(C::BQ * 4);
}

__device__ __forceinline__ bool live(const Params& p, int i, int key) {
  return key < p.sk && !(p.causal && key > i) &&
         !(p.window > 0 && static_cast<long long>(i) - key >= p.window);
}

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + R) of one (b, h) slice (row stride rs elements) into a
// shared tile of pitch ld, in 16-byte pieces; rows at or past s are zeros.
template <int R, int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* base, long long rs,
                                          int r0, int s) {
  constexpr int CH = W / 4;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < s) val = *reinterpret_cast<const float4*>(base + (r0 + r) * rs + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// C (M x N, pitch ldc) = (acc ? C : 0) + op(A) op(B), op(A) M x K and op(B)
// K x N, all float32 in shared memory, in FMA. A is stored M x K (TA false)
// or K x M (TA true: op(A) = A^T), B is stored K x N (TB false) or N x K (TB
// true).
template <int M, int N, int K, bool TA, bool TB>
__device__ __forceinline__ void block_mm(float* C, int ldc, const float* A, int lda,
                                         const float* B, int ldb, bool acc) {
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
template <int D>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dq_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, TPR = C::TPR;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver carve{smem};
  float* sQ = carve.take<float>(BQ * C::LDD);
  float* sdO = carve.take<float>(BQ * C::LDD);
  float* sK = carve.take<float>(BK * C::LDD);
  float* sV = carve.take<float>(BK * C::LDD);
  float* sS = carve.take<float>(BQ * C::LDS);
  float* sdP = carve.take<float>(BQ * C::LDS);
  float* sdS = carve.take<float>(BQ * C::LDP);
  float* sdQ = carve.take<float>(BQ * C::LDA);

  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long* st = p.st;
  const float* qg = p.q + b * st[0] + h * st[1];
  const float* kg = p.k + b * st[3] + hk * st[4];
  const float* vg = p.v + b * st[6] + hk * st[7];
  const float* og = p.o + b * st[9] + h * st[10];
  const float* dog = p.dout + b * st[12] + h * st[13];

  load_tile<BQ, D>(sQ, C::LDD, qg, st[2], q0, p.sq);
  load_tile<BQ, D>(sdO, C::LDD, dog, st[14], q0, p.sq);
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) sdQ[(i / D) * C::LDA + i % D] = 0.f;
  __syncthreads();

  const int r = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int row = q0 + r;
  float delta = 0.f;
  if (row < p.sq) {
    for (int d = g; d < D; d += TPR) delta += sdO[r * C::LDD + d] * og[row * st[11] + d];
  }
  delta = row_sum<TPR>(delta);

  int lo, hi;
  key_tiles(p, q0, min(q0 + BQ, p.sq) - 1, BK, lo, hi);

  const float lse = row < p.sq ? p.lse[static_cast<long long>(bh) * p.sq + row] : INFINITY;
  if (row < p.sq && g == 0) p.delta[static_cast<long long>(bh) * p.sq + row] = delta;

  // dQ += dS K over the tiles that hold a live key (a row with no live key
  // adds 0).
  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // sK, sV and sdS are free
    load_tile<BK, D>(sK, C::LDD, kg, st[5], k0, p.sk);
    load_tile<BK, D>(sV, C::LDD, vg, st[8], k0, p.sk);
    __syncthreads();
    block_mm<BQ, BK, D, false, true>(sS, C::LDS, sQ, C::LDD, sK, C::LDD, false);
    block_mm<BQ, BK, D, false, true>(sdP, C::LDS, sdO, C::LDD, sV, C::LDD, false);
    __syncthreads();
    for (int c = g; c < BK; c += TPR) {
      float ds = 0.f;
      if (row < p.sq && lse != INFINITY && live(p, row, k0 + c)) {
        const float pr = expf(sS[r * C::LDS + c] * p.scale - lse);
        ds = pr * (sdP[r * C::LDS + c] - delta) * p.scale;
      }
      sdS[r * C::LDP + c] = ds;
    }
    __syncthreads();
    block_mm<BQ, D, BK, false, false>(sdQ, C::LDA, sdS, C::LDP, sK, C::LDD, true);
  }
  __syncthreads();
  float* dqg = p.dq + (static_cast<long long>(bh) * p.sq + q0) * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int rr = i / D;
    if (q0 + rr < p.sq) dqg[i] = sdQ[rr * C::LDA + i % D];
  }
}

// Pass 2: one block a (b * Hkv + KV head, key tile); the first key tiles
// (the longest causal columns) first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dkdv_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, TPR = C::TPR;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver carve{smem};
  float* sQ = carve.take<float>(BQ * C::LDD);
  float* sdO = carve.take<float>(BQ * C::LDD);
  float* sK = carve.take<float>(BK * C::LDD);
  float* sV = carve.take<float>(BK * C::LDD);
  float* sS = carve.take<float>(BQ * C::LDS);
  float* sdP = carve.take<float>(BQ * C::LDS);
  float* sP = carve.take<float>(BQ * C::LDP);
  float* sdS = carve.take<float>(BQ * C::LDP);
  float* sdK = carve.take<float>(BK * C::LDA);
  float* sdV = carve.take<float>(BK * C::LDA);
  float* sLse = carve.take<float>(BQ);
  float* sDelta = carve.take<float>(BQ);

  const int bhk = blockIdx.x;
  const int b = bhk / p.hkv, hk = bhk % p.hkv;
  const int group = p.hq / p.hkv;
  const int k0 = blockIdx.y * BK;
  const int k1 = min(k0 + BK, p.sk) - 1;
  const long long* st = p.st;
  const float* kg = p.k + b * st[3] + hk * st[4];
  const float* vg = p.v + b * st[6] + hk * st[7];

  load_tile<BK, D>(sK, C::LDD, kg, st[5], k0, p.sk);
  load_tile<BK, D>(sV, C::LDD, vg, st[8], k0, p.sk);
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    sdK[(i / D) * C::LDA + i % D] = 0.f;
    sdV[(i / D) * C::LDA + i % D] = 0.f;
  }

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
    const float* qg = p.q + b * st[0] + h * st[1];
    const float* dog = p.dout + b * st[12] + h * st[13];
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every tile of the last step is read
      load_tile<BQ, D>(sQ, C::LDD, qg, st[2], q0, p.sq);
      load_tile<BQ, D>(sdO, C::LDD, dog, st[14], q0, p.sq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < p.sq;
        sLse[i] = in ? p.lse[bh * p.sq + q0 + i] : NAN;
        sDelta[i] = in ? p.delta[bh * p.sq + q0 + i] : 0.f;
      }
      __syncthreads();
      block_mm<BQ, BK, D, false, true>(sS, C::LDS, sQ, C::LDD, sK, C::LDD, false);
      block_mm<BQ, BK, D, false, true>(sdP, C::LDS, sdO, C::LDD, sV, C::LDD, false);
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
        sP[r * C::LDP + c] = pr;
        sdS[r * C::LDP + c] = ds;
      }
      __syncthreads();
      block_mm<BK, D, BQ, true, false>(sdV, C::LDA, sP, C::LDP, sdO, C::LDD, true);
      block_mm<BK, D, BQ, true, false>(sdK, C::LDA, sdS, C::LDP, sQ, C::LDD, true);
    }
  }
  __syncthreads();
  float* dkg = p.dk + (static_cast<long long>(bhk) * p.sk + k0) * D;
  float* dvg = p.dv + (static_cast<long long>(bhk) * p.sk + k0) * D;
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    if (k0 + i / D < p.sk) {
      dkg[i] = sdK[(i / D) * C::LDA + i % D];
      dvg[i] = sdV[(i / D) * C::LDA + i % D];
    }
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

template <int D>
int run_fma(const Params& p, int batch, cudaStream_t stream) {
  using C = Cfg<D>;
  static_assert(dq_smem_bytes<D>() <= 232448, "pass 1 fits a block's shared memory");
  static_assert(dkdv_smem_bytes<D>() <= 232448, "pass 2 fits a block's shared memory");
  const dim3 grid_q(batch * p.hq, (p.sq + C::BQ - 1) / C::BQ);
  int err = launch(attn_bwd_dq_kernel<D>, dq_smem_bytes<D>(), grid_q, p, stream);
  if (err != 0) return err;
  const dim3 grid_k(batch * p.hkv, (p.sk + C::BK - 1) / C::BK);
  return launch(attn_bwd_dkdv_kernel<D>, dkdv_smem_bytes<D>(), grid_k, p, stream);
}

// ---------------------------------------------------------------------------
// "wgmma": bf16, D = Dv in {16, 32, 64, 96, 128, 256}, and (D, Dv) = (192, 128)
// ---------------------------------------------------------------------------

constexpr int kTcRowsQ = 128;  // pass 1: query rows a block (64 a consumer)
// Pass 2's split by product: named barriers 1 + b (P^T of buffer b
// written) and 3 + b (buffer b read), over both consumer warpgroups.
constexpr int kBarPtFull = 1;
constexpr int kBarPtFree = 3;
constexpr int kConsumerThreads = 2 * kWarpgroup;

struct TcParams {
  const bf16* o;      // out, for D_i
  const bf16* dout;   // dout, for D_i
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;  // their element strides
  const float* lse;   // (B, Hq, Sq): the forward's, natural log
  float* stats;       // pass 1 -> pass 2: per (b * Hq + h, tile of RK rows) the
                      // rows' lse log2(e), then their D_i (rows padded to sq_pad)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* part_dk;     // groups > 1: pass 2's partials, (groups, B * Hkv, Sk, D)
  float* part_dv;     // and (groups, B * Hkv, Sk, Dv)
  int hq, hkv, sq, sk, sq_pad, d, dv_dim, causal, window, groups;
  float scale, scale2;  // 1 / sqrt(D) and log2(e) / sqrt(D)
};

// The tiles (ops.py::bwd_tiles states the same) and shared memory of one
// instance. DP: D rounded up to a multiple of 64, the width of q and k
// loaded and multiplied; DVP: Dv likewise, that of v, out and dout. A
// consumer thread has kConsumerRegs = 240 registers, and its accumulators
// and operands take, in floats or packed bf16 pairs:
//   pass 1, dQ + S + dP + dS packed: DP/2 + BK1/2 + BK1/2 + BK1/4; at DP =
//     128 with BK1 = 128 keys a K/V tile, 64 + 64 + 64 + 32 = 224; at DP =
//     192 that tile would need 256, so BK1 = 64: 96 + 32 + 32 + 16 = 176;
//     at DP = 256, BK1 = 48: 128 + 24 + 24 + 12 = 188 (64 would fit the
//     registers, but not two stages in shared memory).
//   pass 2 split by rows, dK + dV + S^T + dP^T + P^T and dS^T packed: DP/2
//     + DVP/2 + RK/2 + RK/2 + RK/4 + RK/4 for Q/dO tiles of RK rows; at
//     (128, 128) with RK = 64, 64 + 64 + 32 + 32 + 16 + 16 = 224; at (192,
//     128) RK = 64 would need 256, so RK = 32: 96 + 64 + 16 + 16 + 8 + 8 =
//     208. At (256, 256) dK and dV alone take 256, so
//   pass 2 split by product (kSplit), RK = 64: consumer 0, dV + S^T + P^T
//     packed, DVP/2 + RK/2 + RK/4 = 128 + 32 + 16 = 176; consumer 1, dK +
//     dP^T + the P^T it reads + dS^T packed, DP/2 + RK/2 + RK/2 + RK/4 =
//     128 + 32 + 32 + 16 = 208. (32-row tiles fit too, but their m64n32
//     S^T and dP^T re-read K and V from shared memory twice as often a
//     FLOP: 0.35 against 0.31 ms at gemma-2b's shape.)
// Shared memory at (256, 256): pass 1, Q and dO 64 KB each and two
// stages of 48-key K and V (48 KB a stage), 225 KB; pass 2, K and V of 64
// keys (32 KB each), two stages of 64-row Q and dO with their stats
// (64.5 KB a stage) and the two 16 KB P^T buffers, 226 KB. At (192, 128)
// the smaller pass-2 tiles leave shared memory for a deeper ring.
template <int DP, int DVP>
struct TcBwd {
  static constexpr int NP = DP / kPanel;    // 64-column panels of q and k
  static constexpr int NPV = DVP / kPanel;  // those of v and dout
  static constexpr bool kSplit = DP == 256;  // pass 2 split by product
  static constexpr bool kWide = DP == 192;
  // Pass 1: K/V tiles of BK1 keys in a ring of STAGES1.
  static constexpr int BK1 = kSplit ? 48 : kWide ? 64 : 128;
  static constexpr int STAGES1 = 2;
  static constexpr uint32_t Q1_BYTES = kTcRowsQ * DP * 2;
  static constexpr uint32_t DO1_BYTES = kTcRowsQ * DVP * 2;
  static constexpr uint32_t K1_BYTES = BK1 * DP * 2;
  static constexpr uint32_t V1_BYTES = BK1 * DVP * 2;
  // 1024 to align the tiles; Q, dO; the K and V rings; 1 + 4 * STAGES1
  // mbarriers.
  static constexpr size_t SMEM1 =
      1024 + Q1_BYTES + DO1_BYTES + STAGES1 * (K1_BYTES + V1_BYTES) + 8 * (1 + 4 * STAGES1);
  // Pass 2: KEYS2 keys a block; Q/dO tiles of RK rows with their (lse,
  // D_i) in a ring of STAGES2.
  static constexpr int KEYS2 = kSplit ? 64 : 128;
  static constexpr int RK = kWide ? 32 : 64;
  static constexpr int STAGES2 = kWide ? 6 : 2;
  // Pass 2 issues step i + 1's S^T and dP^T right behind step i's dK
  // product where the registers allow it: at DP = 128 that loop spills.
  static constexpr bool kOverlap2 = kWide;
  static constexpr uint32_t K2_BYTES = KEYS2 * DP * 2;
  static constexpr uint32_t V2_BYTES = KEYS2 * DVP * 2;
  static constexpr uint32_t Q2_BYTES = RK * DP * 2;
  static constexpr uint32_t DO2_BYTES = RK * DVP * 2;
  static constexpr uint32_t STAT_BYTES = 2 * RK * sizeof(float);  // lse, then D_i
  // kSplit: P^T, a consumer thread's RK / 2 floats, in two buffers.
  static constexpr uint32_t PT_BYTES = kSplit ? kWarpgroup * (RK / 2) * 4 : 0;
  // 1024 to align the tiles; K, V; the Q, dO and stats rings; the P^T
  // buffers; 1 + 2 * STAGES2 mbarriers.
  static constexpr size_t SMEM2 = 1024 + K2_BYTES + V2_BYTES +
                                  STAGES2 * (Q2_BYTES + DO2_BYTES + STAT_BYTES) +
                                  2 * PT_BYTES + 8 * (1 + 2 * STAGES2);
  static_assert(SMEM1 <= 227 * 1024 && SMEM2 <= 227 * 1024,
                "a block's shared memory is at most 227 KB");
  static_assert(!kSplit || KEYS2 == 64, "split by product: both consumers own the 64 keys");
  static_assert(DP / 2 + BK1 + BK1 / 4 <= 224,
                "pass 1: a consumer's accumulators and operands leave room in 240 registers");
  static_assert(kSplit ? DP / 2 + RK + RK / 4 <= 224 && DVP / 2 + RK / 2 + RK / 4 <= 224
                       : DP / 2 + DVP / 2 + RK + RK / 2 <= 224,
                "pass 2: a consumer's accumulators and operands leave room in 240 registers");
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void put2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void put2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

// A thread's rows `row` and row + 8 of an accumulator (64 x N, N / 2 floats
// a thread) into row-major `out` of `width` columns (the first `width` of
// the N), rows at or past `rows` left out.
template <int N, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], T* out, int width, int row,
                                           int rows, int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= rows) continue;
    T* dst = out + static_cast<long long>(row + 8 * r) * width;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (8 * j < width) put2(dst + 8 * j + col, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// Pass 2's walk over the query tiles (of RK rows) of one key tile [k0, k1],
// the same for each query head of the group (ops.py::bwd_tile_plan): from
// the first tile with a live pair (causal: the one holding row k0, if any)
// to the last with one, then, where rows with no live key exist (a window
// and Sq >= Sk + window), on from the first tile holding such a row to the
// end, since those rows weigh every key.
template <int RK>
struct QueryWalk {
  int first, live_hi, dead_lo, last;

  __device__ QueryWalk(const TcParams& p, int k0, int k1) {
    last = (p.sq - 1) / RK;
    live_hi = last;
    dead_lo = last + 1;
    if (p.window > 0) {
      const long long hi = min(static_cast<long long>(p.sq) - 1,
                               static_cast<long long>(k1) + p.window - 1);
      live_hi = static_cast<int>(hi / RK);
      const long long dead = static_cast<long long>(p.sk) + p.window - 1;
      if (dead <= p.sq - 1) dead_lo = static_cast<int>(dead / RK);
    }
    // Causal: from the tile holding row k0, none where there is no such row.
    first = !p.causal ? 0 : k0 >= p.sq ? last + 1 : skip(k0 / RK);
  }
  __device__ int skip(int qt) const { return qt > live_hi && qt < dead_lo ? dead_lo : qt; }
  __device__ int next(int qt) const { return skip(qt + 1); }
};

// Pass 1's P in place of S: 2^(s scale2 - lse2) for the thread's rows row
// and row + 8 (lse2 their lse in log2 units; +inf gives 0), 0 where masked
// or past Sk.
template <int N>
__device__ __forceinline__ void probs_by_row(float (&sc)[N / 2], const float (&lse2)[2],
                                             const TcParams& p, bool need_mask, int k0, int row,
                                             int col) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fast_exp2(fmaf(sc[4 * j + e], p.scale2, -lse2[e >> 1]));
      if (need_mask) {
        const int kpos = k0 + 8 * j + col + (e & 1);
        if (kpos >= p.sk || masked(p.causal, p.window, row + 8 * (e >> 1), kpos)) x = 0.f;
      }
      sc[4 * j + e] = x;
    }
}

// Pass 2's P^T in place of S^T, by column (the tile's query rows q0 + 8j
// + col, + 1, whose lse2 are in log2 units), packed pairwise into pa as the
// A operand of dV += P^T dO; where the tile takes the mask, 0 where masked
// or past Sk, and for a row with no live key (lse = +inf) `uniform` = 1/Sk
// in pa and 0 in st, so its dS is 0. The thread's keys: key and key + 8.
template <int RK>
__device__ __forceinline__ void probs_by_col(float (&st)[RK / 2], uint32_t (&pa)[RK / 16][4],
                                             const float2* lse2, const TcParams& p,
                                             bool need_mask, int q0, int key, int col,
                                             float uniform) {
#pragma unroll
  for (int j = 0; j < RK / 8; ++j) {
    const float2 l2 = lse2[4 * j + col / 2];  // columns 8j + col, + 1
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = (e & 1) ? l2.y : l2.x;
      float x = fast_exp2(fmaf(st[4 * j + e], p.scale2, -l));
      pv[e] = x;
      if (need_mask) {
        const int kpos = key + 8 * (e >> 1);
        const int qpos = q0 + 8 * j + col + (e & 1);
        if (l == INFINITY) {
          pv[e] = kpos < p.sk ? uniform : 0.f;
          x = 0.f;
        } else if (kpos >= p.sk || masked(p.causal, p.window, qpos, kpos)) {
          pv[e] = x = 0.f;
        }
      }
      st[4 * j + e] = x;
    }
    pa[j / 2][2 * (j % 2)] = pack_bf16(pv[0], pv[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(pv[2], pv[3]);
  }
}

// Pass 2's dS^T = P^T o (dP^T - D_i) scale in place of dP^T, D_i by
// column, packed into pb as the A operand of dK += dS^T Q.
template <int RK>
__device__ __forceinline__ void dscores_by_col(const float (&st)[RK / 2], float (&dpt)[RK / 2],
                                               uint32_t (&pb)[RK / 16][4], const float2* delta,
                                               float scale, int col) {
#pragma unroll
  for (int j = 0; j < RK / 8; ++j) {
    const float2 di = delta[4 * j + col / 2];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? di.y : di.x)) * scale;
  }
  pack_p<RK>(dpt, pb);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kTcThreads, 1)
    attn_bwd_dq_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const TcParams p) {
  using Shape = TcBwd<DP, DVP>;
  constexpr int NP = Shape::NP;
  constexpr int NPV = Shape::NPV;
  constexpr int BK = Shape::BK1;
  constexpr int STAGES = Shape::STAGES1;
  constexpr int RK = Shape::RK;
  extern __shared__ unsigned char smem_raw[];
  // Q (NP panels of 128 rows x 128 bytes each) and dO (NPV such panels),
  // then the K and V rings (STAGES stages of NP and NPV panels of BK
  // rows), 1024-aligned.
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + Shape::Q1_BYTES;
  const uint32_t k_s = do_s + Shape::DO1_BYTES;
  const uint32_t v_s = k_s + STAGES * Shape::K1_BYTES;
  const uint32_t bar_q = v_s + STAGES * Shape::V1_BYTES;
  const uint32_t full_k = bar_q + 8;  // stage s at + 8 s
  const uint32_t full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES;
  const uint32_t empty_v = empty_k + 8 * STAGES;

  // The block's head and query tile in the forward's order
  // (ops.py::block_order).
  int b, h, q0;
  block_of(static_cast<int>(blockIdx.x), p.hq, p.hkv, p.sq, kTcRowsQ, b, h, q0);
  const int bh = b * p.hq + h;
  const int kvh = h / (p.hq / p.hkv);
  const int q1 = min(q0 + kTcRowsQ, p.sq) - 1;
  int lo, hi;
  kv_tile_range(p.sk, p.causal, p.window, q0, q1, BK, lo, hi);
  const int n_tiles = hi - lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerWarps);
      mbar_init(empty_v + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {
    // Producer: Q and dO once, then K and V, last tile first.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Shape::Q1_BYTES + Shape::DO1_BYTES);
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
        tma_load(q_s + pp * kTcRowsQ * 128, &tq, pp * kPanel, q0, h, b, bar_q);
#pragma unroll
      for (int pp = 0; pp < NPV; ++pp)
        tma_load(do_s + pp * kTcRowsQ * 128, &tdo, pp * kPanel, q0, h, b, bar_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (hi - i) * BK;
        const int s = i % STAGES;
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;
        const uint32_t k_off = s * Shape::K1_BYTES;
        const uint32_t v_off = s * Shape::V1_BYTES;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, Shape::K1_BYTES);
#pragma unroll
        for (int pp = 0; pp < NP; ++pp)
          tma_load(k_s + k_off + pp * BK * 128, &tk, pp * kPanel, k0, kvh, b, full_k + 8 * s);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, Shape::V1_BYTES);
#pragma unroll
        for (int pp = 0; pp < NPV; ++pp)
          tma_load(v_s + v_off + pp * BK * 128, &tv, pp * kPanel, k0, kvh, b, full_v + 8 * s);
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows q0 + 64 c .. q0 + 64 c + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / kWarpgroup - 1;
    const int t = threadIdx.x % kWarpgroup;
    const int lane = t % 32;
    const int row = q0 + 64 * c + 16 * (t / 32) + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);                          // and col + 1, + 8j

    // Prologue, while the producer's loads are in flight: D_i over the quad
    // (each lane a quarter of the row's Dv columns) and lse, in log2 units,
    // for rows row and row + 8; both written out for pass 2, rows past Sq
    // as (+inf, 0).
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      float acc = 0.f;
      if (rr < p.sq) {
        const int c0 = (lane % 4) * (p.dv_dim / 4);
        const bf16* orow = p.o + b * p.o_sb + h * p.o_sh + rr * p.o_ss + c0;
        const bf16* drow = p.dout + b * p.do_sb + h * p.do_sh + rr * p.do_ss + c0;
        for (int j = 0; j < p.dv_dim / 4; j += 4) {
          const uint2 ov = *reinterpret_cast<const uint2*>(orow + j);
          const uint2 dv = *reinterpret_cast<const uint2*>(drow + j);
          const float2 o01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.x));
          const float2 o23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.y));
          const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.x));
          const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.y));
          acc = fmaf(o01.x, d01.x, acc);
          acc = fmaf(o01.y, d01.y, acc);
          acc = fmaf(o23.x, d23.x, acc);
          acc = fmaf(o23.y, d23.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      delta[r] = acc;
      lse2[r] = rr < p.sq ? p.lse[static_cast<long long>(bh) * p.sq + rr] * kLog2e : INFINITY;
      if (lane % 4 == 0 && rr < p.sq_pad) {
        float* tile = p.stats + (static_cast<long long>(bh) * p.sq_pad + rr / RK * RK) * 2;
        tile[rr % RK] = lse2[r];
        tile[RK + rr % RK] = delta[r];
      }
    }

    float dq[DP / 2];
    float sc[BK / 2];
    float dp[BK / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
    const uint32_t q_rows = q_s + 64 * c * 128;
    const uint32_t do_rows = do_s + 64 * c * 128;
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int k0 = (hi - i) * BK;
      const int s = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      const uint32_t k_tile = k_s + s * Shape::K1_BYTES;
      const uint32_t v_tile = v_s + s * Shape::V1_BYTES;
      const bool need_mask = (p.causal && k0 + BK - 1 > q0) ||
                             (p.window > 0 && q1 - k0 >= p.window) || k0 + BK > p.sk;
      // S = Q K^T and dP = dO V^T, two groups; P while dP runs.
      mbar_wait(full_k + 8 * s, phase);
      reg_fence(sc);
      wgmma_fence();
      issue_ss<BK, DP / 16>(sc, q_rows, kTcRowsQ * 128, k_tile, BK * 128);
      wgmma_commit();
      mbar_wait(full_v + 8 * s, phase);
      reg_fence(dp);
      wgmma_fence();
      issue_ss<BK, DVP / 16>(dp, do_rows, kTcRowsQ * 128, v_tile, BK * 128);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(sc);
      probs_by_row<BK>(sc, lse2, p, need_mask, k0, row, col);
      wgmma_wait<0>();
      reg_fence(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + 8 * s);
      // dS = P o (dP - D_i) scale, as the A operand of dQ += dS K.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - delta[e >> 1]) * p.scale;
      pack_p<BK>(dp, pa);
      reg_fence(pa);
      reg_fence(dq);
      wgmma_fence();
      issue_rs<DP, BK / 16>(dq, pa, k_tile, BK * 128);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
      reg_fence(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
    }

    bf16* dqg = p.dq + static_cast<long long>(bh) * p.sq * p.d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row + 8 * r >= p.sq) continue;
      bf16* qrow = dqg + static_cast<long long>(row + 8 * r) * p.d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j < p.d) {
          *reinterpret_cast<uint32_t*>(qrow + 8 * j + col) =
              pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kTcThreads, 1)
    attn_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const TcParams p) {
  using Shape = TcBwd<DP, DVP>;
  constexpr int NP = Shape::NP;
  constexpr int NPV = Shape::NPV;
  constexpr int RK = Shape::RK;
  constexpr int KEYS = Shape::KEYS2;
  constexpr int STAGES = Shape::STAGES2;
  extern __shared__ unsigned char smem_raw[];
  // K and V (NP and NPV panels of KEYS keys x 128 bytes each), then the Q
  // and dO rings (STAGES stages of NP and NPV panels of RK rows), the
  // (lse, D_i) ring, the P^T buffers, 1024-aligned.
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + Shape::K2_BYTES;
  const uint32_t q_s = v_s + Shape::V2_BYTES;
  const uint32_t do_s = q_s + STAGES * Shape::Q2_BYTES;
  const uint32_t st_s = do_s + STAGES * Shape::DO2_BYTES;
  const uint32_t pt_s = st_s + STAGES * Shape::STAT_BYTES;
  const uint32_t bar_kv = pt_s + 2 * Shape::PT_BYTES;
  const uint32_t full = bar_kv + 8;  // stage s at + 8 s
  const uint32_t empty = full + 8 * STAGES;
  const float* stats = reinterpret_cast<const float*>(smem_raw + (st_s - smem_u32(smem_raw)));

  // Block (b * Hkv + KV head, head group g): the group's query heads h0 ..
  // h0 + heads - 1.
  const int bhk = blockIdx.x / p.groups;
  const int g = blockIdx.x % p.groups;
  const int b = bhk / p.hkv;
  const int hk = bhk % p.hkv;
  const int heads = p.hq / p.hkv / p.groups;
  const int h0 = hk * (p.hq / p.hkv) + g * heads;
  const int k0 = blockIdx.y * KEYS;  // the first key tiles (longest columns) first
  const int k1 = min(k0 + KEYS, p.sk) - 1;
  const QueryWalk<RK> walk(p, k0, k1);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {
    // Producer: K and V once, then Q, dO and (lse, D_i) tiles, head by head.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, Shape::K2_BYTES + Shape::V2_BYTES);
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
        tma_load(k_s + pp * KEYS * 128, &tk, pp * kPanel, k0, hk, b, bar_kv);
#pragma unroll
      for (int pp = 0; pp < NPV; ++pp)
        tma_load(v_s + pp * KEYS * 128, &tv, pp * kPanel, k0, hk, b, bar_kv);
      int i = 0;
      for (int hg = 0; hg < heads; ++hg) {
        const int h = h0 + hg;
        const float* rows = p.stats + (static_cast<long long>(b) * p.hq + h) * p.sq_pad * 2;
        for (int qt = walk.first; qt <= walk.last; qt = walk.next(qt), ++i) {
          const int s = i % STAGES;
          const uint32_t full_s = full + 8 * s;
          mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(full_s, Shape::Q2_BYTES + Shape::DO2_BYTES + Shape::STAT_BYTES);
#pragma unroll
          for (int pp = 0; pp < NP; ++pp)
            tma_load(q_s + s * Shape::Q2_BYTES + pp * RK * 128, &tq, pp * kPanel, qt * RK, h, b,
                     full_s);
#pragma unroll
          for (int pp = 0; pp < NPV; ++pp)
            tma_load(do_s + s * Shape::DO2_BYTES + pp * RK * 128, &tdo, pp * kPanel, qt * RK, h,
                     b, full_s);
          bulk_load(st_s + s * Shape::STAT_BYTES, rows + qt * 2 * RK, Shape::STAT_BYTES, full_s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = threadIdx.x / kWarpgroup - 1;
  const int t = threadIdx.x % kWarpgroup;
  const int lane = t % 32;
  const int col = 2 * (lane % 4);  // and col + 1, + 8j: the tile's query rows
  const float uniform = 1.f / static_cast<float>(p.sk);
  const auto lse2_of = [&](int i) {
    return reinterpret_cast<const float2*>(stats + (i % STAGES) * 2 * RK);
  };
  const auto need_mask = [&](int qt) {
    const int q0 = qt * RK;
    const int q1 = min(q0 + RK, p.sq) - 1;
    return (p.causal && k0 + KEYS - 1 > q0) || (p.window > 0 && q1 - k0 >= p.window) ||
           k0 + KEYS > p.sk;
  };
  // The block's first row of dK and dV: in dk and dv, or with head groups
  // in group g's slice of the float32 partials.
  const auto rows_at = [&]() {
    return p.groups == 1 ? static_cast<long long>(bhk) * p.sk
                         : (static_cast<long long>(g) * (gridDim.x / p.groups) + bhk) * p.sk;
  };
  mbar_wait(bar_kv, 0);

  if constexpr (Shape::kSplit) {
    // Split by product: both consumers own keys k0 .. k0 + 63, the rows of
    // their accumulators. Step i is (query head hg, query tile qt), as the
    // producer walks them.
    const int key = k0 + 16 * (t / 32) + lane / 4;  // and key + 8
    float4* pt_buf = reinterpret_cast<float4*>(smem_raw + (pt_s - smem_u32(smem_raw)));
    constexpr int PT4 = RK / 8;  // float4s of P^T a thread
    if (c == 0) {
      // S^T = K Q^T, P^T, handed over in float32 (the dS version: 0 on a
      // row with no live key), then dV += P^T dO.
      float dv[DVP / 2];
      float st[RK / 2];
      uint32_t pa[RK / 16][4];
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) dv[i] = 0.f;
#pragma unroll
      for (int i = 0; i < RK / 2; ++i) st[i] = 0.f;
      int i = 0;
      for (int hg = 0; hg < heads; ++hg) {
        for (int qt = walk.first; qt <= walk.last; qt = walk.next(qt), ++i) {
          const int s = i % STAGES;
          mbar_wait(full + 8 * s, (i / STAGES) & 1);
          reg_fence(st);
          wgmma_fence();
          issue_ss<RK, DP / 16>(st, k_s, KEYS * 128, q_s + s * Shape::Q2_BYTES, RK * 128);
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(st);
          probs_by_col<RK>(st, pa, lse2_of(i), p, need_mask(qt), qt * RK, key, col, uniform);
          // Buffer i % 2 is free once consumer 1 has read step i - 2's.
          if (i >= 2) named_sync(kBarPtFree + (i & 1), kConsumerThreads);
          float4* buf = pt_buf + (i & 1) * PT4 * kWarpgroup;
#pragma unroll
          for (int j = 0; j < PT4; ++j)
            buf[j * kWarpgroup + t] = make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2],
                                                  st[4 * j + 3]);
          named_arrive(kBarPtFull + (i & 1), kConsumerThreads);
          reg_fence(pa);
          reg_fence(dv);
          wgmma_fence();
          issue_rs<DVP, RK / 16>(dv, pa, do_s + s * Shape::DO2_BYTES, RK * 128);
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(dv);
          reg_fence(pa);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * s);
        }
      }
      const long long at = rows_at();
      if (p.groups == 1) {
        store_rows<DVP>(dv, p.dv + at * p.dv_dim, p.dv_dim, key, p.sk, col);
      } else {
        store_rows<DVP>(dv, p.part_dv + at * p.dv_dim, p.dv_dim, key, p.sk, col);
      }
    } else {
      // dP^T = V dO^T; with consumer 0's P^T, dS^T; then dK += dS^T Q.
      int steps = 0;
      for (int qt = walk.first; qt <= walk.last; qt = walk.next(qt)) ++steps;
      steps *= heads;
      float dk[DP / 2];
      float dpt[RK / 2];
      float st[RK / 2];
      uint32_t pb[RK / 16][4];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] = 0.f;
#pragma unroll
      for (int i = 0; i < RK / 2; ++i) dpt[i] = 0.f;
      int i = 0;
      for (int hg = 0; hg < heads; ++hg) {
        for (int qt = walk.first; qt <= walk.last; qt = walk.next(qt), ++i) {
          const int s = i % STAGES;
          mbar_wait(full + 8 * s, (i / STAGES) & 1);
          reg_fence(dpt);
          wgmma_fence();
          issue_ss<RK, DVP / 16>(dpt, v_s, KEYS * 128, do_s + s * Shape::DO2_BYTES, RK * 128);
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(dpt);
          named_sync(kBarPtFull + (i & 1), kConsumerThreads);
          const float4* buf = pt_buf + (i & 1) * PT4 * kWarpgroup;
#pragma unroll
          for (int j = 0; j < PT4; ++j) {
            const float4 x = buf[j * kWarpgroup + t];
            st[4 * j] = x.x;
            st[4 * j + 1] = x.y;
            st[4 * j + 2] = x.z;
            st[4 * j + 3] = x.w;
          }
          // Consumer 0 waits for this buffer only where it has a step i + 2.
          if (i + 2 < steps) named_arrive(kBarPtFree + (i & 1), kConsumerThreads);
          dscores_by_col<RK>(st, dpt, pb, lse2_of(i) + RK / 2, p.scale, col);
          reg_fence(pb);
          reg_fence(dk);
          wgmma_fence();
          issue_rs<DP, RK / 16>(dk, pb, q_s + s * Shape::Q2_BYTES, RK * 128);
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(dk);
          reg_fence(pb);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * s);
        }
      }
      const long long at = rows_at();
      if (p.groups == 1) {
        store_rows<DP>(dk, p.dk + at * p.d, p.d, key, p.sk, col);
      } else {
        store_rows<DP>(dk, p.part_dk + at * p.d, p.d, key, p.sk, col);
      }
    }
  } else {
    // Split by rows: consumer c owns keys k0 + 64 c .. k0 + 64 c + 63, the
    // rows of its accumulators.
    const int key = k0 + 64 * c + 16 * (t / 32) + lane / 4;  // and key + 8
    float dk[DP / 2];
    float dv[DVP / 2];
    float st[RK / 2];
    float dpt[RK / 2];
    uint32_t pa[RK / 16][4];
    uint32_t pb[RK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < RK / 2; ++i) st[i] = dpt[i] = 0.f;
    const uint32_t k_rows = k_s + 64 * c * 128;
    const uint32_t v_rows = v_s + 64 * c * 128;
    // Step i is (query head hg, query tile qt): the group's heads, each over
    // the same query tiles. Per step: S^T = K Q^T and dP^T = V dO^T in two
    // groups, P^T while dP^T runs, dV += P^T dO, dS^T, dK += dS^T Q.
    const auto issue_st_dpt = [&](int i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      reg_fence(st);
      reg_fence(dpt);
      wgmma_fence();
      issue_ss<RK, DP / 16>(st, k_rows, KEYS * 128, q_s + s * Shape::Q2_BYTES, RK * 128);
      wgmma_commit();
      issue_ss<RK, DVP / 16>(dpt, v_rows, KEYS * 128, do_s + s * Shape::DO2_BYTES, RK * 128);
      wgmma_commit();
    };
    if constexpr (!Shape::kOverlap2) {
      // Every product of step i done before step i + 1's are issued; stage
      // i goes back to the producer then.
      int i = 0;
      for (int hg = 0; hg < heads; ++hg) {
        for (int qt = walk.first; qt <= walk.last; qt = walk.next(qt), ++i) {
          const int s = i % STAGES;
          issue_st_dpt(i);
          wgmma_wait<1>();
          reg_fence(st);
          probs_by_col<RK>(st, pa, lse2_of(i), p, need_mask(qt), qt * RK, key, col, uniform);
          reg_fence(pa);
          reg_fence(dv);
          wgmma_fence();
          issue_rs<DVP, RK / 16>(dv, pa, do_s + s * Shape::DO2_BYTES, RK * 128);
          wgmma_commit();
          wgmma_wait<1>();
          reg_fence(dpt);
          dscores_by_col<RK>(st, dpt, pb, lse2_of(i) + RK / 2, p.scale, col);
          reg_fence(pb);
          reg_fence(dk);
          wgmma_fence();
          issue_rs<DP, RK / 16>(dk, pb, q_s + s * Shape::Q2_BYTES, RK * 128);
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(dv);
          reg_fence(dk);
          reg_fence(pa);
          reg_fence(pb);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * s);
        }
      }
    } else {
      // Step i + 1's S^T and dP^T are issued right behind step i's dK
      // product (S^T and dP^T are free once dS^T_i is packed), so the tensor
      // cores find them queued; stage i goes back to the producer once
      // S^T_{i+1} is done (step i's products, issued before it, are then
      // done too). The loop turns where no product is in flight: across its
      // back edge ptxas would serialize them.
      const auto scores_to_dv = [&](int i, int qt) {
        wgmma_wait<1>();
        reg_fence(st);
        reg_fence(dk);
        reg_fence(pb);
        __syncwarp();
        if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
        probs_by_col<RK>(st, pa, lse2_of(i), p, need_mask(qt), qt * RK, key, col, uniform);
        reg_fence(pa);
        reg_fence(dv);
        wgmma_fence();
        issue_rs<DVP, RK / 16>(dv, pa, do_s + (i % STAGES) * Shape::DO2_BYTES, RK * 128);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dpt);
        reg_fence(dv);
        reg_fence(pa);
      };
      int hg = 0, qt = walk.first;
      if (qt <= walk.last) {
        issue_st_dpt(0);
        scores_to_dv(0, qt);
      }
      for (int i = 0; qt <= walk.last; ++i) {
        const int s = i % STAGES;
        dscores_by_col<RK>(st, dpt, pb, lse2_of(i) + RK / 2, p.scale, col);
        reg_fence(pb);
        reg_fence(dk);
        wgmma_fence();
        issue_rs<DP, RK / 16>(dk, pb, q_s + s * Shape::Q2_BYTES, RK * 128);
        wgmma_commit();
        qt = walk.next(qt);
        if (qt > walk.last && ++hg < heads) qt = walk.first;
        if (qt <= walk.last) {
          issue_st_dpt(i + 1);
          scores_to_dv(i + 1, qt);
        } else {
          wgmma_wait<0>();
          reg_fence(dk);
          reg_fence(pb);
        }
      }
    }
    const long long at = rows_at();
    if (p.groups == 1) {
      store_rows<DP>(dk, p.dk + at * p.d, p.d, key, p.sk, col);
      store_rows<DVP>(dv, p.dv + at * p.dv_dim, p.dv_dim, key, p.sk, col);
    } else {
      store_rows<DP>(dk, p.part_dk + at * p.d, p.d, key, p.sk, col);
      store_rows<DVP>(dv, p.part_dv + at * p.dv_dim, p.dv_dim, key, p.sk, col);
    }
  }
}

// Pass 3 (head groups only): dk and dv from pass 2's float32 partials, each
// element the sum over the groups in their order, then bf16. A thread takes
// 4 consecutive elements of dk (the first nk) or of dv (the next nv).
__global__ void __launch_bounds__(256) attn_bwd_sum_groups(const float* part_dk,
                                                           const float* part_dv, bf16* dk,
                                                           bf16* dv, long long nk, long long nv,
                                                           int groups) {
  long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  const float* src = part_dk;
  bf16* dst = dk;
  long long n = nk;
  if (e >= nk) {
    e -= nk;
    src = part_dv;
    dst = dv;
    n = nv;
    if (e >= nv) return;
  }
  float4 acc = *reinterpret_cast<const float4*>(src + e);
  for (int g = 1; g < groups; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + g * n + e);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<uint2*>(dst + e) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}

// st: the element strides (batch, head, row) of q, k, v, out and dout.
// Sets tp's sq_pad to the instance's RK.
template <int DP, int DVP>
int run_tc(const void* q, const void* k, const void* v, int batch, const long long* st,
           TcParams tp, cudaStream_t stream) {
  using Shape = TcBwd<DP, DVP>;
  tp.sq_pad = (tp.sq + Shape::RK - 1) / Shape::RK * Shape::RK;
  const int d = tp.d, dv = tp.dv_dim;
  // Pass 1 reads Q and dO in 128-row boxes, K and V in BK1-row boxes; pass
  // 2 Q and dO in RK-row boxes, K and V in KEYS2-row boxes.
  CUtensorMap tq1, tdo1, tk1, tv1, tq2, tdo2, tk2, tv2;
  if (!encode(&tq1, q, d, tp.sq, tp.hq, batch, st, kTcRowsQ) ||
      !encode(&tdo1, tp.dout, dv, tp.sq, tp.hq, batch, st + 12, kTcRowsQ) ||
      !encode(&tk1, k, d, tp.sk, tp.hkv, batch, st + 3, Shape::BK1) ||
      !encode(&tv1, v, dv, tp.sk, tp.hkv, batch, st + 6, Shape::BK1) ||
      !encode(&tq2, q, d, tp.sq, tp.hq, batch, st, Shape::RK) ||
      !encode(&tdo2, tp.dout, dv, tp.sq, tp.hq, batch, st + 12, Shape::RK) ||
      !encode(&tk2, k, d, tp.sk, tp.hkv, batch, st + 3, Shape::KEYS2) ||
      !encode(&tv2, v, dv, tp.sk, tp.hkv, batch, st + 6, Shape::KEYS2)) {
    return kEncodeFailed;
  }
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_tc<DP, DVP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Shape::SMEM1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_tc<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Shape::SMEM2));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Pass 1: a 1-D grid of (head, query tile) blocks in ops.py::block_order.
  const long long blocks1 =
      static_cast<long long>(batch) * tp.hq * ((tp.sq + kTcRowsQ - 1) / kTcRowsQ);
  if (blocks1 > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_dq_tc<DP, DVP><<<static_cast<unsigned>(blocks1), kTcThreads, Shape::SMEM1, stream>>>(
      tq1, tk1, tv1, tdo1, tp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k(batch * tp.hkv * tp.groups, (tp.sk + Shape::KEYS2 - 1) / Shape::KEYS2);
  attn_bwd_dkdv_tc<DP, DVP><<<grid_k, kTcThreads, Shape::SMEM2, stream>>>(tq2, tk2, tv2, tdo2,
                                                                          tp);
  err = cudaGetLastError();
  if (err != cudaSuccess || tp.groups == 1) return static_cast<int>(err);
  const long long nk = static_cast<long long>(batch) * tp.hkv * tp.sk * d;
  const long long nv = static_cast<long long>(batch) * tp.hkv * tp.sk * dv;
  const long long threads = (nk + nv) / 4;
  attn_bwd_sum_groups<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      tp.part_dk, tp.part_dv, tp.dk, tp.dv, nk, nv, tp.groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: the head dim of q and k, dvd: that
// of v, out and dout. window: 0 for none. st: the element strides (batch,
// head, row) of q, k, v, out and dout, in that order. lse: the forward's
// (B, Hq, Sq) float32 log-sum-exp. stats: float32 scratch of B * Hq *
// round_up(Sq, RK) * 2, RK the instance's pass-2 rows (ops.py::bwd_tiles).
// groups: pass 2's head groups (ops.py::bwd_head_groups; 1 on the fma
// design), a divisor of Hq / Hkv; with groups > 1, partials: float32
// scratch of groups * B * Hkv * Sk * (D + Dv). dq, dk and dv are
// contiguous. The design is chosen here: "wgmma" for bf16 with D = Dv in
// {16, 32, 64, 96, 128, 256} and for bf16 (192, 128), "fma" for float32
// (ops.py::bwd_design). Returns the cudaGetLastError() after the launches
// (cudaErrorInvalidValue for head dims, a dtype or groups without an
// instance), or kEncodeFailed.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv,
                                   const void* lse, void* stats, void* partials, int dtype,
                                   int batch, int hq, int hkv, int sq, int sk, int d, int dvd,
                                   int causal, int window, int groups, const long long* st,
                                   void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0 || groups <= 0 ||
      (hq / hkv) % groups != 0 || (groups > 1 && (dtype != 1 || partials == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sq <= 0 || sk <= 0 || batch <= 0) return 0;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    float* part_dk = static_cast<float*>(partials);
    float* part_dv = part_dk == nullptr
                         ? nullptr
                         : part_dk + static_cast<long long>(groups) * batch * hkv * sk * d;
    const TcParams tp{static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                      st[9], st[10], st[11], st[12], st[13], st[14],
                      static_cast<const float*>(lse), static_cast<float*>(stats),
                      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                      part_dk, part_dv, hq, hkv, sq, sk, 0, d, dvd, causal, window, groups,
                      scale, kLog2e * scale};
    if (d == 192 && dvd == 128) return run_tc<192, 128>(q, k, v, batch, st, tp, s);
    if (dvd != d) return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 16:
      case 32:
      case 64: return run_tc<64, 64>(q, k, v, batch, st, tp, s);
      case 96:
      case 128: return run_tc<128, 128>(q, k, v, batch, st, tp, s);
      case 256: return run_tc<256, 256>(q, k, v, batch, st, tp, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dvd != d) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(o),
           static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
           static_cast<float*>(dv), static_cast<const float*>(lse), static_cast<float*>(stats),
           {}, hq, hkv, sq, sk, causal, window, scale};
  for (int i = 0; i < 15; ++i) p.st[i] = st[i];
  switch (d) {
    case 16: return run_fma<16>(p, batch, s);
    case 32: return run_fma<32>(p, batch, s);
    case 64: return run_fma<64>(p, batch, s);
    case 96: return run_fma<96>(p, batch, s);
    case 128: return run_fma<128>(p, batch, s);
    case 256: return run_fma<256>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
