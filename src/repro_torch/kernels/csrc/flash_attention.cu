// Blocked online-softmax attention for Hopper: a FlashAttention-3-shaped
// bfloat16 kernel on wgmma and TMA, and a float32 FMA kernel.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::_attn_kernel
// (launched by flash_attention_pallas). It computes attention_ref's function:
//
//   out[b, h, i] = softmax_j(score(i, j)) @ v[b, h / group, j],
//   score(i, j)  = q[b, h, i] . k[b, h / group, j] / sqrt(D), or -1e30 where
//                  masked: causal (j > i) or outside the window (i - j >= w),
//
// with float32 scores, running max m, running sum l and accumulator acc, and
// the output cast to the input type. Query head h reads KV head h / group by
// index: no repeated K/V is made. The scores are scaled after the dot, as the
// reference does, by a multiply with 1/sqrt(D). Keys past Sk never score
// (p = 0) and query rows past Sq are not stored, so nothing is padded.
//
// Tiles skipped. A K/V tile that is wholly masked for every row of the query
// tile (above the causal diagonal, or before the window) is not visited: its
// keys would get p = exp(-1e30 - m) = 0 once a row has a live key. A row with
// no live key at all (only with a window and Sq >= Sk + window) gets, as in
// the reference, equal weights on every key; a query tile that holds such a
// row visits every tile. Python's statement of this schedule is
// kernels/flash_attention/ops.py::kv_tile_plan.
//
// Bound on this card: operations. A causal prefill at B = 2, Hq = 32, S =
// 4096, D = 128 does 2.75e11 FLOPs (0.278 ms at 989 TFLOP/s) and must move
// 168 MB (0.050 ms at 3.35 TB/s). Its time against that bound is in PERF.md.
//
// bfloat16, every head dim (16 to 256) with v's head dim Dv equal to D, and
// MLA's D = 192 (nope 128 + rope 64) with Dv = 128. Only wgmma reaches the
// tensor cores' rate, and only if the loads overlap the math, so a block is
// warp-specialised, as FlashAttention-3:
//   - 128 query rows of one (b, h) per block of three warpgroups. Warpgroup 0
//     is the producer: one thread issues TMA loads of the Q tile (once) and of
//     K and V tiles of BK keys into a ring of two stages, each load signalling
//     an mbarrier; consumers give a stage back through another. setmaxnreg
//     moves registers from the producer (24) to the consumers (240).
//   - Warpgroups 1 and 2 own 64 query rows each. S = Q K^T is wgmma
//     m64nBKk16 with both operands in shared memory, K-major; the online
//     softmax runs on the accumulator in registers, in log2 units (ex2 on the
//     special-function unit), row max and sum over the quad of lanes that
//     share a row; P, rounded to bf16 in registers, is the register A operand
//     of O += P V (wgmma m64nDvk16), whose B operand V is read MN-major (the
//     transpose bit), so no transposed copy of V is made. Each step issues
//     the next tile's S and the last tile's P V together. O is rescaled and
//     divided by l in float32 and cast once. On the tile of keys 0..BK-1,
//     which the first rows' few large p weigh, P's bf16 rounding residual
//     is multiplied by V too (one more P V for that tile).
//   - Tiles are 64 columns (one 128-byte swizzle row) wide: TMA writes them
//     with the 128-byte swizzle that the wgmma descriptors name. A head dim
//     below a multiple of 64 (16, 32, 96) loads as the next multiple: TMA
//     fills the columns past D with zeros, which add nothing to Q K^T, and
//     O's columns past D are not stored.
//   - Only the tiles that need it are masked: a tile crossing the causal
//     diagonal, one at the window's lower edge, and the one holding key
//     Sk - 1 when Sk is not a multiple of BK. Wholly live tiles run with no
//     mask arithmetic, and K/V tiles are visited from the last to the first.
//   - q, k, v and out are (B, H, S, D) with any strides whose last is 1 (TMA
//     tensor maps take them; 16-byte aligned), so the model's transposed
//     views go in and out without a copy. The maps are encoded on the host
//     with cuTensorMapEncodeTiled, a driver function reached through
//     cudaGetDriverEntryPoint: the library links no libcuda.
//   - BK is 128 keys, 64 for Dv = 256 (whose O accumulator alone takes 128
//     registers). At (192, 128) Q K^T takes 12 k-steps of 16 over three
//     panels and P V writes 128 columns; Q (48 KB), two K stages (48 KB each)
//     and two V stages (32 KB each) take 209 KB of the 227 KB a block may
//     have. One block fits an SM. No atomics: every call gives the same bits.
//   - Block order (ops.py::block_order), a 1-D grid: the blocks go by KV
//     head (b * Hkv + kvh), and inside one the query tiles go longest
//     causal rows first, each over the KV head's Hq / Hkv query heads. So
//     the blocks in flight read the K and V of a few KV heads, which stay in
//     L2 while their query tiles pass. With the heads fastest (the earlier
//     (B * Hq, query tiles) grid), a wave of 132 blocks at MLA's shape held
//     all 128 heads (335 MB of K and V at S = 4096) and streamed each
//     block's tiles from HBM: 0.0154 ms a head against 0.0094 at 16 heads
//     (PERF.md).
//
// float32: no tensor cores (TF32 would break the 2e-3 tolerance): scores and
// the accumulator are float32 FMA, with S and acc in shared memory, BK = 32,
// 64 query rows a block, on contiguous inputs, Dv = D.
//
// Saved for a backward (ops.py::_Attention), both kernels also write each
// row's log-sum-exp, lse = log sum_j exp(score(i, j)) in natural log units,
// +inf for a row with no live key: the backward's P is exp(score - lse), so
// it never rebuilds the row's softmax. With a null lse pointer (prefill and
// serving) nothing more is stored and the output's bits are the same.

#include "hopper_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kBlockM = 128;          // query rows a block
constexpr int kStages = 2;            // K/V ring stages

struct TcParams {
  __nv_bfloat16* o;
  float* lse;                  // (B, Hq, Sq) or null: see row_lse
  long long o_sb, o_sh, o_ss;  // out's strides in elements (batch, head, row)
  int hq, hkv, sq, sk, dv, causal, window;
  float scale2;                // log2(e) / sqrt(D)
};

// DP: D rounded up to a multiple of 64 (the width of q and k loaded and
// multiplied); DV: Dv rounded up likewise (v's and the output's).
template <int DP, int DV>
struct TcShape {
  static constexpr int BK = DV <= 128 ? 128 : 64;
  static constexpr int NP = DP / kPanel;
  static constexpr int NPV = DV / kPanel;
  static constexpr uint32_t Q_BYTES = kBlockM * DP * 2;
  static constexpr uint32_t K_BYTES = BK * DP * 2;
  static constexpr uint32_t V_BYTES = BK * DV * 2;
  // 1024 bytes to align the tiles (the swizzle repeats every 1024), the Q
  // tile, K and V rings, and 1 + 4 * kStages mbarriers.
  static constexpr size_t SMEM =
      1024 + Q_BYTES + kStages * (K_BYTES + V_BYTES) + 8 * (1 + 4 * kStages);
  static_assert(SMEM <= 227 * 1024, "a block's shared memory is at most 227 KB");
};

// What the online softmax reads of the call.
// A row's log-sum-exp of its scaled scores, in natural log units, from the
// online softmax's m and l, which are in log2 units (m the largest score
// times log2(e) / sqrt(D), l the row's sum of 2^(s - m)); +inf for a row with
// no live key, whose m is the mask value. The backward reads it as its P.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m <= 0.5f * kMasked ? INFINITY : (m + log2f(l)) * kLn2;
}

struct SoftmaxArgs {
  int sk, causal, window, q0, q1;
  float scale2;
};

// The online softmax of one tile's scores, in place: sc becomes p (float),
// m_run and l_run (this thread's share of the row sums) are updated, and
// alpha is what O must be multiplied by before this tile's P V. Masked
// where the tile needs it, in log2 units; elsewhere the scale is folded
// into the exponent: exp2(s * scale2 - m).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2],
                                             const SoftmaxArgs& a, int k0, int row, int col) {
  const bool need_mask = (a.causal && k0 + BK - 1 > a.q0) ||
                         (a.window > 0 && a.q1 - k0 >= a.window) || k0 + BK > a.sk;
  float mul = a.scale2;
  if (need_mask) {
    mul = 1.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + col + (e & 1);
        const int qpos = row + 8 * (e >> 1);
        float x = sc[4 * j + e] * a.scale2;
        if (kpos >= a.sk) {
          x = -INFINITY;  // past the end: p = 0
        } else if (masked(a.causal, a.window, qpos, kpos)) {
          x = kMasked;
        }
        sc[4 * j + e] = x;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // Finite: key k0 of every visited tile is below Sk, so it scores a
    // value or -1e30.
    const float m_new = fmaxf(m_run[r], mx[r] * mul);
    alpha[r] = fast_exp2(m_run[r] - m_new);
    m_run[r] = m_new;
    neg_m[r] = -m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fast_exp2(fmaf(sc[4 * j + e], mul, neg_m[e >> 1]));
      sc[4 * j + e] = x;
      sum[e >> 1] += x;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
}


// P's rounding residual as the A operand, in place: pa (P rounded to bf16,
// from pack_p) becomes bf16(p - pa), so that P V + residual V is P V to about
// 2^-17 of each p.
template <int BK>
__device__ __forceinline__ void pack_p_residual(const float (&sc)[BK / 2],
                                                uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[kk][e]));
      pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e] - hi.x, sc[8 * kk + 2 * e + 1] - hi.y);
    }
}

template <int DV>
__device__ __forceinline__ void rescale(float (&o)[DV / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int DP, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
    attn_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const TcParams p) {
  using Shape = TcShape<DP, DV>;
  constexpr int BK = Shape::BK;
  constexpr int NP = Shape::NP;
  constexpr int NPV = Shape::NPV;
  extern __shared__ unsigned char smem_raw[];
  // Tiles: Q (NP panels of 128 rows x 128 bytes), then the K ring (kStages
  // stages of NP panels of BK rows x 128 bytes) and the V ring (kStages
  // stages of NPV such panels), 1024-aligned.
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + Shape::Q_BYTES;
  const uint32_t v_s = k_s + kStages * Shape::K_BYTES;
  const uint32_t bar_q = v_s + kStages * Shape::V_BYTES;
  const uint32_t full_k = bar_q + 8;  // stage s at + 8 s
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  // The block's head and query tile by ops.py::block_order.
  int b, h, q0;
  block_of(static_cast<int>(blockIdx.x), p.hq, p.hkv, p.sq, kBlockM, b, h, q0);
  const int bh = b * p.hq + h;
  const int kvh = h / (p.hq / p.hkv);
  const int q1 = min(q0 + kBlockM, p.sq) - 1;
  int lo, hi;
  kv_tile_range(p.sk, p.causal, p.window, q0, q1, BK, lo, hi);
  const int n_tiles = hi - lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerWarps);
      mbar_init(empty_v + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {
    // Producer. Stage s of tile i is free once both consumer warpgroups
    // have arrived on its empty barrier for tile i - kStages.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Shape::Q_BYTES);
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
        tma_load(q_s + pp * kBlockM * 128, &tq, pp * kPanel, q0, h, b, bar_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (hi - i) * BK;
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const uint32_t k_off = s * Shape::K_BYTES;
        const uint32_t v_off = s * Shape::V_BYTES;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, Shape::K_BYTES);
#pragma unroll
        for (int pp = 0; pp < NP; ++pp)
          tma_load(k_s + k_off + pp * BK * 128, &tk, pp * kPanel, k0, kvh, b, full_k + 8 * s);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, Shape::V_BYTES);
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

    float o[DV / 2];
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    uint32_t pa[BK / 16][4];
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    const uint32_t q_rows = q_s + 64 * c * 128;

    // Step i issues S_i = Q K_i and, after rescaling O for tile i - 1,
    // O += P_{i-1} V_{i-1}: two products in flight together. K_i goes back
    // to the producer as soon as S_i is done, V_{i-1} once P V is. (FA3
    // takes the softmax of S_i between the two waits; ptxas schedules it
    // after the second here, and forcing it before gained nothing on the
    // card: the other consumer warpgroup's products fill the tensor cores
    // during this one's softmax. PERF.md, PR 14.)
    const SoftmaxArgs args{p.sk, p.causal, p.window, q0, q1, p.scale2};
    float alpha[2];
    mbar_wait(bar_q, 0);
    mbar_wait(full_k, 0);
    wgmma_fence();
    issue_ss<BK, DP / 16>(sc, q_rows, kBlockM * 128, k_s, BK * 128);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k);
    softmax_tile<BK>(sc, m_run, l_run, alpha, args, hi * BK, row, col);
    pack_p<BK>(sc, pa);
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      mbar_wait(full_k + 8 * s, (i / kStages) & 1);
      mbar_wait(full_v + 8 * sp, ((i - 1) / kStages) & 1);
      reg_fence(sc);
      reg_fence(pa);
      wgmma_fence();
      issue_ss<BK, DP / 16>(sc, q_rows, kBlockM * 128, k_s + s * Shape::K_BYTES, BK * 128);
      wgmma_commit();
      reg_fence(o);
      rescale<DV>(o, alpha);
      wgmma_fence();
      issue_rs<DV, BK / 16>(o, pa, v_s + sp * Shape::V_BYTES, BK * 128);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      softmax_tile<BK>(sc, m_run, l_run, alpha, args, (hi - i) * BK, row, col);
      reg_fence(sc);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
      pack_p<BK>(sc, pa);
    }
    const int sl = (n_tiles - 1) % kStages;
    mbar_wait(full_v + 8 * sl, ((n_tiles - 1) / kStages) & 1);
    rescale<DV>(o, alpha);
    reg_fence(o);
    reg_fence(pa);
    wgmma_fence();
    issue_rs<DV, BK / 16>(o, pa, v_s + sl * Shape::V_BYTES, BK * 128);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    if (hi - n_tiles + 1 == 0) {
      // The last tile visited is keys 0..BK-1, which hold every key of the
      // first rows: there a few p near 1 carry the row, and P rounded to
      // bf16 (2^-9 of each p) would leave an absolute error of that size on
      // outputs of size 1 (the float32 P V of attention_ref has none). Add
      // the residual's product: one more P V for this tile only.
      reg_fence(sc);
      pack_p_residual<BK>(sc, pa);
      reg_fence(pa);
      wgmma_fence();
      issue_rs<DV, BK / 16>(o, pa, v_s + sl * Shape::V_BYTES, BK * 128);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
    }

    // l over the quad, then O / l, cast once, stored from registers.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = 1.f / l_run[r];
    }
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row + 8 * r >= p.sq) continue;
      if (p.lse != nullptr && lane % 4 == 0) {
        p.lse[static_cast<long long>(bh) * p.sq + row + 8 * r] = row_lse(m_run[r], l_run[r]);
      }
      __nv_bfloat16* orow = og + (row + 8 * r) * p.o_ss;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        if (8 * j < p.dv) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
              pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Hq, Sq) or null
  int hq, hkv, sq, sk, causal, window;
  float scale;
};

constexpr int kBlockKF32 = 32;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBlockQ + kBlockKF32) * (D + 1) +
          kBlockQ * (kBlockKF32 + 1) + kBlockQ * D + 3 * kBlockQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(Params p) {
  constexpr int BK = kBlockKF32;
  constexpr int QS = D + 1;   // odd strides: conflict-free column reads
  constexpr int SS = BK + 1;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;                // [64][QS]
  float* KV = Qs + kBlockQ * QS;     // [BK][QS]: the tile's K, then its V
  float* S = KV + BK * QS;           // [64][SS]: scores, then p
  float* O = S + kBlockQ * SS;       // [64][D]: the accumulator
  float* m_run = O + kBlockQ * D;    // [64]
  float* l_run = m_run + kBlockQ;    // [64]
  float* alpha = l_run + kBlockQ;    // [64]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int q1 = min(q0 + kBlockQ, p.sq) - 1;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int kvh = (bh % p.hq) / (p.hq / p.hkv);
  const size_t kv_off = (static_cast<size_t>(b) * p.hkv + kvh) * p.sk * D;
  const float* qg = static_cast<const float*>(p.q) + (static_cast<size_t>(bh) * p.sq + q0) * D;
  const float* kg = static_cast<const float*>(p.k) + kv_off;
  const float* vg = static_cast<const float*>(p.v) + kv_off;
  float* og = static_cast<float*>(p.o) + (static_cast<size_t>(bh) * p.sq + q0) * D;
  const int tid = threadIdx.x;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * QS + d] = q0 + r < p.sq ? qg[i] : 0.f;
    O[i] = 0.f;
  }
  if (tid < kBlockQ) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }

  int lo, hi;
  kv_tile_range(p.sk, p.causal, p.window, q0, q1, BK, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's reads of KV are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      KV[r * QS + d] = k0 + r < p.sk ? kg[static_cast<size_t>(k0) * D + i] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBlockQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(Qs[r * QS + d], KV[c * QS + d], acc);
      const int kpos = k0 + c;
      float x = acc * p.scale;
      if (kpos >= p.sk) {
        x = -INFINITY;
      } else if (masked(p.causal, p.window, q0 + r, kpos)) {
        x = kMasked;
      }
      S[r * SS + c] = x;
    }
    __syncthreads();  // K is read: load V while the rows take their softmax
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      KV[r * QS + d] = k0 + r < p.sk ? vg[static_cast<size_t>(k0) * D + i] : 0.f;
    }
    if (tid < kBlockQ) {
      float* srow = S + tid * SS;
      float mx = m_run[tid];
      for (int c = 0; c < BK; ++c) mx = fmaxf(mx, srow[c]);
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        srow[c] = expf(srow[c] - mx);
        sum += srow[c];
      }
      const float a = expf(m_run[tid] - mx);
      l_run[tid] = l_run[tid] * a + sum;
      m_run[tid] = mx;
      alpha[tid] = a;
    }
    __syncthreads();
    for (int i = tid; i < kBlockQ * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float acc = O[i] * alpha[r];
#pragma unroll 8
      for (int c = 0; c < BK; ++c) acc = fmaf(S[r * SS + c], KV[c * QS + d], acc);
      O[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    if (q0 + r < p.sq) og[i] = O[i] / l_run[r];
  }
  if (p.lse != nullptr && tid < kBlockQ && q0 + tid < p.sq) {
    p.lse[static_cast<long long>(bh) * p.sq + q0 + tid] =
        m_run[tid] <= 0.5f * kMasked ? INFINITY : m_run[tid] + logf(l_run[tid]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------


// st: the element strides (batch, head, row) of q, k and v, in that order;
// d: the head dim of q and k.
template <int DP, int DV>
int run_tc(const void* q, const void* k, const void* v, int batch, int d, const long long* st,
           const TcParams& tp, cudaStream_t stream) {
  using Shape = TcShape<DP, DV>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, d, tp.sq, tp.hq, batch, st, kBlockM) ||
      !encode(&tk, k, d, tp.sk, tp.hkv, batch, st + 3, Shape::BK) ||
      !encode(&tv, v, tp.dv, tp.sk, tp.hkv, batch, st + 6, Shape::BK)) {
    return kEncodeFailed;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      attn_tc_kernel<DP, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // A 1-D grid of every (head, query tile), in ops.py::block_order.
  const long long blocks =
      static_cast<long long>(batch) * tp.hq * ((tp.sq + kBlockM - 1) / kBlockM);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  attn_tc_kernel<DP, DV><<<static_cast<unsigned>(blocks), kTcThreads, Shape::SMEM, stream>>>(
      tq, tk, tv, tp);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Params& p, int batch_heads,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse: null, or float32 (B, Hq, Sq), contiguous, for each row's
// log-sum-exp of its scaled scores (natural log; +inf for a row with no live
// key), which a backward reads; with null nothing more is stored.
// dtype: 0 = float32 (contiguous inputs and output; the strides are not
// read), 1 = bfloat16. d: the head dim of q and k, dv: that of v and out.
// window: 0 for none. Strides are in elements, for the batch, head and row
// dimensions of q, k, v and out. Returns the cudaGetLastError() after the
// launch (cudaErrorInvalidValue for head dims or a dtype without an
// instance, or a grid past 2^31 - 1 blocks), or kEncodeFailed.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int dtype, int batch, int hq, int hkv, int sq, int sk,
                                   int d, int dv, int causal, int window, long long q_sb,
                                   long long q_sh, long long q_ss, long long k_sb,
                                   long long k_sh, long long k_ss, long long v_sb,
                                   long long v_sh, long long v_ss, long long o_sb,
                                   long long o_sh, long long o_ss, void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sq <= 0 || sk <= 0 || batch <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const TcParams tp{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), o_sb, o_sh,
                      o_ss, hq, hkv, sq, sk, dv, causal, window,
                      kLog2e / sqrtf(static_cast<float>(d))};
    const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
    if (dv != d) {
      if (d == 192 && dv == 128) return run_tc<192, 128>(q, k, v, batch, d, st, tp, s);
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (d) {
      case 16:
      case 32:
      case 64: return run_tc<64, 64>(q, k, v, batch, d, st, tp, s);
      case 96:
      case 128: return run_tc<128, 128>(q, k, v, batch, d, st, tp, s);
      case 256: return run_tc<256, 256>(q, k, v, batch, d, st, tp, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dv != d) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, static_cast<float*>(lse), hq, hkv, sq, sk, causal, window,
                 1.0f / sqrtf(static_cast<float>(d))};
  const int bh = batch * hq;
  switch (d) {
    case 16: return launch(attn_f32_kernel<16>, f32_smem_bytes<16>(), p, bh, s);
    case 32: return launch(attn_f32_kernel<32>, f32_smem_bytes<32>(), p, bh, s);
    case 64: return launch(attn_f32_kernel<64>, f32_smem_bytes<64>(), p, bh, s);
    case 96: return launch(attn_f32_kernel<96>, f32_smem_bytes<96>(), p, bh, s);
    case 128: return launch(attn_f32_kernel<128>, f32_smem_bytes<128>(), p, bh, s);
    case 256: return launch(attn_f32_kernel<256>, f32_smem_bytes<256>(), p, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
