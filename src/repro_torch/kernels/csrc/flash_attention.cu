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
//     have. The grid is (B * Hq, query tiles), the longest causal rows
//     first; one block fits an SM. No atomics: every call gives the same bits.
//
// float32: no tensor cores (TF32 would break the 2e-3 tolerance): scores and
// the accumulator are float32 FMA, with S and acc in shared memory, BK = 32,
// 64 query rows a block, on contiguous inputs, Dv = D.

#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The K/V tiles [lo, hi] that hold a live key for query rows [q0, q1].
__device__ __forceinline__ void kv_tile_range(int sk, int causal, int window, int q0, int q1,
                                              int bk, int& lo, int& hi) {
  lo = 0;
  hi = (sk + bk - 1) / bk - 1;
  // A row with no live key weighs every key equally: visit them all.
  if (window > 0 && q1 >= sk + window - 1) return;
  if (causal) hi = min(hi, q1 / bk);
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / bk;
}

__device__ __forceinline__ bool masked(int causal, int window, int qpos, int kpos) {
  return (causal && kpos > qpos) || (window > 0 && qpos - kpos >= window);
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kBlockM = 128;          // query rows a block
constexpr int kWarpgroup = 128;       // threads
constexpr int kTcThreads = 3 * kWarpgroup;
constexpr int kConsumerWarps = 8;     // arrivals that free a stage
constexpr int kStages = 2;            // K/V ring stages
constexpr int kPanel = 64;            // bf16 columns in one 128-byte swizzle row
constexpr int kProducerRegs = 24;     // setmaxnreg: 128 * 24 + 256 * 240 = 384 * 168
constexpr int kConsumerRegs = 240;

struct TcParams {
  __nv_bfloat16* o;
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

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of TMA transfers on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `bar` with this parity to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// A (64 columns x rows) box of a 4-d (D, S, H, B) tensor map into shared
// memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all >> 4), layout 1 = 128B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so the compiler
// neither reads them before the wait nor reuses them while it runs.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Two floats as a bf16 pair: lo in the low half, the lower column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma instructions, one function per shape. The accumulator of
// m64nN is N / 2 floats a thread: for each 8 columns c, {d[4c], d[4c + 1]}
// are row lane / 4 and {d[4c + 2], d[4c + 3]} row lane / 4 + 8 of the warp's
// 16 rows, at columns 8c + 2 (lane % 4) + {0, 1}. Inline PTX takes no arrays,
// so the operand lists are written out.

// d (64 x 64, float32) {=, +=} a (64 x 16, smem) * b (16 x 64, smem),
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, float32) {=, +=} a (64 x 16, smem) * b (16 x 128, smem),
// both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) {=, +=} a (64 x 16, registers) * b (16 x 64, smem,
// MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 128, float32) {=, +=} a (64 x 16, registers) * b (16 x 128, smem,
// MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 256, float32) {=, +=} a (64 x 16, registers) * b (16 x 256, smem,
// MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n64(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n64(d, a, b, 1);
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n128(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n128(d, a, b, 1);
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_n256(d, a, b, 1);
  }
};

// S = Q K^T for one tile, issued: D / 16 steps of 16 columns, both
// operands K-major, 8-row groups 1024 bytes apart, a step 32 bytes into the
// swizzled row.
template <int DP, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    Wgmma<BK>::ss(sc, smem_desc(q_rows + (kk / 4) * kBlockM * 128 + step, 16, 1024),
                  smem_desc(k_tile + (kk / 4) * BK * 128 + step, 16, 1024), kk > 0);
  }
}

// O += P V for one tile, issued: BK / 16 steps of 16 keys. V is MN-major:
// 64-column panels BK * 128 bytes apart (leading offset), 8-key groups 1024
// bytes apart.
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<DV>::rs(o, pa[kk], smem_desc(v_tile + kk * 16 * 128, BK * 128, 1024));
}

// 2^x on the special-function unit (exp2f adds a range fix-up that these
// arguments, at most 0, do not need; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What the online softmax reads of the call.
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

// P as the A operand: the accumulator's columns 16kk..16kk+15 are the
// m16n8k16 A fragment of step kk, taken pairwise to bf16.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
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

  const int bh = blockIdx.x;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int kvh = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // longest rows first
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
    issue_qk<DP, BK>(sc, q_rows, k_s);
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
      issue_qk<DP, BK>(sc, q_rows, k_s + s * Shape::K_BYTES);
      wgmma_commit();
      reg_fence(o);
      rescale<DV>(o, alpha);
      wgmma_fence();
      issue_pv<DV, BK>(o, pa, v_s + sp * Shape::V_BYTES);
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
    issue_pv<DV, BK>(o, pa, v_s + sl * Shape::V_BYTES);
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
      issue_pv<DV, BK>(o, pa, v_s + sl * Shape::V_BYTES);
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
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// What flash_attention_fwd returns when a tensor map cannot be encoded
// (outside the range of cudaError_t).
constexpr int kEncodeFailed = 10000;

// cuTensorMapEncodeTiled's signature (cuda.h), reached through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// The tensor map of a (B, H, S, D) bf16 tensor with element strides
// st = (batch, head, row) and 1, read in boxes of 64 columns x `rows` rows
// with the 128-byte swizzle; elements out of bounds read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int d, int s, int h, int b,
            const long long* st, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kPanel, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
  const dim3 grid(batch * tp.hq, (tp.sq + kBlockM - 1) / kBlockM);
  attn_tc_kernel<DP, DV><<<grid, kTcThreads, Shape::SMEM, stream>>>(tq, tk, tv, tp);
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

// dtype: 0 = float32 (contiguous inputs and output; the strides are not
// read), 1 = bfloat16. d: the head dim of q and k, dv: that of v and out.
// window: 0 for none. Strides are in elements, for the batch, head and row
// dimensions of q, k, v and out. Returns the cudaGetLastError() after the
// launch (cudaErrorInvalidValue for head dims or a dtype without an
// instance), or kEncodeFailed.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int batch, int hq, int hkv, int sq, int sk,
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
    const TcParams tp{static_cast<__nv_bfloat16*>(o), o_sb, o_sh, o_ss, hq, hkv, sq, sk, dv,
                      causal, window, kLog2e / sqrtf(static_cast<float>(d))};
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
  const Params p{q, k, v, o, hq, hkv, sq, sk, causal, window,
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
