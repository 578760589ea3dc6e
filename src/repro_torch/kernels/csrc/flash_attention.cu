// Blocked online-softmax attention (FlashAttention-2 style) for Hopper.
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
// reference does, by a multiply with 1/sqrt(D).
//
// Layout and grid. q and out are (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), all
// contiguous. One block of 4 warps per (tile of 64 query rows, b * Hq + h);
// the query tiles run in reverse order so the long causal rows start first.
// The Q tile sits in shared memory; K and V tiles of BK keys stream through
// it. Ragged lengths are bounds checks: query rows past Sq are not stored and
// keys past Sk never score (p = 0), so nothing is padded.
//
// Tiles skipped. A K/V tile that is wholly masked for every row of the query
// tile (above the causal diagonal, or before the window) is not visited: its
// keys would get p = exp(-1e30 - m) = 0 once a row has a live key. A row with
// no live key at all (only with a window and Sq >= Sk + window) gets, as in
// the reference, equal weights on every key; a query tile that holds such a
// row visits every tile.
//
// bfloat16: each warp owns 16 query rows and runs mma.sync m16n8k16 (bf16 in,
// float32 accumulate) for S = Q K^T and for acc += P V, with S, P, m, l and
// acc in registers (the FA2 register layout: P's accumulator fragments are
// reused as the A operand of the second product). V is stored transposed in
// shared memory so both products read their B fragments as 32-bit pairs.
// BK is 64 keys, 32 for D = 256 (whose accumulator alone takes 128 registers).
//
// float32: no tensor cores (TF32 would break the 2e-3 tolerance): scores and
// the accumulator are float32 FMA, with S and acc in shared memory, BK = 32.
//
// Bound on this card: operations. A causal prefill at B = 2, Hq = 32, S =
// 4096, D = 128 does 2.75e11 FLOPs (0.278 ms at 989 TFLOP/s) and must move
// 168 MB (0.050 ms at 3.35 TB/s). This first version uses mma.sync from
// shared memory without ldmatrix, wgmma, TMA or pipelining of the K/V loads;
// its time against that bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, sk, causal, window;
  float scale;
};

// The K/V tiles [lo, hi] that hold a live key for query rows [q0, q1].
__device__ __forceinline__ void kv_tile_range(const Params& p, int q0, int q1,
                                              int bk, int& lo, int& hi) {
  lo = 0;
  hi = (p.sk + bk - 1) / bk - 1;
  // A row with no live key weighs every key equally: visit them all.
  if (p.window > 0 && q1 >= p.sk + p.window - 1) return;
  if (p.causal) hi = min(hi, q1 / bk);
  if (p.window > 0 && q0 - p.window + 1 > 0) lo = (q0 - p.window + 1) / bk;
}

__device__ __forceinline__ bool masked(const Params& p, int qpos, int kpos) {
  return (p.causal && kpos > qpos) || (p.window > 0 && qpos - kpos >= p.window);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// Two floats as a bf16 pair: lo in the low half, the lower column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, int BK>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(kBlockQ + BK) * (D + 8) + D * (BK + 8));
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads) attn_bf16_kernel(Params p) {
  constexpr int QS = D + 8;   // row stride of the Q and K tiles (elements):
                              // 16-byte rows, conflict-free fragment reads
  constexpr int VS = BK + 8;  // row stride of the transposed V tile
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * QS;
  __nv_bfloat16* Vt = Ks + BK * QS;  // Vt[d][key]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int q1 = min(q0 + kBlockQ, p.sq) - 1;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int kvh = (bh % p.hq) / (p.hq / p.hkv);
  const size_t kv_off = (static_cast<size_t>(b) * p.hkv + kvh) * p.sk * D;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + (static_cast<size_t>(bh) * p.sq + q0) * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + (static_cast<size_t>(bh) * p.sq + q0) * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;  // fragment row group
  const int t4 = tid % 4;        // thread within the group
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kBlockQ * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(Qs + r * QS + c * 8) =
        q0 + r < p.sq ? *reinterpret_cast<const uint4*>(qg + static_cast<size_t>(r) * D + c * 8)
                      : zero;
  }

  // This thread's two rows of the tile: ra and ra + 8.
  const int ra = warp * 16 + g;
  const int qpos[2] = {q0 + ra, q0 + ra + 8};
  const float scale2 = p.scale * kLog2e;  // scores in log2 units: exp2f
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  int lo, hi;
  kv_tile_range(p, q0, q1, BK, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's reads are done; Q is stored
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int r = i % BK, c = i / BK;
      uint4 kv = zero, vv = zero;
      if (k0 + r < p.sk) {
        const size_t off = static_cast<size_t>(k0 + r) * D + c * 8;
        kv = *reinterpret_cast<const uint4*>(kg + off);
        vv = *reinterpret_cast<const uint4*>(vg + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * QS + c * 8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c * 8 + e) * VS + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows by the tile's BK keys.
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + ra * QS + kk * 16 + t4 * 2;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * QS), ld32(qa + 8),
                             ld32(qa + 8 * QS + 8)};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kb = Ks + (nt * 8 + g) * QS + kk * 16 + t4 * 2;
        mma_bf16(s[nt], a, ld32(kb), ld32(kb + 8));
      }
    }

    // Scale and mask; the running max of each row over the quad's lanes.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * scale2;
        if (kpos >= p.sk) {
          x = -INFINITY;  // past the end: p = 0
        } else if (masked(p, qpos[e >> 1], kpos)) {
          x = kMasked;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // mx is finite: key k0 of every visited tile is in range.
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];

    // acc += P V, with P's accumulator fragments as the A operand.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vb = Vt + (dt * 8 + g) * VS + kk * 16 + t4 * 2;
        mma_bf16(o[dt], a, ld32(vb), ld32(vb + 8));
      }
    }
  }

  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] < p.sq) {
        *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(ra + 8 * r) * D + col) =
            pack_bf16(o[dt][2 * r] * inv[r], o[dt][2 * r + 1] * inv[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

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
  kv_tile_range(p, q0, q1, BK, lo, hi);
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
      } else if (masked(p, q0 + r, kpos)) {
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

template <int D>
int run(int dtype, const Params& p, int batch_heads, cudaStream_t stream) {
  if (dtype == 1) {
    constexpr int BK = D <= 128 ? 64 : 32;
    return launch(attn_bf16_kernel<D, BK>, bf16_smem_bytes<D, BK>(), p,
                  batch_heads, stream);
  }
  return launch(attn_f32_kernel<D>, f32_smem_bytes<D>(), p, batch_heads, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window: 0 for none. Returns the
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head_dim
// or dtype without an instance).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int batch, int hq, int hkv,
                                   int sq, int sk, int d, int causal, int window,
                                   void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sq <= 0 || sk <= 0 || batch <= 0) return 0;
  Params p{q, k, v, o, hq, hkv, sq, sk, causal, window, 1.0f / sqrtf(static_cast<float>(d))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * hq;
  switch (d) {
    case 16: return run<16>(dtype, p, bh, s);
    case 32: return run<32>(dtype, p, bh, s);
    case 64: return run<64>(dtype, p, bh, s);
    case 96: return run<96>(dtype, p, bh, s);
    case 128: return run<128>(dtype, p, bh, s);
    case 256: return run<256>(dtype, p, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
