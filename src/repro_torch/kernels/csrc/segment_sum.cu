// Sorted segment sum for Hopper: out[s] = the sum of data[i] over every row i
// with ids[i] == s, for rows already sorted by id.
//
// Replaces src/repro/kernels/segment_sum/segment_sum.py::_segsum_kernel (launched
// by segment_sum_sorted_pallas, wrapper kernels/segment_sum/ops.py::
// segment_sum_sorted). The TPU kernel turns the scatter into a one-hot matrix
// product on the MXU over scalar-prefetched ranges of edge blocks, because a
// TPU has no cheap scatter.
//
// Bound on this card: memory, m*d*s + 4m + n*d*s + 4(n+1) bytes at 3.35 TB/s
// (s the item size): the rows and ids read once, the output and the row
// pointers written once. The carries below are the design's overhead and stay
// out of the bound.
//
// Design: the work is split by rows, not by segment (a merge-path split over
// (row, segment)), so no warp's share of the rows grows with the largest
// segment. Three launches on the caller's stream, no atomics, no host read:
//
// 1. Tiles. The rows are cut into tiles of tile_rows rows (the wrapper's
//    ops.py::row_tiles states the plan) and each warp sums one tile (times one
//    block of at most 128 columns). A tile is walked in stages of stage_rows
//    rows: lane 0 brings each stage's rows and ids into the warp's own ring of
//    kStages shared-memory slots with cp.async.bulk (the 1-D TMA; sorted rows
//    are one contiguous byte range), completing on the slot's mbarrier, while
//    the warp sums the stage that has landed. Each copy's range is widened to
//    16 bytes at both ends and the rows are read at their offset inside the
//    slot, so rows of any width (47 floats, 1 column, odd bf16 widths) are
//    taken as they lie. Rows wider than 128 columns whose stride is not a
//    multiple of 16 bytes (129 or 1,433 columns, odd bf16 widths) are copied
//    row by row, one column block at a time.
//    Inside a stage the lanes spread over columns for wide rows (C = 32 lanes,
//    up to 4 columns each) and over rows for narrow ones: C lanes (the
//    narrowest power of two that covers d) over the columns and R = 32 / C
//    walkers, each walking stage_rows / R consecutive rows in order, so no lane
//    idles on 1- and 8-column rows. A run of one segment that starts and ends
//    inside a walker's rows goes to out at once; the walkers' edge runs, and
//    the run carried from the previous stage, are joined by a segmented scan
//    over the walkers (shuffles, a fixed tree). Rows with an id outside
//    [0, n) are summed into runs that are dropped, and a tile with no other
//    row reads no rows.
//    A segment that lies inside one tile is summed there and written once. A
//    segment that crosses tile boundaries leaves one float32 partial per tile
//    in the carry buffer (the wrapper's, from torch.empty): the tile where it
//    starts writes its tail slot, each later tile its head slot.
//    The same pass writes the row pointers from the ids it has in shared
//    memory: ptr[s] = i for every s in (ids[i-1], ids[i]] clamped to [0, n],
//    for each row boundary i in [0, m] (ids[-1] = -1, ids[m] = n), which is
//    torch.searchsorted(ids, arange(n + 1)): the first row with id >= s.
//    Wide rows whose stride is a multiple of 16 bytes (the MoE combines' bf16
//    rows of 4,096 and 7,168 columns, MACE's float32 messages) take their own
//    tile pass, wide_kernel: a block of kWideThreads threads owns a tile and
//    kWideThreads * 16 bytes of columns (1,024 bf16, 512 float32), each
//    thread one 16-byte column slice that it loads straight into registers
//    (ld.global.nc, kWideRows rows in flight) and sums down the tile's rows
//    in order, emitting each run as above; neighbouring blocks take the
//    neighbouring column blocks of one tile, so a row is read whole at once.
//    Its tiles are 128 rows (ops.py::WIDE_TILE_ROWS): tiles of 256 and 512
//    rows were 4% and up to 27% slower at the combines on the H100.
//    A stage of such rows copied row by row into shared memory held
//    deepseek-v3's combine to 20% of its bound (a 256-byte copy a row and
//    column block), and one 2-D TMA box a stage (15 rows x 256 bytes) to 23%,
//    where the same bytes as contiguous 4 KB stages ran at 52% (PERF.md).
// 2. Fold. One warp per group of kFoldTiles tiles adds each segment's tile
//    partials in the group in tile order: a segment whose partials all lie in
//    the group goes to out, the group's first and last segments that cross its
//    edges leave a group head and tail partial.
// 3. Finish. One warp per 32 segments reads ptr: an empty segment is written
//    as 0, a segment that crosses groups as its first group's tail partial
//    plus the head partials of the later groups, in order. The largest
//    segment of the power-law case, 685k rows, is 1,304 tiles and 41 groups.
//
// Tile size: stages of at most kStageBytes (4 KB: 3 per warp and 8 warps a
// block are 96 KB, two blocks an SM, up to 48 stages in flight an SM), and a
// tile of max(8 stages, 512 rows): 8 stages keep a warp's ring busy, and 512
// rows keep the carries (at most two partials of d floats written and read
// per tile boundary) under 1% of the rows' bytes in float32. Measured on the
// H100 against 4-warp blocks, 4 or 6 slots, 8 KB slots and 4x longer tiles,
// this is the fastest or within 1% at every shape of the GNN path.
//
// Determinism: every output element is summed in one fixed order -- rows in
// order inside a walker (or a wide_kernel thread), walkers by a fixed scan
// tree, tiles in order inside a group, groups in order -- with no atomics,
// so two calls give bit-equal outputs. Sums are float32 and rounded once to the output's type. Offsets
// are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block, one tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;         // shared-memory slots a warp
constexpr int kStageBytes = 4096;  // one slot: a stage's rows and ids
constexpr int kMaxCols = 128;      // columns of a column block
constexpr int kWideThreads = 128;  // threads of a wide_kernel block
constexpr int kWideRows = 8;       // rows a wide_kernel thread has in flight
enum Copy { kStream = 0, kWide = 1, kRows = 2 };  // ops.py::COPY_PATHS
constexpr int kUnroll = 4;         // rows a walker loads before it adds them
constexpr int kSmem = kWarps * kStages * (kStageBytes + 8);  // slots, mbarriers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // rounded once, to nearest even
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
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

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__host__ __device__ __forceinline__ long long round16(long long x) {
  return (x + 15) & ~15LL;
}

// A copy of [src, src + bytes) widened to 16 bytes at both ends: the aligned
// start and the padded size.
struct Span {
  const unsigned char* start;
  uint32_t bytes;
};

__device__ __forceinline__ Span span(const void* src, long long bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = (a + static_cast<uintptr_t>(bytes) + 15) & ~static_cast<uintptr_t>(15);
  return {reinterpret_cast<const unsigned char*>(lo), static_cast<uint32_t>(hi - lo)};
}

struct Params {
  const void* data;  // (m, d) rows sorted by id
  const int* ids;    // (m,)
  int* ptr;          // (n + 1,): written here, read by the fold and finish passes
  float* carry;      // (tiles + groups, 2, d): head and tail partials, of each
                     // tile (pass 1), then of each group of kFoldTiles (pass 2)
  void* out;         // (n, d)
  long long m, n, d;
  long long tile_rows;
  long long tiles;  // ceil(m / tile_rows)
  int walker_rows;  // rows a walker walks in a stage; stage_rows = R * this
  int col_block;    // columns a warp sums (d, or kMaxCols when d > kMaxCols)
  int row_slot;     // bytes a row takes in a slot when copied row by row, else 0
  int ids_off;      // offset of the ids inside a slot
};

// ptr[s] = row for every s in (before, after] clamped to [0, n] (n < 2^31 - 1),
// s spread over `count` lanes.
__device__ __forceinline__ void fill_ptr(int* ptr, int n, int before, int after, long long row,
                                         int lane, int count) {
  if (before >= n || after < 0) return;
  const int end = min(after, n);
  for (int s = max(before + 1, 0) + lane; s <= end; s += count) ptr[s] = static_cast<int>(row);
}

// Where a finished run goes: a run that began before the tile (its id is the
// id of the row before the tile) to the tile's head partial, a run that
// continues past the tile to its tail partial, any other to out.
template <typename T, int C, int K>
struct Sink {
  T* out;  // out's column c0 in row 0; head and tail likewise
  float* head;
  float* tail;
  long long d, n;
  int col, cw, prev_id;

  __device__ __forceinline__ void put(float* dst, const float (&acc)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = col + k * C;
      if (c < cw) dst[c] = acc[k];
    }
  }
  __device__ __forceinline__ void emit(int id, const float (&acc)[K], bool ends) const {
    if (id < 0 || id >= n) return;  // a negative or sentinel id: dropped
    if (id == prev_id) {
      put(head, acc);
    } else if (ends) {
      T* dst = out + static_cast<long long>(id) * d;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = col + k * C;
        if (c < cw) store(dst + c, acc[k]);
      }
    } else {
      put(tail, acc);
    }
  }
};

// Pass 1: warp w of block b sums tile (b % tile_groups) * kWarps + w over
// columns [c0, c0 + col_block) with c0 = (b / tile_groups) * col_block.
template <typename T, int C, int K>
__global__ void __launch_bounds__(kThreads, 2)
    tile_kernel(const Params p, long long tile_groups) {
  constexpr int R = 32 / C;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = lane % C;
  const int sub = lane / C;
  const long long group = blockIdx.x % tile_groups;
  const long long c0 = (blockIdx.x / tile_groups) * static_cast<long long>(p.col_block);
  const long long tile = group * kWarps + warp;
  if (tile >= p.tiles) return;
  const long long t0 = tile * p.tile_rows;
  const long long t1 = min(t0 + p.tile_rows, p.m);
  // The ids of the rows before and after the tile, with ids[-1] = -1 and
  // ids[m] = n as the row pointers' rule has them. One column block writes
  // the pointers of the tile's row boundaries.
  const bool writes_ptr = c0 == 0;
  const int prev_id = t0 > 0 ? p.ids[t0 - 1] : -1;
  const int next_id = t1 < p.m ? p.ids[t1] : static_cast<int>(p.n);
  const int first = p.ids[t0];
  const int last = p.ids[t1 - 1];
  if (last < 0 || first >= p.n) {  // no row of the tile is summed
    if (writes_ptr) {
      fill_ptr(p.ptr, static_cast<int>(p.n), prev_id, first, t0, lane, 32);
      if (t1 == p.m) {
        fill_ptr(p.ptr, static_cast<int>(p.n), last, static_cast<int>(p.n), p.m, lane, 32);
      }
    }
    return;  // the whole warp leaves together
  }

  const int cw = static_cast<int>(min(static_cast<long long>(p.col_block), p.d - c0));
  const int Q = p.walker_rows;
  const long long SR = static_cast<long long>(R) * Q;
  const long long nst = (t1 - t0 + SR - 1) / SR;
  const T* data = static_cast<const T*>(p.data);
  unsigned char* ring = smem + warp * kStages * kStageBytes;
  const uint32_t bars = smem_u32(smem + kWarps * kStages * kStageBytes) + warp * kStages * 8;

  // Lane 0 brings stage j (rows [t0 + j SR, ...)) into slot j % kStages.
  auto issue = [&](long long j) {
    const int slot = static_cast<int>(j % kStages);
    const long long sb = t0 + j * SR;
    const long long se = min(sb + SR, t1);
    const uint32_t dst = smem_u32(ring + slot * kStageBytes);
    const uint32_t bar = bars + slot * 8;
    const Span ids = span(p.ids + sb, (se - sb) * 4);
    uint32_t bytes = ids.bytes;
    if (p.row_slot == 0) {
      const Span rows = span(data + sb * p.d, (se - sb) * p.d * static_cast<long long>(sizeof(T)));
      mbar_expect_tx(bar, bytes + rows.bytes);
      bulk_load(dst, rows.start, rows.bytes, bar);
    } else {
      for (long long r = sb; r < se; ++r)
        bytes += span(data + r * p.d + c0, cw * static_cast<long long>(sizeof(T))).bytes;
      mbar_expect_tx(bar, bytes);
      for (long long r = sb; r < se; ++r) {
        const Span row = span(data + r * p.d + c0, cw * static_cast<long long>(sizeof(T)));
        bulk_load(dst + static_cast<uint32_t>((r - sb) * p.row_slot), row.start, row.bytes, bar);
      }
    }
    bulk_load(dst + p.ids_off, ids.start, ids.bytes, bar);
  };

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long j = 0; j < min(nst, static_cast<long long>(kStages)); ++j) issue(j);
  }
  __syncwarp();

  const Sink<T, C, K> sink{static_cast<T*>(p.out) + c0, p.carry + (2 * tile) * p.d + c0,
                           p.carry + (2 * tile + 1) * p.d + c0, p.d, p.n, col, cw, prev_id};

  // The run open at the end of the stages walked so far; its id is the id of
  // the last row walked.
  int cid = prev_id;
  float cacc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) cacc[k] = 0.f;
  bool cany = false;

  for (long long j = 0; j < nst; ++j) {
    const int slot = static_cast<int>(j % kStages);
    const long long sb = t0 + j * SR;
    const long long se = min(sb + SR, t1);
    const unsigned char* st = ring + slot * kStageBytes;
    mbar_wait(bars + slot * 8, static_cast<uint32_t>((j / kStages) & 1));
    const int* ids_s = reinterpret_cast<const int*>(
        st + p.ids_off + (reinterpret_cast<uintptr_t>(p.ids + sb) & 15));
    // The row pointers of the stage's row boundaries. Lane l reads the ids of
    // the slot's 16-byte granule k = k0 + l (rows 4k - lead .. 4k - lead + 3
    // of the stage); the id before the stage's first row is cid.
    if (writes_ptr) {
      const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(p.ids + sb) & 15) / 4);
      const int4* granules = reinterpret_cast<const int4*>(st + p.ids_off);
      const int rows_in = static_cast<int>(se - sb);
      int before_chunk = cid;
      for (int k0 = 0; 4 * k0 < rows_in + lead; k0 += 32) {
        const int k = k0 + lane;
        const int4 g4 = 4 * k < rows_in + lead ? granules[k] : make_int4(0, 0, 0, 0);
        const int v[4] = {g4.x, g4.y, g4.z, g4.w};
        int before = __shfl_up_sync(kFull, g4.w, 1);
        if (lane == 0) before = before_chunk;
        before_chunk = __shfl_sync(kFull, g4.w, 31);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * k + e - lead;  // the row in the stage
          if (r == 0) before = cid;
          if (r >= 0 && r < rows_in && v[e] != before) {
            fill_ptr(p.ptr, static_cast<int>(p.n), before, v[e], sb + r, 0, 1);
          }
          before = v[e];
        }
      }
    }
    const uintptr_t base = reinterpret_cast<uintptr_t>(data);
    const unsigned char* rows = st + ((base + sb * p.d * sizeof(T)) & 15);
    const int row_bytes = static_cast<int>(p.d * sizeof(T));

    // This walker's rows [w0, w0 + nrows) of the stage, in order: its first
    // run (head), the run open at its end (tail, if another run began), and
    // every run between them, which is complete and goes out at once.
    const int w0 = sub * Q;
    const int nrows = max(0, min(Q, static_cast<int>(se - sb) - w0));
    int cur = nrows > 0 ? ids_s[w0] : -3;
    int hid = cur;
    bool tail = false;
    float hacc[K], acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) hacc[k] = acc[k] = 0.f;
    for (int q0 = 0; q0 < nrows; q0 += kUnroll) {
      int id[kUnroll];
      float v[kUnroll][K];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = w0 + q0 + u;
        const bool in = q0 + u < nrows;
        id[u] = in ? ids_s[i] : 0;
        const unsigned char* rowp =
            p.row_slot == 0
                ? rows + i * row_bytes
                : st + i * p.row_slot + ((base + ((sb + i) * p.d + c0) * sizeof(T)) & 15);
        const T* row = reinterpret_cast<const T*>(rowp);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = col + k * C;
          v[u][k] = in && c < cw ? to_float(row[c]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u >= nrows) break;
        if (id[u] != cur) {
          if (tail) {
            sink.emit(cur, acc, true);
          } else {
            hid = cur;
#pragma unroll
            for (int k = 0; k < K; ++k) hacc[k] = acc[k];
          }
          tail = true;
          cur = id[u];
#pragma unroll
          for (int k = 0; k < K; ++k) acc[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += v[u][k];
      }
    }
    if (!tail) {
      hid = cur;
#pragma unroll
      for (int k = 0; k < K; ++k) hacc[k] = acc[k];
    }
    const int tid = cur;
    float (&tacc)[K] = acc;
    __syncwarp();  // the slot is read: lane 0 may refill it
    if (lane == 0 && j + kStages < nst) issue(j + kStages);

    // Join the walkers in order, after the carried run. Each walker's end
    // run (tail, else head) is a scan element; it starts a new scan segment
    // unless it is the head and continues the previous walker's end run.
    const bool valid = nrows > 0;
    const int eid = tail ? tid : hid;
    int pid = R > 1 ? __shfl_up_sync(kFull, eid, C) : eid;
    if (sub == 0) pid = cid;
    const bool pany = sub > 0 || cany;
    const bool cont = hid == pid;
    float e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      e[k] = tail ? tacc[k] : hacc[k];
      if (sub == 0 && cont && !tail) e[k] += cacc[k];
    }
    int start = tail || !cont || sub == 0;
#pragma unroll
    for (int off = 1; off < R; off <<= 1) {
      const int up_start = __shfl_up_sync(kFull, start, off * C);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float up = __shfl_up_sync(kFull, e[k], off * C);
        if (sub >= off && !start) e[k] += up;
      }
      if (sub >= off) start |= up_start;
    }
    // e: the sum of this walker's end run so far. The previous end run's sum:
    float pe[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pe[k] = R > 1 ? __shfl_up_sync(kFull, e[k], C) : e[k];
      if (sub == 0) pe[k] = cacc[k];
    }
    if (valid) {
      // The previous end run ended at this walker's first row.
      if (!cont && pany) sink.emit(pid, pe, true);
      // The head run ended inside this walker.
      if (tail) {
        if (cont) {
#pragma unroll
          for (int k = 0; k < K; ++k) hacc[k] += pe[k];
        }
        sink.emit(hid, hacc, true);
      }
    }
    // The last walker with rows holds the new carried run.
    const int last = static_cast<int>((se - sb + Q - 1) / Q) - 1;
    cid = __shfl_sync(kFull, eid, last * C + col);
#pragma unroll
    for (int k = 0; k < K; ++k) cacc[k] = __shfl_sync(kFull, e[k], last * C + col);
    cany = true;
  }
  // The run open at the tile's end ends there unless the next row has its id.
  if (sub == 0) sink.emit(cid, cacc, next_id != cid);
  if (writes_ptr && t1 == p.m) {
    fill_ptr(p.ptr, static_cast<int>(p.n), cid, static_cast<int>(p.n), p.m, lane, 32);
  }
}

// The row pointers of tile [t0, t1)'s row boundaries, and of boundary m
// after the last tile, spread over the block's threads.
__device__ __forceinline__ void tile_pointers(const Params& p, long long t0, long long t1) {
  const long long end = t1 == p.m ? t1 : t1 - 1;
  for (long long i = t0 + threadIdx.x; i <= end; i += blockDim.x) {
    const int before = i > 0 ? p.ids[i - 1] : -1;
    const int after = i < p.m ? p.ids[i] : static_cast<int>(p.n);
    fill_ptr(p.ptr, static_cast<int>(p.n), before, after, i, 0, 1);
  }
}

// 16 bytes of a row as floats.
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// V floats as 16 bytes of the output's type, each rounded once.
__device__ __forceinline__ uint4 pack(const float (&v)[4], float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8], __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Pass 1 for wide rows (a row stride that is a multiple of 16 bytes): block
// b sums tile b / col_blocks over columns [c0, c0 + col_block) with c0 =
// (b % col_blocks) * col_block, thread t the V = 16 / sizeof(T) columns
// from c0 + V t. Each thread walks the tile's rows in order with kWideRows
// 16-byte loads in flight, and sends each run where Sink sends it: out, or
// the tile's head or tail partial.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    wide_kernel(const Params p, long long col_blocks) {
  constexpr int V = 16 / sizeof(T);
  const long long tile = blockIdx.x / col_blocks;
  const long long c0 = (blockIdx.x % col_blocks) * p.col_block;
  const long long t0 = tile * p.tile_rows;
  const long long t1 = min(t0 + p.tile_rows, p.m);
  if (c0 == 0) tile_pointers(p, t0, t1);
  const int prev_id = t0 > 0 ? p.ids[t0 - 1] : -1;
  const int next_id = t1 < p.m ? p.ids[t1] : static_cast<int>(p.n);
  const int first = p.ids[t0];
  const int last = p.ids[t1 - 1];
  const long long col = c0 + static_cast<long long>(threadIdx.x) * V;
  if (last < 0 || first >= p.n || col >= p.d) return;  // no row of the tile is summed here
  const T* data = static_cast<const T*>(p.data) + col;
  float* head = p.carry + 2 * tile * p.d + col;
  float* tail = head + p.d;
  auto emit = [&](int id, const float (&acc)[V], bool ends) {
    if (id < 0 || id >= p.n) return;  // a negative or sentinel id: dropped
    if (id == prev_id || !ends) {
      float* dst = id == prev_id ? head : tail;
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        *reinterpret_cast<float4*>(dst + k) = make_float4(acc[k], acc[k + 1], acc[k + 2],
                                                           acc[k + 3]);
      }
    } else {
      *reinterpret_cast<uint4*>(static_cast<T*>(p.out) + id * p.d + col) = pack(acc, T());
    }
  };
  int cur = first;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (long long i0 = t0; i0 < t1; i0 += kWideRows) {
    uint4 raw[kWideRows];
    int id[kWideRows];
#pragma unroll
    for (int u = 0; u < kWideRows; ++u) {
      if (i0 + u < t1) {
        raw[u] = __ldg(reinterpret_cast<const uint4*>(data + (i0 + u) * p.d));
        id[u] = __ldg(p.ids + i0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < kWideRows; ++u) {
      if (i0 + u >= t1) break;
      if (id[u] != cur) {
        emit(cur, acc, true);
        cur = id[u];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = 0.f;
      }
      float v[V];
      unpack(raw[u], v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += v[k];
    }
  }
  emit(cur, acc, next_id != cur);
}

constexpr int kFoldTiles = 32;  // tiles a warp of the fold pass joins, one a lane
constexpr int kCols = 4;        // columns a lane adds at once in passes 2 and 3
constexpr int kAhead = 8;       // partials loaded before they are added

template <typename T>
__device__ __forceinline__ void store_cols(T* dst, long long cb, int lane, long long d,
                                           const float (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const long long col = cb + lane + 32 * c;
    if (col < d) store(dst + col, acc[c]);
  }
}

// Pass 2: warp g joins the partials of tiles [32 g, 32 g + 32), in tile
// order. Lane j finds tile 32 g + j's items: a head partial (of the segment
// at its first row, if that segment began before it) and a tail partial (of
// the segment at its last row, if that segment began in it and goes on).
// A segment whose items all lie in the group is written to out; the group's
// first segment, if it began before the group, leaves the group's head
// partial, and its last, if it goes on past the group, the group's tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const int* __restrict__ ids, const int* __restrict__ ptr,
                const float* __restrict__ carry, float* __restrict__ gcarry,
                T* __restrict__ out, long long m, long long n, long long d,
                long long tile_rows, long long tiles) {
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (g * kFoldTiles >= tiles) return;
  const long long p0 = ptr[0];
  const long long p1 = ptr[n];
  const long long t = g * kFoldTiles + lane;
  int hs = -1, ts = -1;  // the head's and the tail's segment, -1 for none
  if (t < tiles) {
    const long long lo = max(t * tile_rows, p0);
    const long long hi = min(min((t + 1) * tile_rows, m), p1);
    if (lo < hi) {
      const int sh = ids[lo];
      if (ptr[sh] < lo) hs = sh;
      const int st = ids[hi - 1];
      if (ptr[st] >= lo && ptr[st + 1] > hi) ts = st;
    }
  }
  if (!__any_sync(kFull, hs >= 0 || ts >= 0)) return;
  float* ghead = gcarry + 2 * g * d;
  float* gtail = ghead + d;
  for (long long cb = 0; cb < d; cb += 32 * kCols) {
    int seg = -1;
    bool began = false;
    float acc[kCols];
    auto flush = [&](bool goes_on) {
      if (seg < 0) return;
      if (!began) {
        store_cols(ghead, cb, lane, d, acc);
      } else if (goes_on) {
        store_cols(gtail, cb, lane, d, acc);
      } else {
        store_cols(out + static_cast<long long>(seg) * d, cb, lane, d, acc);
      }
    };
    for (int j0 = 0; j0 < kFoldTiles; j0 += kAhead) {
      float hv[kAhead][kCols], tv[kAhead][kCols];
      int h[kAhead], tt[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        h[u] = __shfl_sync(kFull, hs, j0 + u);
        tt[u] = __shfl_sync(kFull, ts, j0 + u);
        const float* row = carry + 2 * (g * kFoldTiles + j0 + u) * d + cb + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const bool in = cb + lane + 32 * c < d;
          hv[u][c] = h[u] >= 0 && in ? row[32 * c] : 0.f;
          tv[u][c] = tt[u] >= 0 && in ? row[d + 32 * c] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (h[u] >= 0) {
          if (h[u] == seg) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[c] += hv[u][c];
          } else {  // a segment that began before the group
            flush(false);
            seg = h[u];
            began = false;
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[c] = hv[u][c];
          }
        }
        if (tt[u] >= 0) {
          flush(false);
          seg = tt[u];
          began = true;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] = tv[u][c];
        }
      }
    }
    flush(seg >= 0 && (ptr[seg + 1] - 1) / tile_rows / kFoldTiles > g);
  }
}

// Pass 3: warp w of the grid looks at segments [32 w, 32 w + 32): writes 0 to
// the empty ones and, to each that crosses groups of tiles, its first group's
// tail partial plus the head partials of the later groups it reaches, in
// order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const int* __restrict__ ptr, const float* __restrict__ gcarry,
                  T* __restrict__ out, long long n, long long d, long long group_rows) {
  const long long s0 = (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * 32;
  const int lane = threadIdx.x & 31;
  if (s0 >= n) return;
  const long long s = s0 + lane;
  long long b = 0, e = 0;
  int kind = 0;  // 0 written by pass 1 or 2, 1 empty, 2 crosses groups
  if (s < n) {
    b = ptr[s];
    e = ptr[s + 1];
    kind = b == e ? 1 : (b / group_rows != (e - 1) / group_rows ? 2 : 0);
  }
  unsigned work = __ballot_sync(kFull, kind != 0);
  while (work) {
    const int src = __ffs(work) - 1;
    work &= work - 1;
    const int k = __shfl_sync(kFull, kind, src);
    const long long ga = __shfl_sync(kFull, b, src) / group_rows;
    const long long gb = (__shfl_sync(kFull, e, src) - 1) / group_rows;
    T* dst = out + (s0 + src) * d;
    if (k == 1) {
      for (long long c = lane; c < d; c += 32) store(dst + c, 0.f);
      continue;
    }
    for (long long cb = 0; cb < d; cb += 32 * kCols) {
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const long long col = cb + lane + 32 * c;
        acc[c] = col < d ? gcarry[(2 * ga + 1) * d + col] : 0.f;
      }
      for (long long g = ga + 1; g <= gb; g += kAhead) {
        float v[kAhead][kCols];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const long long col = cb + lane + 32 * c;
            v[u][c] = col < d && g + u <= gb ? gcarry[2 * (g + u) * d + col] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            if (g + u <= gb) acc[c] += v[u][c];
          }
        }
      }
      store_cols(dst, cb, lane, d, acc);
    }
  }
}

// Bytes of a slot's row region and ids region for `rows` rows.
struct Layout {
  long long ids_off, total;
};

__host__ Layout slot_layout(long long rows, long long d, int row_slot, int item) {
  const long long data = row_slot ? rows * row_slot : round16(rows * d * item) + 16;
  const long long ids = round16(rows * 4) + 16;
  return {data, data + ids};
}

template <typename T, int C, int K>
int launch_tiles(const Params& p, cudaStream_t stream) {
  // The shared-memory limit is an attribute of the function on each device.
  constexpr int kDevices = 64;
  static bool ready[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(tile_kernel<T, C, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) ready[dev] = true;
  }
  const long long groups = (p.tiles + kWarps - 1) / kWarps;
  const long long col_blocks = (p.d + p.col_block - 1) / p.col_block;
  if (groups * col_blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  tile_kernel<T, C, K><<<static_cast<unsigned>(groups * col_blocks), kThreads, kSmem,
                         stream>>>(p, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tiles_for(const Params& p, int lanes, cudaStream_t stream) {
  const int per_lane = (p.col_block + lanes - 1) / lanes;
  switch (lanes) {
    case 1: return launch_tiles<T, 1, 1>(p, stream);
    case 2: return launch_tiles<T, 2, 1>(p, stream);
    case 4: return launch_tiles<T, 4, 1>(p, stream);
    case 8: return launch_tiles<T, 8, 1>(p, stream);
    case 16: return launch_tiles<T, 16, 1>(p, stream);
    case 32:
      if (per_lane <= 1) return launch_tiles<T, 32, 1>(p, stream);
      if (per_lane <= 2) return launch_tiles<T, 32, 2>(p, stream);
      if (per_lane <= 4) return launch_tiles<T, 32, 4>(p, stream);
      break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Passes 2 and 3 on the carries that pass 1 left.
int fold_and_finish(const Params& p, int bf16, cudaStream_t s) {
  const long long m = p.m, n = p.n, d = p.d, tile_rows = p.tile_rows;
  void* out = p.out;
  float* gcarry = p.carry + 2 * p.tiles * d;
  const long long groups = (p.tiles + kFoldTiles - 1) / kFoldTiles;
  const unsigned fold_blocks = static_cast<unsigned>((groups + kWarps - 1) / kWarps);
  const unsigned seg_blocks = static_cast<unsigned>((n + 32 * kWarps - 1) / (32 * kWarps));
  if (bf16) {
    fold_kernel<__nv_bfloat16><<<fold_blocks, kThreads, 0, s>>>(
        p.ids, p.ptr, p.carry, gcarry, static_cast<__nv_bfloat16*>(out), m, n, d, tile_rows,
        p.tiles);
    finish_kernel<__nv_bfloat16><<<seg_blocks, kThreads, 0, s>>>(
        p.ptr, gcarry, static_cast<__nv_bfloat16*>(out), n, d, tile_rows * kFoldTiles);
  } else {
    fold_kernel<float><<<fold_blocks, kThreads, 0, s>>>(
        p.ids, p.ptr, p.carry, gcarry, static_cast<float*>(out), m, n, d, tile_rows, p.tiles);
    finish_kernel<float><<<seg_blocks, kThreads, 0, s>>>(
        p.ptr, gcarry, static_cast<float*>(out), n, d, tile_rows * kFoldTiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: (m, d) rows sorted by id, float32 (bf16 = 0) or bfloat16 (bf16 = 1),
// 16-byte aligned; ids: (m,) int32; ptr: (n + 1,) int32 scratch; carry:
// (carry_rows, 2, d) float32 scratch, carry_rows = tiles + ceil(tiles /
// fold_tiles) with tiles = ceil(m / tile_rows); out: (n, d) of data's type.
// lanes, walker_rows, tile_rows, col_block, fold_tiles, carry_rows and copy
// are ops.py::row_tiles' plan, checked here against this file's constants
// and its rule for the path (ops.py::copy_path). Returns
// cudaErrorInvalidValue for a plan that does not fit them, else the first
// nonzero cudaGetLastError() of the three launches.
extern "C" int segment_sum_run(const void* data, const void* ids, void* ptr, void* carry,
                               void* out, long long m, long long n, long long d, int bf16,
                               int lanes, int walker_rows, long long tile_rows,
                               int col_block, int fold_tiles, long long carry_rows, int copy,
                               void* stream) {
  if (n <= 0 || d <= 0 || m <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(data) & 15) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int item = bf16 ? 2 : 4;
  const long long tiles = (m + tile_rows - 1) / tile_rows;
  const int rule = d <= kMaxCols ? kStream : (d * item % 16 == 0 ? kWide : kRows);
  if (copy != rule || tile_rows < 1 || fold_tiles != kFoldTiles ||
      carry_rows != tiles + (tiles + kFoldTiles - 1) / kFoldTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rule == kWide) {
    // A block a tile and column block; a thread one 16-byte slice a row.
    const long long col_blocks = (d + col_block - 1) / col_block;
    if (lanes != kWideThreads || col_block != kWideThreads * 16 / item ||
        walker_rows != kWideRows || tiles * col_blocks > 2147483647LL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p{data, static_cast<const int*>(ids), static_cast<int*>(ptr),
             static_cast<float*>(carry), out, m, n, d, tile_rows, tiles, walker_rows,
             col_block, 0, 0};
    const unsigned blocks = static_cast<unsigned>(tiles * col_blocks);
    if (bf16) {
      wide_kernel<__nv_bfloat16><<<blocks, kWideThreads, 0, s>>>(p, col_blocks);
    } else {
      wide_kernel<float><<<blocks, kWideThreads, 0, s>>>(p, col_blocks);
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    return fold_and_finish(p, bf16, s);
  }
  if (lanes < 1 || lanes > 32 || 32 % lanes || walker_rows < 1 || col_block < 1 ||
      col_block > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int R = 32 / lanes;
  const int row_slot =
      col_block < d ? static_cast<int>(round16(static_cast<long long>(col_block) * item) + 16)
                    : 0;
  const long long stage_rows = static_cast<long long>(R) * walker_rows;
  const Layout lay = slot_layout(stage_rows, d, row_slot, item);
  if (lay.total > kStageBytes || tile_rows % stage_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{data, static_cast<const int*>(ids), static_cast<int*>(ptr),
           static_cast<float*>(carry), out, m, n, d, tile_rows, tiles, walker_rows,
           col_block, row_slot, static_cast<int>(lay.ids_off)};
  const int err =
      bf16 ? launch_tiles_for<__nv_bfloat16>(p, lanes, s) : launch_tiles_for<float>(p, lanes, s);
  if (err) return err;
  return fold_and_finish(p, bf16, s);
}
