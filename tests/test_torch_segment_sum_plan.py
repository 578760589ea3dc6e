"""The split of the port's segment sum kernel, stated in plain PyTorch in
``repro_torch/kernels/segment_sum/ops.py``: ``row_tiles`` (how the rows
are cut into tiles, stages and walkers), ``row_pointers_ref`` (the row
pointers the kernel's tile pass writes) and ``segment_sum_tiled_ref``
(a sum by the kernel's split, in its order of passes: runs inside tiles,
then tile partials in tile order a fold group at a time, then group
partials; not in its order of sums inside a tile).

The data are integer-valued float32, so every order of the sums gives
the same exact sum: the emulation is held bit for bit to the port's
plain version, to ``repro``'s Pallas kernel in interpret mode and to its
oracle, on each shape of split the kernel meets."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_sum.ops import (  # noqa: E402
    segment_sum_sorted as jax_segment_sum_sorted,
)
from repro.kernels.segment_sum.ref import segment_sum_sorted_ref as jax_ref  # noqa: E402
from repro_torch.kernels.segment_sum import ops  # noqa: E402
from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref  # noqa: E402


def _ids(case: str):
    """``(sorted int32 ids, num_segments, tile_rows)`` of one case."""
    r = np.random.default_rng(sum(map(ord, case)))
    if case == "uniform":
        ns, ids = 700, r.integers(0, 700, 3000)
        return np.sort(ids), ns, ops.row_tiles(3000, 6, 4).tile_rows
    if case == "hub":  # one segment owns most rows, over many tiles and groups
        return np.sort(np.minimum(r.integers(0, 64, 2000), 3)), 64, 16
    if case == "one_segment":
        return np.zeros(500, np.int64), 1, 8
    if case == "ends_on_tile_boundaries":  # 8 rows, then 16, then the rest
        ids = np.concatenate([np.zeros(8), np.ones(16), 2 + np.sort(r.integers(0, 5, 40))])
        return ids, 7, 8
    if case == "spans_three_tiles":  # 21 rows from the middle of a tile
        ids = np.concatenate([np.sort(r.integers(0, 3, 6)), np.full(21, 3),
                              4 + np.sort(r.integers(0, 4, 13))])
        return ids, 8, 4
    if case == "spans_fold_groups":  # one tile a row: 100 tiles, 4 groups
        ids = np.concatenate([[0, 0, 1], np.full(100, 2), [3, 5, 5]])
        return ids, 6, 1
    if case == "empty_segments":  # two thirds of the segments empty
        return np.sort(r.choice(np.arange(0, 60, 3), 300)), 60, 8
    if case == "negative_and_sentinel":  # the reference's padding ids too
        ns = 50
        body = r.integers(0, ns, 400)
        ids = np.concatenate([[-7, -1, -1], body, [ns, ns, ns + 5, ns + 300]])
        return np.sort(ids), ns, 8
    if case == "smaller_than_a_tile":
        return np.sort(r.integers(0, 10, 37)), 10, ops.row_tiles(37, 6, 4).tile_rows
    raise ValueError(case)


CASES = ("uniform", "hub", "one_segment", "ends_on_tile_boundaries",
         "spans_three_tiles", "spans_fold_groups", "empty_segments",
         "negative_and_sentinel", "smaller_than_a_tile")


@pytest.mark.parametrize("case", CASES)
def test_tiled_sum_matches_pallas_and_oracle_bit_for_bit(case):
    ids, ns, tile_rows = _ids(case)
    ids = ids.astype(np.int32)
    m = ids.shape[0]
    assert tile_rows < m or case == "smaller_than_a_tile"
    x = np.random.default_rng(m).integers(-8, 9, (m, 6)).astype(np.float32)
    got = ops.segment_sum_tiled_ref(torch.from_numpy(x), torch.from_numpy(ids), ns,
                                    tile_rows)
    plain = segment_sum_sorted_ref(torch.from_numpy(x), torch.from_numpy(ids), ns)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    jx, jids = jnp.asarray(x), jnp.asarray(ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ref(jx, jids, ns)))
    pallas = jax_segment_sum_sorted(jx, jids, ns, impl="pallas", block_e=128, block_s=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("case", CASES)
def test_row_pointers_match_searchsorted(case):
    ids, ns, _ = _ids(case)
    ids = torch.from_numpy(ids.astype(np.int32))
    want = torch.searchsorted(ids, torch.arange(ns + 1, dtype=torch.int32),
                              out_int32=True)
    got = ops.row_pointers_ref(ids, ns)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("ids,ns", [
    ([], 4),  # no rows: every pointer is 0
    ([-3, -1], 5),  # no id in range: every pointer is m
    ([7, 9], 5),  # every id past the end: every pointer is 0
    ([-2, 9], 5),  # a negative id straight to a sentinel
    ([0, 0, 4, 4], 0),  # no segments: one pointer
])
def test_row_pointers_at_the_edges(ids, ns):
    ids = torch.tensor(ids, dtype=torch.int32)
    want = torch.searchsorted(ids, torch.arange(ns + 1, dtype=torch.int32),
                              out_int32=True)
    np.testing.assert_array_equal(ops.row_pointers_ref(ids, ns).numpy(), want.numpy())


def test_tiled_sum_keeps_trailing_dims_and_dtype():
    ids, ns, _ = _ids("hub")
    ids = torch.from_numpy(ids.astype(np.int32))
    x = torch.from_numpy(
        np.random.default_rng(1).integers(-8, 9, (ids.shape[0], 8, 8)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        got = ops.segment_sum_tiled_ref(x.to(dtype), ids, ns, 16)
        assert got.dtype == dtype and tuple(got.shape) == (ns, 8, 8)
        want = segment_sum_sorted_ref(x.to(dtype), ids, ns)
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


@pytest.mark.parametrize("d", [1, 2, 3, 8, 16, 17, 47, 64, 100, 128, 129, 300])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_row_tiles_fit_the_kernel(d, itemsize):
    # What csrc/segment_sum.cu checks before its launch, and the design's
    # rules: a stage and its ids fit a slot, whole stages make a tile of at
    # least TILE_STAGES stages and TILE_ROWS rows, 32 // lanes walkers
    # (an odd number of rows each when there are several), and at most
    # four columns a lane; the carry holds a row for each tile and for
    # each fold group. Rows wider than a column block whose stride is a
    # multiple of 16 bytes (300 float32 columns) take the wide path
    # instead (test_wide_plan_reads_each_row_slice_once).
    plan = ops.row_tiles(61_859_140, d, itemsize)
    assert plan.tiles == -(-61_859_140 // plan.tile_rows)
    assert plan.carry_rows == plan.tiles + -(-plan.tiles // ops.FOLD_TILES)
    if plan.copy == "wide":
        assert d > ops.MAX_COLS and d * itemsize % 16 == 0
        assert plan.lanes == ops.WIDE_THREADS and plan.col_block * itemsize == 16 * plan.lanes
        assert plan.tile_rows % ops.WIDE_ROWS == 0
        return
    walkers = 32 // plan.lanes
    assert plan.lanes * walkers == 32
    assert plan.stage_rows == walkers * plan.walker_rows
    assert walkers == 1 or plan.walker_rows % 2 == 1
    assert plan.col_block == min(d, ops.MAX_COLS)
    assert plan.lanes * 4 >= plan.col_block and (plan.lanes == 32 or plan.lanes >= d)
    slot = 0 if plan.col_block == d else -(-plan.col_block * itemsize // 16) * 16 + 16
    rows = plan.stage_rows
    data = rows * slot if slot else -(-rows * d * itemsize // 16) * 16 + 16
    assert data + -(-rows * 4 // 16) * 16 + 16 <= ops.STAGE_BYTES
    assert plan.tile_rows % plan.stage_rows == 0
    assert plan.tile_rows >= max(ops.TILE_ROWS, ops.TILE_STAGES * plan.stage_rows)


WIDE = (129, 300, 320, 384, 640, 1024, 1033, 1433, 4096, 7167, 7168)


@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_wide_plan_reads_each_row_slice_once(d, itemsize):
    # Rows wider than a column block: the row stride picks the path. A
    # stride that is a multiple of 16 bytes takes the wide path: a block
    # of WIDE_THREADS threads a tile and column block, each thread one
    # 16-byte slice of every row, 16-byte aligned in every row, so the
    # blocks' slices cover each row's columns once; WIDE_ROWS rows in
    # flight a thread, whole rounds of them a tile. Any other stride
    # copies a stage into shared memory row by row, each row widened to
    # 16 bytes in a slice of its own, the stage and its ids in a slot.
    m = 32_768
    plan = ops.row_tiles(m, d, itemsize)
    assert plan.copy == ops.copy_path(d, itemsize)
    assert plan.copy == ("wide" if d * itemsize % 16 == 0 else "rows")
    assert plan.tiles == -(-m // plan.tile_rows)
    assert plan.carry_rows == plan.tiles + -(-plan.tiles // ops.FOLD_TILES)
    if plan.copy == "wide":
        assert plan.lanes == ops.WIDE_THREADS
        assert plan.col_block * itemsize == ops.WIDE_THREADS * 16
        assert plan.walker_rows == plan.stage_rows == ops.WIDE_ROWS
        assert plan.tile_rows == ops.WIDE_TILE_ROWS and plan.tile_rows % ops.WIDE_ROWS == 0
        per = 16 // itemsize  # columns a thread
        slices = [(c0 + t * per, c0 + (t + 1) * per)
                  for c0 in range(0, d, plan.col_block) for t in range(plan.lanes)
                  if c0 + t * per < d]
        assert [c for lo, hi in slices for c in range(lo, hi)] == list(range(d))
        assert all(lo * itemsize % 16 == 0 and d * itemsize % 16 == 0 for lo, _ in slices)
        return
    assert plan.col_block == ops.MAX_COLS and plan.lanes == 32
    assert plan.walker_rows == plan.stage_rows
    slot = -(-plan.col_block * itemsize // 16) * 16 + 16
    ids = -(-plan.stage_rows * 4 // 16) * 16 + 16
    assert plan.stage_rows * slot + ids <= ops.STAGE_BYTES
    assert (plan.stage_rows + 1) * slot + -(-(plan.stage_rows + 1) * 4 // 16) * 16 + 16 \
        > ops.STAGE_BYTES
    assert plan.tile_rows % plan.stage_rows == 0
    assert plan.tile_rows >= max(ops.TILE_ROWS, ops.TILE_STAGES * plan.stage_rows)


@pytest.mark.parametrize("d,itemsize,path", [
    (1, 4, "stream"), (100, 4, "stream"), (128, 2, "stream"), (129, 4, "rows"),
    (129, 2, "rows"), (132, 4, "wide"), (136, 2, "wide"), (4096, 2, "wide"),
    (7168, 2, "wide"), (7167, 2, "rows"), (1433, 4, "rows"), (384, 4, "wide"),
])
def test_copy_path_by_width_and_stride(d, itemsize, path):
    assert ops.copy_path(d, itemsize) == path


@pytest.mark.parametrize("d", [1024, 1033])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 8])
def test_tiled_sum_at_the_wide_plan_matches_pallas_and_oracle_bit_for_bit(d, dtype, k):
    # Combine-like rows: k rows a token, token-major, with a dropped id
    # before the first token and the sentinel id T after the last, summed
    # by the wide plan's tiles (several tiles, segments crossing them): on
    # the wide path (1,024 columns) and the row-by-row one (1,033).
    # Integer-valued data: every order of the sums is exact, also in bf16.
    tokens = 150 if k == 8 else 600
    ids = np.concatenate([[-1], np.repeat(np.arange(tokens), k), [tokens, tokens]])
    ids = ids.astype(np.int32)
    m = ids.shape[0]
    x = np.random.default_rng(d + k).integers(-8, 9, (m, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    plan = ops.row_tiles(m, d, torch.finfo(tdt).bits // 8)
    assert plan.tiles >= 2 and plan.copy == ("wide" if d == 1024 else "rows")
    data, tids = torch.from_numpy(x).to(tdt), torch.from_numpy(ids)
    got = ops.segment_sum_tiled_ref(data, tids, tokens, plan.tile_rows)
    assert got.dtype == tdt
    want = segment_sum_sorted_ref(data, tids, tokens)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    jids = jnp.asarray(ids)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jax_ref(jx, jids, tokens), np.float32))
    pallas = jax_segment_sum_sorted(jx, jids, tokens, impl="pallas", block_e=128, block_s=32)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(pallas, np.float32))


def test_kernel_launch_refuses_cpu_tensors():
    seg = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.segment_sum_and_pointers(torch.ones(3, 2), seg, 1)
