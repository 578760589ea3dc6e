"""The port's list ranking against ``repro`` on the CPU: ranks,
``sublist_lengths`` and ``walk_steps`` bit for bit, in every pack mode,
with RS4/RS5 through the kernels' plain versions (the reference through
its Pallas kernels in interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import list_ranking as rl  # noqa: E402
from repro.core import pram as rp  # noqa: E402
from repro.ops import kiss  # noqa: E402
from repro_torch.core import list_ranking as tl  # noqa: E402
from repro_torch.core import pram as tp  # noqa: E402
from repro_torch.core.components import ConvergenceError  # noqa: E402
from repro_torch.core.serial import serial_list_rank  # noqa: E402


@pytest.mark.parametrize("pack_mode", ["aos", "soa", "word64"])
@pytest.mark.parametrize("n,p", [(1, None), (2000, None), (3000, 37)])
def test_random_splitter_rank_matches_reference(pack_mode, n, p):
    succ = kiss.random_linked_list(n, seed=n)
    want, ws = rl.random_splitter_rank(
        succ, p, pack_mode=pack_mode, kernel_impl="pallas_interpret",
        with_stats=True,
    )
    got, gs = tl.random_splitter_rank(
        succ, p, pack_mode=pack_mode, with_stats=True, device="cpu"
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), serial_list_rank(succ))
    np.testing.assert_array_equal(gs.splitters, ws.splitters)
    np.testing.assert_array_equal(gs.sublist_lengths, ws.sublist_lengths)
    assert gs.walk_steps == ws.walk_steps
    assert gs.expected_mean == ws.expected_mean


def test_even_splitters_and_a_nonzero_head():
    n = 1500
    succ = kiss.random_linked_list(n, seed=9)
    spl = rl.even_splitters(succ, 16)
    np.testing.assert_array_equal(tl.even_splitters(succ, 16), spl)
    want = rl.random_splitter_rank(succ, splitters=spl)
    got = tl.random_splitter_rank(succ, splitters=spl, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n_, p_, seed, head in [(1000, 10, 3, 0), (1000, 1000, 0, 7), (5, 5, 1, 4)]:
        np.testing.assert_array_equal(
            tl.select_splitters(n_, p_, seed=seed, head=head),
            rl.select_splitters(n_, p_, seed=seed, head=head),
        )


@pytest.mark.parametrize("pack_mode", ["aos", "soa"])
def test_max_steps_raises_when_the_walk_is_cut(pack_mode):
    succ = kiss.random_linked_list(2000, seed=4)
    _, stats = tl.random_splitter_rank(succ, 8, with_stats=True, device="cpu")
    with pytest.raises(ConvergenceError):
        tl.random_splitter_rank(
            succ, 8, pack_mode=pack_mode, max_steps=stats.walk_steps - 1,
            device="cpu",
        )
    got, gs = tl.random_splitter_rank(
        succ, 8, pack_mode=pack_mode, max_steps=stats.walk_steps,
        with_stats=True, device="cpu",
    )
    assert gs.walk_steps == stats.walk_steps
    np.testing.assert_array_equal(got.numpy(), serial_list_rank(succ))


@pytest.mark.parametrize("pack_mode", ["aos", "soa"])
@pytest.mark.parametrize("n", [1, 2, 777])
def test_wylie_rank_matches_reference(pack_mode, n):
    succ = kiss.random_linked_list(n, seed=n)
    want = rl.wylie_rank(jnp.asarray(succ), pack_mode=pack_mode)
    got = tl.wylie_rank(succ, pack_mode=pack_mode, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lockstep_walk_counts_steps_exactly():
    # Lane i walks i + 1 steps; 70 lanes cross several check intervals.
    target = torch.arange(1, 71)

    def active_fn(st):
        return st < target

    def step_fn(st, active):
        return st + active.to(st.dtype)

    state, steps, converged = tp.lockstep_walk(
        torch.zeros(70, dtype=torch.int64), active_fn, step_fn
    )
    assert steps == 70 and converged
    assert torch.equal(state, target)
    _, steps, converged = tp.lockstep_walk(
        torch.zeros(70, dtype=torch.int64), active_fn, step_fn, max_steps=40
    )
    assert steps == 40 and not converged
    _, steps, converged = tp.lockstep_walk(
        torch.zeros(70, dtype=torch.int64), active_fn, step_fn, max_steps=0
    )
    assert steps == 0 and not converged


def test_pram_index_helpers_match_reference():
    np.testing.assert_array_equal(
        tp.striding_indices(12, 4).numpy(), np.asarray(rp.striding_indices(12, 4))
    )
    np.testing.assert_array_equal(
        tp.partitioning_indices(12, 4).numpy(),
        np.asarray(rp.partitioning_indices(12, 4)),
    )
    x = np.arange(12, dtype=np.int32)
    np.testing.assert_array_equal(
        tp.strided_view(torch.from_numpy(x), 3).numpy(),
        np.asarray(rp.strided_view(jnp.asarray(x), 3)),
    )
    np.testing.assert_array_equal(
        tp.partitioned_view(torch.from_numpy(x), 3).numpy(),
        np.asarray(rp.partitioned_view(jnp.asarray(x), 3)),
    )
    with pytest.raises(ValueError):
        tp.striding_indices(10, 4)
    for n in (1, 2, 100, 4096, 1 << 23):
        assert tl.max_splitters_for_linear_work(n) == rl.max_splitters_for_linear_work(n)


def test_unknown_modes_raise():
    with pytest.raises(ValueError, match="unknown pack_mode 'word64'"):
        tl.wylie_rank([0], pack_mode="word64", device="cpu")
    with pytest.raises(ValueError, match="unknown kernel_impl 'pallas'"):
        tl.random_splitter_rank([0], kernel_impl="pallas", device="cpu")
