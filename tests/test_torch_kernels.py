"""The port's kernel wrappers on the CPU: each plain PyTorch version
against ``repro``'s Pallas kernel in interpret mode, bit for bit, and
the wrapper contract (impl choice, no launch off the card)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import random_succ  # noqa: E402
from repro.kernels.edge_hook.ops import edge_hook as jax_edge_hook  # noqa: E402
from repro.kernels.pointer_jump.ops import pointer_jump as jax_pointer_jump  # noqa: E402
from repro.kernels.splitter_aggregate.ops import (  # noqa: E402
    splitter_aggregate as jax_splitter_aggregate,
)
from repro_torch.kernels import launch_counts, resolve_impl  # noqa: E402
from repro_torch.kernels.edge_hook.ops import edge_hook  # noqa: E402
from repro_torch.kernels.edge_hook.ref import drop_scatter_min  # noqa: E402
from repro_torch.kernels.pointer_jump.ops import pointer_jump  # noqa: E402
from repro_torch.kernels.splitter_aggregate.ops import splitter_aggregate  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _hook_state(n, m, seed):
    r = np.random.default_rng(seed)
    a = r.integers(0, n, m).astype(np.int32)
    b = r.integers(0, n, m).astype(np.int32)
    labels = r.integers(0, n, n).astype(np.int32)
    prev = r.integers(0, n, n).astype(np.int32)
    stamps = r.integers(0, 3, n).astype(np.int32)
    return a, b, labels, prev, stamps


@pytest.mark.parametrize("n,m", [(64, 300), (1000, 777), (50, 0)])
def test_edge_hook_sv2_matches_pallas(n, m):
    a, b, labels, prev, stamps = _hook_state(n, m, n * 31 + m)
    want_d, want_q = jax_edge_hook(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(labels),
        jnp.asarray(stamps), jnp.int32(3), labels_prev=jnp.asarray(prev),
        mode="sv2", impl="pallas_interpret", block_e=128,
    )
    got_d, got_q = edge_hook(
        _t(a), _t(b), _t(labels), _t(stamps), 3, labels_prev=_t(prev),
        mode="sv2",
    )
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


@pytest.mark.parametrize("n,m", [(64, 300), (1000, 777), (50, 0)])
def test_edge_hook_sv3_matches_pallas_and_exports_mask(n, m):
    a, b, labels, _prev, stamps = _hook_state(n, m, n * 17 + m)
    want_d, want_q = jax_edge_hook(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(labels),
        jnp.asarray(stamps), jnp.int32(3), mode="sv3",
        impl="pallas_interpret", block_e=128,
    )
    np.testing.assert_array_equal(np.asarray(want_q), stamps)  # pass-through
    got_d, live = edge_hook(_t(a), _t(b), _t(labels), _t(stamps), 3, mode="sv3")
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert live.dtype == torch.bool and live.shape == (m,)
    np.testing.assert_array_equal(live.numpy(), labels[a] != labels[b])


@pytest.mark.parametrize("p", [1, 8, 57, 256])
def test_pointer_jump_matches_pallas(p):
    succ = random_succ(p, seed=p).astype(np.int32)
    w = (succ != np.arange(p)).astype(np.int32)
    want_r, want_n = jax_pointer_jump(
        jnp.asarray(succ), jnp.asarray(w), impl="pallas_interpret"
    )
    got_r, got_n = pointer_jump(_t(succ), _t(w))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("n,p", [(100, 4), (5000, 64)])
def test_splitter_aggregate_matches_pallas(n, p):
    r = np.random.default_rng(n)
    packed = np.stack(
        [r.integers(0, 50, n), r.integers(0, p, n)], -1
    ).astype(np.int32)
    sprank = r.integers(0, 10000, p).astype(np.int32)
    want = jax_splitter_aggregate(
        jnp.asarray(packed), jnp.asarray(sprank), impl="pallas", block_n=512
    )
    got = splitter_aggregate(_t(packed), _t(sprank))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_drop_scatter_min_matches_jax_drop_mode():
    r = np.random.default_rng(3)
    n = 40
    target = r.integers(0, n, n).astype(np.int32)
    idx = r.integers(0, n + 1, 200).astype(np.int32)  # n is the drop lane
    val = r.integers(0, n, 200).astype(np.int32)
    want = jnp.asarray(target).at[jnp.asarray(idx)].min(
        jnp.asarray(val), mode="drop"
    )
    got = drop_scatter_min(_t(target), _t(idx), _t(val))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_on_cpu_run_the_plain_version_without_launching():
    before = dict(launch_counts)
    x = torch.arange(8, dtype=torch.int32)
    edge_hook(x, x, x, torch.zeros(8, dtype=torch.int32), 1, mode="sv3")
    pointer_jump(x, torch.ones(8, dtype=torch.int32))
    splitter_aggregate(torch.zeros((8, 2), dtype=torch.int32), x)
    assert launch_counts == before


@pytest.mark.parametrize("wrapper", ["edge_hook", "pointer_jump", "splitter_aggregate"])
def test_impl_cuda_on_cpu_tensors_raises(wrapper):
    x = torch.arange(8, dtype=torch.int32)
    calls = {
        "edge_hook": lambda: edge_hook(x, x, x, x, 1, mode="sv2", impl="cuda"),
        "pointer_jump": lambda: pointer_jump(x, x, impl="cuda"),
        "splitter_aggregate": lambda: splitter_aggregate(
            torch.zeros((8, 2), dtype=torch.int32), x, impl="cuda"),
    }
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        calls[wrapper]()


def test_resolve_impl_rejects_unknown_names():
    x = torch.zeros(1)
    assert resolve_impl("auto", x) == "torch"
    assert resolve_impl("torch", x) == "torch"
    with pytest.raises(ValueError, match="unknown impl 'pallas'"):
        resolve_impl("pallas", x)
    with pytest.raises(ValueError, match="unknown mode"):
        edge_hook(x, x, x, x, 1, mode="sv4")
