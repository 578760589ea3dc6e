"""The port's public entry points against ``repro.core`` on the CPU:
the same dispatch rules and the same results, unported paths that
raise, and no quiet fallback to the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro.ops import kiss  # noqa: E402


def _cc_case(name):
    if name == "sparse":
        return kiss.giant_dust_graph(2000, seed=1), 2000
    # m/n >= AUTO_SAMPLE_DENSITY: the auto rule turns sampling on
    return kiss.random_graph(250, 0.08, seed=2), 250


@pytest.mark.parametrize("name", ["sparse", "dense_graph"])
@pytest.mark.parametrize(
    "kwargs",
    [{}, {"engine": "dense"}, {"engine": "frontier", "min_bucket": 64},
     {"sample_rounds": 0}],
    ids=["auto", "dense", "frontier", "no_sampling"],
)
def test_connected_components_matches_reference(name, kwargs):
    e, n = _cc_case(name)
    want_l, want_r = ref.connected_components(e[:, 0], e[:, 1], n, **kwargs)
    got_l, got_r = port.connected_components(
        e[:, 0], e[:, 1], n, device="cpu", **kwargs
    )
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_r == int(want_r)


def test_auto_rule_samples_dense_graphs_only():
    for name, want in [("sparse", 0), ("dense_graph", port.AUTO_SAMPLE_ROUNDS)]:
        e, n = _cc_case(name)
        *_, stats = port.connected_components(
            e[:, 0], e[:, 1], n, with_stats=True, device="cpu"
        )
        assert stats.sample_rounds == want
    assert port.AUTO_SAMPLE_DENSITY == ref.AUTO_SAMPLE_DENSITY
    assert port.AUTO_SAMPLE_ROUNDS == ref.AUTO_SAMPLE_ROUNDS


@pytest.mark.parametrize(
    "kwargs",
    [{"engine": "sharded_frontier"}, {"mesh": object()},
     {"exchange": "sparse"}, {"sparse_capacity": 8}, {"axis": "graph"}],
)
def test_sharded_paths_are_not_ported(kwargs):
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        port.connected_components([0], [1], 2, device="cpu", **kwargs)


def test_connected_components_rejects_bad_choices():
    with pytest.raises(ValueError, match="unknown engine 'sharded'"):
        port.connected_components([0], [1], 2, engine="sharded", device="cpu")
    with pytest.raises(ValueError, match="frontier-engine options"):
        port.connected_components(
            [0], [1], 2, engine="dense", sample_rounds=1, device="cpu"
        )


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"pack_mode": "soa"}, {"pack_mode": "word64", "seed": 3},
     {"kernel_impl": "torch", "head": 0}],
)
def test_list_rank_matches_reference(kwargs):
    succ = kiss.random_linked_list(3000, seed=8)
    ref_kwargs = dict(kwargs)
    if "kernel_impl" in ref_kwargs:
        ref_kwargs["kernel_impl"] = "xla"
    want = ref.list_rank(succ, 50, **ref_kwargs)
    got = port.list_rank(succ, 50, device="cpu", **kwargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_list_rank_rejects_bad_choices_and_meshes():
    with pytest.raises(ValueError, match="unknown kernel_impl 'xla'"):
        port.list_rank([0], kernel_impl="xla", device="cpu")
    with pytest.raises(ValueError, match="unknown pack_mode 'bits'"):
        port.list_rank([0], pack_mode="bits", device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        port.list_rank([0], mesh=object(), device="cpu")


def test_no_quiet_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = np.array([[0, 1]], np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.connected_components(e[:, 0], e[:, 1], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.connected_components(e[:, 0], e[:, 1], 2, engine="dense")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.list_rank(np.array([1, 1], np.int32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.wylie_rank(np.array([1, 1], np.int32))
    # Asking for the CPU, or handing over CPU tensors, is explicit.
    labels, _ = port.connected_components(e[:, 0], e[:, 1], 2, device="cpu")
    assert labels.tolist() == [0, 0]
    rank = port.list_rank(torch.tensor([1, 1], dtype=torch.int32))
    assert rank.tolist() == [1, 0]
