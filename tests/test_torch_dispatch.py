"""The port's public entry points against ``repro.core`` on the CPU:
the same dispatch rules and the same results (the sharded engines on a
one-rank gloo group against the reference's one-device mesh), and no
quiet fallback to the CPU."""
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


def _meshes():
    """A one-rank gloo mesh of the port and the reference's one-device
    mesh."""
    from repro.distributed.graph import graph_mesh as ref_mesh
    from repro_torch.distributed import graph_mesh

    return graph_mesh(1, device="cpu"), ref_mesh(1)


@pytest.mark.parametrize(
    "kwargs",
    [{"engine": "sharded_frontier"}, {"mesh": "graph_mesh(1)"},
     {"exchange": "sparse"}, {"sparse_capacity": 8}, {"axis": "graph"}],
)
def test_sharded_paths_are_not_ported(kwargs):
    """Each sharded trigger reaches a sharded engine, as in the
    reference, and gives the reference's labels and rounds (with the
    sharded frontier engine's stats where it runs)."""
    e, n = _cc_case("sparse")
    port_kw, ref_kw = dict(kwargs), dict(kwargs)
    if "mesh" in kwargs:
        port_kw["mesh"], ref_kw["mesh"] = _meshes()
    want = ref.connected_components(
        e[:, 0], e[:, 1], n, with_stats=True, **ref_kw
    )
    got = port.connected_components(
        e[:, 0], e[:, 1], n, device="cpu", with_stats=True, **port_kw
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == int(want[1])
    assert type(got[2]).__name__ == type(want[2]).__name__
    for f, w in vars(want[2]).items():
        np.testing.assert_array_equal(np.asarray(getattr(got[2], f)),
                                      np.asarray(w), err_msg=f)


def test_sharded_dispatch_rejects_what_the_reference_rejects():
    mesh, rmesh = _meshes()
    e, n = _cc_case("sparse")
    for fn, m in ((port.connected_components, mesh),
                  (ref.connected_components, rmesh)):
        kw = {"device": "cpu"} if fn is port.connected_components else {}
        with pytest.raises(ValueError, match="single-device frontier"):
            fn(e[:, 0], e[:, 1], n, mesh=m, sample_rounds=2, **kw)
        with pytest.raises(ValueError, match="frontier engine is single"):
            fn(e[:, 0], e[:, 1], n, mesh=m, engine="frontier", **kw)
        with pytest.raises(ValueError, match="sharded-engine options"):
            fn(e[:, 0], e[:, 1], n, engine="frontier", exchange="dense", **kw)
        with pytest.raises(ValueError, match="needs engine='sharded_frontier'"):
            fn(e[:, 0], e[:, 1], n, mesh=m, engine="dense",
               hook_impl="auto", **kw)
        with pytest.raises(ValueError, match="unknown exchange"):
            fn(e[:, 0], e[:, 1], n, mesh=m, exchange="ring", **kw)


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
    # mesh= reaches the sharded ranker: the reference's ranks and stats
    mesh, rmesh = _meshes()
    succ = kiss.random_linked_list(1001, seed=8)
    want, want_st = ref.list_rank(succ, 30, mesh=rmesh, with_stats=True)
    got, got_st = port.list_rank(succ, 30, mesh=mesh, with_stats=True,
                                 device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_st.sublist_lengths,
                                  want_st.sublist_lengths)
    assert got_st.walk_steps == want_st.walk_steps
    for fn, m in ((port.list_rank, mesh), (ref.list_rank, rmesh)):
        with pytest.raises(ValueError, match="single-device options"):
            fn(succ, mesh=m, pack_mode="soa")


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
    # A mesh goes to the card too unless the CPU is asked for.
    from repro_torch.distributed import graph_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graph_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.connected_components(e[:, 0], e[:, 1], 2,
                                  engine="sharded_frontier")
    # Asking for the CPU, or handing over CPU tensors, is explicit.
    labels, _ = port.connected_components(e[:, 0], e[:, 1], 2, device="cpu")
    assert labels.tolist() == [0, 0]
    rank = port.list_rank(torch.tensor([1, 1], dtype=torch.int32))
    assert rank.tolist() == [1, 0]
