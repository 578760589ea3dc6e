"""The port's neighbor sampler and the data builders that came with it,
against ``repro`` on the CPU, bit for bit: ``edges_to_csr``, ``NeighborSampler.sample_hop`` and
``sample_multihop``, ``sampled_minibatch`` at the reference test's size
(``tests/test_gnn.py``), and ``random_succ``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import graphs as jax_graphs  # noqa: E402
from repro.ops import neighbor_sampler as jax_ns  # noqa: E402
from repro.ops.kiss import random_graph as jax_random_graph  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.ops import neighbor_sampler as ns  # noqa: E402



def _eq(got, want, what=""):
    np.testing.assert_array_equal(got, want, err_msg=what)
    assert np.asarray(got).dtype == np.asarray(want).dtype, what


@pytest.mark.parametrize("n,density,seed", [
    (50, 0.2, 0), (400, 0.03, 3), (1, 1.0, 1),
    (2, 1.0, 0), (1000, 0.01, 7), (300, 0.5, 2),
])
def test_edges_to_csr_equals_the_reference(n, density, seed):
    edges = jax_random_graph(n, density, seed)
    got = ns.edges_to_csr(edges, n)
    want = jax_ns.edges_to_csr(edges, n)
    for g, w, what in zip(got, want, ("indptr", "indices")):
        _eq(g, w, what)


def test_edges_to_csr_with_isolated_nodes():
    edges = np.array([[0, 3], [3, 0], [5, 5]], np.int32)
    got = ns.edges_to_csr(edges, 9)
    want = jax_ns.edges_to_csr(edges, 9)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def _samplers(n, density, seed):
    edges = jax_random_graph(n, density, seed)
    indptr, indices = jax_ns.edges_to_csr(edges, n)
    return (ns.NeighborSampler(indptr, indices, seed=seed + 1),
            jax_ns.NeighborSampler(indptr, indices, seed=seed + 1))


def _same_block(got, want):
    for key in ("dst_nodes", "src_nodes", "dst_index"):
        _eq(getattr(got, key), getattr(want, key), key)


@pytest.mark.parametrize("fanout", [1, 4, 15])
def test_sample_hop_equals_the_reference(fanout):
    port, ref = _samplers(300, 0.02, 2)
    nodes = np.arange(0, 300, 7, dtype=np.int64)
    for _ in range(3):  # the streams advance alike
        _same_block(port.sample_hop(nodes, fanout), ref.sample_hop(nodes, fanout))


def test_sample_hop_on_a_graph_without_edges():
    indptr, indices = np.zeros(6, np.int64), np.zeros(0, np.int32)
    nodes = np.array([0, 4, 2], np.int64)
    got = ns.NeighborSampler(indptr, indices).sample_hop(nodes, 3)
    _same_block(got, jax_ns.NeighborSampler(indptr, indices).sample_hop(nodes, 3))
    _eq(got.src_nodes, np.repeat(nodes, 3).astype(np.int32))  # self-loops


@pytest.mark.parametrize("fanouts", [[3, 2], [15, 10], [5]])
def test_sample_multihop_equals_the_reference(fanouts):
    port, ref = _samplers(500, 0.025, 5)
    seeds = np.array([3, 17, 256, 499, 3], np.int64)
    got, want = port.sample_multihop(seeds, fanouts), ref.sample_multihop(seeds, fanouts)
    assert len(got) == len(want) == len(fanouts)
    for g, w in zip(got, want):
        _same_block(g, w)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=500, n_edges=3000, d_feat=8, batch_nodes=16, fanouts=[3, 2]),
    dict(n_nodes=2000, n_edges=20000, d_feat=5, batch_nodes=64, fanouts=[15, 10],
         num_classes=7, seed=4),
    dict(n_nodes=300, n_edges=900, d_feat=3, batch_nodes=32, fanouts=[5],
         num_classes=3, seed=1),
    dict(n_nodes=1000, n_edges=5000, d_feat=4, batch_nodes=8, fanouts=[4, 3, 2],
         num_classes=11, seed=2),
])
def test_sampled_minibatch_equals_the_reference(kw):
    got = graphs.sampled_minibatch(**kw)
    want = jax_graphs.sampled_minibatch(**kw)
    assert got.keys() == want.keys()
    for key in want:
        _eq(got[key], want[key], key)
    assert np.all(np.diff(got["dst"]) >= 0)  # sorted by destination
    assert (got["labels"] >= 0).sum() <= kw["batch_nodes"]


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 5), (1000, 0), (20_000, 0), (777, 9)])
def test_random_succ_equals_the_reference(n, seed):
    got = graphs.random_succ(n, seed=seed)
    _eq(got, jax_graphs.random_succ(n, seed=seed))
    # one list from node 0, ending in a self-loop
    seen, node = 0, 0
    while got[node] != node:
        node, seen = got[node], seen + 1
    assert seen == n - 1
