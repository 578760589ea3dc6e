"""Graph datasets of the port: ``full_graph``, ``molecule_batch``,
``random_tree`` and ``random_tree_forest``, the port's copies of
``repro/data/graphs.py``.

They run on the port's KISS (``ops/kiss.py``), which is bit-identical
to the reference's, so the same seed gives both packages the same
arrays (``tests/test_torch_gnn.py`` and ``tests/test_torch_trees.py``
hold them equal bit for bit). The GNN graphs' edges are returned SORTED
BY DESTINATION (stable), so a GNN forward
sums every aggregation with the ``segment_sum`` kernel without sorting
again. Everything is numpy on the host; ``forward`` moves the arrays
to its parameters' device. ``sampled_minibatch`` needs the neighbor
sampler and waits for it (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import numpy as np

from repro_torch.ops.kiss import KissRng


def _sort_by_dst(src: np.ndarray, dst: np.ndarray):
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def full_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    num_classes: int = 7,
    *,
    with_positions: bool = False,
    num_species: int = 10,
    seed: int = 0,
) -> dict:
    """Cora-like / products-like full-batch node-classification graph."""
    rng = KissRng(seed, 8192)
    ends = rng.uniform_ints((n_edges, 2), n_nodes)
    src, dst = _sort_by_dst(
        ends[:, 0].astype(np.int32), ends[:, 1].astype(np.int32)
    )
    del ends
    feats = (
        rng.uniform_ints((n_nodes, d_feat), 1000).astype(np.float32) / 500.0 - 1.0
    )
    g = {
        "node_feats": feats,
        "src": src,
        "dst": dst,
        "labels": rng.uniform_ints((n_nodes,), num_classes).astype(np.int32),
        "graph_ids": np.zeros(n_nodes, np.int32),
        "num_graphs": 1,
    }
    if with_positions:
        g["positions"] = (
            rng.uniform_ints((n_nodes, 3), 2000).astype(np.float32) / 100.0
        )
        g["species"] = rng.uniform_ints((n_nodes,), num_species).astype(np.int32)
    return g


def molecule_batch(
    batch: int,
    nodes_per_graph: int = 30,
    edges_per_graph: int = 64,
    d_feat: int = 16,
    num_species: int = 10,
    seed: int = 0,
) -> dict:
    """Batched small molecules (one disjoint-union graph)."""
    rng = KissRng(seed, 4096)
    n = batch * nodes_per_graph
    m = batch * edges_per_graph
    ends = rng.uniform_ints((m, 2), nodes_per_graph)
    offs = np.repeat(
        np.arange(batch, dtype=np.int64) * nodes_per_graph, edges_per_graph
    )
    src, dst = _sort_by_dst(
        (ends[:, 0] + offs).astype(np.int32), (ends[:, 1] + offs).astype(np.int32)
    )
    return {
        "node_feats": rng.uniform_ints((n, d_feat), 1000).astype(np.float32)
        / 500.0
        - 1.0,
        "positions": rng.uniform_ints((n, 3), 2000).astype(np.float32) / 200.0,
        "species": rng.uniform_ints((n,), num_species).astype(np.int32),
        "src": src,
        "dst": dst,
        "labels": rng.uniform_ints((batch,), 1000).astype(np.float32) / 500.0 - 1.0,
        "graph_ids": np.repeat(
            np.arange(batch, dtype=np.int32), nodes_per_graph
        ),
        "num_graphs": batch,
    }


def random_tree(n: int, seed: int = 0) -> np.ndarray:
    """Edge list (n-1, 2) of a uniform-attachment random tree.

    Node i > 0 attaches to a KISS-uniform earlier node, then the whole
    tree is KISS-relabeled so node ids carry no structure (the
    ``repro_torch.trees`` input family: expected depth O(log n)).
    """
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    rng = KissRng(seed, n_streams=min(max(n, 1), 8192))
    if n == 1:
        return np.zeros((0, 2), np.int32)
    draws = rng.uniform_ints((n - 1,), 1 << 31)
    child = np.arange(1, n, dtype=np.int64)
    parent = draws % child  # uniform in [0, i) for node i
    keys = rng.uniform_ints((n,), 1 << 31)
    relabel = np.argsort(keys, kind="stable").astype(np.int32)
    return np.stack([relabel[parent], relabel[child]], axis=1).astype(np.int32)


def random_tree_forest(n: int, num_trees: int, seed: int = 0) -> np.ndarray:
    """Edge list of ``num_trees`` disjoint uniform-attachment random
    trees over n nodes (KISS-random node partition): the batched
    many-small-trees workload, served in one padded tour. One
    ``random_tree`` per tree, in a host loop."""
    rng = KissRng(seed, n_streams=min(max(n, 1), 8192))
    keys = rng.uniform_ints((n,), 1 << 31)
    order = np.argsort(keys, kind="stable")
    pieces = np.array_split(order, max(num_trees, 1))
    edges = []
    for ci, nodes in enumerate(pieces):
        if len(nodes) < 2:
            continue
        local = random_tree(len(nodes), seed=seed * 7919 + ci + 1)
        edges.append(nodes[local])
    if not edges:
        return np.zeros((0, 2), np.int32)
    return np.concatenate(edges, axis=0).astype(np.int32)
