"""Quickstart on the PyTorch port: the paper's two algorithms through the
public API of ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py [--n 2000000] [--device cpu]

Generates a KISS-random linked list and graph (as in the paper's
experiments), ranks the list with both Wylie pointer jumping and the
parallel random-splitter algorithm (SoA vs AoS packing -- the 48/64-bit
experiment), labels components with Shiloach-Vishkin, and verifies
everything against the port's own serial oracles (``core/serial.py``,
``trees/reference.py``). Runs on the CUDA card unless ``--device``
names another.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    num_components,
    random_splitter_rank,
    shiloach_vishkin,
    sv_round_bound,
    tree_analytics,
    wylie_rank,
)
from repro_torch.core.serial import (
    canonicalize_labels,
    serial_connected_components,
    serial_list_rank,
)
from repro_torch.ops.kiss import random_forest, random_linked_list
from repro_torch.trees.reference import serial_tree_reference


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--splitters", type=int, default=4096)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = args.device

    print(f"== list ranking, n={args.n:,} ==")
    succ = random_linked_list(args.n, seed=1)

    t0 = time.perf_counter()
    r_wylie = _host(wylie_rank(succ, device=dev))
    t_wylie = time.perf_counter() - t0
    print(f"wylie (O(n log n) work):          {t_wylie*1e3:8.1f} ms")

    for pm, label in (("soa", "SoA ('48-bit')"), ("aos", "AoS ('64-bit')")):
        t0 = time.perf_counter()
        r_split, stats = random_splitter_rank(
            succ, args.splitters, seed=2, pack_mode=pm, with_stats=True,
            device=dev,
        )
        r_split = _host(r_split)
        dt = time.perf_counter() - t0
        print(
            f"random splitter {label}: {dt*1e3:8.1f} ms  "
            f"(p={args.splitters}, max sub-list {_host(stats.sublist_lengths).max()}, "
            f"mean {stats.expected_mean:.0f})"
        )
        assert (r_split == r_wylie).all()

    if args.n <= 2_000_000:
        ref = serial_list_rank(succ)
        assert (r_wylie == ref).all()
        print("verified against serial traversal")

    print("\n== connected components ==")
    n = min(args.n, 500_000)
    edges = random_forest(n, num_components=40, seed=3)
    t0 = time.perf_counter()
    labels, rounds = shiloach_vishkin(edges[:, 0], edges[:, 1], n, device=dev)
    labels = _host(labels)
    dt = time.perf_counter() - t0
    print(
        f"shiloach-vishkin: {dt*1e3:8.1f} ms  rounds={int(rounds)} "
        f"(bound {sv_round_bound(n)})  components={num_components(labels)}"
    )
    ref = canonicalize_labels(serial_connected_components(edges, n))
    assert (canonicalize_labels(labels) == ref).all()
    print("verified against union-find")

    print("\n== euler-tour tree analytics (the two primitives composed) ==")
    t0 = time.perf_counter()
    ta = tree_analytics(edges[:, 0], edges[:, 1], n, device=dev)
    depth = _host(ta.depth)
    dt = time.perf_counter() - t0
    sizes = _host(ta.subtree_size)
    parent = _host(ta.parent)
    roots = parent == np.arange(n)
    print(
        f"forest -> tour -> computations: {dt*1e3:8.1f} ms  "
        f"(trees={ta.forest.num_trees}, arcs={ta.tour.num_arcs}, "
        f"max depth={depth.max()}, largest tree={sizes[roots].max()})"
    )
    ref = serial_tree_reference(_host(ta.forest.edge_u), _host(ta.forest.edge_v), n)
    assert (depth == ref["depth"]).all() and (parent == ref["parent"]).all()
    print("verified against serial Euler walk")


if __name__ == "__main__":
    main()
