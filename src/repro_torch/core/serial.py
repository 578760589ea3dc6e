"""Sequential oracles for connected components and list ranking.

The port's copy of the CC and list-ranking parts of
``repro.core.serial`` (numpy only): the paper's CPU baselines, used by
the tests. They are Python loops, so they suit small inputs only.
"""
from __future__ import annotations

import numpy as np


def serial_list_rank(succ: np.ndarray, head: int = 0) -> np.ndarray:
    """O(n) single-thread traversal (the paper's sequential CPU baseline).

    rank[j] = number of edges from j to the last element (rank[last] = 0).
    """
    n = len(succ)
    order = np.empty(n, dtype=np.int64)
    j = head
    for i in range(n):
        order[i] = j
        nxt = succ[j]
        if nxt == j:
            assert i == n - 1, "list does not cover all nodes"
            break
        j = nxt
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n - 1, -1, -1)
    return rank


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def serial_connected_components(edges: np.ndarray, n: int) -> np.ndarray:
    """Union-find labels; canonical label = min node id in the component."""
    uf = UnionFind(n)
    for a, b in edges:
        uf.union(int(a), int(b))
    return np.array([uf.find(i) for i in range(n)], dtype=np.int64)


def canonicalize_labels(labels: np.ndarray) -> np.ndarray:
    """Map each component label to the min node id inside it (for equality
    testing across algorithms that pick different representatives)."""
    labels = np.asarray(labels)
    n = len(labels)
    rep: dict[int, int] = {}
    for i in range(n):
        l = int(labels[i])
        if l not in rep:
            rep[l] = i
    return np.array([rep[int(l)] for l in labels], dtype=np.int64)
