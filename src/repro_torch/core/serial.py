"""Sequential oracles: the paper's CPU baselines.

The port's copy of ``repro.core.serial`` (numpy only): connected
components, list ranking, SSSP (Dijkstra, Bellman-Ford and the parent
rule) and PageRank. The tests and ``chip_smoke.py`` hold the port to
them. Most are Python loops, so they suit small inputs only;
``serial_pagerank`` is vectorised and runs at full size.
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


def _sssp_arcs(edges: np.ndarray, weights: np.ndarray | None):
    """Both-orientation (u, v, w) arcs in float32 -- the engines'
    undirected 2m walk. ``weights=None`` means unit weights (BFS)."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    m = len(edges)
    w = (
        np.ones(m, np.float32)
        if weights is None
        else np.asarray(weights, np.float32).ravel()
    )
    assert len(w) == m, "weights length != edge count"
    u = np.concatenate([edges[:, 0], edges[:, 1]])
    v = np.concatenate([edges[:, 1], edges[:, 0]])
    return u, v, np.concatenate([w, w])


def serial_sssp_parents(
    edges: np.ndarray,
    weights: np.ndarray | None,
    dist: np.ndarray,
    source: int,
) -> np.ndarray:
    """The engines' deterministic parent rule, serially: ``parent[v] =
    min{u : u != v, dist[u] + w(u, v) == dist[v]}`` (float32 compare,
    both edge orientations), ``parent[source] = source``, unreachable
    ``-1``. Shared by both oracles so the tie-break matches
    ``repro_torch.core.sssp._min_parents`` bit-for-bit."""
    n = len(dist)
    u, v, w = _sssp_arcs(edges, weights)
    parent = np.full(n, n, np.int64)
    for ui, vi, wi in zip(u, v, w):
        if ui == vi:
            continue  # self-relaxes never parent (engine rule)
        if np.float32(dist[ui] + wi) == dist[vi]:
            parent[vi] = min(parent[vi], ui)
    parent[parent == n] = -1
    parent[np.isinf(dist)] = -1
    parent[source] = source
    return parent.astype(np.int64)


def serial_dijkstra(
    edges: np.ndarray,
    weights: np.ndarray | None,
    n: int,
    source: int,
):
    """Binary-heap Dijkstra in float32 (the sequential CPU baseline for
    ``repro_torch.core.sssp``; weights must be >= 0). Returns ``(dist,
    parent)``: float32 distances with ``+inf`` for unreachable nodes,
    parents per ``serial_sssp_parents``. Float32 addition is monotonic
    and every path cost accumulates left-to-right one edge at a time --
    the same operations the relax-min engines perform -- so distances
    are bit-identical to Bellman-Ford's fixpoint."""
    import heapq

    u, v, w = _sssp_arcs(edges, weights)
    adj: list[list[tuple[int, np.float32]]] = [[] for _ in range(n)]
    for ui, vi, wi in zip(u, v, w):
        adj[ui].append((int(vi), wi))
    dist = np.full(n, np.inf, np.float32)
    dist[source] = np.float32(0.0)
    heap = [(np.float32(0.0), source)]
    done = np.zeros(n, bool)
    while heap:
        d, x = heapq.heappop(heap)
        if done[x]:
            continue
        done[x] = True
        for y, wy in adj[x]:
            nd = np.float32(dist[x] + wy)
            if nd < dist[y]:
                dist[y] = nd
                heapq.heappush(heap, (nd, y))
    return dist, serial_sssp_parents(edges, weights, dist, source)


def serial_bellman_ford(
    edges: np.ndarray,
    weights: np.ndarray | None,
    n: int,
    source: int,
):
    """Round-synchronous serial Bellman-Ford in float32: relax every
    arc each round until the fixpoint (at most n - 1 improving rounds).
    Returns ``(dist, parent)`` exactly like ``serial_dijkstra`` -- the
    two oracles agree bit-for-bit, and both pin the engines."""
    u, v, w = _sssp_arcs(edges, weights)
    dist = np.full(n, np.inf, np.float32)
    dist[source] = np.float32(0.0)
    for _ in range(max(n, 1)):
        cand = (dist[u] + w).astype(np.float32)
        new = dist.copy()
        np.minimum.at(new, v, cand)
        if (new == dist).all():
            break
        dist = new
    return dist, serial_sssp_parents(edges, weights, dist, source)


def serial_pagerank(
    edges: np.ndarray,
    weights: np.ndarray | None,
    n: int,
    *,
    damping: float = 0.85,
    num_iters: int,
    teleport: np.ndarray | None = None,
) -> np.ndarray:
    """NumPy mirror of ``repro_torch.core.pagerank`` at a fixed iteration
    count: the exact float32 op sequence -- separately-rounded
    multiplies, teleport as the scatter BASE, ``np.add.at``
    accumulation in edge-slot order (which the port's ``ADD`` monoid
    keeps through the ``ordered_fold`` kernel) -- so scores pin both device engines
    bit-for-bit, iteration for iteration. ``weights=None`` means unit
    weights; dangling mass leaks exactly like the engines'."""
    u, v, w = _sssp_arcs(edges, weights)
    dmp = np.float32(damping)
    omd = np.float32(1.0) - dmp
    t = (
        np.full(n, 1.0 / n, np.float32)
        if teleport is None
        else np.asarray(teleport, np.float32).ravel()
    )
    deg = np.zeros(n, np.float32)
    np.add.at(deg, u, w)
    r = t.copy()
    for _ in range(num_iters):
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(deg > 0, r / deg, np.float32(0.0)).astype(
                np.float32
            )
        r = (omd * t).astype(np.float32)
        np.add.at(r, v, (dmp * (out[u] * w)).astype(np.float32))
    return r


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
