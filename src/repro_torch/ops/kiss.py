"""Marsaglia-Zaman KISS random number generator (paper section 3.2).

The port's own copy of ``repro.ops.kiss``: numpy only, and bit-for-bit
the same streams and generator outputs (``tests/test_torch_kiss.py``
holds the two against each other). It is copied rather than imported
because importing ``repro.ops`` imports jax.

The paper uses KISS both inside the GPU kernels (splitter selection) and to
generate all experimental inputs, because it needs only 32/64-bit integer
ops. We reproduce it exactly: a lag-1 multiply-with-carry pair + xorshift +
LCG, all uint32. A vectorized variant gives every "PRAM thread" its own
stream, as on the GPU.

Data generators for the paper's experiment families (random linked lists,
k-ary tree graphs, random graphs of density d, list graphs) live here too so
benchmarks and tests share one input distribution.
"""
from __future__ import annotations

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)


class KissRng:
    """Scalar/vector KISS99 over numpy uint32 state.

    state per stream: (z, w, jsr, jcong). All arithmetic mod 2^32.
    """

    def __init__(self, seed: int, n_streams: int = 1):
        # Seed-expand with splitmix-style mixing so distinct seeds/streams
        # decorrelate; the generator itself is pure KISS.
        base = (int(seed) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        s = np.arange(n_streams, dtype=np.uint64) + np.uint64(base)
        def mix(x: np.ndarray, c: int) -> np.ndarray:
            x = (x + np.uint64(c)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            x ^= x >> np.uint64(30)
            x = (x * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(
                0xFFFFFFFFFFFFFFFF
            )
            x ^= x >> np.uint64(27)
            return x

        self.z = ((mix(s, 1) & _M32) | np.uint64(1)).astype(np.uint32)
        self.w = ((mix(s, 2) & _M32) | np.uint64(1)).astype(np.uint32)
        self.jsr = ((mix(s, 3) & _M32) | np.uint64(1)).astype(np.uint32)
        self.jcong = (mix(s, 4) & _M32).astype(np.uint32)

    def next_u32(self) -> np.ndarray:
        """One KISS step per stream -> uint32 array of shape (n_streams,)."""
        with np.errstate(over="ignore"):
            z = self.z.astype(np.uint64)
            w = self.w.astype(np.uint64)
            z = (np.uint64(36969) * (z & np.uint64(65535)) + (z >> np.uint64(16)))
            w = (np.uint64(18000) * (w & np.uint64(65535)) + (w >> np.uint64(16)))
            self.z = (z & _M32).astype(np.uint32)
            self.w = (w & _M32).astype(np.uint32)
            mwc = ((z << np.uint64(16)) + w) & _M32

            jsr = self.jsr
            jsr = jsr ^ (jsr << np.uint32(17))
            jsr = jsr ^ (jsr >> np.uint32(13))
            jsr = jsr ^ (jsr << np.uint32(5))
            self.jsr = jsr

            jcong = (
                np.uint64(69069) * self.jcong.astype(np.uint64) + np.uint64(1234567)
            ) & _M32
            self.jcong = jcong.astype(np.uint32)

            return ((mwc ^ jcong) + jsr.astype(np.uint64) & _M32).astype(np.uint32)

    def uniform_ints(self, shape: tuple[int, ...], bound: int) -> np.ndarray:
        """Uniform ints in [0, bound) of the requested shape (row-major)."""
        total = int(np.prod(shape))
        n = self.z.shape[0]
        steps = -(-total // n)
        out = np.empty(steps * n, dtype=np.uint32)
        for i in range(steps):
            out[i * n : (i + 1) * n] = self.next_u32()
        return (out[:total] % np.uint32(bound)).astype(np.int64).reshape(shape)


# ---------------------------------------------------------------------------
# Experiment input families (paper sections 3.3 / 4).
# ---------------------------------------------------------------------------


def random_linked_list(n: int, seed: int = 0) -> np.ndarray:
    """succ[] for a random list over n nodes; node 0 is the head.

    Random order is derived from KISS keys (argsort), matching the paper's
    "completely random" lists whose traversal defeats coalescing. The last
    node satisfies succ[last] = last.
    """
    rng = KissRng(seed, n_streams=min(n, 8192))
    keys = rng.uniform_ints((n - 1,), 1 << 31) if n > 1 else np.empty(0)
    order = np.empty(n, dtype=np.int64)
    order[0] = 0
    if n > 1:
        rest = 1 + np.argsort(keys, kind="stable")
        order[1:] = rest
    succ = np.empty(n, dtype=np.int32)
    succ[order[:-1]] = order[1:]
    succ[order[-1]] = order[-1]
    return succ


def list_graph(n: int, num_lists: int, seed: int = 0) -> np.ndarray:
    """Edge list (m, 2) of `num_lists` disjoint random chains over n nodes."""
    rng = KissRng(seed, n_streams=min(n, 8192))
    keys = rng.uniform_ints((n,), 1 << 31)
    order = np.argsort(keys, kind="stable")
    pieces = np.array_split(order, num_lists)
    edges = [np.stack([p[:-1], p[1:]], axis=1) for p in pieces if len(p) > 1]
    return np.concatenate(edges, axis=0).astype(np.int32)


def tree_graph(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Edge list of a random tree with max branching factor k.

    Built as a complete k-ary tree under a KISS-random relabeling, which is
    the paper's "random trees of degree k" family (diameter ~ log_k n).
    """
    rng = KissRng(seed, n_streams=min(n, 8192))
    keys = rng.uniform_ints((n,), 1 << 31)
    relabel = np.argsort(keys, kind="stable").astype(np.int32)
    child = np.arange(1, n, dtype=np.int64)
    parent = (child - 1) // k
    return np.stack([relabel[parent], relabel[child]], axis=1).astype(np.int32)


def random_graph(n: int, density: float, seed: int = 0) -> np.ndarray:
    """Edge list of an Erdos-Renyi-style graph with edge density `density`.

    m = density * n * (n-1) / 2 endpoints drawn i.i.d. from KISS (possible
    duplicate/self edges, as in the paper's generator; connectivity treats
    them harmlessly).
    """
    m = max(1, int(density * n * (n - 1) / 2))
    rng = KissRng(seed, n_streams=8192)
    ends = rng.uniform_ints((m, 2), n)
    return ends.astype(np.int32)


def random_forest(
    n: int, num_components: int, avg_degree: int = 3, seed: int = 0
) -> np.ndarray:
    """Random components: spanning chains + extra random intra-comp edges."""
    rng = KissRng(seed, n_streams=8192)
    keys = rng.uniform_ints((n,), 1 << 31)
    order = np.argsort(keys, kind="stable")
    comps = np.array_split(order, num_components)
    edges = []
    for ci, nodes in enumerate(comps):
        if len(nodes) < 2:
            continue
        edges.append(np.stack([nodes[:-1], nodes[1:]], axis=1))
        extra = max(0, (avg_degree - 2) * len(nodes) // 2)
        if extra:
            idx = KissRng(seed * 7919 + ci, 4096).uniform_ints(
                (extra, 2), len(nodes)
            )
            edges.append(nodes[idx])
    return np.concatenate(edges, axis=0).astype(np.int32)


def giant_dust_graph(
    n: int, giant_frac: float = 0.9, seed: int = 0
) -> np.ndarray:
    """One giant component plus dust: a single KISS-random chain over
    ``giant_frac`` of the nodes (worst-case diameter, so SV needs its
    full O(log n) rounds on it), the rest isolated singletons. The
    skewed-component-size family connectivity studies use to show
    sampling / frontier skipping wins (most edges stop mattering after
    the giant's labels coalesce)."""
    g = max(2, int(n * giant_frac))
    return list_graph(g, 1, seed=seed)  # nodes [g, n) stay isolated dust
