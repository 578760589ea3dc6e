"""Tree computations as +-1-weighted ranks over the Euler tour.

The port of ``repro.trees.compute``. Ordering the tour's arcs is a LIST
RANKING call, through the port's engines: ``wylie_rank``, or
``random_splitter_rank`` with its RS4/RS5 phases in the
``pointer_jump`` and ``splitter_aggregate`` kernels (``kernel_impl=``).
Every tree quantity then falls out of dense prefix sums over the ranked
order, the Euler-tour technique:

* an arc is **forward** (discovers its destination) iff it precedes its
  twin in the tour;
* ``parent[v]`` = source of the forward arc into v (``root_tree``);
* ``depth[v]`` = prefix sum of +1 (forward) / -1 (backward) weights at
  that arc;
* ``subtree_size[v]`` = half the (inclusive) span between the forward
  arc and its twin;
* ``preorder``/``postorder`` = prefix counts of forward/backward arcs.

All quantities are exact int32, so they are bit-identical across rank
engines and devices. A forest ranks in ONE multi-list call; per-tree
prefix sums are isolated by construction, and padded capacity slots are
inert self-loops.

JAX's ``.at[...].max(..., mode="drop")`` and ``.set(..., mode="drop")``
become writes into a buffer one row longer, whose last row takes the
dropped lanes and is cut off. The ``.set`` targets (``order`` and
``in_arc``) have no duplicate index among the kept lanes -- ``gpos`` is
a bijection of the valid arcs, and each non-root node has exactly one
forward arc into it -- so plain index assignment is exact there.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.components import check_choice
from repro_torch.core.list_ranking import (
    KERNEL_IMPLS,
    WYLIE_PACK_MODES,
    max_splitters_for_linear_work,
    random_splitter_rank,
    select_splitters,
    wylie_rank,
)
from repro_torch.core.operators import next_pow2
from repro_torch.device import resolve_device
from repro_torch.trees.forest import SpanningForest, spanning_forest
from repro_torch.trees.tour import EulerTour, euler_tour

RANK_ENGINES = ("auto", "wylie", "splitter")


def tour_splitters(
    tour: EulerTour, num_splitters: int | None = None, seed: int = 0
) -> np.ndarray:
    """Splitters for ranking a (multi-list) tour, on the host: every
    tour head plus random extras. Heads MUST be splitters -- a list head
    has no upstream splitter to cover it.

    The set is padded to the next power of two with distinct,
    deterministically chosen extra arc ids, as in the reference, so the
    splitter count takes few values across served forests. A duplicate
    splitter would hand one arc two lanes, so the pad ids are distinct
    from the set."""
    L = tour.capacity
    if tour.num_arcs:
        # mask, don't slice: padded-edge-buffer tours interleave dead
        # self-loop arcs with the real ones (see ``euler_tour``)
        heads = np.unique(
            tour.head_of_arc.cpu().numpy().astype(np.int64)[
                tour.valid.cpu().numpy()
            ]
        )
    else:
        heads = np.zeros((0,), np.int64)
    p = num_splitters or min(4096, max_splitters_for_linear_work(max(L, 2)))
    p = min(max(p, 1), L)
    head0 = int(heads[0]) if len(heads) else 0
    extras = select_splitters(L, p, seed=seed, head=head0)
    spl = np.unique(np.concatenate([heads, extras.astype(np.int64)]))
    target = min(L, next_pow2(len(spl)))
    if target > len(spl):
        pool = np.setdiff1d(np.arange(L, dtype=np.int64), spl)
        spl = np.sort(np.concatenate([spl, pool[: target - len(spl)]]))
    return spl


def tour_ranks(
    tour: EulerTour,
    *,
    rank_engine: str = "auto",
    num_splitters: int | None = None,
    kernel_impl: str = "auto",
    pack_mode: str = "aos",
    seed: int = 0,
    mesh=None,
) -> torch.Tensor:
    """Rank the tour's arcs: rank[j] = arcs from j to its tour's end.

    ``rank_engine="wylie"`` runs pointer jumping, ``"splitter"`` the
    random-splitter engine over ``tour_splitters``: single-device, or the
    sharded engine when a mesh is given or the process group has several
    ranks -- ``repro_torch.core.list_rank``'s convention, including
    ``kernel_impl`` routing RS4/RS5 (``"auto"``: the CUDA kernels for
    tensors on the card, their plain versions on the CPU). ``"auto"``
    picks wylie on one rank and the sharded splitter engine otherwise;
    wylie is single-device, so it rejects ``mesh=``. Ranks are exact
    integers, the same on every route. Every dispatch string is
    validated, including knobs the chosen branch ignores."""
    from repro_torch.core import _multi_rank

    check_choice("rank_engine", rank_engine, RANK_ENGINES)
    check_choice("kernel_impl", kernel_impl, KERNEL_IMPLS)
    check_choice("pack_mode", pack_mode, WYLIE_PACK_MODES)
    multi = mesh is not None or _multi_rank()
    if rank_engine == "auto":
        rank_engine = "splitter" if multi else "wylie"
    if rank_engine == "wylie":
        if mesh is not None:
            raise ValueError(
                "wylie_rank is single-device; drop mesh= or use "
                "rank_engine='splitter'"
            )
        return wylie_rank(tour.succ, pack_mode=pack_mode)
    splitters = tour_splitters(tour, num_splitters=num_splitters, seed=seed)
    if multi:
        from repro_torch.distributed.graph import sharded_random_splitter_rank

        return sharded_random_splitter_rank(
            tour.succ, splitters=splitters, mesh=mesh,
            kernel_impl=kernel_impl, device=tour.succ.device,
        )
    return random_splitter_rank(
        tour.succ, splitters=splitters, kernel_impl=kernel_impl
    )


def _analytics(ranks, arc_src, arc_dst, twin, head_of_arc, valid, root_of,
               *, n):
    """All tree quantities from the arc ranks, in dense prefix ops sized
    by the capacity L. Slots of the order buffer past the real arcs are
    never read (every read position is the ``gpos`` of a real arc,
    below them), and a cumsum prefix does not see entries above it."""
    dev = ranks.device
    L = ranks.shape[0]
    i32 = torch.int32
    ids = torch.arange(L, dtype=i32, device=dev)
    ranks = ranks.to(i32)
    # Position within the arc's own tour (0 on padded slots: their head
    # is themselves).
    pos = ranks[head_of_arc.long()] - ranks

    # Per-tree tour length and the exclusive base offset of each tree in
    # the concatenated (root-id-ordered) global order.
    tree_of_arc = root_of[arc_src.long()]
    tree_len = torch.zeros(n + 1, dtype=i32, device=dev).scatter_reduce_(
        0, torch.where(valid, tree_of_arc, n).long(), pos + 1, "amax",
        include_self=True,
    )[:n]
    base = torch.zeros(n, dtype=i32, device=dev)
    base[1:] = torch.cumsum(tree_len, 0, dtype=i32)[:-1]
    gpos = base[tree_of_arc.long()] + pos  # bijection: valid arcs -> [0, num_arcs)

    fwd = pos < pos[twin.long()]  # forward = discovers its destination

    # The arc in each global tour slot, then the three prefix families:
    # +-1 depth weights, forward counts, backward counts. Depth needs no
    # per-tree correction (each complete tour sums to 0); pre/post
    # subtract their tree-start prefix.
    order = torch.zeros(L + 1, dtype=i32, device=dev)
    order[torch.where(valid, gpos, L).long()] = ids
    w_fwd = fwd[order[:L].long()].to(i32)
    C = torch.cumsum(2 * w_fwd - 1, 0, dtype=i32)
    F = torch.cumsum(w_fwd, 0, dtype=i32)
    B = torch.cumsum(1 - w_fwd, 0, dtype=i32)
    before = (base - 1).clamp(min=0).long()
    F_start = torch.where(base > 0, F[before], 0)
    B_start = torch.where(base > 0, B[before], 0)

    # The unique forward arc into each non-root node, and its twin out.
    in_arc = torch.full((n + 1,), -1, dtype=i32, device=dev)
    in_arc[torch.where(fwd & valid, arc_dst, n).long()] = ids
    in_arc = in_arc[:n]
    has = in_arc >= 0
    ia = in_arc.clamp(min=0).long()
    oa = twin[ia].long()
    nodes = torch.arange(n, dtype=i32, device=dev)
    roots = root_of.long()

    parent = torch.where(has, arc_src[ia], nodes)
    depth = torch.where(has, C[gpos[ia].long()], 0)
    size_sub = torch.where(
        has, torch.div(pos[oa] - pos[ia] + 1, 2, rounding_mode="floor"),
        torch.div(tree_len, 2, rounding_mode="floor") + 1,
    )
    pre = torch.where(has, F[gpos[ia].long()] - F_start[roots], 0)
    post = torch.where(
        has, B[gpos[oa].long()] - B_start[roots] - 1,
        torch.div(tree_len, 2, rounding_mode="floor"),
    )
    return parent, depth, size_sub, pre, post


@dataclass
class TreeComputations:
    """Per-node tree quantities over a (forest) Euler tour; roots have
    ``parent[r] == r``, ``depth 0``, ``preorder 0``, and per-tree
    ``postorder == tree_size - 1``; isolated nodes are size-1 roots."""

    parent: torch.Tensor  # (n,) int32
    depth: torch.Tensor  # (n,) int32
    subtree_size: torch.Tensor  # (n,) int32
    preorder: torch.Tensor  # (n,) int32 per-tree DFS discovery index
    postorder: torch.Tensor  # (n,) int32 per-tree DFS finish index
    ranks: torch.Tensor  # (L,) the tour ranks everything derives from


def tree_computations(
    tour: EulerTour, *, ranks: torch.Tensor | None = None, **rank_kwargs
) -> TreeComputations:
    """Run the whole tree-computation family over one ranked tour.

    ``ranks`` reuses an existing ``tour_ranks`` result; otherwise one is
    computed with ``rank_kwargs`` (``rank_engine=``, ``kernel_impl=``,
    ``mesh=``, ...).
    """
    n = tour.num_nodes
    if tour.capacity == 0 or tour.num_arcs == 0:
        # validate dispatch strings even on the trivial path
        check_choice(
            "rank_engine", rank_kwargs.get("rank_engine", "auto"),
            RANK_ENGINES,
        )
        check_choice(
            "kernel_impl", rank_kwargs.get("kernel_impl", "auto"),
            KERNEL_IMPLS,
        )
        dev = tour.succ.device
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        return TreeComputations(
            parent=ids, depth=zeros, subtree_size=zeros + 1,
            preorder=zeros, postorder=zeros,
            ranks=torch.zeros(tour.capacity, dtype=torch.int32, device=dev),
        )
    if ranks is None:
        ranks = tour_ranks(tour, **rank_kwargs)
    parent, depth, size_sub, pre, post = _analytics(
        ranks, tour.arc_src, tour.arc_dst, tour.twin, tour.head_of_arc,
        tour.valid, tour.root_of, n=n,
    )
    return TreeComputations(
        parent=parent, depth=depth, subtree_size=size_sub,
        preorder=pre, postorder=post, ranks=ranks,
    )


def root_tree(tour: EulerTour, **kwargs) -> torch.Tensor:
    """Parent array of the rooted forest (roots point at themselves)."""
    return tree_computations(tour, **kwargs).parent


def depths(tour: EulerTour, **kwargs) -> torch.Tensor:
    return tree_computations(tour, **kwargs).depth


def subtree_sizes(tour: EulerTour, **kwargs) -> torch.Tensor:
    return tree_computations(tour, **kwargs).subtree_size


def preorder(tour: EulerTour, **kwargs) -> torch.Tensor:
    return tree_computations(tour, **kwargs).preorder


def postorder(tour: EulerTour, **kwargs) -> torch.Tensor:
    return tree_computations(tour, **kwargs).postorder


@dataclass
class TreeAnalytics:
    """End-to-end result: forest -> tour -> computations."""

    forest: SpanningForest
    tour: EulerTour
    computations: TreeComputations

    @property
    def parent(self) -> torch.Tensor:
        return self.computations.parent

    @property
    def depth(self) -> torch.Tensor:
        return self.computations.depth

    @property
    def subtree_size(self) -> torch.Tensor:
        return self.computations.subtree_size


def tree_analytics(
    src,
    dst,
    num_nodes: int,
    *,
    engine: str = "auto",
    rank_engine: str = "auto",
    kernel_impl: str = "auto",
    num_splitters: int | None = None,
    pad_to: int | None = None,
    pad_edges_to: int | None = None,
    mesh=None,
    seed: int = 0,
    device=None,
    **cc_kwargs,
) -> TreeAnalytics:
    """One-shot pipeline on an arbitrary graph: CC + spanning forest,
    Euler tour, and the batched tree computations. Keywords:

    * ``engine=`` -- ``"auto"`` (default), ``"frontier"``, ``"dense"``,
      ``"sharded_frontier"``:
      the CC engine extracting the forest (as in
      ``connected_components``, whose ``edge_hook`` kernel it runs);
      ``**cc_kwargs`` forward to it.
    * ``rank_engine=`` -- ``"auto"`` (default: wylie on one rank, the
      sharded splitter engine with a mesh or several ranks), ``"wylie"``,
      ``"splitter"``: the list-ranking engine over the tour.
    * ``kernel_impl=`` -- ``"auto"`` (default), ``"torch"``, ``"cuda"``:
      the splitter engine's RS4/RS5 kernels (ignored by wylie, validated
      regardless).
    * ``num_splitters=`` (int, default: linear-work bound), ``seed=``
      (int, default 0) -- splitter selection.
    * ``pad_to=`` (int, default None) -- fixes the tour capacity (see
      ``tour_capacity``).
    * ``pad_edges_to=`` (int, default None) -- pads the forest-edge
      buffer to a fixed capacity before touring; implies a tour
      capacity of ``2 * pad_edges_to`` unless ``pad_to`` raises it.
    * ``device=`` -- where host inputs go (the CUDA card by default);
      tensors stay on their device, and so does everything after them.
    * ``mesh=`` -- threads to BOTH the CC engine and the ranking engine
      (the all-sharded path end to end; ``rank_engine="auto"`` then
      picks the sharded splitter engine).

    All quantities are exact int32: results are bit-identical across
    every engine combination.
    """
    forest = spanning_forest(
        src, dst, num_nodes, engine=engine, mesh=mesh, device=device,
        **cc_kwargs,
    )
    dev = src.device if isinstance(src, torch.Tensor) else resolve_device(device)
    edge_u, edge_v, num_edges = forest.edge_u, forest.edge_v, None
    if pad_edges_to is not None:
        f = forest.num_edges
        if f > pad_edges_to:
            raise ValueError(
                f"pad_edges_to={pad_edges_to} below the {f} forest edges"
            )
        num_edges = f
        edge_u = np.zeros((pad_edges_to,), np.int32)
        edge_v = np.zeros((pad_edges_to,), np.int32)
        edge_u[:f] = forest.edge_u
        edge_v[:f] = forest.edge_v
    tour = euler_tour(
        edge_u, edge_v, num_nodes, labels=forest.labels, pad_to=pad_to,
        num_edges=num_edges, device=dev,
    )
    comp = tree_computations(
        tour, rank_engine=rank_engine, kernel_impl=kernel_impl,
        num_splitters=num_splitters, seed=seed, mesh=mesh,
    )
    return TreeAnalytics(forest=forest, tour=tour, computations=comp)
