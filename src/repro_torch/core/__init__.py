"""The paper's two algorithms in PyTorch -- connected components and
list ranking, with the dispatch rules of ``repro.core`` -- and the
graph analytics on them: SSSP and PageRank on the operator layer, and
the Euler-tour tree wrappers (``repro_torch.trees``).

This port runs on one device. The sharded engines of the reference
(``engine="sharded_frontier"``, ``mesh=``, the ``exchange=`` /
``sparse_capacity=`` / ``axis=`` keywords) raise ``NotImplementedError``
until ROADMAP queue 1 item 11 ports them; ``serve_graphs`` raises until
item 10 ports graph serving.
"""
from repro_torch.core.components import (
    ConvergenceError,
    check_choice,
    dedup_edges,
    label_propagation,
    num_components,
    shiloach_vishkin,
    sv_round_bound,
)
from repro_torch.core.frontier import FrontierStats, frontier_shiloach_vishkin
from repro_torch.core.list_ranking import (
    KERNEL_IMPLS,
    PACK_MODES,
    SplitterStats,
    even_splitters,
    max_splitters_for_linear_work,
    random_splitter_rank,
    select_splitters,
    wylie_rank,
)
from repro_torch.core.pagerank import (
    PAGERANK_ENGINES,
    PageRankStats,
    pagerank,
    pagerank_iter_bound,
)
from repro_torch.core.sssp import (
    SSSP_ENGINES,
    SsspStats,
    bellman_ford,
    frontier_bellman_ford,
    shortest_paths,
    sssp_round_bound,
)
from repro_torch.core.pram import (
    lockstep_walk,
    partitioned_view,
    partitioning_indices,
    strided_view,
    striding_indices,
)

# Engine-specific tuning knobs: naming one pins the dispatch to that
# engine. The sampling pre-pass (sample_rounds/seed) and min_bucket
# exist only on the frontier engine; hook_impl on both single-device
# engines.
_SAMPLING_KW = frozenset({"sample_rounds", "seed"})
_FRONTIER_KW = _SAMPLING_KW | {"min_bucket"}
_SHARDED_KW = frozenset({"exchange", "sparse_capacity", "axis"})
_CC_ENGINES = ("auto", "frontier", "dense", "sharded_frontier")

# Sampling policy (the reference's, unchanged): when the auto dispatch
# lands on the frontier engine and the graph has at least
# AUTO_SAMPLE_DENSITY input edges per node, the Afforest-style pre-pass
# runs AUTO_SAMPLE_ROUNDS rounds. Labels remain a correct partition, but
# representatives may differ from the dense engine's; pass
# ``sample_rounds=0`` or pin ``engine=`` to opt out.
AUTO_SAMPLE_DENSITY = 8.0
AUTO_SAMPLE_ROUNDS = 2

_SHARDED_TODO = (
    "the sharded engines are not ported yet (ROADMAP queue 1, item 11: "
    "sharded graph engine)"
)


def _auto_sample_rounds(src, num_nodes):
    """Afforest pre-pass rounds for the auto dispatch: 0 unless the
    input is edge-heavy (m/n >= AUTO_SAMPLE_DENSITY)."""
    shape = getattr(src, "shape", None)
    if shape is not None:
        m = shape[0] if len(shape) else 0
    else:
        m = len(src) if hasattr(src, "__len__") else 0
    if num_nodes > 0 and m / num_nodes >= AUTO_SAMPLE_DENSITY:
        return AUTO_SAMPLE_ROUNDS
    return 0


def connected_components(
    src, dst, num_nodes, *, max_rounds=None, mesh=None, engine="auto",
    device=None, **kwargs
):
    """Connected components with automatic engine dispatch.

    Returns ``(labels, rounds)`` -- identical on every path --
    ``labels[i]`` being the component root id (an int32 tensor on the
    run's device) and ``rounds`` an int.

    ``engine=`` -- ``"auto"`` (default) or ``"frontier"`` runs the
    frontier-compacted engine (``repro_torch.core.frontier``);
    ``"dense"`` walks every edge every round (``shiloach_vishkin``).
    ``"sharded_frontier"`` and ``mesh=`` raise ``NotImplementedError``.

    Keywords:

    * ``sample_rounds=`` / ``seed=`` -- the Afforest-style sampling
      pre-pass; frontier engine only. On the auto path, graphs with at
      least ``AUTO_SAMPLE_DENSITY`` input edges per node get
      ``AUTO_SAMPLE_ROUNDS`` rounds unless ``sample_rounds=`` is given.
    * ``min_bucket=`` (int, default 1024) -- smallest frontier bucket.
    * ``hook_impl=`` -- ``"auto"`` (default: the ``edge_hook`` CUDA
      kernel for tensors on the card, its plain version on the CPU),
      ``"torch"`` or ``"cuda"``.
    * ``dedup=``, ``record_hooks=``, ``with_stats=`` -- as in
      ``repro.core.connected_components``.
    * ``device=`` -- where host (numpy/list) inputs go: the CUDA card by
      default, ``"cpu"`` on request. Tensors stay on their device.
    """
    check_choice("engine", engine, _CC_ENGINES)
    sharded_kw = _SHARDED_KW & kwargs.keys()
    if mesh is not None or engine == "sharded_frontier" or sharded_kw:
        raise NotImplementedError(_SHARDED_TODO)
    if engine == "auto":
        engine = "frontier"
        if "sample_rounds" not in kwargs:
            auto_k = _auto_sample_rounds(src, num_nodes)
            if auto_k:
                kwargs["sample_rounds"] = auto_k
    if engine == "frontier":
        return frontier_shiloach_vishkin(
            src, dst, num_nodes, max_rounds=max_rounds, device=device,
            **kwargs
        )
    fkw = _FRONTIER_KW & kwargs.keys()
    if fkw:
        raise ValueError(
            f"{sorted(fkw)} are frontier-engine options; use "
            "engine='frontier'"
        )
    return shiloach_vishkin(
        src, dst, num_nodes, max_rounds=max_rounds, device=device, **kwargs
    )


def list_rank(succ, num_splitters=None, *, mesh=None, device=None, **kwargs):
    """List ranking with the random-splitter engine. Returns the exact
    int32 ranks. Keywords as in ``repro.core.list_rank``:

    * ``num_splitters=`` (int, default ``min(4096,
      max_splitters_for_linear_work(n))``).
    * ``kernel_impl=`` -- ``"auto"`` (default: the CUDA kernels for
      tensors on the card, their plain versions on the CPU),
      ``"torch"`` or ``"cuda"``: RS4/RS5's implementation.
    * ``pack_mode=`` -- ``"aos"`` (default), ``"soa"``, ``"word64"``.
    * ``splitters=``/``seed=``/``head=``/``max_steps=``/``with_stats=``
      -- forwarded unchanged.
    * ``device=`` -- where a host list goes (the CUDA card by default).

    ``mesh=`` raises ``NotImplementedError``.
    """
    if "kernel_impl" in kwargs:
        check_choice("kernel_impl", kwargs["kernel_impl"], KERNEL_IMPLS)
    if "pack_mode" in kwargs:
        check_choice("pack_mode", kwargs["pack_mode"], PACK_MODES)
    if mesh is not None:
        raise NotImplementedError(_SHARDED_TODO)
    return random_splitter_rank(succ, num_splitters, device=device, **kwargs)


def spanning_forest(src, dst, num_nodes, **kwargs):
    """Spanning forest from CC hook decisions -- see
    ``repro_torch.trees.spanning_forest`` (engine dispatch as above)."""
    from repro_torch.trees import spanning_forest as _sf

    return _sf(src, dst, num_nodes, **kwargs)


def euler_tour(edge_u, edge_v, num_nodes, **kwargs):
    """Euler tour of a spanning forest -- see
    ``repro_torch.trees.euler_tour``; the returned tour's ``succ`` feeds
    ``list_rank``/``wylie_rank``."""
    from repro_torch.trees import euler_tour as _et

    return _et(edge_u, edge_v, num_nodes, **kwargs)


def root_tree(tour, **kwargs):
    """Parent array of a toured forest -- see
    ``repro_torch.trees.root_tree``; ``rank_engine=``/``kernel_impl=``
    dispatch the underlying list ranking."""
    from repro_torch.trees import root_tree as _rt

    return _rt(tour, **kwargs)


def tree_analytics(src, dst, num_nodes, **kwargs):
    """One-shot graph -> forest -> tour -> tree computations pipeline --
    see ``repro_torch.trees.tree_analytics``."""
    from repro_torch.trees import tree_analytics as _ta

    return _ta(src, dst, num_nodes, **kwargs)


def serve_graphs(requests, **kwargs):
    """Wave-batched graph serving: not ported yet."""
    raise NotImplementedError(
        "graph serving is not ported yet (ROADMAP queue 1, item 10: "
        "graph serving)"
    )


__all__ = [
    "connected_components",
    "list_rank",
    "spanning_forest",
    "euler_tour",
    "root_tree",
    "tree_analytics",
    "serve_graphs",
    "check_choice",
    "wylie_rank",
    "random_splitter_rank",
    "select_splitters",
    "even_splitters",
    "max_splitters_for_linear_work",
    "SplitterStats",
    "shiloach_vishkin",
    "frontier_shiloach_vishkin",
    "FrontierStats",
    "label_propagation",
    "sv_round_bound",
    "ConvergenceError",
    "num_components",
    "dedup_edges",
    "shortest_paths",
    "bellman_ford",
    "frontier_bellman_ford",
    "SsspStats",
    "SSSP_ENGINES",
    "sssp_round_bound",
    "pagerank",
    "pagerank_iter_bound",
    "PageRankStats",
    "PAGERANK_ENGINES",
    "striding_indices",
    "partitioning_indices",
    "strided_view",
    "partitioned_view",
    "lockstep_walk",
    "AUTO_SAMPLE_DENSITY",
    "AUTO_SAMPLE_ROUNDS",
]
