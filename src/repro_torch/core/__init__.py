"""The paper's two algorithms in PyTorch -- connected components and
list ranking, with the dispatch rules of ``repro.core`` -- and the
graph analytics on them: SSSP and PageRank on the operator layer, and
the Euler-tour tree wrappers (``repro_torch.trees``).

The sharded engines (``engine="sharded_frontier"``, ``mesh=``, the
``exchange=`` / ``sparse_capacity=`` / ``axis=`` keywords) run on
``torch.distributed`` (``repro_torch.distributed.graph``): where the
reference counts visible devices, the port counts the ranks of the
default process group. ``serve_graphs`` serves many small graph requests
in wave-batched disjoint unions (``repro_torch.serve.graph``).
"""
import torch.distributed as dist

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
# engine. The sampling pre-pass (sample_rounds/seed) exists only on the
# single-device frontier engine; min_bucket and hook_impl are honoured
# by both frontier engines (single-device and sharded), so with a mesh
# they steer toward engine="sharded_frontier" instead of raising.
_SAMPLING_KW = frozenset({"sample_rounds", "seed"})
_FRONTIER_KW = _SAMPLING_KW | {"min_bucket"}
_SINGLE_KW = _FRONTIER_KW | {"hook_impl"}
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


def _multi_rank() -> bool:
    """Whether the default process group has several ranks: the port's
    ``jax.device_count() > 1``."""
    return dist.is_initialized() and dist.get_world_size() > 1


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

    ``engine=`` -- one of ``"auto"`` (default), ``"frontier"``,
    ``"dense"``, ``"sharded_frontier"``, with the reference's rules:

    * ``"auto"``: an explicit ``mesh=`` picks the sharded frontier
      engine; otherwise one rank runs the single-device frontier engine
      (``repro_torch.core.frontier``) and a process group of several
      ranks the dense sharded engine (``repro_torch.distributed.graph``).
      The reference's fallbacks to the dense walks under a ``jax.jit``
      trace have no torch meaning: nothing here is traced.
    * ``"frontier"``: the single-device frontier engine (rejects
      ``mesh=``).
    * ``"dense"``: every edge every round (one rank: ``shiloach_vishkin``;
      with a mesh, sharded keywords or several ranks: the dense sharded
      engine).
    * ``"sharded_frontier"``: the per-rank frontier engine (``mesh=``
      optional; default ``graph_mesh(device=device)``).

    Keywords (each steers the auto dispatch toward an engine that
    honours it):

    * ``sample_rounds=`` / ``seed=`` -- the Afforest-style sampling
      pre-pass; single-device frontier engine only (with a sharded
      trigger they raise). On the auto path, graphs with at least
      ``AUTO_SAMPLE_DENSITY`` input edges per node get
      ``AUTO_SAMPLE_ROUNDS`` rounds unless ``sample_rounds=`` is given.
    * ``min_bucket=`` (int, default 1024) -- smallest frontier bucket;
      both frontier engines (per rank in the sharded one).
    * ``hook_impl=`` -- ``"auto"`` (default: the ``edge_hook`` CUDA
      kernel for tensors on the card, its plain version on the CPU),
      ``"torch"`` or ``"cuda"``; the dense, frontier and sharded
      frontier engines. The dense sharded engine takes no ``hook_impl``,
      as in the reference; its hooks run through ``edge_hook`` "auto".
    * ``exchange=`` (``"dense"`` / ``"sparse"``), ``sparse_capacity=``,
      ``axis=`` -- the sharded engines' label exchange and mesh axis.
    * ``dedup=``, ``record_hooks=``, ``with_stats=`` -- as in
      ``repro.core.connected_components``.
    * ``device=`` -- where host (numpy/list) inputs go: the CUDA card by
      default, ``"cpu"`` on request. Tensors stay on their device; the
      sharded engines run on the mesh's device.
    """
    check_choice("engine", engine, _CC_ENGINES)
    single_kw = _SINGLE_KW & kwargs.keys()
    sharded_kw = _SHARDED_KW & kwargs.keys()
    sampling_kw = _SAMPLING_KW & kwargs.keys()
    if sampling_kw and (
        sharded_kw or mesh is not None or engine == "sharded_frontier"
    ):
        trigger = (
            sorted(sharded_kw) if sharded_kw
            else "mesh=" if mesh is not None
            else "engine='sharded_frontier'"
        )
        raise ValueError(
            f"{sorted(sampling_kw)} are single-device frontier options "
            "(the sampling pre-pass has no sharded counterpart); drop "
            f"them or drop {trigger}"
        )
    if engine == "auto":
        if mesh is not None:
            engine = "sharded_frontier"
        elif single_kw and not sharded_kw:
            engine = "frontier"
        elif sharded_kw:
            # bucket/hook knobs and exchange knobs meet only in the
            # composed engine
            engine = "sharded_frontier" if single_kw else "_sharded"
        elif _multi_rank():
            engine = "_sharded"
        else:
            engine = "frontier"
        if engine == "frontier" and "sample_rounds" not in kwargs:
            auto_k = _auto_sample_rounds(src, num_nodes)
            if auto_k:
                kwargs["sample_rounds"] = auto_k
    if engine == "frontier":
        if sharded_kw:
            raise ValueError(
                f"{sorted(sharded_kw)} are sharded-engine options; drop "
                "them or use engine='auto'/'sharded_frontier'"
            )
        if mesh is not None:
            raise ValueError(
                "the frontier engine is single-device; drop mesh= or use "
                "engine='auto'/'sharded_frontier'"
            )
        return frontier_shiloach_vishkin(
            src, dst, num_nodes, max_rounds=max_rounds, device=device,
            **kwargs
        )
    if engine == "sharded_frontier":
        from repro_torch.distributed.graph import (
            sharded_frontier_shiloach_vishkin,
        )

        return sharded_frontier_shiloach_vishkin(
            src, dst, num_nodes, mesh=mesh, max_rounds=max_rounds,
            device=device, **kwargs
        )
    if engine == "dense":
        fkw = _FRONTIER_KW & kwargs.keys()
        if fkw:
            raise ValueError(
                f"{sorted(fkw)} are frontier-engine options; use "
                "engine='frontier' or engine='sharded_frontier'"
            )
        if single_kw and (mesh is not None or sharded_kw):
            # only hook_impl can land here
            raise ValueError(
                f"{sorted(single_kw)} with a mesh needs "
                "engine='sharded_frontier' (the dense sharded engine "
                "takes no hook_impl)"
            )
        if single_kw or (
            mesh is None and not sharded_kw and not _multi_rank()
        ):
            return shiloach_vishkin(
                src, dst, num_nodes, max_rounds=max_rounds, device=device,
                **kwargs
            )
    # several ranks, a mesh or sharded knobs: the sharded engine IS the
    # dense walk
    from repro_torch.distributed.graph import sharded_shiloach_vishkin

    return sharded_shiloach_vishkin(
        src, dst, num_nodes, mesh=mesh, max_rounds=max_rounds, device=device,
        **kwargs
    )


_SINGLE_ENGINE_KW = frozenset({"pack_mode"})


def list_rank(succ, num_splitters=None, *, mesh=None, device=None, **kwargs):
    """List ranking with automatic engine dispatch: the random-splitter
    engine on one rank, its sharded counterpart
    (``repro_torch.distributed.graph.sharded_random_splitter_rank``) when
    a ``mesh=`` is given or the process group has several ranks. Returns
    the exact int32 ranks, the same on every path. Keywords as in
    ``repro.core.list_rank``:

    * ``num_splitters=`` (int, default ``min(4096,
      max_splitters_for_linear_work(n))``).
    * ``kernel_impl=`` -- ``"auto"`` (default: the CUDA kernels for
      tensors on the card, their plain versions on the CPU),
      ``"torch"`` or ``"cuda"``: RS4/RS5's implementation, on both
      engines.
    * ``pack_mode=`` -- ``"aos"`` (default), ``"soa"``, ``"word64"``:
      single-device walk-state packing; given without a mesh it pins the
      single-device engine, with a mesh it raises.
    * ``splitters=``/``seed=``/``head=``/``max_steps=``/``with_stats=``
      -- forwarded unchanged.
    * ``device=`` -- where a host list goes (the CUDA card by default).
    """
    if "kernel_impl" in kwargs:
        check_choice("kernel_impl", kwargs["kernel_impl"], KERNEL_IMPLS)
    if "pack_mode" in kwargs:
        check_choice("pack_mode", kwargs["pack_mode"], PACK_MODES)
    single_only = _SINGLE_ENGINE_KW & kwargs.keys()
    if mesh is not None or (_multi_rank() and not single_only):
        if single_only:
            raise ValueError(
                f"{sorted(single_only)} are single-device options; drop "
                "them or drop mesh="
            )
        from repro_torch.distributed.graph import sharded_random_splitter_rank

        return sharded_random_splitter_rank(
            succ, num_splitters, mesh=mesh, device=device, **kwargs
        )
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
    """Serve many small graph requests wave-batched: one padded
    disjoint-union engine call per wave, bit-exact vs issuing each
    request alone -- see ``repro_torch.serve.graph.GraphServeEngine``.

    ``requests`` is an iterable of ``repro_torch.serve.GraphRequest``;
    ``kwargs`` are the engine knobs (``engine=`` / ``rank_engine=`` /
    ``kernel_impl=`` dispatch as in the functions above, plus the
    wave/bucket capacity knobs and ``device=``: the CUDA card by
    default). Returns the finished requests with ``result`` populated,
    in completion order.
    """
    from repro_torch.serve.graph import GraphServeEngine

    eng = GraphServeEngine(**kwargs)
    for r in requests:
        eng.submit(r)
    return eng.run()


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
