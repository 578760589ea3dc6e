"""PageRank as an advance/filter/compute composition.

The port of ``repro.core.pagerank`` (see its docstring): push-style mass
propagation, ``r' = (1-d) * t + d * sum_{(u,v)} w(u,v) * r[u] / deg(u)``
over the undirected 2m arc walk, as one ``advance`` under the ``ADD``
monoid, one ``compute`` and the shared ``run_rebuild_loop`` host loop. An
ADD frontier cannot skip edges, so the tolerance mask ``|r' - r| > tol``
only decides when to stop.

**Exactness**, the reference's contract:

* ``out = where(deg > 0, r / deg, 0)``;
* each multiply of ``dmp * (out[a] * w2)`` is rounded on its own;
* the contributions fold onto the base ``(1 - d) * t`` in edge-slot
  order, and ``deg`` is itself a slot-order fold of ``w2`` by ``a``.

The reference gets slot order from XLA's scatter-add. Here the ``ADD``
monoid folds through the ``ordered_fold`` kernel on the card (its plain
version on the CPU), and the two stable sorts it needs -- arcs by ``b``
for the mass, by ``a`` for the degrees -- are made once a call, outside
the iteration loop (``fold_plan``). So are the arcs' sources and weights
in the mass plan's slot order, from which the kernel gathers ``out`` and
multiplies itself each iteration (``GatheredValues``): the m2-long
``dmp * (out[a] * w2)`` is never written. Scores are then bit-equal to the
numpy oracle ``core.serial.serial_pagerank`` iteration for iteration, on
either device. Per-node ``teleport`` vectors and the leak of dangling
mass are the reference's.

Two engines share the iteration body:

* ``frontier`` -- the host tolerance loop on ``run_rebuild_loop``:
  iterate until no node moves more than ``tol``, ``ConvergenceError``
  at the iteration bound (``pagerank_iter_bound``).
* ``dense`` -- exactly ``num_iters`` iterations with no read to the
  host in between (the reference's ``lax.fori_loop``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.components import (
    ConvergenceError,
    check_choice,
    oriented_edges,
    oriented_weights,
)
from repro_torch.core.operators import (
    ADD,
    GatheredValues,
    advance,
    compute,
    run_rebuild_loop,
)
from repro_torch.kernels.ordered_fold.ops import fold_plan
from repro_torch.obs import trace

# pagerank(engine=) choices: the knob "pagerank_engine".
PAGERANK_ENGINES = ("auto", "frontier", "dense")

DEFAULT_DAMPING = 0.85
DEFAULT_TOL = 1e-6


def pagerank_iter_bound(
    damping: float = DEFAULT_DAMPING, tol: float = DEFAULT_TOL
) -> int:
    """Iteration ceiling for the tolerance loop: the residual undercuts
    ``tol`` within ``log(tol * (1 - damping)) / log(damping)``
    iterations. Also the dense engine's default ``num_iters``."""
    if not 0.0 < damping < 1.0:
        raise ValueError(f"damping must be in (0, 1), got {damping}")
    if not tol > 0.0:
        raise ValueError(f"tol must be > 0, got {tol}")
    return max(
        int(math.ceil(math.log(tol * (1.0 - damping)) / math.log(damping)))
        + 1,
        1,
    )


@dataclass
class PageRankStats:
    """Work accounting, as in the reference: the degree pass walks the
    2m arcs once, then every iteration walks all of them, so
    ``edges_touched`` is ``m2 * (iterations + 1)`` on both engines."""

    iterations: int
    edges_touched: int
    m2: int  # oriented arc count (every iteration walks all of it)
    levels: list = field(default_factory=list)  # live (>tol) nodes per iter

    def publish(self, registry=None, prefix: str = "pagerank.frontier") -> None:
        """Publish into the metrics registry (``repro_torch.obs.metrics``)."""
        from repro_torch.obs.metrics import publish_stats

        publish_stats(self, prefix, registry)


def _prep_mass_edges(src, dst, weights, n: int, device=None):
    """Both-orientation ``(a, b, w2)`` arc tensors. Unlike SSSP's prep,
    +inf is rejected too: mass multiplies along edges, so a non-finite
    weight poisons every score it reaches. Node ids outside ``[0, n)``
    raise (``components.oriented_edges``)."""
    if weights is not None and not isinstance(weights, torch.Tensor):
        weights = np.asarray(weights, np.float32).ravel()
        if not np.isfinite(weights).all():
            raise ValueError("pagerank weights must be finite")
        if (weights < 0).any():
            raise ValueError("pagerank weights must be >= 0")
    a, b = oriented_edges(src, dst, n, device)
    return a, b, oriented_weights(weights, a)


def _degrees(a_plan, w2, t):
    """Weighted out-degree per node: an ADD-monoid advance of the weight
    lane along the arcs sorted by ``a``; ``t`` only supplies the (n,)
    float32 shape."""
    return advance(torch.zeros_like(t), a_plan, w2, monoid=ADD)


def _mass_arcs(a, w2, b_plan):
    """The arcs' sources and weights in ``b_plan``'s slot order: one
    gather of each, once a call."""
    return a.index_select(0, b_plan.perm), w2.index_select(0, b_plan.perm)


def _mass_step(b_plan, a_sorted, w_sorted, deg, t, r, dmp, omd):
    """One push iteration: per-node out-mass, advanced along every arc
    under ADD onto the teleport base ``(1-d) * t``; each arc carries
    ``dmp * (out[a] * w2)``, each multiply rounded on its own, gathered
    and multiplied inside the fold."""
    out = compute(lambda ri, di: torch.where(di > 0, ri / di, 0.0), r, deg)
    return advance(omd * t, b_plan, GatheredValues(out, a_sorted, w_sorted, dmp),
                   monoid=ADD)


def _pr_iterate(b_plan, a_sorted, w_sorted, deg, t, r, dmp, omd, tol):
    """One host-loop iteration: new scores and the tolerance mask."""
    new = _mass_step(b_plan, a_sorted, w_sorted, deg, t, r, dmp, omd)
    return new, (new - r).abs() > tol


def _pr_fixed(b_plan, a_sorted, w_sorted, deg, t, r, dmp, omd, *, num_iters):
    """``num_iters`` iterations with no read to the host: the dense
    engine, bit-equal to the host loop's first ``num_iters`` steps."""
    for _ in range(num_iters):
        r = _mass_step(b_plan, a_sorted, w_sorted, deg, t, r, dmp, omd)
    return r


def _prep_teleport(teleport, n: int, device):
    if teleport is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    th = (teleport.detach().cpu().numpy() if isinstance(teleport, torch.Tensor)
          else np.asarray(teleport))
    th = th.astype(np.float32).ravel()
    if th.shape != (n,):
        raise ValueError(f"teleport shape {th.shape} != ({n},)")
    if not np.isfinite(th).all() or (th < 0).any():
        raise ValueError("teleport mass must be finite and >= 0")
    return torch.from_numpy(th).to(device)


def pagerank(
    src,
    dst,
    weights=None,
    num_nodes: int | None = None,
    *,
    damping: float = DEFAULT_DAMPING,
    tol: float = DEFAULT_TOL,
    teleport=None,
    num_iters: int | None = None,
    max_rounds: int | None = None,
    engine: str = "auto",
    with_stats: bool = False,
    device=None,
):
    """Weighted PageRank over the undirected 2m arc walk. Returns
    ``(scores, iterations)`` -- float32 scores and the iteration count
    as an int -- plus ``PageRankStats`` when ``with_stats``.
    ``weights=None`` means unit weights; ``teleport`` (default uniform
    ``1/n``) is the per-node restart mass. Host inputs go to ``device``
    (default: the CUDA card); tensors stay where they are.

    ``engine=`` -- ``"auto"`` (default), ``"frontier"``, ``"dense"``
    (knob ``pagerank_engine``):

    * ``"auto"``: the frontier tolerance loop. The reference runs the
      dense engine instead under a ``jax.jit`` trace; PyTorch runs
      eagerly, so that branch has no counterpart here.
    * ``"frontier"``: iterate until every node moves <= ``tol``;
      ``max_rounds`` (default ``pagerank_iter_bound(damping, tol)``) is
      the ``ConvergenceError`` bound. Rejects ``num_iters``.
    * ``"dense"``: exactly ``num_iters`` iterations (default
      ``pagerank_iter_bound(damping, tol)``). ``max_rounds`` below
      ``num_iters`` caps the iterations and then checks: a still-moving
      score vector raises ``ConvergenceError``.
    """
    if num_nodes is None:
        raise TypeError("pagerank requires num_nodes")
    n = int(num_nodes)
    check_choice("pagerank_engine", engine, PAGERANK_ENGINES)
    bound = (
        max_rounds if max_rounds is not None
        else pagerank_iter_bound(damping, tol)
    )
    a, b, w2 = _prep_mass_edges(src, dst, weights, n, device)
    dev = a.device
    m2 = int(a.shape[0])
    # float32 scalars computed as the oracle computes them (1 - d in float32).
    dmp = torch.tensor(np.float32(damping), device=dev)
    omd = torch.tensor(np.float32(1.0) - np.float32(damping), device=dev)
    tolv = torch.tensor(np.float32(tol), device=dev)
    t = _prep_teleport(teleport, n, dev)
    if engine == "auto":
        engine = "frontier"
    if engine == "frontier" and num_iters is not None:
        raise ValueError(
            "num_iters= is a dense-engine option (fixed schedule); the "
            "frontier engine iterates to tol -- use engine='dense'"
        )
    # The two stable sorts of the call and the arcs in the mass plan's
    # slot order, outside the iteration loop.
    a_plan, b_plan = fold_plan(a, n), fold_plan(b, n)
    deg = _degrees(a_plan, w2, t)
    arcs = (b_plan, *_mass_arcs(a, w2, b_plan))
    r = t  # iteration 0 state: all mass at its teleport slot
    stats = PageRankStats(iterations=0, edges_touched=m2, m2=m2)

    if engine == "dense":
        iters = (
            num_iters if num_iters is not None
            else pagerank_iter_bound(damping, tol)
        )
        run_iters = min(iters, bound) if max_rounds is not None else iters
        with trace.span(
            "pagerank.dense", device=True, n=n, m2=m2, iters=run_iters,
        ) as sp:
            r = _pr_fixed(*arcs, deg, t, r, dmp, omd, num_iters=run_iters)
            sp.block_on(r)
        if max_rounds is not None and run_iters < iters:
            # The budget cut the fixed schedule short: probe one extra
            # iteration and fail loudly if scores are still moving.
            _new, mask = _pr_iterate(*arcs, deg, t, r, dmp, omd, tolv)
            live = int(mask.sum())
            if live:
                raise ConvergenceError(
                    f"pagerank hit its iteration budget ({bound}) with "
                    f"{live} nodes still above tol={tol} on {n} nodes; "
                    f"raise max_rounds (the tolerance bound is "
                    f"pagerank_iter_bound={pagerank_iter_bound(damping, tol)})"
                )
        stats.iterations = run_iters
        stats.edges_touched += m2 * run_iters
        out = (r, run_iters)
        return out + (stats,) if with_stats else out

    live_mask = None
    with trace.span("pagerank.frontier", n=n, m2=m2) as run_sp:

        def live_nodes():
            if live_mask is None:
                return n  # every node is live before the first push
            # The level-synchronous sync: the host reads the tolerance
            # filter's live count to decide termination.
            return int(live_mask.sum())

        def push_level(live):
            nonlocal r, live_mask
            with trace.span("pagerank.level", live=live):
                r, live_mask = _pr_iterate(*arcs, deg, t, r, dmp, omd, tolv)
            stats.edges_touched += m2
            stats.levels.append(live)

        def bound_hit(live, _rounds):
            raise ConvergenceError(
                f"pagerank hit its iteration bound ({bound}) with "
                f"{live} nodes still above tol={tol} on {n} nodes; "
                f"raise max_rounds (the tolerance bound is "
                f"pagerank_iter_bound={pagerank_iter_bound(damping, tol)})"
            )

        iters = run_rebuild_loop(
            bound=bound, live_count=live_nodes, run_level=push_level,
            on_bound=bound_hit,
        )
        run_sp.tag(iterations=iters)
    stats.iterations = iters
    out = (r, iters)
    return out + (stats,) if with_stats else out
