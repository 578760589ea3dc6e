"""Wave-batched graph-analytics serving over the ``repro_torch.core``
engines: the port of ``repro.serve.graph``.

The workload is "many small molecule graphs per call": a stream of
independent little CC / spanning-forest / tree-analytics / SSSP /
PageRank requests that would each waste a device dispatch if issued
alone. The engine serves them in waves:

* requests queue up and are admitted in FIFO order into WAVES under a
  node/edge budget (``serve/waves.WaveScheduler``, the same outer loop
  as the LM token engine);
* each wave is packed into ONE disjoint-union graph by node/edge offset
  packing -- request i's nodes become ``[node_off[i], node_off[i] +
  n_i)`` -- then padded to a power-of-two **capacity bucket**
  (``core/operators.next_pow2`` on nodes and edges; pad nodes are
  isolated, pad edges are inert (0, 0) self-loops, and the analytics
  stage pads its forest-edge buffer to the node capacity so the tour
  ranks at the fixed ``2 * node_cap`` arc capacity);
* the packed union goes to the device once and runs through the
  engines as one call per wave -- ``connected_components`` /
  ``spanning_forest`` / ``tree_analytics`` with ``dedup=False``,
  ``shortest_paths`` or ``pagerank`` -- and each output comes back to
  the host with one read per wave, then is unpacked per request by
  offset.

**Bit-exactness.** CC, spanning forests, and Euler-tour analytics over
a disjoint union decompose per component: every SV hook compares labels
only within a component, labels are per-request node ids shifted by the
request's node offset, the recorded hook edges of request i are exactly
its solo hook edges shifted, and the tour's stable source-sort keeps
each request's arc order. Pad nodes are isolated self-components, pad
self-loop edges never hook, and ``record_hooks`` / extra converged
rounds are label-neutral -- so every unpacked result is bit-identical
to issuing the request alone with the same engine knobs, and to the
reference engine's result (``tests/test_torch_serve_graph.py``).
Per-request ``rounds`` does NOT decompose -- the union runs to its
slowest member -- so it is reported per wave.

**Engines.** On one rank with no mesh, ``engine="auto"`` resolves to
``"dense"``, as the reference's does on one device: the auto dispatch's
Afforest policy keys on edge density, which packing changes. A pinned
``"frontier"`` is honoured (bit-exact). ``mesh=``,
``engine="sharded_frontier"`` and the sharded keywords dispatch as in
``repro_torch.core`` (the sharded engines of
``repro_torch.distributed.graph``, bit-exact too); sssp and pagerank
waves run single-device engines and reject them at ``submit``, as the
reference does.

**Device.** ``device=`` (the CUDA card by default; ``"cpu"`` only when
the caller asks) is resolved once, by ``repro_torch.device.
resolve_device``: without a card the engine raises at construction and
never falls back to the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.components import check_choice
from repro_torch.core.operators import next_pow2
from repro_torch.device import resolve_device
from repro_torch.obs import trace
from repro_torch.serve.waves import WaveScheduler

# Request kinds. The first three form a pipeline-stage chain -- each
# stage subsumes the ones before it, so a mixed wave runs the deepest
# stage any member needs (record_hooks and the tour stages are
# label-neutral by construction). "sssp" and "pagerank" are OUTSIDE
# the chain: each runs a different device program (relax-min over
# weighted edges; add-monoid mass push), so ``_next_wave`` packs them
# only with their own kind -- stage promotion never mixes families.
KINDS = ("cc", "forest", "analytics", "sssp", "pagerank")
_STAGE = {
    k: i for i, k in enumerate(KINDS) if k not in ("sssp", "pagerank")
}


def _family(kind: str) -> str:
    """Wave-packing family: kinds that can share one device program."""
    return kind if kind in ("sssp", "pagerank") else "cc-chain"


@dataclass
class GraphResult:
    """Per-request outputs, unpacked to request-local node ids (host
    numpy arrays).

    ``labels``/``num_components`` are filled for every kind in the
    cc-chain family; ``edge_u``/``edge_v`` (the spanning forest, in
    solo edge order) from kind ``"forest"`` up; the tree-analytics
    arrays only for ``"analytics"``. Kind ``"sssp"`` instead fills
    ``dist``/``pred``/``sources``: one row per source, ``+inf`` /
    ``-1`` for unreachable nodes. Kind ``"pagerank"`` fills only
    ``scores``: per-node float32 PageRank mass at the engine's fixed
    iteration count (``pagerank_iters``).
    """

    labels: np.ndarray | None = None
    num_components: int = 0
    edge_u: np.ndarray | None = None
    edge_v: np.ndarray | None = None
    parent: np.ndarray | None = None
    depth: np.ndarray | None = None
    subtree_size: np.ndarray | None = None
    preorder: np.ndarray | None = None
    postorder: np.ndarray | None = None
    dist: np.ndarray | None = None  # (num_sources, n) float32
    pred: np.ndarray | None = None  # (num_sources, n) int32 parent tree
    sources: np.ndarray | None = None  # the request's source nodes
    scores: np.ndarray | None = None  # (n,) float32 pagerank mass


@dataclass
class GraphRequest:
    uid: int
    src: np.ndarray
    dst: np.ndarray
    num_nodes: int
    kind: str = "analytics"
    # weighted-kind inputs: per-edge weights (None = unit) for sssp /
    # pagerank and the sssp source nodes (None = [0]); rejected on
    # kinds that cannot consume them.
    weights: np.ndarray | None = None
    sources: np.ndarray | None = None
    result: GraphResult | None = None
    done: bool = False
    failed: bool = False  # quarantined by the containment layer
    error: str | None = None  # captured failure, when failed

    @property
    def num_edges(self) -> int:
        return int(len(self.src))


@dataclass
class WaveRecord:
    """Deterministic per-wave accounting."""

    requests: int
    stage: str
    num_nodes: int  # live union nodes
    num_edges: int  # live union edges
    node_cap: int
    edge_cap: int
    new_bucket: bool  # first wave in this (stage, node_cap, edge_cap)
    rounds: int  # SV/relax rounds of the union run (max over members)
    src_cap: int = 0  # sssp waves: padded source-row capacity

    def publish(
        self, registry=None, prefix: str = "serve.graph.wave"
    ) -> None:
        """Publish into the metrics registry
        (``repro_torch.obs.metrics``): counters accumulate across
        waves, so ``.requests`` is the engine's served-request total and
        ``.new_bucket`` its bucket count."""
        from repro_torch.obs.metrics import publish_stats

        publish_stats(self, prefix, registry)


def _per_request(node_off, counts) -> np.ndarray:
    """Each request's node offset, repeated ``counts[i]`` times."""
    return np.repeat(node_off[:-1], counts).astype(np.int32)


def _pack_edges(wave, node_off, edge_cap: int, pad_weight=None):
    """The wave's disjoint union as host arrays of ``edge_cap`` slots,
    request after request in FIFO order: ``(src, dst)``, or ``(src,
    dst, weights)`` when ``pad_weight`` is given. Pad slots are (0, 0)
    self-loops of weight ``pad_weight``."""
    m = sum(r.num_edges for r in wave)
    shift = _per_request(node_off, [r.num_edges for r in wave])
    src = np.zeros((edge_cap,), np.int32)
    dst = np.zeros((edge_cap,), np.int32)
    src[:m] = np.concatenate([r.src for r in wave]) + shift
    dst[:m] = np.concatenate([r.dst for r in wave]) + shift
    if pad_weight is None:
        return src, dst
    wts = np.full((edge_cap,), pad_weight, np.float32)
    wts[:m] = np.concatenate([r.weights for r in wave])
    return src, dst, wts


class GraphServeEngine(WaveScheduler):
    """Admit many small graph requests; serve each wave as one padded
    engine call. See the module docstring for the packing / bucketing /
    exactness model.

    * ``max_requests`` (default 16), ``max_nodes`` (4096), ``max_edges``
      (16384) -- wave admission budget; a single request beyond the
      node/edge budget is rejected at ``submit``.
    * ``min_nodes`` (64) / ``min_edges`` (128) -- bucket floor, so tiny
      waves share one small bucket instead of one per size.
    * ``max_sources`` (8) -- per-request source budget for
      ``kind="sssp"`` requests; a wave's source rows pack into a
      ``src_cap`` power-of-two row count (``_run_sssp_wave``).
    * ``damping`` (0.85) / ``pagerank_iters`` (None =
      ``pagerank_iter_bound(damping, DEFAULT_TOL)``) -- the engine-wide
      ``kind="pagerank"`` knobs. PageRank serving always runs the DENSE
      engine at exactly ``pagerank_iters`` iterations: a
      tolerance-driven stop would run every wave to its slowest
      member's count, making a request's scores depend on its
      wave-mates.
    * ``engine=`` / ``rank_engine=`` / ``kernel_impl=`` /
      ``num_splitters=`` and extra engine kwargs (``hook_impl=``,
      ``min_bucket=``, ...) dispatch as in ``repro_torch.core``, except
      that ``engine="auto"`` resolves to ``"dense"`` and the sampling
      pre-pass (``sample_rounds``) is rejected: it re-roots components
      by edge density, which packing changes. ``mesh=``,
      ``engine="sharded_frontier"`` and the sharded keywords reach the
      sharded engines; sssp and pagerank requests reject them at
      ``submit``.
    * ``device=`` -- where waves run: the CUDA card by default, the CPU
      only when asked (``"cpu"``). Raises without a card.
    * ``max_retries=`` / ``on_failure=`` (``"quarantine"`` default,
      ``"raise"``) / ``fault_plan=`` -- the containment knobs
      (``serve/waves.py``). An OOM-shaped wave failure permanently caps
      the packing budget to half the failing bucket and re-packs
      smaller waves; a request is only failed when it exhausts the
      device alone.
    """

    def __init__(
        self,
        *,
        max_requests: int = 16,
        max_nodes: int = 4096,
        max_edges: int = 16384,
        min_nodes: int = 64,
        min_edges: int = 128,
        max_sources: int = 8,
        damping: float = 0.85,
        pagerank_iters: int | None = None,
        engine: str = "auto",
        rank_engine: str = "auto",
        kernel_impl: str = "auto",
        num_splitters: int | None = None,
        mesh=None,
        device=None,
        max_retries: int = 1,
        on_failure: str = "quarantine",
        fault_plan=None,
        **engine_kwargs,
    ):
        import repro_torch.core as core
        from repro_torch.core.list_ranking import KERNEL_IMPLS
        from repro_torch.core.pagerank import DEFAULT_TOL, pagerank_iter_bound
        from repro_torch.trees.compute import RANK_ENGINES

        check_choice("engine", engine, core._CC_ENGINES)
        check_choice("rank_engine", rank_engine, RANK_ENGINES)
        check_choice("kernel_impl", kernel_impl, KERNEL_IMPLS)
        bad = {
            "sample_rounds", "seed", "dedup", "record_hooks", "with_stats",
        } & set(engine_kwargs)
        if bad:
            raise ValueError(
                f"{sorted(bad)} are not servable knobs: the serve path "
                "fixes dedup/record_hooks itself and the sampling "
                "pre-pass would break batched == solo bit-exactness"
            )
        super().__init__(
            max_retries=max_retries, on_failure=on_failure,
            fault_plan=fault_plan,
        )
        self.max_requests = max_requests
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.min_nodes = min_nodes
        self.min_edges = min_edges
        self.max_sources = max_sources  # per-request sssp source budget
        # PageRank serve knobs are engine-wide (wave-uniform): every
        # request in a pagerank wave runs the same damping at the same
        # fixed iteration count, so the resolved count is pinned HERE.
        # pagerank_iter_bound also validates damping in (0, 1).
        self.damping = float(damping)
        default_iters = pagerank_iter_bound(self.damping, DEFAULT_TOL)
        self.pagerank_iters = (
            default_iters if pagerank_iters is None else int(pagerank_iters)
        )
        if self.pagerank_iters < 1:
            raise ValueError("pagerank_iters must be >= 1")
        # Degradation caps (permanent, only ever lowered): the packing
        # budget after OOM-shaped failures; see _degrade.
        self._node_budget = max_nodes
        self._edge_budget = max_edges
        if engine == "auto" and mesh is None and not core._multi_rank():
            engine = "dense"
        self.engine = engine
        self.rank_engine = rank_engine
        self.kernel_impl = kernel_impl
        self.num_splitters = num_splitters
        self.mesh = mesh
        self.device = resolve_device(device)
        self.engine_kwargs = dict(engine_kwargs)
        self.wave_records: list[WaveRecord] = []
        self._buckets: set[tuple] = set()

    # -- deterministic counters --
    @property
    def bucket_compiles(self) -> int:
        """Distinct ``(stage, node_cap, edge_cap[, src_cap])`` buckets
        of the waves that ran to completion. The reference's name and
        definition; in the port this counts bucket shapes launched, not
        compilations (PyTorch runs eagerly, and the CUDA kernels are
        built once for every shape)."""
        return len(self._buckets)

    @property
    def requests_per_wave(self) -> float:
        recs = self.wave_records
        return sum(r.requests for r in recs) / len(recs) if recs else 0.0

    @property
    def node_pad_waste(self) -> float:
        """Padded node slots that carried no request, as a fraction."""
        recs = self.wave_records
        cap = sum(r.node_cap for r in recs)
        return 1.0 - sum(r.num_nodes for r in recs) / cap if cap else 0.0

    @property
    def edge_pad_waste(self) -> float:
        recs = self.wave_records
        cap = sum(r.edge_cap for r in recs)
        return 1.0 - sum(r.num_edges for r in recs) / cap if cap else 0.0

    # ------------------------------------------------------------------
    def submit(self, req: GraphRequest):
        """Validate and enqueue. Rejections happen HERE, loudly -- a
        request that could never fit a wave must not reach the wave
        loop."""
        check_choice("kind", req.kind, KINDS)
        if req.num_nodes < 1:
            raise ValueError(f"request {req.uid}: num_nodes must be >= 1")
        req.src = np.asarray(req.src, np.int32).ravel()
        req.dst = np.asarray(req.dst, np.int32).ravel()
        if req.src.shape != req.dst.shape:
            raise ValueError(
                f"request {req.uid}: src/dst length mismatch "
                f"({req.src.shape} vs {req.dst.shape})"
            )
        if req.num_nodes > self.max_nodes or req.num_edges > self.max_edges:
            raise ValueError(
                f"request {req.uid}: {req.num_nodes} nodes / "
                f"{req.num_edges} edges exceeds the wave budget "
                f"(max_nodes={self.max_nodes}, max_edges={self.max_edges})"
            )
        if req.num_edges and (
            int(min(req.src.min(), req.dst.min())) < 0
            or int(max(req.src.max(), req.dst.max())) >= req.num_nodes
        ):
            raise ValueError(
                f"request {req.uid}: edge endpoints outside "
                f"[0, {req.num_nodes})"
            )
        if req.kind == "sssp":
            self._validate_sssp(req)
        elif req.kind == "pagerank":
            self._validate_pagerank(req)
        elif req.weights is not None or req.sources is not None:
            raise ValueError(
                f"request {req.uid}: weights/sources are only consumed "
                "by the sssp/pagerank kinds"
            )
        super().submit(req)

    @staticmethod
    def _weights(req: GraphRequest, kind: str) -> np.ndarray:
        """The request's float32 weights (None = unit), validated."""
        if req.weights is None:
            w = np.ones(req.num_edges, np.float32)
        else:
            w = np.asarray(req.weights, np.float32).ravel()
        if w.shape != req.src.shape:
            raise ValueError(
                f"request {req.uid}: weights length {w.shape} != edge "
                f"count {req.src.shape}"
            )
        if req.num_edges and (not np.isfinite(w).all() or bool((w < 0).any())):
            raise ValueError(
                f"request {req.uid}: {kind} weights must be finite and >= 0"
            )
        return w

    def _validate_sssp(self, req: GraphRequest) -> None:
        """Normalize + validate the sssp-only request fields, loudly."""
        if self.mesh is not None or self.engine == "sharded_frontier":
            raise ValueError(
                f"request {req.uid}: sssp waves run the single-device "
                "relax engines; drop mesh= / engine='sharded_frontier'"
            )
        extra = set(self.engine_kwargs) - {"min_bucket"}
        if extra:
            raise ValueError(
                f"request {req.uid}: {sorted(extra)} are not sssp "
                "engine knobs (only min_bucket= carries over)"
            )
        req.weights = self._weights(req, "sssp")
        if req.sources is None:
            s = np.zeros(1, np.int32)
        else:
            s = np.atleast_1d(np.asarray(req.sources, np.int32)).ravel()
        if not 1 <= len(s) <= self.max_sources:
            raise ValueError(
                f"request {req.uid}: {len(s)} sources exceeds the "
                f"per-request budget (1..max_sources={self.max_sources})"
            )
        if int(s.min()) < 0 or int(s.max()) >= req.num_nodes:
            raise ValueError(
                f"request {req.uid}: sources outside [0, {req.num_nodes})"
            )
        req.sources = s

    def _validate_pagerank(self, req: GraphRequest) -> None:
        """Normalize + validate the pagerank-only request fields."""
        if self.mesh is not None or self.engine == "sharded_frontier":
            raise ValueError(
                f"request {req.uid}: pagerank waves run the single-"
                "device dense engine; drop mesh= / "
                "engine='sharded_frontier'"
            )
        if self.engine_kwargs:
            raise ValueError(
                f"request {req.uid}: {sorted(self.engine_kwargs)} are "
                "not pagerank engine knobs (the dense fixed-iteration "
                "engine takes only damping= / pagerank_iters=)"
            )
        if req.sources is not None:
            raise ValueError(
                f"request {req.uid}: sources is an sssp-only field "
                "(pagerank scores every node)"
            )
        req.weights = self._weights(req, "pagerank")

    def _next_wave(self) -> list[GraphRequest]:
        """FIFO greedy packing under the node/edge budget (the
        degradation caps, when an OOM has lowered them). A wave stays
        within one packing FAMILY: the families run different device
        programs. A family boundary closes the wave (no reordering past
        it, so completion order stays deterministic)."""
        wave: list[GraphRequest] = []
        nodes = edges = 0
        while self.queue and len(wave) < self.max_requests:
            r = self.queue[0]
            if wave and _family(r.kind) != _family(wave[0].kind):
                break
            if wave and (
                nodes + r.num_nodes > self._node_budget
                or edges + r.num_edges > self._edge_budget
            ):
                break
            wave.append(self.queue.pop(0))
            nodes += r.num_nodes
            edges += r.num_edges
        return wave

    def _wave_caps(self, wave: list[GraphRequest]) -> tuple[int, int]:
        """The capacity bucket a wave maps to."""
        n_union = sum(r.num_nodes for r in wave)
        m_union = sum(r.num_edges for r in wave)
        node_cap = max(self.min_nodes, next_pow2(n_union))
        edge_cap = max(self.min_edges, next_pow2(max(m_union, 1)))
        return node_cap, edge_cap

    def _degrade(
        self, wave: list[GraphRequest], exc: Exception
    ) -> list[list[GraphRequest]] | None:
        """OOM-shaped failure: permanently cap the packing budget to
        half the failing bucket and re-pack this wave under it. A
        singleton wave cannot shrink, so it returns None and
        quarantines."""
        if len(wave) == 1:
            return None
        node_cap, edge_cap = self._wave_caps(wave)
        self._node_budget = min(
            self._node_budget, max(self.min_nodes, node_cap // 2)
        )
        self._edge_budget = min(
            self._edge_budget, max(self.min_edges, edge_cap // 2)
        )
        subs: list[list[GraphRequest]] = []
        cur: list[GraphRequest] = []
        nodes = edges = 0
        for r in wave:
            if cur and (
                nodes + r.num_nodes > self._node_budget
                or edges + r.num_edges > self._edge_budget
            ):
                subs.append(cur)
                cur, nodes, edges = [], 0, 0
            cur.append(r)
            nodes += r.num_nodes
            edges += r.num_edges
        if cur:
            subs.append(cur)
        if len(subs) == 1:  # budget already below the floor: halve by count
            mid = len(wave) // 2
            subs = [wave[:mid], wave[mid:]]
        return subs

    def _on_device(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Each packed host array as a tensor on the engine's device:
        one host-to-device copy apiece, once per wave."""
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def _layout(self, wave: list[GraphRequest]):
        """``(node_off, n_union, m_union, node_cap, edge_cap)``."""
        node_off = np.cumsum([0] + [r.num_nodes for r in wave])
        node_cap, edge_cap = self._wave_caps(wave)
        m_union = sum(r.num_edges for r in wave)
        return node_off, int(node_off[-1]), m_union, node_cap, edge_cap

    def _finish(self, bucket, rec: WaveRecord) -> None:
        """Bucket accounting and the wave record, only for waves that
        ran to completion: a wave that failed (injected fault, OOM,
        engine error) never reaches here."""
        self._buckets.add(bucket)
        self.wave_records.append(rec)
        rec.publish(self.metrics)

    def _run_wave(self, wave: list[GraphRequest]):
        from repro_torch.core import connected_components
        from repro_torch.trees import spanning_forest, tree_analytics

        if self.fault_plan is not None:
            self.fault_plan.check_wave(wave)

        if wave[0].kind == "sssp":  # family-pure by _next_wave
            return self._run_sssp_wave(wave)
        if wave[0].kind == "pagerank":
            return self._run_pagerank_wave(wave)

        stage = KINDS[max(_STAGE[r.kind] for r in wave)]
        node_off, n_union, m_union, node_cap, edge_cap = self._layout(wave)
        if self.fault_plan is not None:
            self.fault_plan.check_bucket(node_cap)
        with trace.span(
            "serve.wave.pack", requests=len(wave), stage=stage,
            node_cap=node_cap, edge_cap=edge_cap,
        ):
            # one (2, edge_cap) copy: pad slots are inert self-loops
            edges = self._on_device(
                np.stack(_pack_edges(wave, node_off, edge_cap))
            )[0]
            src, dst = edges[0], edges[1]

        bucket = (stage, node_cap, edge_cap)
        new_bucket = bucket not in self._buckets

        kw = dict(
            self.engine_kwargs, engine=self.engine, mesh=self.mesh,
            dedup=False,
        )
        if self.fault_plan is not None and self.fault_plan.wants_nonconverge(
            wave
        ):
            # Remove the round budget so the core engines' REAL
            # ConvergenceError sentinel fires for this wave.
            kw["max_rounds"] = 0
        # The engine span covers the device work AND the reads back to
        # the host -- those reads are the wave's sync, so the span
        # closes on an already-synced boundary.
        with trace.span(
            "serve.wave.engine", stage=stage, requests=len(wave),
            node_cap=node_cap, edge_cap=edge_cap, new_bucket=new_bucket,
        ) as esp:
            extras = None
            if stage == "cc":
                labels, rounds = connected_components(
                    src, dst, node_cap, **kw
                )
                labels = labels.cpu().numpy()
                edge_u = edge_v = None
            elif stage == "forest":
                forest = spanning_forest(src, dst, node_cap, **kw)
                labels, rounds = forest.labels, forest.rounds
                edge_u, edge_v = forest.edge_u, forest.edge_v
            else:
                ta = tree_analytics(
                    src, dst, node_cap,
                    rank_engine=self.rank_engine,
                    kernel_impl=self.kernel_impl,
                    num_splitters=self.num_splitters,
                    pad_edges_to=node_cap,
                    **kw,
                )
                labels, rounds = ta.forest.labels, ta.forest.rounds
                edge_u, edge_v = ta.forest.edge_u, ta.forest.edge_v
                comp = ta.computations
                # the five int32 (node_cap,) outputs in one read
                extras = torch.stack([
                    comp.parent, comp.depth, comp.subtree_size,
                    comp.preorder, comp.postorder,
                ]).cpu().numpy()
            esp.tag(rounds=int(rounds))

        with trace.span("serve.wave.unpack", requests=len(wave)):
            self._unpack(wave, node_off, labels, edge_u, edge_v, extras)

        self._finish(bucket, WaveRecord(
            requests=len(wave), stage=stage,
            num_nodes=n_union, num_edges=m_union,
            node_cap=node_cap, edge_cap=edge_cap,
            new_bucket=new_bucket, rounds=int(rounds),
        ))

    def _run_sssp_wave(self, wave: list[GraphRequest]):
        """The sssp-family wave: one multi-source ``shortest_paths``
        call over the disjoint union. Every request's sources become
        rows of the packed distance array (offset-shifted), padded to a
        ``src_cap`` power-of-two row count; pad edges are +inf-weight
        self-loops (inert under relax-min, never parents) and pad
        source rows target a pad node when one exists (an isolated
        node: the row converges at once). In a disjoint union request
        i's rows are its solo rows bit-exactly: no finite-weight path
        crosses an offset boundary. Only each request's own block of
        rows and columns comes back to the host: one gather and one
        read per output. ``fault_plan.check_wave`` already ran in
        ``_run_wave``."""
        from repro_torch.core import shortest_paths

        stage = "sssp"
        node_off, n_union, m_union, node_cap, edge_cap = self._layout(wave)
        row_off = np.cumsum([0] + [len(r.sources) for r in wave])
        src_cap = next_pow2(int(row_off[-1]))
        if self.fault_plan is not None:
            self.fault_plan.check_bucket(node_cap)
        with trace.span(
            "serve.wave.pack", requests=len(wave), stage=stage,
            node_cap=node_cap, edge_cap=edge_cap, src_cap=src_cap,
        ):
            src, dst, wts = _pack_edges(wave, node_off, edge_cap, np.inf)
            pad_src = n_union if n_union < node_cap else 0
            srcs = np.full((src_cap,), pad_src, np.int32)
            k = [len(r.sources) for r in wave]
            srcs[:row_off[-1]] = (np.concatenate([r.sources for r in wave])
                                  + _per_request(node_off, k))
            # Each request's (rows, columns) block of the (src_cap,
            # node_cap) outputs, flattened in request order: row j of
            # the wave (request i's) reads columns node_off[i] + [0, n_i).
            n_row = np.repeat([r.num_nodes for r in wave], k)
            row_start = np.cumsum(n_row) - n_row
            flat = (np.repeat(np.arange(row_off[-1]) * node_cap
                              + _per_request(node_off, k) - row_start, n_row)
                    + np.arange(int(n_row.sum())))
            edges, wts, flat = self._on_device(np.stack([src, dst]), wts, flat)

        bucket = (stage, node_cap, edge_cap, src_cap)
        new_bucket = bucket not in self._buckets

        # "auto" resolves to "dense"; a pinned "frontier" is honoured
        # (bit-exact).
        engine = "frontier" if self.engine == "frontier" else "dense"
        kw = dict(self.engine_kwargs)  # only min_bucket= survives submit
        if engine != "frontier":
            kw.pop("min_bucket", None)
        if self.fault_plan is not None and self.fault_plan.wants_nonconverge(
            wave
        ):
            kw["max_rounds"] = 0  # fire the REAL relax-bound sentinel
        with trace.span(
            "serve.wave.engine", stage=stage, requests=len(wave),
            node_cap=node_cap, edge_cap=edge_cap, src_cap=src_cap,
            new_bucket=new_bucket, engine=engine,
        ) as esp:
            dist, pred, rounds = shortest_paths(
                edges[0], edges[1], wts, node_cap, sources=srcs,
                engine=engine, **kw
            )
            dist = dist.reshape(-1)[flat].cpu().numpy()
            pred = pred.reshape(-1)[flat].cpu().numpy()
            esp.tag(rounds=int(rounds))

        with trace.span("serve.wave.unpack", requests=len(wave)):
            size = [len(r.sources) * r.num_nodes for r in wave]
            # unreachable stays -1; reachable parents shift back
            pred = np.where(pred >= 0, pred - _per_request(node_off, size),
                            -1).astype(np.int32)
            cut = np.cumsum([0] + size)
            for r, lo, hi in zip(wave, cut[:-1], cut[1:]):
                shape = (len(r.sources), r.num_nodes)
                r.result = GraphResult(
                    dist=dist[lo:hi].reshape(shape),
                    pred=pred[lo:hi].reshape(shape),
                    sources=r.sources.copy(),
                )
                r.done = True

        self._finish(bucket, WaveRecord(
            requests=len(wave), stage=stage,
            num_nodes=n_union, num_edges=m_union,
            node_cap=node_cap, edge_cap=edge_cap,
            new_bucket=new_bucket, rounds=int(rounds), src_cap=src_cap,
        ))

    def _run_pagerank_wave(self, wave: list[GraphRequest]):
        """The pagerank-family wave: one dense fixed-iteration
        ``pagerank`` call over the disjoint union. Each request keeps
        its SOLO teleport vector in its node slice (``1/n_i`` uniform
        mass), pad nodes get teleport 0, and pad edges are weight-0.0
        self-loops: they push zero mass and add zero degree, and ``x +
        0.0f == x`` bitwise for the non-negative scores and degrees
        PageRank produces. Mass never crosses an offset boundary and the
        packed edge-slot order restricted to one request is its solo
        order (forward arcs then backward arcs, pads between them adding
        +0.0), so the slot-order fold (``ordered_fold``) accumulates
        each node's mass in exactly its solo sequence: every unpacked
        ``scores`` slice is bit-identical to the solo dense run at
        ``pagerank_iters`` iterations. Every pad arc targets node 0, so
        node 0 folds ``2 * (edge_cap - m_union)`` extra +0.0 slots an
        iteration. ``fault_plan.check_wave`` already ran in
        ``_run_wave``."""
        from repro_torch.core.pagerank import pagerank

        stage = "pagerank"
        node_off, n_union, m_union, node_cap, edge_cap = self._layout(wave)
        if self.fault_plan is not None:
            self.fault_plan.check_bucket(node_cap)
        with trace.span(
            "serve.wave.pack", requests=len(wave), stage=stage,
            node_cap=node_cap, edge_cap=edge_cap,
        ):
            src, dst, wts = _pack_edges(wave, node_off, edge_cap, 0.0)
            n = np.array([r.num_nodes for r in wave])
            tel = np.zeros((node_cap,), np.float32)
            # 1/n_i in float64, rounded once to float32: the solo default
            tel[:n_union] = np.repeat((1.0 / n).astype(np.float32), n)
            edges, wts = self._on_device(np.stack([src, dst]), wts)

        bucket = (stage, node_cap, edge_cap)
        new_bucket = bucket not in self._buckets

        kw = {}
        if self.fault_plan is not None and self.fault_plan.wants_nonconverge(
            wave
        ):
            # Cap the iteration budget below the fixed count so the
            # dense engine's REAL ConvergenceError sentinel fires.
            kw["max_rounds"] = 0
        with trace.span(
            "serve.wave.engine", stage=stage, requests=len(wave),
            node_cap=node_cap, edge_cap=edge_cap, new_bucket=new_bucket,
            engine="dense",
        ) as esp:
            # teleport stays numpy: pagerank validates it on the host
            # and copies it to the edges' device once
            scores, iters = pagerank(
                edges[0], edges[1], wts, node_cap,
                damping=self.damping, teleport=tel,
                num_iters=self.pagerank_iters, engine="dense", **kw,
            )
            scores = scores.cpu().numpy()
            esp.tag(rounds=int(iters))

        with trace.span("serve.wave.unpack", requests=len(wave)):
            for r, o in zip(wave, node_off):
                r.result = GraphResult(
                    scores=scores[o:o + r.num_nodes].copy()
                )
                r.done = True

        self._finish(bucket, WaveRecord(
            requests=len(wave), stage=stage,
            num_nodes=n_union, num_edges=m_union,
            node_cap=node_cap, edge_cap=edge_cap,
            new_bucket=new_bucket, rounds=int(iters),
        ))

    def _unpack(self, wave, node_off, labels, edge_u, edge_v, extras):
        """Slice the packed union's host outputs back to request-local
        ids."""
        n_union = int(node_off[-1])
        shift = _per_request(node_off, [r.num_nodes for r in wave])
        # A request's labels are ids of its own node range, so the
        # union's distinct labels, bucketed by request, count each
        # request's components.
        owner = np.searchsorted(node_off, np.unique(labels[:n_union]),
                                side="right") - 1
        comps = np.bincount(owner, minlength=len(wave))
        labels = (labels[:n_union] - shift).astype(np.int32)
        if extras is not None:
            extras = extras[:, :n_union]
            parent = (extras[0] - shift).astype(np.int32)
            depth, size, pre, post = extras[1:]
        if edge_u is not None:
            # Request i's forest edges are the hook slots of its own node
            # range, already in solo (hooked-tree id) order: one stable
            # sort by owning request keeps that order and groups them
            # (the reference masks the whole forest once a request).
            owner = np.searchsorted(node_off, edge_u, side="right") - 1
            order = np.argsort(owner, kind="stable")
            owner = owner[order]
            edge_u = edge_u[order] - node_off[owner]
            edge_v = edge_v[order] - node_off[owner]
            cut = np.searchsorted(owner, np.arange(len(wave) + 1))
        for i, (r, lo, hi) in enumerate(zip(wave, node_off[:-1], node_off[1:])):
            res = GraphResult(labels=labels[lo:hi],
                              num_components=int(comps[i]))
            # fill only the fields the request's OWN kind asked for --
            # stage promotion must not leak wave-mate-dependent extras
            if edge_u is not None and _STAGE[r.kind] >= _STAGE["forest"]:
                res.edge_u = edge_u[cut[i]:cut[i + 1]].astype(np.int32)
                res.edge_v = edge_v[cut[i]:cut[i + 1]].astype(np.int32)
            if extras is not None and r.kind == "analytics":
                res.parent = parent[lo:hi]
                res.depth = depth[lo:hi]
                res.subtree_size = size[lo:hi]
                res.preorder = pre[lo:hi]
                res.postorder = post[lo:hi]
            r.result = res
            r.done = True

    def run(self) -> list[GraphRequest]:
        """Process the whole queue; returns the requests that reached a
        terminal state during THIS call, in completion order:
        ``result`` populated (``done``) or quarantined (``failed`` with
        ``error`` set)."""
        return super().run()
