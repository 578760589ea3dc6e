"""Shiloach-Vishkin connected components in PyTorch (paper section 4).

The port of ``repro.core.components``. The paper's seven kernels SV0..SV5
become the phases of one round, and the rounds run in a host loop that
reads the "changed" flag once per round (the reference runs them in a
``lax.while_loop``). Arbitrary-CRCW concurrent writes become
deterministic min-CRCW scatters, so runs are reproducible and the
O(log_{3/2} n) + 2 round bound holds.

JAX's ``.at[tgt].min(v, mode="drop")`` with ``tgt = n`` as the no-op lane
has no torch mode; the port scatters into an ``n + 1`` buffer with
``scatter_reduce_(..., "amin")`` (which keeps the old value, as
``.at[].min`` does) and cuts the scratch slot off
(``kernels/edge_hook/ref.py``).

The round body is built once by ``sv_round_fns`` and shared by the dense
loop (``sv_run`` / ``shiloach_vishkin``), the frontier-compacted engine
(``repro_torch.core.frontier``) and the edge-partitioned engines
(``repro_torch.distributed.graph``), so their hook semantics are the
same by construction. Its SV2/SV3 hook phases always go through the
``edge_hook`` wrapper: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU.

Cross-rank merges use the reference's convention ``fn(arr, base, aux, s)
-> (arr, aux)``: ``base`` is the replicated pre-scatter array (what every
rank agreed on before this phase's min-scatter), which lets the sparse
exchange send only the (index, label) pairs that changed; ``aux``
threads exchange statistics through the round loop. On one device the
merges are identities.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import as_int32
from repro_torch.kernels.edge_hook.ops import edge_hook
from repro_torch.kernels.edge_hook.ref import drop_scatter_fill, drop_scatter_min

HOOK_IMPLS = ("auto", "torch", "cuda")


def sv_round_bound(n: int) -> int:
    """Paper/[14]: at most floor(log_{3/2} n) + 2 rounds."""
    return int(math.floor(math.log(max(n, 2)) / math.log(1.5))) + 2


class ConvergenceError(RuntimeError):
    """A bounded round/walk loop hit its bound without reaching a
    fixpoint. Labels past the bound would be WRONG, so every engine
    raises this instead of returning them."""


def _identity_merge(arr, base, aux, s):
    del base, s
    return arr, aux


def _lift_merge(fn):
    """Adapt an engine merge fn (which owns only its engine aux) to the
    nested ``(hooks, engine_aux)`` aux used when ``record_hooks`` is on,
    so no engine's merge functions need to know about hook recording."""

    def lifted(arr, base, aux, s):
        hooks, inner = aux
        arr, inner = fn(arr, base, inner, s)
        return arr, (hooks, inner)

    return lifted


def check_choice(kind: str, value, choices) -> None:
    """Reject unknown dispatch strings loudly, naming the valid set."""
    if value not in choices:
        raise ValueError(
            f"unknown {kind} {value!r}; valid choices: "
            + ", ".join(repr(c) for c in choices)
        )


def init_hooks(n: int, device):
    """Fresh hook-recording state: ``(hook_u, hook_v)``, sentinel ``n``.

    Slot r holds the endpoints of the graph edge that won the min-CRCW
    hook of tree r, or ``n`` if tree r never hooked (component roots).
    Each slot hooks at most once over a run, so the recorded pairs form a
    spanning forest (see ``repro.core.components.init_hooks``)."""
    return (
        torch.full((n,), n, dtype=torch.int32, device=device),
        torch.full((n,), n, dtype=torch.int32, device=device),
    )


def _hook_phase_fns(a: torch.Tensor, b: torch.Tensor, hook_impl: str):
    """SV2/SV3 hook phases over the edge arrays, through the fused
    ``edge_hook`` kernel (or its plain version, per ``hook_impl``)."""

    def sv2(D1, D, Q, s):
        return edge_hook(a, b, D1, Q, s, labels_prev=D, mode="sv2",
                         impl=hook_impl)

    def sv3(D2, Q, s):
        # The kernel exports its compare mask D2[a] != D2[b]: a superset
        # of the edges still able to hook (label equality is permanent).
        return edge_hook(a, b, D2, Q, s, mode="sv3", impl=hook_impl)

    return sv2, sv3


def sv_round_fns(
    a: torch.Tensor,
    b: torch.Tensor,
    n: int,
    merge_labels=None,
    merge_stamps=None,
    hook_impl: str = "auto",
    with_frontier: bool = False,
    record_hooks: bool = False,
    merge_hooks=None,
):
    """Build the SV1a..SV5 round body over edge arrays ``(a, b)``.

    Returns ``round_body(carry) -> carry`` with carry
    ``(D, Q, aux, s, changed)``: labels, stamps, the merges' aux (with
    ``record_hooks``, ``(hooks, engine_aux)``; ``None`` where nothing is
    recorded), the round number as a Python int, and the device bool
    "did this round change anything" (SV5). ``with_frontier=True``
    appends the per-edge frontier mask, read off the SV3 phase's own
    gathers (``(D, Q, aux, s, changed, fmask)``).

    ``merge_labels`` / ``merge_stamps`` run right after each phase's
    min-scatter (identities by default; see the module docstring).

    ``record_hooks=True`` records, for every hook event, the graph edge
    that won the min-CRCW scatter, with ties broken to the
    lexicographically smallest ``(u, v)``. Recording only reads the
    label state, so labels, stamps and round counts are the same with
    it on or off. ``merge_hooks`` is the cross-rank reduction of the
    candidate arrays (a MIN all-reduce in the sharded engines); it runs
    twice a phase -- once to agree on the winning ``u``, once for the
    matching ``v`` -- so the recorded pair is a real edge even when the
    winner lies in another rank's shard.
    """
    ml = merge_labels if merge_labels is not None else _identity_merge
    mq = merge_stamps if merge_stamps is not None else _identity_merge
    if record_hooks:
        ml, mq = _lift_merge(ml), _lift_merge(mq)
    mh = merge_hooks if merge_hooks is not None else (lambda arr: arr)
    sv2_hook, sv3_hook = _hook_phase_fns(a, b, hook_impl)

    def record_phase(hooks, cond, tgt, val, D_before, D_after):
        """Record the winning edge of every slot this phase hooked: the
        edges that met the phase's condition, targeted the slot, and
        wrote exactly the value that survived the min."""
        hook_u, hook_v = hooks
        tc = torch.clamp(tgt, max=n - 1)  # non-winners are masked below
        hooked = D_after[tc] != D_before[tc]
        win = cond & (val == D_after[tc]) & hooked
        empty = torch.full_like(D_after, n)
        cu = mh(drop_scatter_min(empty, torch.where(win, tgt, n), a))
        win_v = win & (a == cu[tc])
        cv = mh(drop_scatter_min(empty, torch.where(win_v, tgt, n), b))
        return (
            torch.where(cu < n, cu, hook_u), torch.where(cv < n, cv, hook_v)
        )

    def round_body(carry):
        D, Q, aux, s = carry[:4]

        # SV1a: short-cut.
        D1 = D[D]
        # SV1b: mark roots whose tree shrank (every lane writes s).
        Q = drop_scatter_fill(Q, torch.where(D1 != D, D1, n), s)
        q_base = Q  # replicated: the shrink marks are rank-independent

        D2, Q = sv2_hook(D1, D, Q, s)
        D2, aux = ml(D2, D1, aux, s)
        Q, aux = mq(Q, q_base, aux, s)
        if record_hooks:
            hooks, inner = aux
            Da, Db = D1[a], D1[b]
            cond2 = (Da == D[a]) & (Db < Da)
            hooks = record_phase(
                hooks, cond2, torch.where(cond2, Da, n), Db, D1, D2
            )
            aux = (hooks, inner)

        D3, fmask = sv3_hook(D2, Q, s)
        D3, aux = ml(D3, D2, aux, s)
        if record_hooks:
            hooks, inner = aux
            Da3, Db3 = D2[a], D2[b]
            cond3 = (Q[Da3] < s) & (D2[Da3] == Da3) & (Da3 != Db3)
            hooks = record_phase(
                hooks, cond3, torch.where(cond3, Da3, n), Db3, D2, D3
            )
            aux = (hooks, inner)

        # SV4: short-cut again.
        D4 = D3[D3]
        # SV5: parallel OR "did anything change this round?".
        changed = (Q == s).any()
        if with_frontier:
            return D4, Q, aux, s + 1, changed, fmask
        return D4, Q, aux, s + 1, changed

    return round_body


def sv_compress(D: torch.Tensor, n: int) -> torch.Tensor:
    """Full path compression so labels are true roots (min-hooking can
    leave 2-level trees on the last round)."""
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        D = D[D]
    return D


def sv_run(
    a: torch.Tensor,
    b: torch.Tensor,
    n: int,
    bound: int,
    merge_labels=None,
    merge_stamps=None,
    *,
    hook_impl: str = "auto",
    aux0=None,
    return_aux: bool = False,
    record_hooks: bool = False,
    merge_hooks=None,
):
    """The SV0..SV5 round loop over edge arrays (a, b), on their device.

    ``merge_labels`` / ``merge_stamps`` / ``merge_hooks`` and the merges'
    starting ``aux0`` are as in ``sv_round_fns`` (identities on one
    device). Returns ``(D, rounds, converged[, hooks][, aux])``.
    ``converged`` is True iff the loop stopped because a round changed
    nothing, False iff it stopped at ``bound`` with changes still
    flowing. The host reads the round's "changed" flag once per round;
    after the merges it is the same on every rank.
    """
    dev = a.device
    # SV0: D(0)[j] = j, Q[j] = 0
    D = torch.arange(n, dtype=torch.int32, device=dev)
    Q = torch.zeros(n, dtype=torch.int32, device=dev)
    aux = aux0
    if record_hooks:
        aux = (init_hooks(n, dev), aux)
    round_body = sv_round_fns(
        a, b, n, merge_labels, merge_stamps, hook_impl=hook_impl,
        record_hooks=record_hooks, merge_hooks=merge_hooks,
    )
    s, changed = 1, True
    while changed and s <= bound:
        D, Q, aux, s, flag = round_body((D, Q, aux, s, changed))
        changed = bool(flag)
    D = sv_compress(D, n)
    out = (D, s - 1, not changed)
    if record_hooks:
        hooks, aux = aux
        out = out + (hooks,)
    if return_aux:
        out = out + (aux,)
    return out


def dedup_edges(src, dst) -> tuple[np.ndarray, np.ndarray]:
    """Drop self-loops and duplicate undirected edges (host-side).

    Self-loops can never hook (SV2 needs Db < Da, SV3 Da != Db) and
    duplicates min-hook idempotently, so removing them changes neither
    labels nor round count -- it only shrinks the 2m edge walk.
    """
    e = np.stack(
        [np.asarray(src).ravel(), np.asarray(dst).ravel()], axis=1
    ).astype(np.int64)
    lo, hi = e.min(axis=1), e.max(axis=1)
    keep = lo != hi
    u = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)
    return u[:, 0].astype(np.int32), u[:, 1].astype(np.int32)


def _maybe_dedup(src, dst, dedup: bool):
    """Dedup host-side (numpy/list) edge inputs; tensors pass through
    untouched -- dedup is label/round-neutral, so skipping it never
    changes results, and tensor callers who want the smaller walk
    dedup once via ``dedup_edges`` up front."""
    host = isinstance(src, (np.ndarray, list, tuple)) and isinstance(
        dst, (np.ndarray, list, tuple)
    )
    if not dedup or not host:
        return src, dst
    return dedup_edges(src, dst)


def oriented_edges(src, dst, n: int, device=None):
    """Both orientations ``(a, b)`` of the undirected edge list, as int32
    tensors on the edges' device (tensors) or on ``device`` (host data).

    Every endpoint must be a node id in ``[0, n)``; anything else raises
    ``ValueError`` here, with one device->host read, because on the card
    the hook kernels would gather and scatter out of bounds with it."""
    src, dst = as_int32(src, device), as_int32(dst, device)
    a, b = torch.cat([src, dst]), torch.cat([dst, src])
    if a.numel():
        lo, hi = torch.stack(torch.aminmax(a)).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(
                f"edge endpoints must lie in [0, {n}); got ids from {lo} "
                f"to {hi}"
            )
    return a, b


def oriented_weights(weights, a: torch.Tensor) -> torch.Tensor:
    """The float32 weight lane of the arcs ``a`` that ``oriented_edges``
    returned: ``weights`` (one per input edge; ``None`` means unit
    weights) for both orientations, on ``a``'s device."""
    m = a.shape[0] // 2
    if weights is None:
        w = torch.ones(m, dtype=torch.float32, device=a.device)
    elif isinstance(weights, torch.Tensor):
        w = weights.reshape(-1).to(device=a.device, dtype=torch.float32)
    else:
        w = torch.from_numpy(np.asarray(weights, np.float32).ravel()).to(a.device)
    if w.shape[0] != m:
        raise ValueError(f"weights length {w.shape[0]} != edge count {m}")
    return torch.cat([w, w])


def shiloach_vishkin(
    src,
    dst,
    num_nodes: int,
    *,
    max_rounds: int | None = None,
    dedup: bool = True,
    hook_impl: str = "auto",
    record_hooks: bool = False,
    device=None,
):
    """Connected components, walking every edge every round. Edges are
    undirected (both orientations are processed, the paper's 2m edge
    walk); self-loops and duplicates in host-side inputs are dropped up
    front (``dedup=False`` keeps the raw walk).

    Returns ``(labels, rounds)``; ``labels[i]`` is the component root
    id. ``record_hooks=True`` appends the spanning-forest hook record
    ``(hook_u, hook_v)``. Hitting ``max_rounds`` without a fixpoint
    raises ``ConvergenceError``. Host inputs go to ``device`` (default:
    the CUDA card); tensors stay where they are.
    """
    from repro_torch.obs import trace

    n = num_nodes
    check_choice("hook_impl", hook_impl, HOOK_IMPLS)
    bound = max_rounds if max_rounds is not None else sv_round_bound(n)
    src, dst = _maybe_dedup(src, dst, dedup)
    a, b = oriented_edges(src, dst, n, device)
    # The run's device span waits for the labels at close -- the same
    # point where the convergence flag has already been read.
    with trace.span("cc.dense", device=True, n=n, bound=bound) as sp:
        out = sv_run(a, b, n, bound, hook_impl=hook_impl,
                     record_hooks=record_hooks)
        labels, rounds, converged = out[0], out[1], out[2]
        sp.block_on(labels)
    if not converged:
        raise ConvergenceError(
            f"shiloach_vishkin hit max_rounds={bound} before the label "
            f"fixpoint on {n} nodes; raise max_rounds (the proven bound "
            f"is sv_round_bound(n)={sv_round_bound(n)})"
        )
    return (labels, rounds) + out[3:]


def label_propagation(
    src, dst, num_nodes: int, *, max_rounds: int | None = None, device=None
):
    """Min-label propagation baseline: O(diameter) rounds, O(m) work per
    round. Returns ``(labels, rounds)``."""
    n = num_nodes
    bound = max_rounds if max_rounds is not None else n
    a, b = oriented_edges(src, dst, n, device)
    D = torch.arange(n, dtype=torch.int32, device=a.device)
    s, changed = 0, True
    while changed and s < bound:
        Dn = D.scatter_reduce(0, b.long(), D[a], "amin", include_self=True)
        Dn = Dn[Dn]  # pointer-jump accelerates long chains
        changed = bool((Dn != D).any())
        D, s = Dn, s + 1
    return sv_compress(D, n), s


def num_components(labels) -> int:
    if isinstance(labels, torch.Tensor):
        return int(torch.unique(labels).numel())
    return int(len(np.unique(np.asarray(labels))))
