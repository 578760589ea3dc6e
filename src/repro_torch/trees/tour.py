"""Euler tour construction by sorted adjacency twinning (Tarjan-Vishkin).

The port of ``repro.trees.tour``. Each forest edge {u, v} becomes two
arcs u->v and v->u (twins at a fixed stride). Arcs are grouped by source
with ONE stable sort (``ops/sorted_dispatch.sort_by_key``) and the
per-node group extents come from ``grouped_offsets``. The tour successor
of arc (u->v) is the arc after its twin (v->u) in v's circular
adjacency, which yields one Euler circuit per tree; breaking each
circuit at its root's first arc (terminal arcs become self-loops) gives
the linked-list shape ``wylie_rank`` and ``random_splitter_rank``
consume: the whole forest is one multi-list ranking instance.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import as_int32
from repro_torch.ops.sorted_dispatch import grouped_offsets, sort_by_key


@dataclass
class EulerTour:
    """A linearized Euler tour of a spanning forest, padded or exact.

    ``succ`` is the tour successor over arc ids (terminal arcs and
    padded slots are self-loops), ready for list ranking. ``valid``
    masks the ``num_arcs`` real arcs -- a contiguous prefix unless the
    tour was built over a padded edge buffer (``num_edges=``), so
    consumers mask by it rather than slicing. Padded slots are inert
    self-loops at node 0. Every tensor lives on the tour's device.
    """

    succ: torch.Tensor  # (L,) int32 tour successor (self-loop terminals)
    arc_src: torch.Tensor  # (L,) int32 source node per arc
    arc_dst: torch.Tensor  # (L,) int32 destination node per arc
    twin: torch.Tensor  # (L,) int32 opposite-orientation arc (self for padding)
    head_of_arc: torch.Tensor  # (L,) int32 head arc of the arc's own tour
    valid: torch.Tensor  # (L,) bool, False on padded/dead slots
    num_arcs: int  # 2 * num_edges real arcs (pre-padding)
    num_nodes: int
    labels: torch.Tensor  # (n,) int32 component label per node
    root_of: torch.Tensor  # (n,) int32 tree root per node (= labels unless re-rooted)

    @property
    def capacity(self) -> int:
        return int(self.succ.shape[0])


def tour_capacity(num_edges: int, min_capacity: int = 16) -> int:
    """Power-of-two arc capacity covering a forest of ``num_edges``
    edges: the padded-batch convention."""
    need = max(2 * num_edges, min_capacity)
    return 1 << (need - 1).bit_length()


def _build_tour(u, v, root_of, k: int, *, n: int, f: int, pad: int):
    """Tour tensors over a (possibly edge-padded) forest edge buffer of
    ``f`` slots, of which the first ``k`` are live. Dead edge slots
    become self-loop arcs grouped under a virtual node ``n``, so they
    sort past every real adjacency group and never perturb the
    twin-next rule."""
    dev = u.device
    L2 = 2 * f
    ids = torch.arange(L2, dtype=torch.int32, device=dev)
    live = (ids % f) < k  # arc j mirrors edge slot j mod f
    asrc = torch.cat([u, v])
    adst = torch.cat([v, u])
    src_key = torch.where(live, asrc, n)
    dst_key = torch.where(live, adst, n).long()
    twin = (ids + f) % L2

    # Group arcs by source: ONE stable sort + group counts. Dead arcs
    # all carry key n, a trailing group real arcs never read.
    sorted_src, perm = sort_by_key(src_key)
    perm = perm.to(torch.int32)
    inv = torch.empty(L2, dtype=torch.int32, device=dev)
    inv[perm.long()] = ids
    counts, offsets = grouped_offsets(sorted_src, n + 1)

    # succ(u->v) = the arc after twin (v->u) in v's circular adjacency.
    tpos = inv[twin.long()]
    grp_end = offsets[dst_key] + counts[dst_key]
    nxt_pos = torch.where(tpos + 1 < grp_end, tpos + 1, offsets[dst_key])
    succ = perm[nxt_pos.long()]

    # Linearize each circuit at its root's first arc. The clamps only
    # guard unused (isolated-root or dead) lanes.
    head_by_node = perm[offsets[root_of.long()].clamp(max=L2 - 1).long()]
    head_of_arc = head_by_node[src_key.clamp(max=n - 1).long()]
    succ = torch.where(succ == head_of_arc, ids, succ)

    # Dead edge slots collapse to inert self-loops, like the padding.
    succ = torch.where(live, succ, ids)
    twin = torch.where(live, twin, ids)
    head_of_arc = torch.where(live, head_of_arc, ids)
    asrc = torch.where(live, asrc, 0)
    adst = torch.where(live, adst, 0)

    if pad > 0:
        pad_ids = torch.arange(L2, L2 + pad, dtype=torch.int32, device=dev)
        zeros = torch.zeros(pad, dtype=torch.int32, device=dev)
        succ = torch.cat([succ, pad_ids])
        twin = torch.cat([twin, pad_ids])
        head_of_arc = torch.cat([head_of_arc, pad_ids])
        asrc = torch.cat([asrc, zeros])
        adst = torch.cat([adst, zeros])
        live = torch.cat([live, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return succ, asrc, adst, twin, head_of_arc, live


def euler_tour(
    edge_u,
    edge_v,
    num_nodes: int,
    *,
    labels=None,
    root: int | None = None,
    pad_to: int | None = None,
    num_edges: int | None = None,
    device=None,
) -> EulerTour:
    """Build the linearized Euler tour of a spanning forest.

    ``edge_u``/``edge_v`` are the forest edges (e.g. from
    ``spanning_forest``); a non-forest edge set is undefined. ``labels``
    are per-node component labels; when omitted, the port's dense
    ``shiloach_vishkin`` computes them over the forest. The label (min
    node id) roots each tree, unless ``root=`` re-roots the tree that
    holds it. ``pad_to`` pads the arc tensors to a fixed capacity with
    inert self-loops (see ``tour_capacity``).

    ``num_edges`` declares ``edge_u``/``edge_v`` a PADDED buffer of which
    only the first ``num_edges`` slots are live. The two arcs of a dead
    slot become inert self-loops under the virtual node ``n``, so
    ``valid`` is then no contiguous prefix: consumers mask by it.
    Host inputs go to ``device`` (default: the CUDA card); tensors stay
    where they are.
    """
    n = num_nodes
    u = as_int32(edge_u, device)
    v = as_int32(edge_v, u.device)
    F = int(u.shape[0])
    f = F if num_edges is None else int(num_edges)
    if not 0 <= f <= F:
        raise ValueError(f"num_edges={f} outside the edge buffer [0, {F}]")
    cap = pad_to if pad_to is not None else 2 * F
    if cap < 2 * F:
        raise ValueError(f"pad_to={cap} below the {2 * F} arcs of the forest")

    if labels is None:
        from repro_torch.core.components import shiloach_vishkin

        labels, _ = shiloach_vishkin(u[:f], v[:f], n)
    labels = as_int32(labels, u.device)
    if root is not None:
        root_of = torch.where(labels == labels[root], root, labels)
    else:
        root_of = labels

    if f == 0:  # no live edges: every node is its own (tour-less) tree
        ids = torch.arange(cap, dtype=torch.int32, device=u.device)
        zeros = torch.zeros(cap, dtype=torch.int32, device=u.device)
        return EulerTour(
            succ=ids, arc_src=zeros, arc_dst=zeros, twin=ids,
            head_of_arc=ids,
            valid=torch.zeros(cap, dtype=torch.bool, device=u.device),
            num_arcs=0, num_nodes=n, labels=labels, root_of=root_of,
        )

    succ, asrc, adst, twin, head_of_arc, valid = _build_tour(
        u, v, root_of, f, n=n, f=F, pad=cap - 2 * F
    )
    return EulerTour(
        succ=succ, arc_src=asrc, arc_dst=adst, twin=twin,
        head_of_arc=head_of_arc, valid=valid,
        num_arcs=2 * f, num_nodes=n, labels=labels, root_of=root_of,
    )
