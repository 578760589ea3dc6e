"""Serial NumPy oracle for the Euler-tour tree computations.

The port's copy of ``repro.trees.reference``. It walks each tree's
Euler circuit arc by arc in a Python loop -- no list ranking, no prefix
scans, no torch -- keeping DFS counters, so the parallel pipeline's
depth, parent, size, preorder and postorder can be checked bit for bit.
The arc order (stable sort by source, twin-next rule, root = min node
id unless re-rooted) is the tour's by definition; the rest is
independent.
"""
from __future__ import annotations

import numpy as np


def serial_tree_reference(
    edge_u,
    edge_v,
    num_nodes: int,
    *,
    labels=None,
    root: int | None = None,
) -> dict:
    """Reference parent/depth/subtree_size/preorder/postorder arrays.

    ``edge_u``/``edge_v`` must be a forest. Roots follow the same
    convention as ``euler_tour``: the minimum node id per component
    (or ``root`` for its own tree).
    """
    n = num_nodes
    u = np.asarray(edge_u, np.int64).ravel()
    v = np.asarray(edge_v, np.int64).ravel()
    f = len(u)

    if labels is None:
        from repro_torch.core.serial import serial_connected_components

        labels = serial_connected_components(np.stack([u, v], axis=1), n) \
            if f else np.arange(n, dtype=np.int64)
    labels = np.asarray(labels, np.int64)
    root_of = labels.copy()
    if root is not None:
        root_of[labels == labels[root]] = root

    parent = np.arange(n, dtype=np.int64)
    depth = np.zeros(n, np.int64)
    size = np.ones(n, np.int64)
    pre = np.zeros(n, np.int64)
    post = np.zeros(n, np.int64)
    if f == 0:
        return dict(parent=parent, depth=depth, subtree_size=size,
                    preorder=pre, postorder=post)

    # Same arc layout as trees/tour.py: arcs [u->v | v->u], stable-sorted
    # by source; twin at stride f; successor = arc after twin in the
    # destination's circular adjacency.
    asrc = np.concatenate([u, v])
    adst = np.concatenate([v, u])
    L = 2 * f
    order = np.argsort(asrc, kind="stable")
    inv = np.empty(L, np.int64)
    inv[order] = np.arange(L)
    counts = np.bincount(asrc, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    twin = (np.arange(L) + f) % L
    tpos = inv[twin]
    grp_end = offsets[adst] + counts[adst]
    nxt_pos = np.where(tpos + 1 < grp_end, tpos + 1, offsets[adst])
    succ = order[nxt_pos]

    # Serial circuit walk per tree root, maintaining DFS counters.
    roots = np.unique(root_of[asrc])
    in_pos = np.full(n, -1, np.int64)
    out_pos = np.full(n, -1, np.int64)
    for r in roots:
        head = order[offsets[r]]
        pre_c, post_c, p = 0, 0, 0
        arc = head
        while True:
            a, bnode = int(asrc[arc]), int(adst[arc])
            if in_pos[bnode] < 0 and bnode != r:
                # forward arc: discover bnode
                parent[bnode] = a
                depth[bnode] = depth[a] + 1
                pre_c += 1
                pre[bnode] = pre_c
                in_pos[bnode] = p
            else:
                # backward arc: finish a
                post[a] = post_c
                post_c += 1
                out_pos[a] = p
            p += 1
            arc = int(succ[arc])
            if arc == head:
                break
        post[r] = post_c  # root finishes last
        size[r] = post_c + 1
    covered = in_pos >= 0
    size[covered] = (out_pos[covered] - in_pos[covered] + 1) // 2
    return dict(parent=parent, depth=depth, subtree_size=size,
                preorder=pre, postorder=post)
