"""Euler-tour tree analytics: list ranking and connectivity, composed.

The port of ``repro.trees``, in three layers:

1. **forest** -- a spanning forest from the hook decisions of
   Shiloach-Vishkin connected components (``record_hooks=True``), which
   leaves labels and round counts as they are.
2. **tour** -- the Euler tour of that forest, built by sorted adjacency
   twinning (``ops/sorted_dispatch``): a successor array that is a
   ready-made input to the list-ranking engines.
3. **compute** -- tree computations (``root_tree``, ``depths``,
   ``subtree_sizes``, ``preorder``/``postorder``) as +-1-weighted ranks
   over the tour, through ``wylie_rank`` or ``random_splitter_rank``
   (its ``pointer_jump`` and ``splitter_aggregate`` kernels); a forest
   of many small trees runs batched in one (optionally padded) tour.

``reference.serial_tree_reference`` is the serial numpy oracle.
"""
from repro_torch.trees.forest import SpanningForest, spanning_forest
from repro_torch.trees.tour import EulerTour, euler_tour, tour_capacity
from repro_torch.trees.compute import (
    RANK_ENGINES,
    TreeAnalytics,
    TreeComputations,
    depths,
    postorder,
    preorder,
    root_tree,
    subtree_sizes,
    tour_ranks,
    tour_splitters,
    tree_analytics,
    tree_computations,
)

__all__ = [
    "SpanningForest",
    "spanning_forest",
    "EulerTour",
    "euler_tour",
    "tour_capacity",
    "RANK_ENGINES",
    "TreeAnalytics",
    "TreeComputations",
    "tour_ranks",
    "tour_splitters",
    "tree_computations",
    "tree_analytics",
    "root_tree",
    "depths",
    "subtree_sizes",
    "preorder",
    "postorder",
]
