"""Multi-rank engines on ``torch.distributed``: the port of
``repro.distributed``. ``graph`` holds the edge-partitioned graph engine
(sharded connected components and list ranking); ``mesh`` the named
meshes, ``collectives`` the collectives with their gradients,
``sharding`` the sharding rules and layouts, and ``pipeline`` GPipe over
a stage axis (sharded training)."""
from repro_torch.distributed.graph import (
    EXCHANGES,
    GRAPH_AXIS,
    CCExchangeStats,
    GraphMesh,
    ShardedFrontierStats,
    cc_exchange_words_per_round,
    default_sparse_capacity,
    frontier_sparse_capacity,
    graph_mesh,
    rank_exchange_words,
    sharded_frontier_shiloach_vishkin,
    sharded_random_splitter_rank,
    sharded_shiloach_vishkin,
)

__all__ = [
    "GRAPH_AXIS",
    "EXCHANGES",
    "GraphMesh",
    "graph_mesh",
    "CCExchangeStats",
    "ShardedFrontierStats",
    "default_sparse_capacity",
    "frontier_sparse_capacity",
    "cc_exchange_words_per_round",
    "rank_exchange_words",
    "sharded_shiloach_vishkin",
    "sharded_frontier_shiloach_vishkin",
    "sharded_random_splitter_rank",
]
