"""GNN architectures of the port: GIN, GAT, EGNN, MACE (with ``so3``) and
the GCN, GraphSAGE and PNA of ``extra.py``, the counterparts of
``repro.models.gnn``, built on the ``ops.scatter_gather`` /
``ops.segment`` message-passing substrate, whose float sums run in the
``segment_sum`` kernel.

Each model module has a config dataclass, parameters in an
``nn.Module`` (``nn.Linear`` layers for GIN and GAT, a ``ParamTree``
under the reference's keys for the others), an init taking
``(cfg, *, generator, device)``, a forward taking ``(params, cfg,
graph)`` and a loss taking the reference's arguments.
``convert.params_from_jax`` carries the reference's parameters across.
"""
