"""GNN architectures of the port: GIN and GAT, the counterparts of
``repro.models.gnn.{gin,gat}``, built on the ``ops.scatter_gather`` /
``ops.segment`` message-passing substrate, whose float sums run in the
``segment_sum`` kernel. EGNN and MACE (with ``so3``) and the models of
``extra.py`` wait for ROADMAP queue 1, item 13.

Each model module has a config dataclass, an ``nn.Module`` holding the
parameters, ``init_params(cfg, *, generator, device)`` and
``forward(params, cfg, graph)`` (inference). ``convert.params_from_jax``
carries the reference's parameters across.
"""
