"""Models of the port. ``models.transformer`` holds the dense decoder LM
(GQA/MQA/MHA) of ``repro.models.transformer``; ``models.gnn`` the GNNs
of ``repro.models.gnn`` and ``models.recsys`` xDeepFM of
``repro.models.recsys`` (inference), whose sums over edges and bags run
in the ``segment_sum`` kernel. ``models.tree`` lays parameters out as
the reference's pytrees."""
