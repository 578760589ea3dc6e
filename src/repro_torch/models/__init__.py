"""Models of the port. ``models.transformer`` holds the dense decoder LM
(GQA/MQA/MHA) of ``repro.models.transformer``; ``models.gnn`` holds GIN
and GAT of ``repro.models.gnn`` (inference), whose aggregations run in
the ``segment_sum`` kernel. EGNN, MACE and the other GNNs wait for
ROADMAP queue 1, item 13, and the RecSys models for item 14."""
