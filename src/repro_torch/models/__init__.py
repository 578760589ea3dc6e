"""Models of the port. ``models.transformer`` holds the dense decoder LM
(GQA/MQA/MHA) of ``repro.models.transformer``; the GNN and RecSys models
wait for ROADMAP queue 1, items 13 and 14."""
