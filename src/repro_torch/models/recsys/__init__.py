"""RecSys models of the port: xDeepFM of ``repro.models.recsys``
(serving and its loss)."""
