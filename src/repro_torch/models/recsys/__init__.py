"""RecSys models of the port: xDeepFM of ``repro.models.recsys``
(inference)."""
