"""Synthetic Criteo-like batches for xDeepFM, the port's copy of
``repro/data/recsys.py``: the port's KISS, so the same seed and step
give the reference's arrays bit for bit."""
from __future__ import annotations

import numpy as np

from repro_torch.ops.kiss import KissRng


def recsys_batch(
    batch: int, n_fields: int, vocab: int, *, seed: int = 0, step: int = 0
) -> dict:
    rng = KissRng(seed * 999_983 + step, n_streams=4096)
    ids = rng.uniform_ints((batch, n_fields), 1 << 30).astype(np.float64)
    # power-law id popularity (hot rows), matching real CTR logs
    ids = ((ids / float(1 << 30)) ** 3 * (vocab - 1)).astype(np.int32)
    labels = (rng.uniform_ints((batch,), 100) < 25).astype(np.int32)  # ~25% CTR
    return {"sparse_ids": ids, "labels": labels}
