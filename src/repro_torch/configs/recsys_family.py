"""The RecSys family of the port's registry (xdeepfm): the shape table
and ``RecsysArch`` of ``repro/configs/recsys_family.py``.

Shapes (per assignment):
  train_batch     batch=65,536              (train_step)
  serve_p99       batch=512                 (online inference)
  serve_bulk      batch=262,144             (offline scoring)
  retrieval_cand  batch=1, 1e6 candidates   (retrieval scoring)

The table is copied, not imported: the reference module imports jax.
``RecsysArch.build`` (the dry-run spec, the row-sharded table and the
ZeRO-sharded optimizer) is launch and training work and waits for
ROADMAP queue 1, items 16 and 17.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.recsys import xdeepfm as xm

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1),
}


@dataclass
class RecsysArch:
    """The RecSys architecture (``models/recsys/xdeepfm.py``): its
    published config and the small one the tests run."""

    name: str
    config: xm.XDeepFMConfig
    smoke_config: xm.XDeepFMConfig
    family: str = "recsys"

    def shapes(self):
        return list(RECSYS_SHAPES)

    def skip_reason(self, shape: str) -> str | None:
        return None
