"""Synthetic LM token stream: KISS-generated Zipf-ish token ids, the
port's copy of ``repro.data.lm`` (numpy, bit-identical tokens).

Deterministic per (seed, step), so a restarted job replays the same
batches.
"""
from __future__ import annotations

import numpy as np

from repro_torch.ops.kiss import KissRng


def lm_batch(
    batch: int, seq_len: int, vocab: int, *, seed: int = 0, step: int = 0
) -> dict:
    """``{"tokens": (batch, seq_len), "labels": the next tokens}``, int32
    numpy arrays."""
    rng = KissRng(seed * 1_000_003 + step, n_streams=4096)
    u = rng.uniform_ints((batch, seq_len + 1), 1 << 30).astype(np.float64)
    # Zipf-ish skew: squash uniform draws through a power law.
    z = (u / float(1 << 30)) ** 4.0
    toks = (z * (vocab - 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


def lm_iterator(batch: int, seq_len: int, vocab: int, seed: int = 0):
    from repro_torch.data.pipeline import PrefetchIterator

    return PrefetchIterator(
        lambda i: lm_batch(batch, seq_len, vocab, seed=seed, step=i)
    )
