"""Host-side data pipeline with background prefetch (double buffering):
the port's copy of ``repro.data.pipeline``.

Batches are made by a daemon thread into a bounded queue, so the card's
step overlaps the host's generation of the next batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class PrefetchIterator:
    def __init__(self, make_batch: Callable[[int], dict], depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        i = 0
        while not self._stop.is_set():
            try:
                self._q.put(self._make(i), timeout=0.2)
                i += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
