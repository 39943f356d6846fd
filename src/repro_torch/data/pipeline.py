"""Host-side input pipeline (port of ``repro.data.pipeline``): background
prefetch of deterministic batches.

A producer thread builds batches ahead of the training loop, through a
bounded queue; the consumer draws the batch of each global step.  The
stream is step-indexed, so a resumed job asks for its restored step and a
batch out of order is rebuilt directly.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class Prefetcher:
    """Runs ``batch_fn(step)`` on a background thread, ``depth`` ahead."""

    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self.batch_fn = batch_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._next
        while not self._stop.is_set():
            batch = self.batch_fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self, expect_step: Optional[int] = None) -> dict:
        step, batch = self._q.get()
        if expect_step is not None and step != expect_step:
            # restart / seek: rebuild deterministically (rare path)
            return self.batch_fn(expect_step)
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
