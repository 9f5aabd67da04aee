"""Stage timing with reference-compatible ``[TIME]`` reports (the port of
``pctpu/runtime/profiler.py``).

CUDA work is asynchronous, so a stage's timer synchronises the card before
it stops: every reported number covers the device work the stage issued,
as register_pair's stage split promises."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self) -> None:
        self.totals_ms: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, ms: float, items: int = 1) -> None:
        with self._lock:
            self.totals_ms[name] += ms
            self.counts[name] += items

    def average_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals_ms.get(name, 0.0) / c if c else 0.0

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 1):
        start = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.add(name, (time.perf_counter() - start) * 1e3, items)
