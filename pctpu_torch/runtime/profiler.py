"""Stage timing with reference-compatible ``[TIME]`` reports, plus optional
profiler traces (the port of ``pctpu/runtime/profiler.py``).

CUDA work is asynchronous, so a stage's timer synchronises the card before
it stops: every reported number covers the device work the stage issued,
as register_pair's stage split promises.  ``trace`` wraps a block in a
``torch.profiler`` trace, the counterpart of pctpu's ``jax.profiler`` one."""

from __future__ import annotations

import contextlib
import os
import tempfile
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

    def report_average(self, name: str, label: str) -> str:
        """A reference-style line, e.g.
        ``[TIME] Average preprocessing and BEV generation: 12.3``"""
        return f"[TIME] {label}: {self.average_ms(name)}"


@contextlib.contextmanager
def trace(name: str, enabled: bool = False, trace_dir: str | None = None):
    """Optional profiler trace around a block: the host (CPU) and, where
    this process sees a CUDA card, the card's kernels and copies, with the
    block as one ``record_function(name)`` span.  The Chrome trace is
    written to ``<trace_dir>/<name>.<pid>.pt.trace.json`` (``trace_dir``
    defaults to ``pctpu-trace`` in the temporary directory).  Disabled, it
    does nothing."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "pctpu-trace")
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.{os.getpid()}.pt.trace.json"))
