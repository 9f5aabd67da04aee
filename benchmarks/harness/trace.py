"""What the traced run reads: the device events of the measured window, the
host spans the harness opened, and host syncs.

Frozen copies, so that a change to the program cannot move the yardstick:
``is_copy``, ``kernel_name`` and the window filter of ``profile_window``
(only device events that start inside the window's own span) from
``pctpu_torch/experiments/card.py`` at commit 88a1f7c, and the sync count
of ``counting_syncs`` from ``pctpu_torch/experiments/registration_floor.py``
at 88a1f7c.  The busy time is the union of the device events' intervals,
as ``registration_floor.py``'s busy arithmetic sums them on one stream.
"""

from __future__ import annotations

import contextlib
import re
import threading
import warnings
from dataclasses import dataclass, field

WINDOW_MARK = "bench_window"
# the harness's host spans are named so on the profiler's timeline
SPAN_PREFIX = "bench."


def is_copy(name: str) -> bool:
    """A device event that is a copy or a memset, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def is_memcpy(name: str) -> bool:
    return name.startswith("Memcpy")


def kernel_name(name: str) -> str:
    """A device event's name without its template and argument lists: the
    ``..._kernel`` it holds, else its last identifier before them (a copy or
    memset keeps its whole name)."""
    if is_copy(name):
        return name
    if m := re.search(r"\w+_kernel", name):
        return m.group(0)
    name = re.sub(r"^std::enable_if<[^>]*>::type\s+", "", name)
    head = name.split("<", 1)[0].replace("(anonymous namespace)", "").split("(", 1)[0]
    parts = head.split()[-1].split("::") if head.strip() else [name]
    return "::".join(parts[-2:]) if parts[-1] == "kernel" else parts[-1]


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


@dataclass
class Trace:
    """The window's device events and host spans, in µs on the profiler's
    clock; ``items`` the clouds or pairs whose results reached the host in
    the window."""
    events: list[DeviceEvent]
    spans: list[tuple[str, float, float]]
    window: tuple[float, float]
    items: int
    batches: int
    extra: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self) -> list[DeviceEvent]:
        return [e for e in self.events if not is_copy(e.name)]

    def named(self, names) -> list[DeviceEvent]:
        return [e for e in self.events if kernel_name(e.name) in names]


def from_profiler(prof, items: int, batches: int) -> Trace:
    """The window of a finished ``torch.profiler.profile``: its device events
    that start inside the ``WINDOW_MARK`` span, and the harness's host spans
    (``SPAN_PREFIX``, taken off).  Read from the profiler's raw event list,
    which a long window fills with millions of events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = [(e.name(), e.device_type() == cuda, e.start_ns() / 1e3,
            (e.start_ns() + e.duration_ns()) / 1e3)
           for e in prof.profiler.kineto_results.events()]
    w0, w1 = next((a, b) for name, dev, a, b in raw if name == WINDOW_MARK and not dev)
    events, spans = [], []
    for name, dev, a, b in raw:
        if dev:
            # the harness's own spans also mark the card's timeline: no work
            if name != WINDOW_MARK and not name.startswith(SPAN_PREFIX) and w0 <= a <= w1:
                events.append(DeviceEvent(name, a, b))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], a, b))
    events.sort(key=lambda e: e.start_us)
    return Trace(events, spans, (w0, w1), items, batches)


def busy_intervals(events: list[DeviceEvent], lo: float, hi: float):
    """The union of the events' intervals, clipped to [lo, hi]: (starts,
    ends) as arrays."""
    import numpy as np

    if not events:
        return np.zeros(0), np.zeros(0)
    a = np.clip(np.array([e.start_us for e in events]), lo, hi)
    b = np.clip(np.array([e.end_us for e in events]), lo, hi)
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    reach = np.maximum.accumulate(b)
    # an interval opens where it starts past everything before it
    new = np.ones(len(a), bool)
    new[1:] = a[1:] > reach[:-1]
    starts = a[new]
    ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return starts, ends


def busy_s(trace: Trace) -> float:
    s, e = busy_intervals(trace.events, *trace.window)
    return float((e - s).sum()) / 1e6


def idle_gaps(trace: Trace):
    """The window's stretches with no device event: (starts, ends)."""
    import numpy as np

    lo, hi = trace.window
    s, e = busy_intervals(trace.events, lo, hi)
    gs = np.concatenate([[lo], e])
    ge = np.concatenate([s, [hi]])
    keep = ge > gs
    return gs[keep], ge[keep]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing (the innermost harness span open at each gap's
    middle), each as [name, seconds]."""
    import numpy as np

    ops: dict[str, float] = {}
    for e in trace.events:
        k = kernel_name(e.name)
        ops[k] = ops.get(k, 0.0) + e.dur_us / 1e6
    gs, ge = idle_gaps(trace)
    mid = 0.5 * (gs + ge)
    owner = np.full(len(mid), -1)
    owner_start = np.full(len(mid), -np.inf)
    names = sorted({n for n, _, _ in trace.spans})
    for name, a, b in trace.spans:
        inside = (mid >= a) & (mid <= b) & (a > owner_start)
        owner[inside] = names.index(name)
        owner_start[inside] = a
    gaps: dict[str, float] = {}
    for i, dur in zip(owner.tolist(), ((ge - gs) / 1e6).tolist()):
        k = names[i] if i >= 0 else "_no_span_"
        gaps[k] = gaps.get(k, 0.0) + dur

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


class SyncCounter:
    """Host syncs of a block, counted by torch's sync debug mode (phase 10
    of ``chip_smoke.py`` counts them so): every warning torch raises for a
    synchronising call, from any thread."""

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def counting(self):
        import torch

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode(0)
        with self._lock:
            self.count += sum("synchroniz" in str(w.message) for w in caught)

