"""The port's one tracer: spans and counters kept in memory, stage timing
with reference-compatible ``[TIME]`` reports, and the ``--profile`` Chrome
trace (the port of ``pctpu/runtime/profiler.py``).

**Spans and counters.**  ``span(name)`` is a context manager that records
its name, its start and end (``time.time_ns()``, the wall clock that
torch.profiler's host events and Chrome trace keep), its thread, its parent
(the enclosing span on the same thread, or else the span that handed the
work over, :func:`handoff` / :func:`adopt`) and the batch index a driver
set (:func:`batch`), so that one batch's spans on several threads share it.
``count(name, n)`` records a counter event with its time.  A name that ends
in ``.wait`` marks the host waiting, on the card or on another thread; a
span's self time is its duration less what its child spans on the same
thread cover.

Tracing is on while a ``torch.profiler`` runs anywhere in the process (the
module flag ``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets for every thread, unlike ``record_function``'s own check) or
while a :func:`recording` block is open.  Off, ``span`` hands back one
shared null context and ``count`` returns at once: no allocation, no time
stamp, no ``record_function``.  On, each event is one append to a bounded
in-memory log (the newest ``LOG_EVENTS`` spans and counter events);
nothing is written until an exporter asks: :func:`records`,
:func:`recording` or :func:`trace`.

**Stage timing.**  ``StageTimer.stage`` opens a span of its name and
synchronises the card before it stops, so every reported number covers
the device work the stage issued.  Drivers called without a timer do no
such synchronise.  ``trace`` wraps a block in a ``torch.profiler`` trace,
the counterpart of pctpu's ``jax.profiler`` one, and adds the program's
spans and counters of every thread to the file it writes."""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import tempfile
import threading
import time
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _torch_profiler

# the newest events kept, each kind: a long profiled run keeps its tail
LOG_EVENTS = 1 << 20

_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_spans: deque = deque(maxlen=LOG_EVENTS)
_counts: deque = deque(maxlen=LOG_EVENTS)
_recording_blocks = 0
_recording_lock = threading.Lock()


def enabled() -> bool:
    """True while a torch.profiler runs in this process or a
    :func:`recording` block is open."""
    return bool(_recording_blocks or _torch_profiler._is_profiler_enabled)


class _Thread(threading.local):
    """A thread's native id, its open spans, and the parent and batch it was
    handed."""

    def __init__(self) -> None:
        # read once: on some hosts each read is a system call
        self.native = threading.get_native_id()
        self.stack: list[Span] = []
        self.parent: int | None = None
        self.batch: int | None = None


_thread = _Thread()


class Span:
    """One recorded span; times in ns of ``time.time_ns()``.  ``thread`` is
    the native thread id, as torch.profiler's host events carry it."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "parent", "batch", "id")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> Span:
        t = _thread
        self.parent = t.stack[-1].id if t.stack else t.parent
        self.batch = t.batch
        self.thread = t.native
        self.id = next(_ids)
        t.stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        _thread.stack.pop()
        _spans.append(self)
        return False


class Count:
    """One counter event: ``n`` more of ``name`` at ``t_ns``."""

    __slots__ = ("name", "t_ns", "n", "thread", "batch", "id")

    def __init__(self, name: str, n: int) -> None:
        self.name, self.n = name, n
        self.t_ns = time.time_ns()
        t = _thread
        self.thread, self.batch = t.native, t.batch
        self.id = next(_ids)


def span(name: str):
    """A context manager that records a span of ``name`` while tracing is
    on; the shared null context while it is off."""
    if _recording_blocks or _torch_profiler._is_profiler_enabled:
        return Span(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Record ``n`` more of ``name`` while tracing is on."""
    if _recording_blocks or _torch_profiler._is_profiler_enabled:
        _counts.append(Count(name, n))


class _Context:
    """Sets this thread's parent and batch for a block, then restores them."""

    __slots__ = ("parent", "batch", "_saved")

    def __init__(self, parent: int | None, batch: int | None) -> None:
        self.parent, self.batch = parent, batch

    def __enter__(self) -> None:
        t = _thread
        self._saved = t.parent, t.batch
        t.parent, t.batch = self.parent, self.batch

    def __exit__(self, *exc) -> bool:
        _thread.parent, _thread.batch = self._saved
        return False


def handoff(batch: int | None = None):
    """What a worker needs to carry this thread's context (the enclosing
    span as its spans' parent, and ``batch`` or this thread's batch); None
    while tracing is off.  The worker passes it to :func:`adopt`."""
    if not enabled():
        return None
    t = _thread
    return (t.stack[-1].id if t.stack else t.parent,
            t.batch if batch is None else batch)


def adopt(context):
    """On the worker, a block whose spans take :func:`handoff`'s context."""
    return _NULL if context is None else _Context(*context)


def batch(index: int):
    """This thread's spans and counter events in the block carry batch
    ``index`` (their parents are left as they are)."""
    return adopt(handoff(index))


def records() -> tuple[list[Span], list[Count]]:
    """Every span and counter event in the log, in the order they ended."""
    return list(_spans), list(_counts)


class Recording:
    """What a :func:`recording` block recorded, on every thread."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.counts: list[Count] = []

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def total(self, name: str) -> int:
        """The sum of the block's ``name`` counter events."""
        return sum(c.n for c in self.counts if c.name == name)

    def totals(self) -> dict[str, int]:
        out: dict[str, int] = defaultdict(int)
        for c in self.counts:
            out[c.name] += c.n
        return dict(out)


def _since(first_id: int) -> tuple[list[Span], list[Count]]:
    spans, counts = records()
    return ([s for s in spans if s.id >= first_id],
            sorted((c for c in counts if c.id >= first_id), key=lambda c: c.id))


@contextlib.contextmanager
def recording():
    """Turn tracing on for a block, without a profiler, and hand back a
    :class:`Recording` that holds, once the block ends, the spans and
    counter events that ended inside it (on any thread)."""
    global _recording_blocks
    rec = Recording()
    with _recording_lock:
        _recording_blocks += 1
    first = next(_ids)
    try:
        yield rec
    finally:
        with _recording_lock:
            _recording_blocks -= 1
        rec.spans, rec.counts = _since(first)


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
            with span(name):
                yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.add(name, (time.perf_counter() - start) * 1e3, items)

    def report_average(self, name: str, label: str) -> str:
        """A reference-style line, e.g.
        ``[TIME] Average preprocessing and BEV generation: 12.3``"""
        return f"[TIME] {label}: {self.average_ms(name)}"


def _chrome_events(spans: list[Span], counts: list[Count], base_ns: int) -> list[dict]:
    """The program's spans as Chrome ``X`` events and its counters as ``C``
    events (each counter's running total), ``ts`` in µs after ``base_ns``."""
    pid = os.getpid()
    out = [{"ph": "X", "cat": "pctpu_torch", "name": s.name, "pid": pid, "tid": s.thread,
            "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "batch": s.batch}} for s in spans]
    running: dict[str, int] = defaultdict(int)
    for c in counts:
        running[c.name] += c.n
        out.append({"ph": "C", "cat": "pctpu_torch", "name": c.name, "pid": pid,
                    "tid": c.thread, "ts": (c.t_ns - base_ns) / 1e3,
                    "args": {"total": running[c.name]}})
    return out


@contextlib.contextmanager
def trace(name: str, enabled: bool = False, trace_dir: str | None = None):
    """Optional profiler trace around a block: the host (CPU) and, where
    this process sees a CUDA card, the card's kernels and copies, with the
    block as one ``record_function(name)`` span.  The program's spans of
    every thread and its counters are added as ``X`` and ``C`` events on
    the file's clock (``ts`` after its ``baseTimeNanoseconds``).  The Chrome
    trace is written to ``<trace_dir>/<name>.<pid>.pt.trace.json``
    (``trace_dir`` defaults to ``pctpu-trace`` in the temporary directory).
    Disabled, it does nothing."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "pctpu-trace")
    first = next(_ids)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    append_to_chrome_trace(path, *_since(first))


# the bytes read at each end of a Chrome trace: its top-level keys besides
# ``traceEvents`` (kineto writes them before the array or after it)
_TRACE_END_BYTES = 1 << 16


def _array_end(tail: str) -> int | None:
    """Where in ``tail`` (the file's last bytes) the ``traceEvents`` array
    closes: the last ``]`` after which only the object's other keys and its
    ``}`` follow."""
    pos = len(tail)
    while (pos := tail.rfind("]", 0, pos)) >= 0:
        rest = tail[pos + 1:].strip()
        if rest == "}":
            return pos
        if rest.startswith(","):
            with contextlib.suppress(ValueError):
                json.loads("{" + rest[1:])
                return pos
    return None


def append_to_chrome_trace(path: str, spans: list[Span], counts: list[Count]) -> None:
    """Add ``spans`` and ``counts`` to the ``traceEvents`` of the Chrome
    trace at ``path``, on its clock (``ts`` after its
    ``baseTimeNanoseconds``).  Only the file's two ends are read: the array
    is closed again after the new events, in place."""
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        head = f.read(_TRACE_END_BYTES).decode("utf-8", "replace")
        # a cut character at the tail's start must come back byte for byte
        at = max(0, size - _TRACE_END_BYTES)
        f.seek(at)
        tail = f.read().decode("utf-8", "surrogateescape")
        base = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', head) or re.search(
            r'"baseTimeNanoseconds"\s*:\s*(\d+)', tail)
        end = _array_end(tail)
        if base is None or end is None:
            raise ValueError(f"{path}: no baseTimeNanoseconds or no closing traceEvents array "
                             "in the trace torch.profiler wrote")
        events = _chrome_events(spans, counts, int(base.group(1)))
        if not events:
            return
        lead = "" if tail[:end].rstrip().endswith("[") else ","
        f.seek(at + len(tail[:end].encode("utf-8", "surrogateescape")))
        f.write((lead + ",\n".join(json.dumps(e) for e in events) + "\n"
                 + tail[end:]).encode("utf-8", "surrogateescape"))
