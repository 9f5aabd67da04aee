"""Where a cell's card sits idle, by the program's own spans: the traced
window of ``run.py --trace 1``, with each idle gap given to a span of
``pctpu_torch.runtime.profiler`` (every thread) in place of the harness's
spans (the main thread's only, as the result line's breakdown has them).

    python3 benchmarks/idle_by_span.py --workload <cell> --seed <n> --seconds <s>
        [--chrome PATH]

A stretch in which the card runs nothing goes to the innermost (latest
started) working span open at its middle on any thread; to a ``.wait``
span only where no working span is open; else to ``_no_span_``.  The share
of idle time inside some program span also checks that the program's clock
(``time.time_ns()``) and the profiler's agree: were they apart, it would
collapse.  After the window, the cost of a span and of a counter event on
this host, tracing off and on.  The window's answers are not checked here:
``run.py`` does that.

Prints one JSON line: ``idle_s``, ``window_s``, ``in_span_share``,
``idle_by_span`` ([name, s], largest first), the program's spans and counter
events a batch (``events_per_batch``, in all and by name), ``span_cost_us``
and the card.  ``--chrome`` also writes the window's Chrome trace (host and
card) with the program's spans and counters of every thread added, each
span with its parent and batch index: the registration drivers' worker and
main threads side by side, which no registration CLI's run can show.  A
30 s window's trace runs to gigabytes: take a few seconds.  Without a CUDA
card it exits 3 and prints nothing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):  # the checkout (pctpu_torch), the harness
    if _p not in sys.path:
        sys.path.insert(0, _p)

NO_SPAN = "_no_span_"


def idle_by_span(trace, spans) -> dict[str, float]:
    """Seconds of the window's idle gaps by owning span name (module
    docstring); ``spans`` are the profiler's ``Span`` records (ns)."""
    import numpy as np

    from harness.trace import idle_gaps

    gs, ge = idle_gaps(trace)
    mid = 0.5 * (gs + ge)  # ascending: the gaps do not overlap
    names = sorted({s.name for s in spans})
    work = np.full(len(mid), -1)
    wait = np.full(len(mid), -1)
    # in order of start, so that a later-started span overwrites
    for s in sorted(spans, key=lambda s: s.start_ns):
        i = np.searchsorted(mid, s.start_ns / 1e3, "left")
        j = np.searchsorted(mid, s.end_ns / 1e3, "right")
        (wait if s.name.endswith(".wait") else work)[i:j] = names.index(s.name)
    owner = np.where(work >= 0, work, wait)
    out: dict[str, float] = {}
    for k, dur in zip(owner.tolist(), ((ge - gs) / 1e6).tolist()):
        name = names[k] if k >= 0 else NO_SPAN
        out[name] = out.get(name, 0.0) + dur
    return out


def events_per_batch(trace, spans, counts) -> dict:
    """The program's spans and counter events that start inside the window,
    a batch: in all and by name."""
    lo, hi = trace.window
    named: dict[str, int] = {}
    for name, t_ns in [(s.name, s.start_ns) for s in spans] + [(c.name, c.t_ns) for c in counts]:
        if lo <= t_ns / 1e3 <= hi:
            named[name] = named.get(name, 0) + 1
    per = max(trace.batches, 1)
    return {"all": sum(named.values()) / per,
            "by_name": {k: v / per for k, v in sorted(named.items(), key=lambda kv: -kv[1])}}


def span_cost_us(n_off: int = 1_000_000, n_on: int = 200_000) -> dict:
    """µs a span with tracing off (and a bare ``with`` of the null context
    beside it), a span and a counter event with tracing on."""
    import contextlib

    from pctpu_torch.runtime import profiler

    def loop(make, n):
        t = time.perf_counter()
        for _ in range(n):
            with make("cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    null = contextlib.nullcontext()
    out = {"off": loop(profiler.span, n_off), "bare_with": loop(lambda _: null, n_off)}
    with profiler.recording():
        out["on"] = loop(profiler.span, n_on)
        t = time.perf_counter()
        for _ in range(n_on):
            profiler.count("cost")
        out["count_on"] = (time.perf_counter() - t) / n_on * 1e6
    return out


def run(args, device=None) -> dict | None:
    """The traced window and its idle attribution; None without a card
    (a ``device`` other than the card is for the harness's own tests)."""
    import torch
    from torch.profiler import record_function

    from harness import main
    from harness.trace import SPAN_PREFIX, SyncCounter, from_profiler
    from pctpu_torch.runtime import profiler

    cell = main.resolve(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print(f"{args.workload}: needs a CUDA card", file=sys.stderr)
            return None
        device = torch.device("cuda", 0)
    import pctpu_torch  # noqa: F401  (TF32 off, as the configuration states)

    win = main.make_window(cell, args.seed, device,
                           lambda name: record_function(SPAN_PREFIX + name))
    setup_s = time.perf_counter() - T_START
    with profiler.recording() as rec:
        prof, items, batches, _ = main.traced_window(win, args.seconds, SyncCounter())
    trace = from_profiler(prof, items, batches)
    spans, counts = rec.spans, rec.counts
    if getattr(args, "chrome", None):
        prof.export_chrome_trace(args.chrome)
        profiler.append_to_chrome_trace(args.chrome, spans, counts)
    del prof
    win.free()
    idle = idle_by_span(trace, spans)
    idle_s = sum(idle.values())
    on_card = device.type == "cuda"
    return {
        "workload": args.workload, "seed": args.seed, "setup_s": setup_s,
        "window_s": trace.window_s, "items": items, "batches": batches, "idle_s": idle_s,
        "in_span_share": (idle_s - idle.get(NO_SPAN, 0.0)) / idle_s if idle_s else None,
        "idle_by_span": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])],
        "events_per_batch": events_per_batch(trace, spans, counts),
        "span_cost_us": span_cost_us(),
        "device": torch.cuda.get_device_name(device) if on_card else str(device),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmarks/idle_by_span.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--chrome", help="write the window's Chrome trace here")
    args = ap.parse_args(argv)
    from harness.main import cache_dirs

    cache_dirs()
    out = run(args)
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
