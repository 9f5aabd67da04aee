"""ICP loop: host milliseconds of ``icp.loop``'s self time (the body of
``icp_batched``, less its child spans on its own thread: the ``icp.wait``
reads of ``done`` and any other) a pair whose results reached the host: the
time the host spends issuing the loop's work.

Read from the program's own spans (``pctpu_torch.runtime.profiler``, every
thread, ``time.time_ns()``: the clock of the profiler's host events), each
loop and its children clipped to the traced window; None without the
tracer, without items or without such a span in the window."""

NAME = "icp.loop"


def read(trace, cell):
    if not trace.items:
        return None
    try:
        from pctpu_torch.runtime.profiler import records
    except ImportError:  # a program without the tracer
        return None
    lo, hi = trace.window
    spans = records()[0]
    loops = {s.id: s for s in spans if s.name == NAME}
    children: dict[int, list] = {}
    for s in spans:
        p = loops.get(s.parent)
        if p is not None and s.thread == p.thread:
            children.setdefault(p.id, []).append(s)
    own, seen = 0.0, False
    for s in loops.values():
        a, b = max(s.start_ns / 1e3, lo), min(s.end_ns / 1e3, hi)
        if b <= a:
            continue
        seen = True
        own += b - a - sum(max(0.0, min(c.end_ns / 1e3, b) - max(c.start_ns / 1e3, a))
                           for c in children.get(s.id, ()))
    if not seen:
        return None
    return own / 1e3 / trace.items
