"""BEV loader: milliseconds the consumer waits in ``loader.wait`` (its
``q.get()`` on the producer thread's queue) a cloud whose results reached the host.

Read from the program's own spans (``pctpu_torch.runtime.profiler``, every
thread, ``time.time_ns()``: the clock of the profiler's host events), each
clipped to the traced window; None without the tracer, without items or
without such a span in the window."""

NAME = "loader.wait"


def read(trace, cell):
    if not trace.items:
        return None
    try:
        from pctpu_torch.runtime.profiler import records
    except ImportError:  # a program without the tracer
        return None
    lo, hi = trace.window
    inside = [min(s.end_ns / 1e3, hi) - max(s.start_ns / 1e3, lo)
              for s in records()[0] if s.name == NAME]
    inside = [d for d in inside if d > 0]
    if not inside:
        return None
    return sum(inside) / 1e3 / trace.items
