"""Device preprocess: the share of the in-bounds points that lost their
slot to a later point in the ordering (``getOrderedCloud``'s last-wins
rule), in percent: ``ordering.slots_lost`` over ``ordering.points``, the
counter events whose time lies in the traced window.  The program takes
both from the ordering's own masks on the device and records them when the
batch's results reach the host (``pipelines/multi_bev.py``'s
``_to_host``).

Read from the program's own counters (``pctpu_torch.runtime.profiler``,
every thread, ``time.time_ns()``: the clock of the profiler's host events);
None without the tracer, without items or without such an event in the
window."""


def read(trace, cell):
    if not trace.items:
        return None
    try:
        from pctpu_torch.runtime.profiler import records
    except ImportError:  # a program without the tracer
        return None
    lo, hi = trace.window
    points = lost = 0
    for c in records()[1]:
        if lo <= c.t_ns / 1e3 <= hi:
            if c.name == "ordering.points":
                points += c.n
            elif c.name == "ordering.slots_lost":
                lost += c.n
    if not points:
        return None
    return 100.0 * lost / points
