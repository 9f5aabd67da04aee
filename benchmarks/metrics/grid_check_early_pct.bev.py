"""BEV loader: the share of the producer's grid-order checks
(``ops.ordering.arrays_grid_ordered``) that the first row of slots decided,
in percent: ``ordering.grid_check.early`` over ``.early`` and ``.full``, the
counter events whose time lies in the traced window.  A check that is not
decided early reads every slot of the cloud.

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
    early = full = 0
    for c in records()[1]:
        if lo <= c.t_ns / 1e3 <= hi:
            if c.name == "ordering.grid_check.early":
                early += c.n
            elif c.name == "ordering.grid_check.full":
                full += c.n
    if not early + full:
        return None
    return 100.0 * early / (early + full)
