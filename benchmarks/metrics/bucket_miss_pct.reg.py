"""Registration drivers: the share of ``BucketSpec``'s verified predictions
that missed, in percent, both stages: ``registration.bucket_miss.*`` over
``registration.bucket_hit.*`` and ``.bucket_miss.*``, the counter events
whose time lies in the traced window.  A miss runs its stage again.

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
    hits = misses = 0
    for c in records()[1]:
        if lo <= c.t_ns / 1e3 <= hi:
            if c.name.startswith("registration.bucket_hit"):
                hits += c.n
            elif c.name.startswith("registration.bucket_miss"):
                misses += c.n
    if not hits + misses:
        return None
    return 100.0 * misses / (hits + misses)
