"""Cloud upload: the share of the window's cloud uploads (``cloud.from_numpy``,
``cloud.make_cloud``) that crossed to the card as one staged block, in percent:
``cloud.upload.staged`` over ``.staged`` and ``.direct``, the counter events whose
time lies in the traced window.  A direct upload copies each field on its own.

Read from the program's own counters (``pctpu_torch.runtime.profiler``, every
thread, ``time.time_ns()``: the clock of the profiler's host events); None
without the tracer, without items or without such an event in the window."""


def read(trace, cell):
    if not trace.items:
        return None
    try:
        from pctpu_torch.runtime.profiler import records
    except ImportError:  # a program without the tracer
        return None
    lo, hi = trace.window
    staged = direct = 0
    for c in records()[1]:
        if lo <= c.t_ns / 1e3 <= hi:
            if c.name == "cloud.upload.staged":
                staged += c.n
            elif c.name == "cloud.upload.direct":
                direct += c.n
    if not staged + direct:
        return None
    return 100.0 * staged / (staged + direct)
