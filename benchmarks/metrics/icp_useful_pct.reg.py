"""ICP loop: the share of the batch's problem slots that did work, in
percent: ``icp.problem_iterations`` (the problems still active in each
batch iteration) over ``icp.problem_slots`` (iterations × problems), the
counter events whose time lies in the traced window.  A batch iterates
until its slowest problem is done; a done problem's slot still runs.

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
    sums = {"icp.problem_iterations": 0, "icp.problem_slots": 0}
    for c in records()[1]:
        if c.name in sums and lo <= c.t_ns / 1e3 <= hi:
            sums[c.name] += c.n
    if not sums["icp.problem_slots"]:
        return None
    return 100.0 * sums["icp.problem_iterations"] / sums["icp.problem_slots"]
