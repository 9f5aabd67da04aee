"""Device: busy milliseconds (the union of kernels, copies and memsets on
the card's timeline) a cloud whose results reached the host."""

from harness.trace import busy_s


def read(trace, cell):
    if not trace.items or not trace.events:
        return None
    return busy_s(trace) * 1e3 / trace.items
