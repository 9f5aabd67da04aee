"""Device: busy milliseconds a pair, the arithmetic of
``pctpu_torch/experiments/registration_floor.py`` @ 88a1f7c (device
durations of kernels, copies and memsets on the card's timeline, here as
their union) over the pairs whose results reached the host."""

from harness.trace import busy_s


def read(trace, cell):
    if not trace.items or not trace.events:
        return None
    return busy_s(trace) * 1e3 / trace.items
