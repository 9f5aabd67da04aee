"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card, in percent."""

from harness.trace import busy_s


def read(trace, cell):
    if not trace.events or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)
