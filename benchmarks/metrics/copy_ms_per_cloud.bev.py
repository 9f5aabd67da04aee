"""BEV wire: device milliseconds of the window's copies (Memcpy, both ways)
a cloud whose results reached the host."""

from harness.trace import is_memcpy


def read(trace, cell):
    if not trace.items:
        return None
    copies = [e for e in trace.events if is_memcpy(e.name)]
    if not copies:
        return None
    return sum(e.dur_us for e in copies) / 1e3 / trace.items
