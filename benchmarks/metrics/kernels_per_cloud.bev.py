"""Device preprocess: kernel launches in the window (copies and memsets
left out) a cloud whose results reached the host."""


def read(trace, cell):
    if not trace.items:
        return None
    n = len(trace.kernels())
    return n / trace.items if n else None
