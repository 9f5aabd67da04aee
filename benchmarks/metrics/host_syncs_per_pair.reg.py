"""ICP loop and driver: host syncs in the window (torch's sync debug mode,
every thread) a pair whose results reached the host."""


def read(trace, cell):
    syncs = trace.extra.get("host_syncs")
    if not trace.items or not syncs:
        return None
    return syncs / trace.items
