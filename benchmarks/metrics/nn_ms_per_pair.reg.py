"""NN wrappers and K1: device milliseconds of the 1-NN's kernels
(``csrc/nn_pruned_warp.cu``: the target's preparation and a pass's seed,
main and finish kernels) a pair whose results reached the host."""

KERNELS = ("nn_prep_kernel", "nn_seed_kernel", "nn_main_kernel", "nn_finish_kernel")


def read(trace, cell):
    events = trace.named(KERNELS)
    if not events or not trace.items:
        return None
    return sum(e.dur_us for e in events) / 1e3 / trace.items
