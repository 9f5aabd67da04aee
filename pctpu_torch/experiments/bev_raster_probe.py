"""Where the time of one ``fused_multi_single_bev`` call goes, on one CUDA
card, at the BEV path's shape (a batch of eight ray-cast HDL-64E clouds).

    python3 -m pctpu_torch.experiments.bev_raster_probe

For ``bev.fused_multi_single_bev`` as the path calls it: the rasters held
against the twin, then what a call puts on the card (kernels, memsets and
the device time of each, torch.profiler), its time by CUDA events (the C
call alone, and the wrapper), the host's microseconds a call (host clock,
no synchronize inside) and the global atomics the raster kernel sends.
The line carries the card's name and power limit.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

import torch


def labeled_batch(dev: torch.device, n: int = 8):
    """(params, n ordered and ground-marked clouds of the ray-cast HDL-64E
    drive as one batched Cloud on ``dev``)."""
    from pctpu_torch.config import get_sensor_params
    from pctpu_torch.experiments.scene import multi_bev_tree
    from pctpu_torch.ops import ground
    from pctpu_torch.ops.preprocess import _reorder_preordered
    from pctpu_torch.pipelines import multi_bev
    from pctpu_torch.runtime.loader import load_xyzirct_arrays, stack_batch

    params = get_sensor_params("HDL_64E")
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "bev_raster_probe")
    shutil.rmtree(root, ignore_errors=True)
    paths = multi_bev_tree(root, params, n_ordered=n, n_raw=0, n_over=0)
    arrays = stack_batch([load_xyzirct_arrays(p, params.grid_size, params=params)
                          for p in paths[:n]])
    shutil.rmtree(root)
    ordered = _reorder_preordered(multi_bev._to_device(arrays, dev), params)
    return params, ground.mark_ground(ordered, params)[0]


def host_us(fn, n: int = 500) -> float:
    """Host microseconds a call, with no synchronize inside the window."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def main() -> int:
    from pctpu_torch.experiments.card import bound_ms, cuda_ms, nvidia_smi_line, profile_calls
    from pctpu_torch.ops import bev

    if not torch.cuda.is_available():
        raise SystemExit("bev_raster_probe needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    params, labeled = labeled_batch(dev)
    want = bev.fused_multi_single_bev_reference(labeled, params.height_res)
    live = int(((labeled.label != 0) & labeled.valid_mask()).sum())
    n_bytes = labeled.label.numel() * 16 + sum(r.numel() for r in want)
    print(f"B = {labeled.label.shape[0]}, {labeled.label.numel()} points, {live} valid and not "
          f"ground; bound {bound_ms(n_bytes, 0)[0]:.6f} ms ({n_bytes} B); card {card}")

    def wrapper():
        return bev.fused_multi_single_bev(labeled, params.height_res)

    launch = bev._raster_launcher(labeled, params.height_res)[0]
    got = wrapper()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("rasters differ from the twin")
    # in turns: the C call alone, the wrapper, and again
    times = {"alone": [], "wrapper": []}
    for _ in range(2):
        times["alone"].append(cuda_ms(launch, reps=50))
        times["wrapper"].append(cuda_ms(wrapper, reps=50))
    kernels, copies, by_name = profile_calls(wrapper)
    counter = bev.atomics_sent(labeled, params.height_res)
    print(f"bit-equal to the twin; alone {min(times['alone']):.4f} ms, with wrapper "
          f"{min(times['wrapper']):.4f} ms (CUDA events, the least of two turns); a "
          f"call puts {kernels} kernels + {copies} memsets on the card, device ms "
          f"{ {k: round(v, 6) for k, v in by_name.items()} }; host {host_us(wrapper):.3f} us "
          f"a call; atomics sent {counter}; card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
