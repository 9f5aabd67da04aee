"""batch_cloud_manip: a float max-height BEV for every keyframe cloud (the
port of ``pctpu/pipelines/batch_cloud_manip.py``).

Reference: reference/BatchCloudManip.cpp:269-335.  HDL-64E constants are
hard-coded there (N_SCAN 64, Horizon 2083, groundScanInd 50, :11-14, 85);
outputs one ``output_bvm/<short>.csv`` + ``<short>.png`` (ground-filtered
201×201 float BEV, saveAsMat :201-239) and the labeled ordered cloud in
``non_ground_point_cloud/``.  The tree is byte-identical to pctpu's.

A producer thread loads and pads clouds; each batch goes to the device
once, in its on-disk widths (ordering, ground marking, float BEV: a fixed
number of launches a batch), and comes back narrowed on the device, through
pinned host buffers on a card with one synchronize (``multi_bev``'s wire);
the writes stay synchronous inside the ``"bev"`` stage, as pctpu times them.
"""

from __future__ import annotations

import os

import torch

from pctpu_torch.config import FloatBevConfig, GroundConfig, SensorParams
from pctpu_torch.io.csvfmt import write_csv
from pctpu_torch.io.pcd import write_pcd
from pctpu_torch.io.png import write_gray_png
from pctpu_torch.ops.bev import float_bev
from pctpu_torch.ops.preprocess import order_and_mark_ground
from pctpu_torch.pipelines.multi_bev import (
    _reset_dir,
    _short_name,
    _to_device,
    _to_host,
    _wire,
)
from pctpu_torch.runtime.loader import (
    batched_prefetch,
    list_pcd_files,
    load_xyzirct_arrays,
    stack_batch,
)
from pctpu_torch.runtime.profiler import StageTimer
from pctpu_torch.utils import logging as log

HDL64E = SensorParams(n_scan=64, horizon_scan=2083, ground_upper_scan=50, height_res=0.25)


def process_batch(clouds, params: SensorParams, ground_cfg: GroundConfig,
                  bev_cfg: FloatBevConfig, compat: str = "bitexact"):
    """One device step: ordering (always the general ``getOrderedCloud``, as
    pctpu runs it here), ground marking and the float BEV of a batch.
    Returns (labeled clouds, BEVs (B, S, S) f32)."""
    labeled = order_and_mark_ground(clouds, params, ground_cfg, compat=compat)
    return labeled, float_bev(labeled, bev_cfg)


def run_batch_cloud_manip(
    keyframes_root_dir: str, batch_size: int = 8, resume: bool = False,
    compat: str = "bitexact", device: str | torch.device = "cuda",
) -> float:
    """Returns average preprocessing+BEV milliseconds per cloud.

    ``compat="tolerance"`` sums the ground sectors with one matmul instead
    of in point order (``ops.ground``)."""
    root = keyframes_root_dir.rstrip("/") + "/"
    in_dir = root + "keyframe_point_cloud/"
    non_ground_dir = root + "non_ground_point_cloud/"
    bvm_dir = root + "output_bvm/"
    params = HDL64E
    device = torch.device(device)
    ground_cfg = GroundConfig()
    bev_cfg = FloatBevConfig(filter_ground=True)

    for d in (non_ground_dir, bvm_dir):
        _reset_dir(d, resume)

    files = list_pcd_files(in_dir)
    if resume:
        # key on the last-written artifact (the labeled pcd) so a crash
        # mid-cloud re-runs it rather than dropping the later outputs
        files = [f for f in files if not os.path.exists(non_ground_dir + _short_name(f) + ".pcd")]

    timer = StageTimer()
    if files:
        loader = batched_prefetch(
            files, batch_size, lambda f: load_xyzirct_arrays(f, params.grid_size)
        )
        for names, payloads in loader:
            arrays = stack_batch(payloads)
            with timer.stage("bev", items=sum(1 for n in names if n)):
                labeled, bevs = process_batch(_to_device(arrays, device), params, ground_cfg,
                                              bev_cfg, compat=compat)
                host = _to_host([{**_wire(labeled), "bev": bevs}])
                for bi, name in enumerate(names):
                    if name is None:
                        continue
                    short = _short_name(name)
                    log.info(f"Converting file: {short}")
                    write_csv(bvm_dir + short + ".csv", host["bev"][bi])
                    write_gray_png(bvm_dir + short + ".png", host["bev"][bi])
                    xyz = host["xyz"][bi]
                    write_pcd(
                        non_ground_dir + short + ".pcd",
                        {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                         **{k: host[k][bi] for k in ("intensity", "row", "col", "t", "label")}},
                    )

    avg = timer.average_ms("bev")
    log.info(timer.report_average("bev", "Average preprocessing and BEV generation"))
    log.info("Done. ")
    return avg
