"""CLI: batch_multi_bev_gen — argv contract of
reference/BatchMultiBevGen.cpp:664-689, the same as
``pctpu.cli.batch_multi_bev_gen``.

Runs on the CUDA card, or on the CPU with ``--device=cpu``; without a card
and that flag it exits non-zero.  The device in use is printed.  It takes
pctpu's extensions: ``--devices=N`` (a data mesh; on the card N cards, or
exit code 2), ``--num-processes=N --process-id=K --coordinator=host:port``
(each process a strided slice of the clouds) and ``--profile=DIR`` (a
``torch.profiler`` trace of the run)."""

import sys

from pctpu_torch.cli._common import (devices_kw, int_kw, pick_device, process_group, split_args,
                                     usage_exit)
from pctpu_torch.pipelines.multi_bev import run_multi_bev
from pctpu_torch.runtime.profiler import trace

USAGE = """\
Usage: batch_multi_bev_gen [keyframes_root_dir] [sensor_type]

[keyframes_root_dir] should be organized as follows:
[keyframes_root_dir]
├ keyframe_point_cloud/ <- folder for selected point clouds in pcd format for each frame
├ keyframe_pose.csv <- 6-DoF pose for each frame
└ keyframe_pose_format.csv <- 6-DoF pose format description

[sensor_type] could be HDL_32E, HDL_64E or OS1_64.

This binary generates ground-removed point clouds, single & multi layer BEV
images and creates geometric distance-based labels for each point cloud.

Extensions: --resume  --batch-size=N  --no-pngs  --device=cuda|cpu (default cuda)
            --compat=bitexact|tolerance (ground-grid accumulation: bit-exact
            C++ rounding sequence (default) vs one matmul per batch)
            --devices=N (data mesh: each batch split over N cards, or over
            N logical CPU devices with --device=cpu)
            --num-processes=N --process-id=K --coordinator=host:port (each
            process converts a strided slice of the clouds; process 0 also
            writes keyframe_label.csv)
            --profile=DIR (a torch.profiler Chrome trace of the run)
"""


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 2:
        usage_exit(USAGE)
    device = pick_device(kw)
    devices = devices_kw(kw, device)
    profile = kw.get("profile")  # a bare --profile writes to the default dir
    with process_group(kw, device, devices) as (nproc, pid), trace(
            "batch_multi_bev_gen", enabled=profile is not None,
            trace_dir=None if profile == "true" else profile):
        run_multi_bev(
            pos[0],
            pos[1],
            batch_size=int_kw(kw, "batch_size", 8),
            resume=kw.get("resume", "false") == "true",
            write_pngs=kw.get("no_pngs", "false") != "true",
            devices=devices,
            process_id=pid,
            num_processes=nproc,
            compat=kw.get("compat", "bitexact"),
            device=device,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
