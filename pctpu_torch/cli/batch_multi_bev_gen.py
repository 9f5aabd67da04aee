"""CLI: batch_multi_bev_gen — argv contract of
reference/BatchMultiBevGen.cpp:664-689, the same as
``pctpu.cli.batch_multi_bev_gen``.

Runs on the CUDA card, or on the CPU with ``--device=cpu``; without a card
and that flag it exits non-zero.  The device in use is printed.  Device
meshes, multi-process sharding and the profiler trace are not ported yet."""

import sys

from pctpu_torch.cli._common import int_kw, pick_device, split_args, usage_exit
from pctpu_torch.pipelines.multi_bev import run_multi_bev

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
            (--devices, --num-processes, --process-id, --coordinator and
            --profile are not ported)
"""

_NOT_PORTED = ("devices", "num_processes", "process_id", "coordinator", "profile")


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 2:
        usage_exit(USAGE)
    if any(k in kw for k in _NOT_PORTED):
        raise NotImplementedError(
            "pctpu_torch runs batch_multi_bev_gen in one process on one device: "
            "--devices, multi-process flags and --profile are not ported"
        )
    device = pick_device(kw)
    run_multi_bev(
        pos[0],
        pos[1],
        batch_size=int_kw(kw, "batch_size", 8),
        resume=kw.get("resume", "false") == "true",
        write_pngs=kw.get("no_pngs", "false") != "true",
        compat=kw.get("compat", "bitexact"),
        device=device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
