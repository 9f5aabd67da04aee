"""CLI: kitti_raw_point_cloud_select — the reference's dead raw-variant
selector (reference/KittiRawPointCloudSelect.cpp:315-373).  The
reference hardcodes its dataset path (:59) and takes no argv; here the
path is the one positional argument (documented deviation — the binary
is not in the reference CMakeLists and is kept for inventory parity).

The port of ``pctpu.cli.kitti_raw_point_cloud_select``, with its argv and
usage text.  It runs on the host, as pctpu's does: it puts no tensor on any
device, so it takes no ``--device``."""

import sys

from pctpu_torch.cli._common import split_args, usage_exit
from pctpu_torch.pipelines.selectors import run_kitti_raw_select

USAGE = """\
Usage: kitti_raw_point_cloud_select <dataset_root_dir>

<dataset_root_dir> should be organized as follows:
<dataset_root_dir>
├ velodyne/
├ times.txt
└ global_pose.txt

Keyframes (fixed 2 m interval) are written to
<dataset_root_dir>/selected_keyframes/.
"""


def main(argv=None) -> int:
    pos, _kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 1:
        usage_exit(USAGE)
    run_kitti_raw_select(pos[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
