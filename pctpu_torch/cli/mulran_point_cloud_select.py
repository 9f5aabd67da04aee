"""CLI: mulran_point_cloud_select — argv contract of
reference/MulranPointCloudSelect.cpp:248-288.

The port of ``pctpu.cli.mulran_point_cloud_select``, with its argv and usage
text.  It runs on the host, as pctpu's does: it puts no tensor on any
device, so it takes no ``--device``."""

import sys

from pctpu_torch.cli._common import split_args, usage_exit
from pctpu_torch.pipelines.selectors import run_mulran_select

USAGE = """\
Usage: mulran_point_cloud_select [dataset_root_dir] [keyframe_dist_interval](default=2)

[dataset_root_dir] should be organized as follows:
[dataset_root_dir]
├ sensor_data/
│ ├ Ouster/
│ └ ouster_front_stamp.csv
└ global_pose.csv
"""


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 1:
        usage_exit(USAGE)
    interval = float(pos[1]) if len(pos) > 1 else 2.0
    run_mulran_select(pos[0], interval, resume=kw.get("resume", "false") == "true")
    return 0


if __name__ == "__main__":
    sys.exit(main())
