"""CLI: cloud_manip — argv contract of reference/CloudManip.cpp:111-161
(``cloud_manip <pcd> tx ty tz yaw_deg``), the same as
``pctpu.cli.cloud_manip``.  ``--output_dir=DIR`` for the six files;
``--snapshot=out.png`` writes a headless render of the viewer scene (input
red, output green, CloudManip.cpp:143-158); ``--snapshot-view=front`` for
the elevation view; ``--html=out.html`` writes the same scene as a
standalone interactive WebGL viewer (``pctpu_torch.io.html_viewer``).

Runs on the CUDA card, or on the CPU with ``--device=cpu``; without a card
and that flag it exits non-zero.  The device in use is printed."""

import math
import sys

from pctpu_torch.cli._common import path_kw, pick_device, split_args, usage_exit
from pctpu_torch.pipelines.cloud_manip import run_cloud_manip


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 5:
        usage_exit("Usage: cloud_manip <pcd> tx ty tz yaw_deg")
    device = pick_device(kw)
    print(f"rotating yaw radiance: {float(pos[4]) / 180.0 * math.pi}")
    run_cloud_manip(
        pos[0],
        float(pos[1]),
        float(pos[2]),
        float(pos[3]),
        float(pos[4]),
        output_dir=kw.get("output_dir", "."),
        snapshot=path_kw(kw, "snapshot"),
        snapshot_view=kw.get("snapshot_view", "top"),
        html=path_kw(kw, "html"),
        device=device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
