"""CLI: batch_cloud_manip — argv contract of
reference/BatchCloudManip.cpp:269-274 (``batch_cloud_manip <root>``), the
same as ``pctpu.cli.batch_cloud_manip`` (``--batch_size=N``, ``--resume``,
``--compat=bitexact|tolerance``).

Runs on the CUDA card, or on the CPU with ``--device=cpu``; without a card
and that flag it exits non-zero.  The device in use is printed."""

import sys

from pctpu_torch.cli._common import int_kw, pick_device, split_args, usage_exit
from pctpu_torch.pipelines.batch_cloud_manip import run_batch_cloud_manip


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 1:
        usage_exit("Usage: batch_cloud_manip <keyframes_root_dir>")
    device = pick_device(kw)
    run_batch_cloud_manip(
        pos[0],
        batch_size=int_kw(kw, "batch_size", 8),
        resume=kw.get("resume", "false") == "true",
        compat=kw.get("compat", "bitexact"),
        device=device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
