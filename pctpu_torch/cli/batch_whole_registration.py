"""CLI: batch_whole_registration — argv contract of
reference/BatchWholeRegistration.cpp:311-321
(``batch_whole_registration <match_result.txt> <point_cloud_dir>``), the
same as ``pctpu.cli.batch_whole_registration``.

Runs on the CUDA card, or on the CPU with ``--device=cpu``; without a card
and that flag it exits non-zero.  The device in use is printed.
``--pair-batch=N`` runs N pairs as one batch through every stage (default 16
on the card, 1 on the CPU); device meshes and multi-process sharding are not
ported yet."""

import sys

from pctpu_torch.cli._common import int_kw, pick_device, split_args, usage_exit
from pctpu_torch.pipelines.registration import run_batch_whole_registration

_NOT_PORTED = ("devices", "num_processes", "process_id", "coordinator")


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 2:
        usage_exit(
            "Usage: batch_whole_registration <match_result.txt> <point_cloud_dir>\n"
            "Extensions: --capacity=N  --report=PATH\n"
            "            --resume (skip pairs already in <report>.progress)\n"
            "            --device=cuda|cpu (default cuda)\n"
            "            --pair-batch=N (pairs batched through every stage;\n"
            "            default 16 on the card, 1 on the CPU)"
        )
    if any(k in kw for k in _NOT_PORTED):
        raise NotImplementedError(
            "pctpu_torch runs on one device in one process: "
            "--devices and multi-process flags are not ported"
        )
    device = pick_device(kw)
    run_batch_whole_registration(
        pos[0],
        pos[1],
        report_path=kw.get("report", "./icp_precision_report_3d_icp_directly.txt"),
        capacity=int_kw(kw, "capacity", None),
        pair_batch=int_kw(kw, "pair_batch", None),
        resume=kw.get("resume", "false") == "true",
        device=device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
