"""CLI: batch_top_part_registration — argv contract of
reference/BatchTopPartRegistration.cpp:311-321
(``batch_top_part_registration <match_result.txt> <point_cloud_dir>``), the
same as ``pctpu.cli.batch_top_part_registration``.

Runs on the CUDA card, or on the CPU with ``--device=cpu``; without a card
and that flag it exits non-zero.  The device in use is printed.
``--pair-batch=N`` runs N pairs as one batch through every stage (default 16
on the card, 1 on the CPU).  pctpu's ``--devices=N`` (each batch split over
a data mesh; on the card N cards, or exit code 2) and ``--num-processes=N
--process-id=K --coordinator=host:port`` (each process a strided share of
the pairs and its own ``<report>.shard<K>``) are taken as pctpu takes them."""

import sys

from pctpu_torch.cli._common import (devices_kw, int_kw, pick_device, process_group,
                                     split_args, usage_exit)
from pctpu_torch.pipelines.registration import run_batch_top_part_registration


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 2:
        usage_exit(
            "Usage: batch_top_part_registration <match_result.txt> <point_cloud_dir>\n"
            "Extensions: --capacity=N  --flat-cap=N  --report=PATH\n"
            "            --resume (skip pairs already in <report>.progress)\n"
            "            --device=cuda|cpu (default cuda)\n"
            "            --pair-batch=N (pairs batched through every stage;\n"
            "            default 16 on the card, 1 on the CPU)  --devices=N\n"
            "            (data mesh)  --num-processes=N --process-id=K\n"
            "            --coordinator=host:port"
        )
    device = pick_device(kw)
    devices = devices_kw(kw, device)
    with process_group(kw, device, devices) as (nproc, pid):
        run_batch_top_part_registration(
            pos[0],
            pos[1],
            report_path=kw.get("report", "./icp_precision_report.txt"),
            flat_cap=int_kw(kw, "flat_cap", 32768),
            capacity=int_kw(kw, "capacity", None),
            pair_batch=int_kw(kw, "pair_batch", None),
            devices=devices,
            process_id=pid,
            num_processes=nproc,
            resume=kw.get("resume", "false") == "true",
            device=device,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
