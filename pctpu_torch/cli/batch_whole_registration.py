"""CLI: batch_whole_registration — argv contract of
reference/BatchWholeRegistration.cpp:311-321
(``batch_whole_registration <match_result.txt> <point_cloud_dir>``), the
same as ``pctpu.cli.batch_whole_registration``.

Runs on the CUDA card when there is one, on the CPU otherwise; the device
in use is printed.  Pair batching, device meshes and multi-process sharding
are not ported yet."""

import sys

import torch

from pctpu_torch.cli._common import int_kw, split_args, usage_exit
from pctpu_torch.pipelines.registration import run_batch_whole_registration

_NOT_PORTED = ("devices", "num_processes", "process_id", "coordinator")


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 2:
        usage_exit(
            "Usage: batch_whole_registration <match_result.txt> <point_cloud_dir>\n"
            "Extensions: --capacity=N  --report=PATH\n"
            "            --resume (skip pairs already in <report>.progress)"
        )
    if int_kw(kw, "pair_batch", 1) != 1 or any(k in kw for k in _NOT_PORTED):
        raise NotImplementedError(
            "pctpu_torch runs pairs one after another on one device: "
            "--pair-batch>1, --devices and multi-process flags are not ported"
        )
    if torch.cuda.is_available():
        device = "cuda"
        print(f"device: cuda ({torch.cuda.get_device_name()})")
    else:
        device = "cpu"
        print("device: cpu")
    run_batch_whole_registration(
        pos[0],
        pos[1],
        report_path=kw.get("report", "./icp_precision_report_3d_icp_directly.txt"),
        capacity=int_kw(kw, "capacity", None),
        resume=kw.get("resume", "false") == "true",
        device=device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
