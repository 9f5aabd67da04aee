"""Readings for the limits of ``correct``: a cell's set-up and a short window
at the cell's own size, seed after seed in one process, then the program's
sampled answers against the plain reference and, on the seeds named for it,
the control's (the reference in the precision below the configuration's) in
the program's place.  The benchmark's own runs never run this.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--seconds 2]

Prints one JSON line a seed and reading: {"seed", "side", "numbers"}.
"""

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

def main(argv=None) -> int:
    import contextlib

    import torch

    from harness.cells import resolve
    from harness.checks import rules
    from harness.main import cache_dirs, make_window

    ap = argparse.ArgumentParser(prog="python3 benchmarks/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    cache_dirs()
    import pctpu_torch  # noqa: F401

    cell = resolve(args.workload)
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        win = make_window(cell, seed, device, lambda name: contextlib.nullcontext())
        items, batches, secs = win.window(args.seconds)
        win.free()
        gc.collect()
        torch.cuda.empty_cache()
        sides = [("program", None)]
        if seed in controls:
            sides.append(("control", cell.traffic["control"]))
        for side, control in sides:
            got = win.check(rules(cell.name), control)
            print(json.dumps({"seed": seed, "side": side, "rate": items / secs,
                              "numbers": got["numbers"],
                              **{k: v for k, v in got.items() if k != "numbers"}}),
                  flush=True)
        del win
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
