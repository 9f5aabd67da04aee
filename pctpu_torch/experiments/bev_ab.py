"""Clouds/s of ``batch_multi_bev_gen`` and the device time of a batch, one
checkout against another, on one CUDA card.

    python3 -m pctpu_torch.experiments.bev_ab CHECKOUT_A CHECKOUT_B [--rounds=N]

Builds the HDL-64E drive of ``chip_smoke.py``'s phase 9
(``experiments.scene.multi_bev_tree``: 64 grid-ordered clouds, two raw, one
over capacity) under ``build/``, then runs each checkout's CLI on it, each
checkout in a process of its own with its own kernels, in the order A, B, B,
A (``--rounds`` times).  A process warms up on 9 clouds, then for each compat
mode runs the CLI three times and times ``preprocess_batch`` on 8 clouds
(CUDA events, 20 batches), and prints one JSON line per run: clouds/s (host
clock around the CLI, ending in a synchronize), the ``[TIME]`` device and
write ms per cloud, the batch's device ms, and the card's name and power
limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

# one checkout's measurement, run with that checkout as the working
# directory so that ``pctpu_torch`` is its package
_RUN = r"""
import contextlib, glob, io, json, os, re, shutil, sys, time
import torch
from pctpu_torch.cli import batch_multi_bev_gen as cli
from pctpu_torch.config import get_sensor_params
from pctpu_torch.experiments.card import cuda_ms, nvidia_smi_line
from pctpu_torch.ops.preprocess import preprocess_batch
from pctpu_torch.pipelines import multi_bev
from pctpu_torch.runtime.loader import load_xyzirct_arrays, stack_batch

tree, warm, tag, checkout = sys.argv[1:5]
card = nvidia_smi_line()
params = get_sensor_params("HDL_64E")
paths = sorted(glob.glob(os.path.join(tree, "keyframe_point_cloud", "*.pcd")))
clouds = multi_bev._to_device(stack_batch([load_xyzirct_arrays(p, params) for p in paths[:8]]),
                              torch.device("cuda", 0))


def run(root, compat):
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([root, "HDL_64E", f"--compat={compat}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for sub in ("non_ground_point_cloud", "output_multi_bev", "output_single_bev"):
        shutil.rmtree(os.path.join(root, sub))
    os.remove(os.path.join(root, "keyframe_label.csv"))
    return rc, wall, out.getvalue()


for compat in ("bitexact", "tolerance"):
    run(warm, compat)
    batch_ms = cuda_ms(lambda: preprocess_batch(clouds, params, assume_ordered=True,
                                                compat=compat), reps=20)
    for k in range(3):
        rc, wall, log = run(tree, compat)
        t = re.search(r"\[TIME\] Average preprocessing and BEV generation: \S+ "
                      r"\(device (\S+) \+ BEV write (\S+),", log)
        print(json.dumps({"tag": tag, "checkout": checkout, "compat": compat, "run": k,
                          "ok": rc == 0, "clouds_per_s": len(paths) / wall,
                          "device_ms_per_cloud": float(t.group(1)),
                          "write_ms_per_cloud": float(t.group(2)),
                          "preprocess_batch_ms": batch_ms, "card": card}), flush=True)
"""


def main(argv: list[str] | None = None) -> int:
    import shutil

    import torch

    from pctpu_torch.config import get_sensor_params
    from pctpu_torch.experiments.scene import multi_bev_tree

    argv = sys.argv[1:] if argv is None else argv
    rounds = int(next((a.split("=", 1)[1] for a in argv if a.startswith("--rounds=")), 1))
    checkouts = [os.path.abspath(a) for a in argv if not a.startswith("--")]
    if len(checkouts) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("bev_ab needs a CUDA card")
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "bev_ab")
    shutil.rmtree(root, ignore_errors=True)
    tree, warm = os.path.join(root, "tree"), os.path.join(root, "warm")
    paths = multi_bev_tree(tree, get_sensor_params("HDL_64E"), n_ordered=64, n_raw=2, n_over=1)
    os.makedirs(os.path.join(warm, "keyframe_point_cloud"))
    for p in paths[:8] + [paths[64]]:
        shutil.copy(p, os.path.join(warm, "keyframe_point_cloud"))
    shutil.copy(os.path.join(tree, "keyframe_pose.csv"), warm)
    for tag in ["A", "B", "B", "A"] * rounds:
        checkout = checkouts[0] if tag == "A" else checkouts[1]
        res = subprocess.run([sys.executable, "-c", _RUN, tree, warm, tag, checkout],
                             cwd=checkout, env={**os.environ, "PYTHONPATH": checkout},
                             capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            return res.returncode
    shutil.rmtree(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
