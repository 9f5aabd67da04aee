"""Two real processes of the port's ``batch_multi_bev_gen`` CLI joined in one
``torch.distributed`` group (gloo, a coordinator on localhost), on the CPU:
the port's counterpart of tests/test_multiprocess_distributed.py.  Both
start at once without ``--resume`` (process 0 resets the output directories
and the group waits for it), each converts its strided half of a full-width
HDL-32E tree, process 1 runs no label phase, and the merged tree is
byte-identical to a one-process run."""

import os
import shutil
import socket
import subprocess
import sys

from pctpu_torch.config import get_sensor_params
from pctpu_torch.experiments.scene import multi_bev_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("non_ground_point_cloud", "output_multi_bev", "output_single_bev")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tree_files(root: str) -> dict:
    out = {}
    for base in OUTPUTS:
        for dirpath, _, files in os.walk(os.path.join(root, base)):
            for f in files:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    with open(os.path.join(root, "keyframe_label.csv"), "rb") as fh:
        out["keyframe_label.csv"] = fh.read()
    return out


def _cli(root: str, *flags: str) -> list[str]:
    return [sys.executable, "-m", "pctpu_torch.cli.batch_multi_bev_gen", root, "HDL_32E",
            "--device=cpu", "--batch-size=2", *flags]


def test_two_processes_match_one(tmp_path):
    n = 6
    single, multi = str(tmp_path / "single"), str(tmp_path / "multi")
    multi_bev_tree(single, get_sensor_params("HDL_32E"), n_ordered=n - 1, n_raw=1, n_over=0,
                   spacing=12.0)
    shutil.copytree(single, multi)
    # the output dirs exist from a stale run: process 0 must reset them
    os.makedirs(os.path.join(multi, "non_ground_point_cloud"))
    with open(os.path.join(multi, "non_ground_point_cloud", "stale.pcd"), "w") as f:
        f.write("stale")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    one = subprocess.run(_cli(single), cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert one.returncode == 0, one.stdout + one.stderr

    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(_cli(multi, "--num-processes=2", f"--process-id={pid}",
                                   f"--coordinator={coord}"),
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
    # each process converted its strided half
    for pid, out in enumerate(outs):
        converted = [line.split()[-1] for line in out.splitlines()
                     if line.startswith("Converting file:")]
        assert converted == [f"{k:06d}" for k in range(pid, n, 2)], out
    # only process 0 runs the global label phase
    assert "One-hot label has length" in outs[0]
    assert "One-hot label has length" not in outs[1]
    expected, got = _tree_files(single), _tree_files(multi)
    assert sorted(got) == sorted(expected) and len(expected) == n * 28 + 1
    assert [k for k in expected if got[k] != expected[k]] == []
