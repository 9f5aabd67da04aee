"""Torch ops the ICP loop dispatches per iteration — its host cost, which no
kernel time shows (each op is a Python → C++ dispatch and, on the card, most
are a launch).

    python3 -m pctpu_torch.experiments.icp_ops [CHECKOUT ...]

For each checkout (default: this one), in a process of its own with that
checkout first on the path, runs point-to-point ICP on the CPU over a
600-point cloud for 5 and for 10 iterations and counts every op dispatched
(``TorchDispatchMode``), with the 1-NN replaced by random correspondences so
that no problem converges and the search's own ops stay out.  The difference
over 5 iterations is one iteration's ops.  Prints one JSON line a checkout
and problem count (1, and 16 where the checkout has ``icp_batched``): ops an
iteration, without views, and the eight lines of the port that dispatch most.
"""

from __future__ import annotations

import os
import subprocess
import sys

_RUN = r"""
import collections, json, sys, traceback
import numpy as np, torch
from torch.utils._python_dispatch import TorchDispatchMode
from pctpu_torch.config import IcpConfig
from pctpu_torch.ops import icp

VIEWS = {"view", "_unsafe_view", "unsqueeze", "squeeze", "select", "slice", "expand",
         "transpose", "permute", "t", "alias", "detach", "lift_fresh"}
rng = np.random.default_rng(0)
calls = [0]


def fake_search(n_problems, nq):
    calls[0] += 1
    idx = torch.randperm(nq).to(torch.int32).expand(n_problems, -1)
    return idx, torch.full((n_problems, nq), 0.09 + (calls[0] % 3) * 0.1)


icp.nn_1_pruned = lambda q, qm, prepared=None, max_distance=None: tuple(
    x[0] for x in fake_search(1, q.shape[0]))
icp.nn_1_pruned_batched = lambda q, qm, prepared, md=None: fake_search(q.shape[0], q.shape[1])


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.lines = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        port = [f for f in traceback.extract_stack() if "pctpu_torch" + "/" in f.filename]
        if port:
            self.lines[port[-1].filename.split("pctpu_torch/")[-1] + f":{port[-1].lineno}"] += 1
        return func(*args, **(kwargs or {}))


def count(n_problems, iterations):
    src = torch.from_numpy(rng.uniform(-20, 20, (n_problems, 600, 3)).astype(np.float32))
    mask = torch.ones((n_problems, 600), dtype=torch.bool)
    cfg = IcpConfig(max_correspondence_distance=2.0, max_iterations=iterations,
                    transformation_epsilon=0.0, euclidean_fitness_epsilon=0.0)
    guess = torch.eye(4).repeat(n_problems, 1, 1)
    with Count() as c:
        if n_problems == 1:
            icp.icp_point_to_point(src[0], mask[0], src[0] + 0.3, mask[0], guess[0], cfg,
                                   nn_impl="pruned")
        else:
            icp.icp_batched(src, mask, src + 0.3, mask, guess, cfg, nn_impl="pruned")
    return c


for n_problems in (1, 16) if hasattr(icp, "icp_batched") else (1,):
    a, b = count(n_problems, 5), count(n_problems, 10)
    ops, lines = b.ops - a.ops, b.lines - a.lines
    print(json.dumps({
        "checkout": sys.argv[1], "problems": n_problems,
        "ops_per_iteration": sum(ops.values()) / 5,
        "non_view_ops_per_iteration": sum(v for k, v in ops.items() if k not in VIEWS) / 5,
        "top_lines": {k: v / 5 for k, v in lines.most_common(8)}}), flush=True)
"""


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for checkout in [os.path.abspath(a) for a in argv] or [here]:
        res = subprocess.run([sys.executable, "-c", _RUN, checkout], cwd=checkout,
                             env={**os.environ, "PYTHONPATH": checkout},
                             capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
