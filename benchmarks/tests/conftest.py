"""Helpers of the harness's own tests: the benchmark's folders on the path,
small traffic for runs on the CPU, and the card fixture of the tests that
need one."""

from __future__ import annotations

import argparse
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# traffic small enough for the CPU: whole pipelines at the configurations'
# widths, on few clouds (the registration keyframes thinned, THIN)
SMALL = {
    "harness.bev_window": {"batch": 2, "pool": 2, "warmup_batches": 1, "check_batches": 1},
    "harness.reg_window": {"pair_batch": 2, "places": 1, "warmup_batches": 1, "check_pairs": 2},
}
THIN = 16


def small_run(cell: str, monkeypatch, seed: int = 2**31 + 7, seconds: float = 0.3,
              trace: int = 0, traffic: dict | None = None, thin: int = THIN):
    """One run of ``cell`` on the CPU with small traffic (or the cell's own
    with ``traffic``'s changes), the registration keyframes thinned to every
    ``thin``-th point: (exit code, result)."""
    import torch

    from harness import cells, main, scene

    orig = cells.resolve
    if orig(cell).traffic["window"] == "harness.reg_window":
        keyframe = scene.keyframe

        def thinned(*a, **k):
            return {f: v[::thin] for f, v in keyframe(*a, **k).items()}

        monkeypatch.setattr(scene, "keyframe", thinned)

    def resolve(name, root=cells.ROOT):
        c = orig(name, root)
        c.traffic.update(SMALL[c.traffic["window"]] if traffic is None else traffic)
        return c

    monkeypatch.setattr(main, "resolve", resolve)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return main.run(args, time.perf_counter(), device=torch.device("cpu"))


@pytest.fixture
def card():
    """The CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)
