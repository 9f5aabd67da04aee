"""Nothing a cell's run loads is JAX or the JAX package, and the command
prints no result where it cannot measure."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

REHEARSE = r"""
import json, sys, time, argparse
sys.path[:0] = [{root!r}, {bench!r}]
sys.path.insert(0, {tests!r})
import torch
from conftest import small_run

class Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)

code, result = small_run({cell!r}, Patch(), seconds=0.2)
from harness.main import forbidden_modules
print(json.dumps({{"forbidden": forbidden_modules(), "port": "pctpu_torch" in sys.modules,
                  "correct": result["correct"]}}))
"""


@pytest.mark.parametrize("cell", ["mulran-os1-64.bev", "kitti-hdl64e.toppart64",
                                  "kitti-hdl64e.whole64"])
def test_no_jax_in_a_rehearsed_run(cell):
    src = REHEARSE.format(root=ROOT, bench=BENCH, tests=os.path.join(BENCH, "tests"),
                          cell=cell)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert got["port"] and got["correct"]


def test_forbidden_names_compared_whole(monkeypatch):
    from harness.main import forbidden_modules

    monkeypatch.setitem(sys.modules, "pctpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    assert "pctpu_torch_lookalike" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "pctpu.ops", sys)
    assert "pctpu.ops" in forbidden_modules()


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                           "mulran-os1-64.bev", "--seed", "1", "--seconds", "1", *args],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
