"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` names its configuration (the ``file`` of the
``configs`` entry) and its traffic mix (``benchmarks/traffic/<traffic>.json``,
whose ``window`` names the module that drives it and whose ``control`` names
its control); each per-layer metric is read by
``benchmarks/metrics/<metric>.py``.  A later change adds a configuration, a
mix, a window driver or a metric by adding files and entries, and edits none
of these.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    traffic mix and the metrics it reports; KeyError for an unknown cell."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """The ``read(trace, cell)`` function of ``benchmarks/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
