"""The BEV pipeline's host↔device wire three ways, in one process on one device.

    python -m pctpu_torch.experiments.wire_ab [--rounds=N] [--clouds=N] [--device=cuda|cpu]

``run_multi_bev`` (bit-exact, PNGs on, batches of 8) over the HDL-64E drive of
``chip_smoke.py``'s phase 9 (``experiments.scene.multi_bev_tree``: ``--clouds``
grid-ordered clouds, two raw, one over capacity) with:

- P: the pipelines' wire (``multi_bev._to_device``, ``_wire``, ``_to_host``:
  on-disk widths both ways, pinned host tensors on a card, one synchronize);
- U: the same narrow wire, copied back into pageable host tensors;
- W: the wide wire (every field widened on the host, 36 B a slot, and each
  field copied back wide, pageable and blocking, narrowed on the host).

After a warm-up run of each, the runs go in turns, P U W W U P, ``--rounds``
times, each writing the tree anew, and every run's tree must equal the first
P run's, byte for byte.  Prints one JSON line a run (clouds/s on the host
clock, ``[TIME]`` device and write ms a cloud, loop wall ms a cloud), then one
summary line: each variant's medians, the pinned blocks the caching host
allocator made during the timed runs, and the writers alone (one thread,
the eight clouds of one batch) reading that batch's pinned arrays against
pageable copies of them, in turns, ms a cloud; with the card's name and
power limit.  Exit 1 when a tree differs, 2 for ``--device=cuda`` without a
card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import sys
import time

import numpy as np
import torch

from pctpu_torch.experiments.bench import to_device_wide
from pctpu_torch.pipelines import multi_bev

_WIRE = ("_to_device", "_wire", "_to_host")
_FIELDS = ("xyz", "intensity", "row", "col", "t", "label")


def _to_host_pageable(parts: list[dict]) -> dict:
    """``multi_bev._to_host`` into pageable host tensors."""
    host = {k: torch.cat([p[k].cpu() for p in parts]).numpy() for k in parts[0]}
    return {k: a.view(multi_bev._ON_DISK.get(k, a.dtype)) for k, a in host.items()}


def _to_host_wide(parts: list[dict]) -> dict:
    host = {k: np.concatenate([p[k].cpu().numpy() for p in parts]) for k in parts[0]}
    return {k: a.astype(multi_bev._ON_DISK[k]) if k in multi_bev._ON_DISK else a
            for k, a in host.items()}


def variants() -> dict[str, tuple]:
    """The three wires as (``_to_device``, ``_wire``, ``_to_host``) of
    ``multi_bev``."""
    real = tuple(getattr(multi_bev, k) for k in _WIRE)
    return {
        "P": real,
        "U": (real[0], real[1], _to_host_pageable),
        "W": (to_device_wide, lambda c: {k: getattr(c, k) for k in _FIELDS}, _to_host_wide),
    }


def tree_bytes(root: str) -> dict[str, bytes]:
    out = {}
    for sub in ("non_ground_point_cloud", "output_multi_bev", "output_single_bev"):
        for d, _, names in os.walk(os.path.join(root, sub)):
            for n in names:
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_once(tree: str, params, dev: torch.device, wire: tuple) -> dict:
    """One ``run_multi_bev`` over ``tree`` with ``wire`` in the pipeline's
    place; the module's own wire is restored after."""
    real = tuple(getattr(multi_bev, k) for k in _WIRE)
    for sub in ("non_ground_point_cloud", "output_multi_bev", "output_single_bev"):
        shutil.rmtree(os.path.join(tree, sub), ignore_errors=True)
    for k, fn in zip(_WIRE, wire):
        setattr(multi_bev, k, fn)
    try:
        _sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = multi_bev.run_multi_bev(tree, params, batch_size=8, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        for k, fn in zip(_WIRE, real):
            setattr(multi_bev, k, fn)
    return {"clouds_per_s": out.num_clouds / wall, "device_ms": out.avg_device_ms_per_cloud,
            "write_ms": out.avg_bev_write_ms_per_cloud, "loop_ms": out.wall_ms_per_cloud}


def writers_alone(paths: list[str], params, dev: torch.device, out_dir: str,
                  turns: int = 3) -> dict:
    """``multi_bev._write_outputs`` on one thread over the clouds of one batch
    (the first eight of ``paths``), from the batch's pinned host arrays and
    from pageable copies of them, in turns (pinned, pageable, pageable,
    pinned) ``turns`` times: median ms a cloud of each."""
    from pctpu_torch.ops.preprocess import preprocess_batch
    from pctpu_torch.runtime.loader import load_xyzirct_arrays, stack_batch

    arrays = stack_batch([load_xyzirct_arrays(p, params.grid_size, params=params)
                          for p in paths[:8]])
    labeled, multi, single = preprocess_batch(multi_bev._to_device(arrays, dev), params,
                                              assume_ordered=True)
    pinned = multi_bev._to_host([{**multi_bev._wire(labeled), "multi": multi,
                                  "single": single}])
    hosts = {"pinned": pinned, "pageable": {k: a.copy() for k, a in pinned.items()}}
    dirs = [os.path.join(out_dir, d) + "/" for d in ("bin", "img", "csv", "single", "pcd")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    times: dict[str, list] = {"pinned": [], "pageable": []}
    for side in ["pinned", "pageable", "pageable", "pinned"] * turns:
        host = hosts[side]
        t0 = time.perf_counter()
        for b in range(len(host["xyz"])):
            multi_bev._write_outputs(f"{b:06d}", host, b, host["multi"][b], host["single"][b],
                                     *dirs, True)
        times[side].append((time.perf_counter() - t0) * 1e3 / len(host["xyz"]))
    return {k: statistics.median(v) for k, v in times.items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pctpu_torch.experiments.wire_ab")
    ap.add_argument("--rounds", type=int, default=3, help="P U W W U P turns (default 3)")
    ap.add_argument("--clouds", type=int, default=64,
                    help="grid-ordered clouds of the drive (default 64, as phase 9)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs (default: the card)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from pctpu_torch.config import get_sensor_params
    from pctpu_torch.experiments import card
    from pctpu_torch.experiments.scene import multi_bev_tree

    argv = sys.argv[1:] if argv is None else argv
    args = parser().parse_args(argv)
    dev = card.tool_device(args.device, "wire_ab")
    if dev is None:
        return 2
    params = get_sensor_params("HDL_64E")
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "wire_ab")
    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "tree")
    paths = multi_bev_tree(tree, params, n_ordered=args.clouds, n_raw=2, n_over=1)
    wires = variants()
    try:
        for v in wires:
            run_once(tree, params, dev, wires[v])
        want = tree_bytes(tree)
        stats0 = torch.cuda.host_memory_stats() if dev.type == "cuda" else {}
        rows, differ = [], []
        for v in "PUWWUP" * args.rounds:
            row = {"variant": v, **run_once(tree, params, dev, wires[v])}
            got = tree_bytes(tree)
            if got != want:
                differ.append(v)
            rows.append(row)
            print(json.dumps(row), flush=True)
        stats1 = torch.cuda.host_memory_stats() if dev.type == "cuda" else {}
        alone = writers_alone(paths, params, dev, os.path.join(root, "alone"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({
        "medians": {v: {k: statistics.median(r[k] for r in rows if r["variant"] == v)
                        for k in ("clouds_per_s", "device_ms", "write_ms", "loop_ms")}
                    for v in wires},
        "new_pinned_blocks": stats1.get("num_host_alloc", 0) - stats0.get("num_host_alloc", 0),
        "writers_alone_ms_per_cloud": alone,
        "trees_equal": not differ, "clouds": len(paths), "device": card.device_record(dev),
    }))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
