"""Smoke check of the PyTorch/CUDA port (pctpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed: nothing here imports jax or pctpu).
Phases, each of which raises on failure (the exit code is then not 0):

1. environment: Python, torch, CUDA, Triton and nvcc versions, the card, and
   its name and power limit as nvidia-smi reports them;
2. build: the CUDA kernels from ``pctpu_torch/csrc``, timed;
3. each kernel against its plain torch twin on the card, on the same
   inputs at the slice's shapes — the bbox-pruned 1-NN at the fine pass
   (49,152 × 49,152 bucket, thr 1 m and none, and with masked points), the
   coarse pass (8,192 flat points, thr 10 m), the whole-cloud pass of
   ``batch_whole_registration`` (65,536 uncut, sorted in each cloud's own
   frame, the source moved by the yaw-only guess: thr 4 m and none; and
   thr 4 m near the truth) and past 262,144 targets; the in-order
   segment sums at 65,536 voxel rows (and, in phase 9, at the sector sums
   of 8 HDL-64E clouds): the tile kernel and the first design's walk
   (``csrc/segment_sum.cu``) bit-equal to the twin and a second run, then,
   in turns in the one call, each alone and with its wrapper, the tile
   kernel without its fill, the twin, ``torch.index_add`` and
   ``torch.segment_reduce``, the bound reckoned from the work (bytes, or
   the longest segment's chain of dependent adds), per-kernel profiler
   times, the launches a call makes and ptxas's registers.  Zero index
   mismatches and bit-equal results are required.  For each 1-NN case: the warp design
   (``csrc/nn_pruned_warp.cu``) with and without a prepared target, its prep
   kernel and the earlier block design (the <128, 1024, prod> variant), each
   against the twin, then CUDA-event times of each (the launches alone and
   with the wrapper), the pairs the warp design visits (its counting
   instance), the per-query 32-group oracle's pairs and the bound; one pass
   on a prepared target must put at most 3 kernels on the card;
   ``torch.cdist(q, t).min(1)`` at the fine and whole shapes and at
   20,000 × 300,000;
4. the voxel grid on the card twice and on the CPU: bit-identical;
5. the slice: a keyframe tree of the 65,536-capacity registration scene and
   moved copies with known yaw and translation
   (``experiments.scene.registration_tree``, the tree that
   ``experiments.registration_ab`` times) goes through the
   ``batch_top_part_registration`` CLI; every pair must succeed within 0.5°
   and 0.10 m of the truth, and each kernel must have been launched;
6. the same tree and pairs through the ``batch_whole_registration`` CLI
   (direct WHOLE_ICP from the yaw guess, the pruned 1-NN at thr 4 m): every
   pair must succeed within 0.5° and 0.10 m; pairs/s, the ``[TIME]``
   fine ms and the NN passes per pair are printed;
7. the fused unpruned 1-NN (``cuda_knn.nn_1_fused``) at 65,536 × 65,536
   (uniform ±70 m), 16,384² and on the unsorted fine-stage bucket, 5% of
   queries and targets masked: 0 mismatches against its twin, and the
   CUDA-event ms of the kernel, the twin and ``knn.nn_1``;
8. the argmin and tile-shape experiment
   (``pctpu_torch.experiments.nn_argmin --quick``): every mode and tile
   shape bit-equal to its twin before it is timed;
9. ``batch_multi_bev_gen`` on a ray-cast HDL-64E drive (64 grid-ordered
   clouds, two raw clouds with duplicate cells, one over the grid's
   capacity; ``pctpu_torch.experiments.scene``): the BEV raster and the
   in-order ground sums bit-equal to their twins at B = 8;
   ``preprocess_batch`` timed with the tile kernel and, in turns, with the
   walk in the sector sums' place; the CLI in both
   compat modes after a warm-up, printing clouds/s, its ``[TIME]`` lines,
   launches per batch, the writer and the largest ground sector; the
   tolerance tree byte-identical to the bit-exact tree, the card's tree to
   the port's CPU run on 4 clouds, and labels, ``.bin`` and single BEV to
   ``native/ref_oracle.cpp`` (any difference must be a D2 slope knife
   edge).

Each of paths 5-9 runs with the launch counts set to 0 just before it and
read just after; a kernel of the path launched no time fails the run.
Prints one JSON line of per-kernel results, then the final line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.metadata
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def pose_error(tf: np.ndarray, truth: np.ndarray) -> tuple[float, float]:
    """(yaw error in degrees, xy translation error in metres)."""
    yaw = math.degrees(math.atan2(tf[1, 0], tf[0, 0]) - math.atan2(truth[1, 0], truth[0, 0]))
    return (abs((yaw + 180.0) % 360.0 - 180.0),
            float(np.hypot(tf[0, 3] - truth[0, 3], tf[1, 3] - truth[1, 3])))


def require_launched(counts: dict, names, path: str) -> None:
    for name in names:
        if counts.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched by {path}")


def print_ptxas(path) -> dict[str, str]:
    """One line per compiled kernel: registers, spills, shared memory.
    Returns them by kernel name."""
    found: dict[str, str] = {}
    if not os.path.exists(path):
        return found
    name = None
    spill = ""
    for line in open(path):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            tpl = re.findall(r"Li(\d+)E", name)
            short = re.search(r"(nn_pruned_kernel|nn_fused_kernel|segment_sum_tile_kernel"
                              r"|segment_sum_walk_kernel|segment_fill_kernel"
                              r"|bev_raster_kernel|bev_expand_kernel|nn_prep_kernel"
                              r"|nn_seed_kernel|nn_main_kernel|nn_finish_kernel)", name)
            counting = "ILb1E" in name
            name = (short.group(1) if short else name) + (
                f"<{','.join(tpl)}>" if tpl else "<counting>" if counting else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            found[name] = f"{m.group(1)} registers, {m.group(2) or 0} B static smem, {spill}"
            print(f"  ptxas {name}: {found[name]}")
            name = None
    return found


def compare(name: str, got, want) -> float:
    """Require equal indices and bit-equal values; returns max |Δ| over the
    finite values (0.0 when bit-equal)."""
    from pctpu_torch.experiments.card import mismatches

    n, max_err = mismatches(got, want)
    print(f"  {name}: {n} mismatches, max_abs_err {max_err}")
    if n:
        raise AssertionError(f"{name}: kernel and twin disagree in {n} entries")
    return max_err


BEV_OUTPUTS = ("non_ground_point_cloud", "output_multi_bev", "output_single_bev",
               "keyframe_label.csv")


def tree_files(root: str) -> dict[str, bytes]:
    """Every output file of a batch_multi_bev_gen tree, by relative path."""
    files = {}
    for sub in BEV_OUTPUTS:
        top = os.path.join(root, sub)
        walk = [(root, [], [sub])] if os.path.isfile(top) else os.walk(top)
        for dirpath, _, names in walk:
            for n in names:
                path = os.path.join(dirpath, n)
                with open(path, "rb") as f:
                    files[os.path.relpath(path, root)] = f.read()
    return files


def library_sums_ms(rows: torch.Tensor, seg: torch.Tensor, n_out: int) -> tuple[float, float]:
    """The library yardsticks of the segment sums, each one call over the
    rows that join a segment: ``torch.index_add`` (its atomics add in no
    fixed order) and ``torch.segment_reduce`` given the run lengths."""
    from pctpu_torch.experiments.card import cuda_ms

    keep = (seg >= 0) & (seg < n_out)
    idx, rows = seg[keep].long(), rows[keep]
    lengths = torch.unique_consecutive(idx, return_counts=True)[1]
    zeros = torch.zeros((n_out, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return (cuda_ms(lambda: torch.index_add(zeros, 0, idx, rows), reps=20),
            cuda_ms(lambda: torch.segment_reduce(rows, "sum", lengths=lengths), reps=20))


def sums_case(name: str, args: tuple, count_as: str, ptxas: dict, smi: str,
              clock_mhz: float, fill: bool = True) -> dict:
    """One shape of the in-order segment sums, ``args`` = (values, seg, init,
    n_out, order): the tile kernel and the first design's walk, each held bit
    for bit against the twin, and the tile kernel against a second run of
    itself; then, in this one call, each alone (the C call's launches, CUDA
    events, and per kernel by torch.profiler) and with its wrapper, the tile
    kernel without its fill, the twin, the two library calls, the bound
    reckoned from the work, and the launches a wrapper call makes.  ``fill``
    says whether the path's caller asks for the fill: the entry's ``ms`` and
    ``wrapper_ms`` are the tile kernel's as the path calls it."""
    from pctpu_torch.experiments.card import cuda_ms, profile_calls, segment_sums_bound
    from pctpu_torch.ops import voxel

    values, seg, init, n_out, order = args
    n_out = seg.shape[0] if n_out is None else n_out
    lanes = values.shape[1]
    want = voxel.segment_sum_sorted_reference(*args)
    got = voxel.segment_sum_sorted(*args, count_as=count_as)
    err = compare(f"{name}: tile kernel", [got], [want])
    compare(f"{name}: walk kernel", [voxel.segment_sum_walk(*args)], [want])
    compare(f"{name}: tile kernel, second run",
            [voxel.segment_sum_sorted(*args, count_as=count_as)], [got])
    launch = {
        "tile": voxel._segment_launcher(*args, count_as)[0],
        "tile, no fill": voxel._segment_launcher(*args, count_as, fill=False)[0],
        "walk": voxel._segment_launcher(*args, "segment_sum_walk", walk=True)[0],
    }
    wrapper = {
        "tile": lambda: voxel.segment_sum_sorted(*args, count_as=count_as),
        "tile, no fill": lambda: voxel.segment_sum_sorted(*args, count_as=count_as, fill=False),
        "walk": lambda: voxel.segment_sum_walk(*args),
    }
    # in turns: tile, walk, walk, tile
    alone = {k: [] for k in launch}
    wrapped = {k: [] for k in wrapper}
    for k in ("tile", "tile, no fill", "walk", "walk", "tile, no fill", "tile"):
        alone[k].append(cuda_ms(launch[k], reps=50))
    for k in ("tile", "tile, no fill", "walk", "walk", "tile, no fill", "tile"):
        wrapped[k].append(cuda_ms(wrapper[k], reps=50))
    alone = {k: min(v) for k, v in alone.items()}
    wrapped = {k: min(v) for k, v in wrapped.items()}
    prof = {k: profile_calls(fn) for k, fn in wrapper.items()}
    rows = values if order is None else values[order]
    twin_ms = cuda_ms(lambda: voxel.segment_sum_sorted_reference(*args), reps=2, warmup=1)
    add_ms, reduce_ms = library_sums_ms(rows, seg, n_out)
    bound = segment_sums_bound(seg, lanes, n_out, clock_mhz)
    regs = {k: v for k, v in ptxas.items() if k.startswith("segment_") and f"<{lanes}>" in k}
    print(f"  {name}: {seg.shape[0]} rows of {lanes} lanes, {bound['rows']} in {bound['segments']} "
          f"segments, longest {bound['longest']}; tile kernel alone {alone['tile']:.4f} ms "
          f"(without its fill {alone['tile, no fill']:.4f}), with wrapper "
          f"{wrapped['tile']:.4f} ms (without its fill {wrapped['tile, no fill']:.4f}; the path "
          f"calls it with{'' if fill else 'out'}); walk alone {alone['walk']:.4f} ms, with wrapper "
          f"{wrapped['walk']:.4f} ms; twin {twin_ms:.4f} ms; torch.index_add {add_ms:.4f} ms, "
          f"torch.segment_reduce {reduce_ms:.4f} ms; bound {bound['ms']:.6f} ms "
          f"({bound['by']}: {bound['bytes']} B, chain {bound['chain_ms']:.6f} ms at "
          f"{clock_mhz:.0f} MHz), reached {bound['ms'] / alone['tile' if fill else 'tile, no fill']:.4f}; a wrapper call puts "
          f"{prof['tile'][0]} kernels + {prof['tile'][1]} copies/memsets on the card (walk "
          f"{prof['walk'][0]} + {prof['walk'][1]}); device ms by kernel (torch.profiler) "
          f"{ {k: round(v, 6) for k, v in {**prof['walk'][2], **prof['tile'][2]}.items()} }; "
          f"ptxas {regs}; card {smi}")
    if prof["tile"][0] > 2 or prof["tile"][1]:
        raise AssertionError(f"{name}: a wrapper call launches more than fill + sums")
    # the least of two timings each; a quarter over the walk is past their noise
    if alone["tile"] > 1.25 * alone["walk"] or wrapped["tile"] > 1.25 * wrapped["walk"]:
        raise AssertionError(f"{name}: the tile kernel is slower than the walk")
    path = "tile" if fill else "tile, no fill"
    return {"err": err, "ms": alone[path], "wrapper_ms": wrapped[path],
            "walk_ms": alone["walk"], "walk_wrapper_ms": wrapped["walk"], "plain_ms": twin_ms,
            "library_ms": add_ms, "segment_reduce_ms": reduce_ms, "bound": bound}


def sums_entry(name: str, replaces: str, launches: int, case: dict) -> dict:
    """A ``kernels`` entry of the segment sums.  ``bound_by`` keeps to
    "bytes" or "operations" (the chain of dependent adds is the latter);
    ``bound_detail`` says "chain" where it is that."""
    bound = case["bound"]
    return {"name": name, "route": "cuda", "source": "pctpu_torch/csrc/segment_sum.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": case["err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": bound["ms"],
            "bound_by": "bytes" if bound["by"] == "bytes" else "operations",
            "library_ms": case["library_ms"], "bound_detail": bound["by"],
            "wrapper_ms": case["wrapper_ms"], "walk_ms": case["walk_ms"],
            "segment_reduce_ms": case["segment_reduce_ms"]}


def nn_case(name: str, args, md, smi: str) -> dict:
    """One phase-3 case of the bbox-pruned 1-NN: the warp design with and
    without a prepared target, the prep kernel and the earlier block design
    (the <128, 1024, prod> variant), each held bit for bit against its twin;
    then their times, the pairs the warp design visits (its counting
    instance), the per-query 32-group oracle's pairs and the bound."""
    from pctpu_torch.experiments.card import (NN_FLOP_PER_PAIR, bound_ms, cuda_ms, oracle_pairs,
                                              profile_calls)
    from pctpu_torch.ops import cuda_knn

    q, qm, t, tm = args
    thr2 = cuda_knn._thr2(md)
    want = cuda_knn.nn_1_pruned_reference(*args, max_distance=md)
    prep = cuda_knn.prepare_target(t, tm)
    ref = cuda_knn.prepare_target_reference(t, tm)
    prep_err = compare(f"{name}: prep kernel",
                       [prep.packed, prep.group_box, prep.tile_box],
                       [ref.packed, ref.group_box, ref.tile_box])
    err = 0.0
    for label, got in (
            ("warp design", cuda_knn.nn_1_pruned(*args, max_distance=md)),
            ("warp design, prepared", cuda_knn.nn_1_pruned(q, qm, max_distance=md,
                                                           prepared=prep)),
            ("block design", cuda_knn.nn_1_pruned_variant(*args, md, cuda_knn.TQ, cuda_knn.TT,
                                                         "prod"))):
        torch.cuda.synchronize()
        err = max(err, compare(f"{name}: {label}", got, want))
    d2 = want[1]
    launch = cuda_knn._pass_launcher(q, qm, prep, thr2)[0]
    old = cuda_knn._pruned_launcher(q, qm, t, tm, thr2, cuda_knn.TQ, cuda_knn.TT, "prod")[0]
    out = {
        "alone": cuda_ms(launch, reps=50),
        "wrapper": cuda_ms(lambda: cuda_knn.nn_1_pruned(q, qm, max_distance=md,
                                                        prepared=prep), reps=50),
        "unprepared": cuda_ms(lambda: cuda_knn.nn_1_pruned(*args, max_distance=md), reps=50),
        "prep": cuda_ms(lambda: cuda_knn.prepare_target(t, tm), reps=50),
        "prep_twin": cuda_ms(lambda: cuda_knn.prepare_target_reference(t, tm), reps=5),
        "old_alone": cuda_ms(old, reps=20),
        "old_wrapper": cuda_ms(lambda: cuda_knn.nn_1_pruned_variant(
            *args, md, cuda_knn.TQ, cuda_knn.TT, "prod"), reps=20),
        "twin": cuda_ms(lambda: cuda_knn.nn_1_pruned_reference(*args, max_distance=md),
                        reps=3, warmup=1),
        "err": err, "prep_err": prep_err, "library": None,
    }
    by_kernel = profile_calls(launch, reps=20)[2]
    visited = cuda_knn.pairs_visited(q, qm, prep, md)
    oracle = oracle_pairs(q, qm, d2, prep.group_box, thr2)
    nq, nt = q.shape[0], t.shape[0]
    # the bytes the work needs, no padding: the packed target's 12 B a point
    # (a masked point is +inf, so no mask) and six box rows of 4 B for each
    # 32-point group and 1,024-point tile; each query's 13 B, 8 B out
    target_bytes = nt * 12 + 6 * 4 * (-(-nt // cuda_knn.GROUP) + -(-nt // cuda_knn.TT))
    n_bytes = nq * 13 + target_bytes + nq * 8
    out["bound"], out["bound_by"] = bound_ms(n_bytes, NN_FLOP_PER_PAIR * oracle)
    out["prep_bound"], out["prep_bound_by"] = bound_ms(nt * 13 + target_bytes, 0)
    print(f"  {name}: Q={nq} T={nt} found={int(torch.isfinite(d2).sum())}; warp design "
          f"alone {out['alone']:.4f} ms, with wrapper {out['wrapper']:.4f} ms, unprepared "
          f"{out['unprepared']:.4f} ms (prep {out['prep']:.4f} ms, its twin "
          f"{out['prep_twin']:.4f} ms); block design alone {out['old_alone']:.4f} ms, with "
          f"wrapper {out['old_wrapper']:.4f} ms; twin {out['twin']:.4f} ms; pairs visited "
          f"{visited} ({visited / (nq * nt):.6f} of Q·T), oracle {oracle}; bound "
          f"{out['bound']:.6f} ms ({out['bound_by']}: {n_bytes} B, "
          f"{NN_FLOP_PER_PAIR * oracle} flop), reached {out['bound'] / out['alone']:.4f}; prep bound "
          f"{out['prep_bound']:.6f} ms ({out['prep_bound_by']}: {nt * 13 + target_bytes} B); "
          f"device ms by kernel (torch.profiler) "
          f"{ {k: round(v, 6) for k, v in by_kernel.items()} }; card {smi}")
    return out


def multi_bev_phase(dev: torch.device, smi: str, n_ordered: int = 64, ptxas: dict | None = None,
                    clock_mhz: float = 1980.0) -> list[dict]:
    """Phase 9 (module docstring).  Returns the ``kernels`` entries of the
    BEV raster and the ground sums."""
    from pctpu_torch.cli import batch_multi_bev_gen as bev_cli
    from pctpu_torch.config import GroundConfig, get_sensor_params
    from pctpu_torch.experiments import oracle
    from pctpu_torch.experiments.card import bound_ms, cuda_ms, profile_calls
    from pctpu_torch.experiments.scene import multi_bev_tree
    from pctpu_torch.io.pcd import read_pcd
    from pctpu_torch.io.png import read_gray_png
    from pctpu_torch.ops import _cuda, bev, ground, voxel
    from pctpu_torch.ops.preprocess import _reorder_preordered, preprocess_batch
    from pctpu_torch.pipelines import multi_bev
    from pctpu_torch.runtime import native_io
    from pctpu_torch.runtime.loader import load_xyzirct_arrays, stack_batch

    params = get_sensor_params("HDL_64E")
    base = os.path.join(ROOT, "build", "chip_smoke_bev")
    shutil.rmtree(base, ignore_errors=True)
    src = os.path.join(base, "tree")
    t0 = time.perf_counter()
    paths = multi_bev_tree(src, params, n_ordered=n_ordered, n_raw=2, n_over=1)
    print(f"multi-BEV tree: {len(paths)} HDL-64E clouds ({n_ordered} grid-ordered, 2 raw, "
          f"1 over capacity) generated in {time.perf_counter() - t0:.1f} s")

    # --- 9a. the kernels against their twins, B = 8 real clouds -----------
    arrays = stack_batch([load_xyzirct_arrays(p, params)
                          for p in paths[:8]])
    clouds = multi_bev._to_device(arrays, dev)
    ordered = _reorder_preordered(clouds, params)
    cfg = GroundConfig()
    labeled, gm = ground.mark_ground(ordered, params)
    lo0 = (params.n_scan - params.ground_upper_scan - 1) * params.horizon_scan
    band = ordered.xyz[:, lo0:]
    srow, scol = ground._belonging_grid(band[..., 0], band[..., 1], cfg)
    values, seg, order = ground.sector_sums_rows(srow * cfg.grid_cols + scol, band[..., 2],
                                                 gm.reshape(8, -1)[:, lo0:] == 1, cfg)
    sums = sums_case("ground sums (B = 8)",
                     (values, seg, (0.0, cfg.count_epsilon), 8 * cfg.grid_rows * cfg.grid_cols,
                      order), "ground_sums", ptxas or {}, smi, clock_mhz)
    largest = sums["bound"]["longest"]
    rasters = bev.fused_multi_single_bev(labeled, params.height_res)
    bev_err = compare("bev_raster (B = 8)", rasters,
                      bev.fused_multi_single_bev_reference(labeled, params.height_res))
    bev_ms = cuda_ms(lambda: bev.fused_multi_single_bev(labeled, params.height_res), reps=20)
    bev_ref_ms = cuda_ms(lambda: bev.fused_multi_single_bev_reference(labeled, params.height_res),
                         reps=5)
    # xyz and label (16 B a point) read once, both rasters (1 B a cell) written
    bev_bound = bound_ms(labeled.label.numel() * 16 + sum(r.numel() for r in rasters), 0)
    print(f"  bev_raster: kernel {bev_ms:.4f} ms, twin {bev_ref_ms:.4f} ms, bound "
          f"{bev_bound[0]:.6f} ms ({bev_bound[1]}); card {smi}")
    def with_walk(fn):
        """``fn()`` with the sector sums taken by the first design's walk."""
        real = ground.segment_sum_sorted
        ground.segment_sum_sorted = lambda *a, count_as=None, **k: voxel.segment_sum_walk(*a, **k)
        try:
            return fn()
        finally:
            ground.segment_sum_sorted = real

    for compat in ("bitexact", "tolerance"):
        def step(compat=compat):
            return preprocess_batch(clouds, params, assume_ordered=True, compat=compat)
        dev_ms = cuda_ms(step, reps=10)
        if compat == "bitexact":
            # the same batch with the walk in the sums' place, in turns
            walk_ms = [with_walk(lambda: cuda_ms(step, reps=10)) for _ in range(2)]
            dev_ms = min(dev_ms, cuda_ms(step, reps=10))
            by_walk, by_tile = with_walk(step), step()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(by_walk[1:], by_tile[1:])):
                raise AssertionError("preprocess_batch: the walk and the tile kernel disagree")
            print(f"  preprocess_batch B = 8 (bitexact) with the walk kernel for the sector sums: "
                  f"{min(walk_ms):.4f} ms; with the tile kernel {dev_ms:.4f} ms (CUDA events, the "
                  f"least of two each, in turns); card {smi}")
        _, multi, single = step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            multi.cpu()
        d2h_ms = (time.perf_counter() - t1) * 1e3 / 5
        kernels, copies, _ = profile_calls(step, reps=3)
        print(f"  preprocess_batch B = 8 ({compat}): {dev_ms:.4f} ms (CUDA events), "
              f"{kernels} kernels + {copies} copies/memsets per batch; multi BEV to the host "
              f"({multi.numel() / 1e6:.2f} MB) {d2h_ms:.4f} ms; card {smi}")

    # --- 9b. the CLI in both modes, after a warm-up -----------------------
    warm = os.path.join(base, "warm")
    os.makedirs(os.path.join(warm, "keyframe_point_cloud"))
    for p in paths[:8] + [paths[n_ordered]]:
        shutil.copy(p, os.path.join(warm, "keyframe_point_cloud"))
    shutil.copy(os.path.join(src, "keyframe_pose.csv"), warm)
    for compat in ("bitexact", "tolerance"):
        with contextlib.redirect_stdout(io.StringIO()):
            bev_cli.main([warm, "HDL_64E", f"--compat={compat}", f"--device={dev.type}"])
    trees = {}
    for compat in ("bitexact", "tolerance"):
        captured = io.StringIO()
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = bev_cli.main([src, "HDL_64E", f"--compat={compat}", f"--device={dev.type}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.launch_counts)
        log = captured.getvalue()
        if rc != 0:
            raise AssertionError(f"batch_multi_bev_gen --compat={compat} exited {rc}")
        require_launched(launches, ("bev_raster", "ground_sums") if compat == "bitexact"
                         else ("bev_raster",), f"batch_multi_bev_gen --compat={compat}")
        if compat == "bitexact":
            bev_launches, sums_launches = launches["bev_raster"], launches["ground_sums"]
        for line in log.splitlines():
            if line.startswith("[TIME]"):
                print(f"  {line}; card {smi}")
            elif line.startswith(("device:", "BEV writer:", "One-hot")):
                print(f"  {line}")
        n_batches = -(-len(paths) // 8)
        print(f"batch_multi_bev_gen --compat={compat}: {len(paths)} clouds in {wall:.3f} s = "
              f"{len(paths) / wall:.4f} clouds/s; hand-kernel launches {launches} "
              f"({n_batches} batches); card {smi}")
        trees[compat] = os.path.join(base, compat)
        os.makedirs(trees[compat])
        for sub in BEV_OUTPUTS:
            os.rename(os.path.join(src, sub), os.path.join(trees[compat], sub))

    exact = tree_files(trees["bitexact"])
    tol = tree_files(trees["tolerance"])
    if len(exact) != len(paths) * 28 + 1:
        raise AssertionError(f"bit-exact tree holds {len(exact)} files")
    differ = sorted(k for k in exact if exact[k] != tol.get(k)) + sorted(set(tol) - set(exact))
    if differ:
        raise AssertionError(f"tolerance tree differs from the bit-exact tree in {differ[:5]}")
    print(f"tolerance tree byte-identical to the bit-exact tree ({len(exact)} files)")

    # --- 9c. the card's tree against the port's CPU run on 4 clouds -------
    sub = os.path.join(base, "cpu")
    os.makedirs(os.path.join(sub, "keyframe_point_cloud"))
    picked = [paths[0], paths[1], paths[n_ordered], paths[-1]]
    for p in picked:
        shutil.copy(p, os.path.join(sub, "keyframe_point_cloud"))
    shutil.copy(os.path.join(src, "keyframe_pose.csv"), sub)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        multi_bev.run_multi_bev(sub, "HDL_64E", batch_size=4, device="cpu")
    cpu = tree_files(sub)
    differ = sorted(k for k in cpu if cpu[k] != exact.get(k))
    if differ or len(cpu) != len(picked) * 28 + 1:
        raise AssertionError(f"CPU run differs from the card's tree in {differ[:5]}")
    print(f"card tree byte-identical to the CPU run on {len(picked)} clouds ({len(cpu)} files, "
          f"CPU {time.perf_counter() - t0:.1f} s)")

    # --- 9d. against the native oracle (the C++'s f64 slope) ---------------
    lib = oracle.load()
    totals = {"labels": 0, "bin": 0, "single": 0, "csv": 0, "d2_cells": 0}
    from pctpu_torch.io.csvfmt import format_csv_bytes

    for p in paths:
        short = os.path.basename(p)[:-4]
        data, _ = read_pcd(p)
        labels, multi, single = oracle.preprocess(lib, data, params)
        out, _ = read_pcd(os.path.join(trees["bitexact"], "non_ground_point_cloud", short + ".pcd"))
        with open(os.path.join(trees["bitexact"], "output_multi_bev", "binary", short + ".bin"),
                  "rb") as f:
            bin_bytes = np.frombuffer(f.read(), np.uint8)
        card_single = read_gray_png(os.path.join(trees["bitexact"], "output_single_bev", "image",
                                                 short + ".png"))
        with open(os.path.join(trees["bitexact"], "output_single_bev", "csv", short + ".csv"),
                  "rb") as f:
            csv_same = f.read() == format_csv_bytes(single)
        diffs = {"labels": int((out["label"].astype(np.int32) != labels).sum()),
                 "bin": int((bin_bytes != multi.ravel()).sum()),
                 "single": int((card_single != single).sum()), "csv": int(not csv_same)}
        if any(diffs.values()):
            xyz = torch.from_numpy(np.stack([out["x"], out["y"], out["z"]], 1)).to(dev)
            n_d2, n_far = oracle.slope_disagreements(
                xyz, torch.from_numpy(out["intensity"]).to(dev), params)
            print(f"  {short}: differs from the oracle {diffs}; slope decisions differing "
                  f"{n_d2}, outside D2's 1e-5° window {n_far}")
            if n_d2 == 0 or n_far:
                raise AssertionError(f"{short}: difference from the oracle not explained by D2")
            totals["d2_cells"] += n_d2
        for k, v in diffs.items():
            totals[k] += v
    print(f"native oracle, {len(paths)} clouds: differing labels {totals['labels']}, .bin bytes "
          f"{totals['bin']}, single-BEV pixels {totals['single']}, CSV files {totals['csv']} "
          f"(D2 slope knife-edge cells {totals['d2_cells']})")
    print(f"BEV writer: {native_io.writer_name()}; largest ground sector {largest} points; "
          f"card {smi}")
    shutil.rmtree(base)
    return [
        {"name": "bev_raster", "route": "cuda", "source": "pctpu_torch/csrc/bev_raster.cu",
         "replaces": "pctpu/ops/bev.py:95", "launches": bev_launches,
         "max_abs_err": bev_err, "ms": bev_ms, "plain_ms": bev_ref_ms,
         "bound_ms": bev_bound[0], "bound_by": bev_bound[1], "library_ms": None},
        sums_entry("ground_sums", "pctpu/ops/ground.py:113", sums_launches, sums),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pctpu_torch  # noqa: F401  (the package import pins full-f32 matmuls)
    from pctpu_torch.cli import batch_top_part_registration as cli
    from pctpu_torch.cli import batch_whole_registration as whole_cli
    from pctpu_torch.experiments import nn_argmin
    from pctpu_torch.experiments.card import (bound_ms, cuda_ms, nvidia_smi_line, profile_calls,
                                              sm_clock_mhz)
    from pctpu_torch.experiments.scene import (TREE_PAIRS, TREE_POSES, pose, registration_scene,
                                               registration_tree)
    from pctpu_torch.ops import _cuda, cuda_knn, knn, voxel
    from pctpu_torch.ops.transform import transform_xyz
    from pctpu_torch.pipelines import registration

    dev = torch.device("cuda", 0)

    # --- 1. environment ----------------------------------------------------
    try:
        triton_version = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_version = "not installed"
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, triton {triton_version}")
    print(f"nvcc: {nvcc[-1]}")
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    print(smi)
    clock_mhz = sm_clock_mhz()
    print(f"highest SM clock {clock_mhz:.0f} MHz")

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    fresh = not _cuda.library_path().exists()
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({'compiled' if fresh else 'cached'} "
          f"{os.path.relpath(_cuda.library_path(), ROOT)})")
    ptxas = print_ptxas(_cuda.library_path().with_suffix(".ptxas.txt"))

    # --- 3. kernels against their twins, on the card -------------------------
    rng = np.random.default_rng(1)
    xyz, lab = registration_scene()
    truth = pose(17.0, 1.5, -2.0)
    xyz2 = (xyz @ truth[:3, :3].T.astype(np.float32) + truth[:3, 3].astype(np.float32))
    cap = 65536

    def padded(a: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
        x[: len(a)] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x, torch.arange(cap, device=dev) < len(a)

    src, src_m = padded(xyz)
    tgt, tgt_m = padded(xyz2.astype(np.float32))
    src_v, src_vm, n_src = voxel.voxel_downsample(src, src_m, 0.2)
    tgt_v, tgt_vm, n_tgt = voxel.voxel_downsample(tgt, tgt_m, 0.2)
    fbucket = registration._fine_bucket(int(max(n_src, n_tgt)), cap)
    # the fine ICP's state a few iterations in: source moved near the truth
    near = torch.from_numpy(pose(17.2, 1.53, -2.04)).float().to(dev)
    q = src_v[:fbucket] @ near[:3, :3].T + near[:3, 3]
    fine_q, fine_qm = cuda_knn.spatial_sort_payload(q, src_vm[:fbucket])
    fine_t, fine_tm = cuda_knn.spatial_sort_payload(tgt_v[:fbucket], tgt_vm[:fbucket])
    drop_q = torch.from_numpy(rng.random(fbucket) < 0.1).to(dev)
    drop_t = torch.from_numpy(rng.random(fbucket) < 0.1).to(dev)
    # the coarse pass: 8,192 flattened points of each cloud
    pick = torch.from_numpy(rng.permutation(int(min(n_src, n_tgt)))[:8192]).to(dev)
    flat_q = fine_q[pick] * torch.tensor([1.0, 1.0, 0.0], device=dev)
    flat_t = fine_t[pick] * torch.tensor([1.0, 1.0, 0.0], device=dev)
    ones = torch.ones(8192, dtype=torch.bool, device=dev)
    flat_q, _ = cuda_knn.spatial_sort_payload(flat_q, ones)
    flat_t, _ = cuda_knn.spatial_sort_payload(flat_t, ones)
    # past 262,144 targets (the TPU's 2-D-grid regime)
    big_q, big_qm = cuda_knn.spatial_sort_payload(
        torch.from_numpy(rng.uniform(-100, 100, (20000, 3)).astype(np.float32)).to(dev),
        torch.ones(20000, dtype=torch.bool, device=dev))
    big_t, big_tm = cuda_knn.spatial_sort_payload(
        torch.from_numpy(rng.uniform(-100, 100, (300000, 3)).astype(np.float32)).to(dev),
        torch.from_numpy(rng.random(300000) > 0.05).to(dev))
    # the batch_whole_registration pass (phase 6, pair 0->1): both voxel
    # clouds uncut at 65,536, each sorted in its own frame, the source moved
    # by the yaw-only guess (truth 17° plus the 3° offset, no translation)
    # and, for the late iterations, near the truth
    whole_s, whole_sm = cuda_knn.spatial_sort_payload(src_v, src_vm)
    whole_t, whole_tm = cuda_knn.spatial_sort_payload(tgt_v, tgt_vm)
    yaw_guess = torch.from_numpy(registration.yaw_rotation_4x4(
        registration._guess_angle_rad(20.0)).astype(np.float32)).to(dev)
    whole_guess = (transform_xyz(whole_s, yaw_guess), whole_sm, whole_t, whole_tm)
    whole_near = (transform_xyz(whole_s, near), whole_sm, whole_t, whole_tm)

    nn_cases = [
        ("fine thr 1 m", (fine_q, fine_qm, fine_t, fine_tm), 1.0),
        ("fine fitness (no thr)", (fine_q, fine_qm, fine_t, fine_tm), None),
        ("fine thr 1 m, 10% masked", (fine_q, fine_qm & ~drop_q, fine_t, fine_tm & ~drop_t), 1.0),
        ("coarse 8192 thr 10 m", (flat_q, ones, flat_t, ones), 10.0),
        ("whole thr 4 m, yaw guess", whole_guess, 4.0),
        ("whole fitness (no thr), yaw guess", whole_guess, None),
        ("whole thr 4 m, near the truth", whole_near, 4.0),
        (f"{big_t.shape[0]} targets, no thr", (big_q, big_qm, big_t, big_tm), None),
        (f"{big_t.shape[0]} targets, thr 2 m", (big_q, big_qm, big_t, big_tm), 2.0),
    ]
    print("bbox-pruned 1-NN (K1/K2): the warp design (csrc/nn_pruned_warp.cu) and the "
          "earlier block design (<128, 1024, prod>) against the twin, bit for bit; ms per pass "
          f"(CUDA events); card {smi}")
    nn_err = prep_err = 0.0
    nn_ms = {}
    for name, args, md in nn_cases:
        nn_ms[name] = nn_case(name, args, md, smi)
        nn_err = max(nn_err, nn_ms[name]["err"])
        prep_err = max(prep_err, nn_ms[name]["prep_err"])
    fine_args = nn_cases[0][1]
    fine_prep = cuda_knn.prepare_target(fine_args[2], fine_args[3])
    kernels, copies, by_kernel = profile_calls(
        lambda: cuda_knn.nn_1_pruned(*fine_args[:2], max_distance=1.0, prepared=fine_prep))
    bare = profile_calls(lambda: cuda_knn.nn_1_pruned(*fine_args, max_distance=1.0))
    print(f"  one pass on a prepared target (torch.profiler over 50): {kernels} kernels + "
          f"{copies} copies/memsets, kernels {sorted(by_kernel)}; unprepared: {bare[0]} kernels + "
          f"{bare[1]} copies/memsets")
    if kernels > 3 or copies:
        raise AssertionError("a pass on a prepared target launches more than 3 kernels")
    # the library yardstick: torch.cdist(q, t).min(1) at the fine and whole shapes
    for name in ("fine thr 1 m", "whole thr 4 m, yaw guess"):
        q, _, t, _ = next(a for n, a, _ in nn_cases if n == name)
        nn_ms[name]["library"] = cuda_ms(lambda: torch.cdist(q, t).min(1), reps=3, warmup=1)
        torch.cuda.empty_cache()
        print(f"  {name}: torch.cdist(q, t).min(1) {nn_ms[name]['library']:.4f} ms "
              f"(Q={q.shape[0]}, T={t.shape[0]}); card {smi}")

    # past 262,144 targets: the same call in one piece (24 GB of distances),
    # or in query chunks if the card cannot hold them
    big_name = nn_cases[-2][0]
    try:
        nn_ms[big_name]["library"] = cuda_ms(lambda: torch.cdist(big_q, big_t).min(1), reps=2,
                                             warmup=1)
        how = "one call"
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        nn_ms[big_name]["library"] = cuda_ms(
            lambda: [torch.cdist(c, big_t).min(1) for c in big_q.split(5000)], reps=2, warmup=1)
        how = "query chunks of 5,000"
    torch.cuda.empty_cache()
    print(f"  {big_name}: torch.cdist(q, t).min(1) {nn_ms[big_name]['library']:.4f} ms "
          f"(Q={big_q.shape[0]}, T={big_t.shape[0]}, {how}); card {smi}")

    values, seg, _ = voxel.voxel_segments(src, src_m, 0.2)
    seg_sums = sums_case("segment sums (65,536 voxel rows)", (values, seg, None, None, None),
                         "segment_sum4", ptxas, smi, clock_mhz, fill=False)

    # --- 4. the voxel grid: deterministic on the card, equal to the CPU ------
    runs = [voxel.voxel_downsample(src, src_m, 0.2) for _ in range(2)]
    cpu = voxel.voxel_downsample(src.cpu(), src_m.cpu(), 0.2)
    for k, out in enumerate((runs[1], tuple(t.to(dev) for t in cpu))):
        if not all(torch.equal(a, b) for a, b in zip(runs[0], out)):
            raise AssertionError(f"voxel grid: run {k + 1} differs from the first")
    print(f"voxel grid: two card runs and the CPU run bit-identical "
          f"({int(runs[0][2])} voxels)")

    # --- 5. the slice through the CLI ----------------------------------------
    tree = os.path.join(ROOT, "build", "chip_smoke_tree")
    shutil.rmtree(tree, ignore_errors=True)
    registration_tree(tree)
    pairs = TREE_PAIRS

    def relative(q_i: int, m_i: int) -> np.ndarray:
        return TREE_POSES[m_i] @ np.linalg.inv(TREE_POSES[q_i])

    match = os.path.join(tree, "match_result.txt")
    warm = os.path.join(tree, "warmup.txt")

    fine_transforms = []
    real_register_pair = registration.register_pair

    def recording_register_pair(*args, **kwargs):
        best, fine = real_register_pair(*args, **kwargs)
        fine_transforms.append(fine.transform)
        return best, fine

    registration.register_pair = recording_register_pair
    argv = ["--capacity=65536", "--flat-cap=32768"]
    try:
        # warm-up pair: CUDA context, cuBLAS and cuSOLVER handles
        cli.main([warm, os.path.join(tree, "clouds"),
                  f"--report={os.path.join(tree, 'warmup_report.txt')}", *argv])
        fine_transforms.clear()
        report = os.path.join(tree, "icp_precision_report.txt")
        captured = io.StringIO()
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = cli.main([match, os.path.join(tree, "clouds"), f"--report={report}", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.launch_counts)
    finally:
        registration.register_pair = real_register_pair
    log = captured.getvalue()
    print(log, end="")
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}")
    stage_ms = {k: float(v) for k, v in re.findall(
        r"\[TIME\] Avg Tiempo for \S+ Stage \((\w+)\): ([0-9.eE+-]+)", log)}
    lines = open(report).read().splitlines()
    if len(lines) != len(pairs) or "count_failure: 0," not in log:
        raise AssertionError(f"not every pair succeeded: {len(lines)} report lines")
    for (q_i, m_i, _), tf in zip(pairs, fine_transforms):
        yaw_err, t_err = pose_error(tf, relative(q_i, m_i))
        print(f"  pair {q_i}->{m_i}: yaw error {yaw_err:.6f} deg, translation error {t_err:.6f} m")
        if not (np.all(np.isfinite(tf)) and yaw_err < 0.5 and t_err < 0.10):
            raise AssertionError(f"pair {q_i}->{m_i} off the truth")
    require_launched(launches, ("nn_prep", "nn_pruned", "segment_sum4"), "the top-part CLI run")
    print(f"slice: {len(pairs)} pairs in {wall:.3f} s = {len(pairs) / wall:.4f} pairs/s; "
          f"[TIME] per pair coarse {stage_ms['coarse']:.3f} ms, fine {stage_ms['fine']:.3f} ms; "
          f"NN passes per pair {launches['nn_pruned'] / len(pairs):.1f}, target preps per pair "
          f"{launches['nn_prep'] / len(pairs):.1f}; launches {launches}; card {smi}")

    # --- 6. batch_whole_registration through its CLI, on the same tree -------
    whole_transforms = []
    real_icp = registration.icp_point_to_point

    def recording_icp(*args, **kwargs):
        res = real_icp(*args, **kwargs)
        whole_transforms.append(res.transform.cpu().numpy())
        return res

    registration.icp_point_to_point = recording_icp
    clouds = os.path.join(tree, "clouds")
    try:
        whole_cli.main([warm, clouds, "--capacity=65536",
                        f"--report={os.path.join(tree, 'warmup_whole.txt')}"])
        whole_transforms.clear()
        whole_report = os.path.join(tree, "whole_report.txt")
        captured = io.StringIO()
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = whole_cli.main([match, clouds, "--capacity=65536",
                                 f"--report={whole_report}"])
        torch.cuda.synchronize()
        whole_wall = time.perf_counter() - t0
        whole_launches = dict(_cuda.launch_counts)
    finally:
        registration.icp_point_to_point = real_icp
    log = captured.getvalue()
    print(log, end="")
    if rc != 0:
        raise AssertionError(f"batch_whole_registration CLI exited {rc}")
    if f"count_success: {len(pairs)}, count_failure: 0," not in log:
        raise AssertionError("batch_whole_registration: not every pair succeeded")
    if open(whole_report).read() != "" or len(open(whole_report + ".progress").readlines()) != len(pairs):
        raise AssertionError("batch_whole_registration: report or progress file wrong")
    for (q_i, m_i, _), tf in zip(pairs, whole_transforms):
        yaw_err, t_err = pose_error(tf, relative(q_i, m_i))
        print(f"  whole pair {q_i}->{m_i}: yaw error {yaw_err:.6f} deg, "
              f"translation error {t_err:.6f} m")
        if not (np.all(np.isfinite(tf)) and yaw_err < 0.5 and t_err < 0.10):
            raise AssertionError(f"whole pair {q_i}->{m_i} off the truth")
    require_launched(whole_launches, ("nn_prep", "nn_pruned", "segment_sum4"),
                     "the batch_whole_registration CLI run")
    whole_fine = float(re.search(r"\[TIME\] Avg Tiempo for 2nd Stage \(fine\): ([0-9.eE+-]+)",
                                 log).group(1))
    print(f"batch_whole_registration: {len(pairs)} pairs in {whole_wall:.3f} s = "
          f"{len(pairs) / whole_wall:.4f} pairs/s; [TIME] fine {whole_fine:.3f} ms per pair; "
          f"NN passes per pair {whole_launches['nn_pruned'] / len(pairs):.1f}, target preps "
          f"per pair {whole_launches['nn_prep'] / len(pairs):.1f}; launches {whole_launches}; "
          f"card {smi}")
    shutil.rmtree(tree)

    # --- 7. the fused unpruned 1-NN (K3) -------------------------------------
    def masked_pair(q, t):
        qm = torch.from_numpy(rng.random(q.shape[0]) >= 0.05).to(dev)
        tm = torch.from_numpy(rng.random(t.shape[0]) >= 0.05).to(dev)
        return q.contiguous(), qm, t.contiguous(), tm

    def uniform(n):
        return torch.from_numpy(rng.uniform(-70, 70, (n, 3)).astype(np.float32)).to(dev)

    fused_cases = [
        ("65,536 x 65,536 uniform", masked_pair(uniform(65536), uniform(65536))),
        ("16,384 x 16,384 uniform", masked_pair(uniform(16384), uniform(16384))),
        (f"fine bucket {fbucket} unsorted",
         masked_pair(src_v[:fbucket] @ near[:3, :3].T + near[:3, 3], tgt_v[:fbucket])),
    ]
    _cuda.reset_launch_counts()
    fused_out = cuda_knn.nn_1_fused(*fused_cases[0][1])  # the path: one call, full width
    torch.cuda.synchronize()
    fused_launches = _cuda.launch_counts["nn_fused"]
    require_launched({"nn_fused": fused_launches}, ("nn_fused",), "the nn_1_fused call")
    print("fused 1-NN (K3) vs twin vs knn.nn_1 (ms per pass, CUDA events):")
    fused_err = 0.0
    fused_ms = {}
    for k, (name, args) in enumerate(fused_cases):
        got = fused_out if k == 0 else cuda_knn.nn_1_fused(*args)
        fused_err = max(fused_err, compare(name, got, cuda_knn.nn_1_fused_reference(*args)))
        xla = knn.nn_1(*args)
        agree = float((xla[0] == got[0]).float().mean())
        k_ms = cuda_ms(lambda: cuda_knn.nn_1_fused(*args), reps=10)
        r_ms = cuda_ms(lambda: cuda_knn.nn_1_fused_reference(*args), reps=2, warmup=1)
        x_ms = cuda_ms(lambda: knn.nn_1(*args), reps=5)
        fused_ms[name] = (k_ms, r_ms, x_ms)
        print(f"  {name}: kernel {k_ms:.4f} ms, twin {r_ms:.4f} ms, knn.nn_1 {x_ms:.4f} ms "
              f"(knn.nn_1 picks the same index for {agree:.6f} of queries); card {smi}")
    # the path's case: its bound (8 flops a pair on every pair) and torch.cdist(q, t).min(1)
    fq, _, ft, _ = fused_cases[0][1]
    fused_bound = bound_ms(fq.shape[0] * (13 + 8) + ft.shape[0] * 13,
                           8 * fq.shape[0] * ft.shape[0])
    fused_lib_ms = cuda_ms(lambda: torch.cdist(fq, ft).min(1), reps=3, warmup=1)
    torch.cuda.empty_cache()
    print(f"  {fused_cases[0][0]}: bound {fused_bound[0]:.6f} ms ({fused_bound[1]}), "
          f"torch.cdist(q, t).min(1) {fused_lib_ms:.4f} ms; card {smi}")

    # --- 8. the argmin and tile-shape experiment (K4) ------------------------
    _cuda.reset_launch_counts()
    exp = nn_argmin.run(["--quick"])
    torch.cuda.synchronize()
    variant_launches = _cuda.launch_counts["nn_variant"]
    require_launched({"nn_variant": variant_launches}, ("nn_variant",), "nn_argmin --quick")
    shapes = {(v["mode"], v["tq"], v["tt"]) for v in exp["variants"]}
    missing = {(m, 256, 1024) for m in nn_argmin.ALL_MODES} | {
        ("prod", tq, tt) for tq, tt in cuda_knn.VARIANT_TILES}
    if missing - shapes:
        raise AssertionError(f"nn_argmin skipped {sorted(missing - shapes)}")
    anchor = next(v for v in exp["variants"] if v["key"] == "prod_thr")
    print(f"nn_argmin: {len(exp['variants'])} variants, each bit-equal to its twin; "
          f"prod thr=1m (256,1024) {anchor['ms_per_pass']:.4f} ms per pass "
          f"(kernel {anchor['kernel_ms']:.4f} ms), twin {exp['twin_ms']:.4f} ms")

    # --- 9. batch_multi_bev_gen ----------------------------------------------
    bev_kernels = multi_bev_phase(dev, smi, ptxas=ptxas, clock_mhz=clock_mhz)

    # K1, the prep and K4's <128, 1024, prod> on the fine pass at thr 1 m
    fine = nn_ms["fine thr 1 m"]
    big_fused = fused_ms[fused_cases[0][0]]
    print(json.dumps({"kernels": [
        {"name": "nn_pruned", "route": "cuda", "source": "pctpu_torch/csrc/nn_pruned_warp.cu",
         "replaces": "pctpu/ops/pallas_knn.py:275", "launches": launches["nn_pruned"],
         "max_abs_err": nn_err, "ms": fine["alone"], "plain_ms": fine["twin"],
         "bound_ms": fine["bound"], "bound_by": fine["bound_by"],
         "library_ms": fine["library"]},
        {"name": "nn_prep", "route": "cuda", "source": "pctpu_torch/csrc/nn_pruned_warp.cu",
         "replaces": "pctpu/ops/pallas_knn.py:275", "launches": launches["nn_prep"],
         "max_abs_err": prep_err, "ms": fine["prep"], "plain_ms": fine["prep_twin"],
         "bound_ms": fine["prep_bound"], "bound_by": fine["prep_bound_by"],
         "library_ms": None},
        sums_entry("segment_sum4", "pctpu/ops/voxel.py:80", launches["segment_sum4"], seg_sums),
        {"name": "nn_fused", "route": "cuda", "source": "pctpu_torch/csrc/nn_fused.cu",
         "replaces": "pctpu/ops/pallas_knn.py:38", "launches": fused_launches,
         "max_abs_err": fused_err, "ms": big_fused[0], "plain_ms": big_fused[1],
         "bound_ms": fused_bound[0], "bound_by": fused_bound[1], "library_ms": fused_lib_ms},
        {"name": "nn_variant", "route": "cuda", "source": "pctpu_torch/csrc/nn_pruned.cu",
         "replaces": "scripts/exp_nn_argmin.py:118", "launches": variant_launches,
         "max_abs_err": max(exp["max_abs_err"], nn_err), "ms": fine["old_alone"],
         "plain_ms": fine["twin"], "bound_ms": fine["bound"], "bound_by": fine["bound_by"],
         "library_ms": fine["library"]},
        *bev_kernels,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
