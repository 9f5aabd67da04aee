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
   thr 4 m near the truth), the fine pass with NaN coordinates in valid
   targets, a masked one and a query (a NaN target is never found: ROADMAP
   F13, README D23) and past 262,144 targets; the in-order
   segment sums at 65,536 voxel rows (and, in phase 9, at the sector sums
   of 8 HDL-64E clouds): the tile kernel and the first design's walk
   (``csrc/segment_sum.cu``) bit-equal to the twin and a second run, then,
   in turns in the one call, each alone and with its wrapper, the tile
   kernel without its fill, the twin, ``torch.index_add`` and
   ``torch.segment_reduce``, the bound reckoned from the work (bytes, or
   the longest segment's chain of dependent adds), per-kernel profiler
   times, the launches a call makes and ptxas's registers.  Zero index
   mismatches and bit-equal results are required.  For each 1-NN case: the warp design
   (``csrc/nn_pruned_warp.cu``: seed writing a work list, persistent main
   grid over it) with and without a prepared target, the first warp design
   (its dense main grid, ``nn_1_pruned_batched_v1``), its prep
   kernel, K4's <128, 1024, prod> instance (``csrc/nn_variant.cu``, K1's
   shape on the variants' template) and the earlier block design (that
   instance of K4's first design, ``csrc/nn_pruned.cu``), each against the
   twin, then CUDA-event times of each (the launches alone and with the
   wrapper; the two warp designs in turns), the pairs the warp design visits
   and its work items against the dense grid's blocks (its counting
   instance), the per-query 32-group oracle's pairs and the bound; one pass
   on a prepared target must put at most 3 kernels and the list's memset on
   the card;
   ``torch.cdist(q, t).min(1)`` at the fine shape (both passes), the whole shape and at
   20,000 × 300,000; then K1 over a problem axis — 16 fine problems at the
   49,152 bucket, each on a target of its own (thr 1 m), and 32 coarse
   problems of 8,192 flat points, two yaw guesses on each of 16 targets
   (thr 10 m): the batched prep (one launch) and pass (at most 3 kernels
   and a memset) bit-equal to the twin, to the first warp design's pass and
   to the 16 / 32 unbatched kernel calls, the batched pass, the first
   design's and the unbatched passes timed in turns (alone and with the
   wrappers), per-kernel profiler times of both designs, the work items
   against the dense grid's blocks and the bound (the sum of the single
   bounds);
4. the voxel grid on the card twice and on the CPU: bit-identical;
5. the slice: a keyframe tree of the 65,536-capacity registration scene and
   moved copies with known yaw and translation
   (``experiments.scene.registration_tree``, the tree that
   ``experiments.registration_ab`` times) goes through the
   ``batch_top_part_registration`` CLI at ``--pair-batch=1``; every pair
   must succeed within 0.5° and 0.10 m of the truth, and each kernel must
   have been launched;
6. the same tree and pairs through the ``batch_whole_registration`` CLI
   at ``--pair-batch=1`` (direct WHOLE_ICP from the yaw guess, the pruned
   1-NN at thr 4 m): every
   pair must succeed within 0.5° and 0.10 m; pairs/s, the ``[TIME]``
   fine ms and the NN passes per pair are printed;
7. the fused unpruned 1-NN (``cuda_knn.nn_1_fused``) at 65,536 × 65,536
   (uniform ±70 m), 16,384² and on the unsorted fine-stage bucket, 5% of
   queries and targets masked: the new kernels (``csrc/nn_fused.cu``), the
   first design's kernel (``nn_1_fused_v1``) and the twin bit for bit, and
   a second run; then, in turns, each alone and with its wrapper (CUDA
   events), per-kernel profiler times, the main kernel's grid, the twin,
   ``knn.nn_1``, the bound and, at the two uniform sizes,
   ``torch.cdist(q, t).min(1)``; exact ties (duplicate and mirrored
   targets) and NaN and infinite coordinates at 1, 3 and one-a-tile target
   splits;
8. the argmin and tile-shape experiment
   (``pctpu_torch.experiments.nn_argmin --quick``): every mode and tile
   shape, in the new design (``csrc/nn_variant.cu``) and the first
   (``csrc/nn_pruned.cu``), bit-equal to its twin before it is timed, the
   two designs in turns; ``nn_variant``, ``nn_variant_prep`` and
   ``nn_variant_v1`` launched; the new prep at every compiled (tt, bf16)
   bit-equal to its twin on the fine target; ptxas's lines of both
   designs' kernels, with 0 bytes of spills required of the new ones;
9. ``batch_multi_bev_gen`` on a ray-cast HDL-64E drive (64 grid-ordered
   clouds, two raw clouds with duplicate cells, one over the grid's
   capacity; ``pctpu_torch.experiments.scene``): the BEV raster (the new
   kernels, the first design's and a second run) and the in-order ground
   sums bit-equal to their twins at B = 8, the raster timed in turns with
   the first design's, with its per-kernel times, the atomics sent and at
   most 2 kernels + 1 memset a call;
   ``preprocess_batch`` timed with the tile kernel and, in turns, with the
   walk in the sector sums' place, and with the first design's raster
   kernels in the rasters' place; the wire of every loader batch
   (``bench.wire_transfer``: MB and ms up and back over the pipelines'
   narrow pinned wire, which must be pinned, and over the wide pageable one
   in turns, a line a batch); the CLI in both
   compat modes after a warm-up, printing clouds/s, its ``[TIME]`` lines,
   launches per batch, the writer and the largest ground sector; the
   tolerance tree byte-identical to the bit-exact tree, the card's tree to
   the port's CPU run on 4 clouds and to its CPU run of every cloud in the
   card's batches (which pins no buffer: a pinned buffer handed out again
   under a lagging writer would show), and labels, ``.bin`` and single BEV
   to ``native/ref_oracle.cpp`` (any difference must be a D2 slope knife
   edge);
10. pair-batched registration: the registration tree's 20-pair list
   (``match_result_20.txt``: one batch of 16 and a tail of 4 padded to 16)
   through both CLIs at ``--pair-batch=16`` and ``=1``, in turns after a
   warm-up; every pair a success within 0.5° and 0.10 m at both, the same
   classification at both, and the batched 1-NN launched; printed: pairs/s,
   the byte-equal report lines and the largest transform |Δ| between 1 and
   16, host syncs (torch's sync debug mode) per pair, per batch iteration
   of the ICP loop and by the line that made them, kernels on the card per
   pair and per problem iteration (torch.profiler), and the
   ``BucketSpec`` hits and misses; then the top-part CLI at 16 once more
   with the ICP's batched pass swapped for the first warp design's
   (``nn_pruned_batched_v1`` launched, ``nn_pruned_batched`` not), its
   pairs bit-equal to the work-list design's;
11. ``batch_cloud_manip`` and ``cloud_manip`` on a ray-cast HDL-64E drive (29
   grid-ordered clouds, two raw, one over capacity): one batch of 8 through
   the device step (ordering, ground marking, float BEV) bit-equal to the
   CPU and its float BEVs to ``native/ref_oracle.cpp``'s
   ``pctpu_ref_float_bev``, NaN heights card = CPU, the float BEV's ms a
   batch beside its bytes bound and the step's ms and kernels a batch in
   both compat modes; the wire of every loader batch, as in phase 9; the CLI
   in both modes after a warm-up (clouds/s, its
   ``[TIME]`` line, the CSV route, which must be the native one), the
   host's share of a cloud stage by stage (load, results back beside the
   wide pageable copies, CSV, PNG, labeled PCD), the trees byte-identical
   across modes, to the port's CPU run on 4 clouds and of every cloud, and,
   for every float BEV's CSV and PNG, to the oracle's;
   ``ground_sums``
   launched; then ``cloud_manip`` on one drive cloud with ``--snapshot``
   in both views and ``--html``, every file byte-equal to the CPU run and
   the moved cloud bit-equal (0 coordinates differ);
12. ``pointcloud_pca_test``, ``top_part_registration`` and the selectors:
   ``pca_moments`` (``csrc/pca_moments.cu``) bit-equal to its twin on a
   ray-cast HDL-64E cloud ground-marked by the port (133,312 rows, the
   demo's filter applied), at N = 1, 31, 32, 33 and 4,097, all masked, and
   with NaN and ±inf rows kept and masked; its ms alone and with its
   wrapper, per-kernel profiler times, the twin, the library pair
   ((xyz·w).sum + ``torch.matmul``) and the chain bound; the
   ``pointcloud_pca_test`` CLI on that cloud, written as a labelled PCD,
   on the card and on the CPU, both snapshot views and ``--html``: standard
   output and every file byte-equal; ``top_part_registration`` on pair 0 →
   1 of the registration tree (after a warm-up run) within 0.5° and 0.10 m
   of the truth on the card and on the CPU, its flat cloud equal and the
   pixels and whisker endpoints that differ printed; the KITTI (HDL-64E) and
   MulRan (OS1-64) selectors on five-frame drives into
   ``batch_multi_bev_gen``, the card's tree byte-equal to the CPU's, and
   the Oxford (HDL-32E) and KITTI-raw selectors' trees listed with their
   hashes;
13. the parallel paths on the one card: ``run_multi_bev`` on a 32-cloud
   HDL-64E drive at batch 8 on a logical data mesh ``[cuda:0] * 2``, its
   tree byte-equal to the unsharded run's; ``batch_multi_bev_gen`` as two
   processes in one gloo group (``--num-processes=2 --process-id=k
   --coordinator=127.0.0.1:<port>``, started together: process 0 resets the
   outputs and the group waits for it), the merged tree byte-equal to a
   one-process run, and clouds/s (clouds over the slower process's loop
   wall, after a warm-up in each process) of one process against two, in
   turns; both registration drivers on the 20-pair list at
   ``--pair-batch=16`` on the logical mesh (in the drivers' ``--devices=2``
   place) and as two processes: every pair within 0.5° and 0.10 m, the
   top-part report byte-equal to the unsharded one and both drivers'
   transforms bit-equal to it, and the two ``.shard<k>`` reports (top part)
   and fitness lines (whole cloud) interleaved back equal to the
   one-process run's; ``register_pair``
   with the fine search over a ``points`` axis of two, within 0.01° / 0.01 m
   of the unsharded run, and ``sharded_nn_1`` bit-equal to ``knn.nn_1`` on
   the fine bucket; ``--devices=2`` exiting 2 on all three CLIs; and
   ``--profile`` on 8 clouds, its Chrome trace holding the run's span and
   ``bev_raster``'s kernel events;
14. the differential campaign on the card
   (``pctpu_torch.experiments.fuzz_campaign``, in-process, seeds from
   3,000,000: ``CAMPAIGN_ARGV``): every leg — the 7 point regimes with voxel
   and top-flatten, the three sensors at full grids, the C++ oracle, the
   adversarial shapes, the float BEV and PCA2D, both normals searches,
   per-iteration ICP in both modes, 16 two-stage pairs one by one and as
   one ``register_pairs`` batch of 16 with the whole driver, and the
   KITTI-raw structuring — each case against its oracle and against the
   port's CPU run; 0 FAIL lines, every KNIFE line naming its D-row, and
   ``bev_raster``, ``ground_sums``, ``segment_sum4``, ``nn_prep``,
   ``nn_pruned``, ``nn_prep_batched`` and ``nn_pruned_batched`` launched;
15. pctpu's tools outside the package, ported into
   ``pctpu_torch.experiments`` and ``examples/``: the reference-parity
   harness's native-oracle tier (the KITTI selector and
   ``batch_multi_bev_gen HDL_64E`` as processes of their own on the card,
   every artifact against ``native/ref_oracle.cpp``: 0 diverging); the
   registration chain's device floor (``FLOOR_STEPS`` batches of 16 pairs,
   the first batch's transforms bit-equal to ``register_pairs``, the card's
   busy time a pair by torch.profiler); the scaling harness at 1 and 2
   devices (a logical mesh on one card, bit-exact BEVs, labels and
   registration transforms identical to one device); the sort-based
   ordering bit-equal to ``get_ordered_cloud`` and both timed; and both
   examples with ``--device=cuda``; ``bev_raster`` and ``ground_sums``
   launched by the parity and scaling runs, ``nn_prep_batched``,
   ``nn_pruned_batched`` and ``segment_sum4`` by the floor and scaling runs;
16. pctpu's benchmark driver and driver entry, ported
   (``pctpu_torch.experiments.{bench, graft_entry}``): ``bench.main`` with
   ``--details`` at full size — exit 0, ``verify`` "ok", every key of the
   line and of the details block present and finite (a recorded
   ``pipeline_span_error`` fails), the span's loader batch copied back
   pinned (its wire printed beside the wide one), ``pct_of_roofline`` ≤ 100 in every
   utilization row, and ``bev_raster``, ``ground_sums``, ``nn_pruned``,
   ``nn_prep_batched``, ``nn_pruned_batched`` and ``segment_sum4``
   launched; ``graft_entry.entry()``'s step once; and
   ``dryrun_multichip(2)`` on the logical mesh ``[cuda:0] * 2``.

Phase 3's two gates that read the profiler: the segment sums' tile kernel
is held against the walk on each design's device time by torch.profiler,
both called in turns in one window (their wall times, on a launch floor of
≈ 15-25 µs, are printed only), and
``experiments.card.profile_calls`` counts a call's kernels among the device
events that start inside the calls' own span.

Each of paths 5-16 runs with the launch counts set to 0 just before it and
read just after (in phases 15 and 16 each tool on its own); a kernel of the path launched no time fails the run.  In
phase 13 that holds for every mesh run and every process on its own, apart
from the unsharded runs they are compared with.
Prints one JSON line of per-kernel results, then the final line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
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
import warnings

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
            short = re.search(r"(nn_pruned_kernel|nn_variant_(?:prep|seed|main|finish)_kernel"
                              r"|nn_fused_(?:v1|prep|main|finish)_kernel|segment_sum_tile_kernel"
                              r"|segment_sum_walk_kernel|segment_fill_kernel"
                              r"|bev_raster_v1_kernel|bev_expand_v1_kernel"
                              r"|bev_raster_kernel|bev_expand_kernel|nn_prep_kernel"
                              r"|nn_seed_kernel|nn_main_kernel|nn_finish_kernel"
                              r"|nn_seed_v1_kernel|nn_main_v1_kernel"
                              r"|pca_windows_kernel|pca_moments_kernel)", name)
            if short:  # the kernel's own template arguments, not its parameters'
                args = re.match(r"I((?:L[ib]\d+E)+)E", name[short.end():])
                tpl = re.findall(r"Li(\d+)E", args.group(1)) if args else []
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


def tree_files(root: str, outputs=BEV_OUTPUTS) -> dict[str, bytes]:
    """Every output file of a tree (by default a batch_multi_bev_gen
    tree's), by relative path."""
    files = {}
    for sub in outputs:
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
    # held on the card's own time for each design's kernels (torch.profiler):
    # the wall times above sit on a launch floor of ≈ 15-25 µs and stay
    # printed.  Both designs run in turns in one window, so that they share
    # the card's clock state: each in a window of its own, the same fill
    # kernel read 0.55 µs in one window and 1.06 µs in the next
    both = profile_calls(lambda: (wrapper["tile"](), wrapper["walk"]()))[2]
    fill = both.get("segment_fill_kernel", 0.0) / 2
    device_ms = {k: both[f"segment_sum_{k}_kernel"] + fill for k in ("tile", "walk")}
    print(f"  {name}: device ms a call, fill included: tile kernel {device_ms['tile']:.6f}, "
          f"walk {device_ms['walk']:.6f}")
    if device_ms["tile"] > 1.25 * device_ms["walk"]:
        raise AssertionError(f"{name}: the tile kernel is slower than the walk on the card")
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
    """One phase-3 case of the bbox-pruned 1-NN: the warp design (its work
    list, P = 1) with and without a prepared target, the first warp design
    (``nn_1_pruned_batched_v1``: dense main grid), the prep kernel, K4's
    <128, 1024, prod> instance (``csrc/nn_variant.cu``, K1's shape on the
    variants' template) and the earlier block design (the same instance of
    the first design, ``nn_1_pruned_variant_v1``), each held bit for bit
    against its twin; then their times (the two warp designs in turns), the
    pairs the warp design visits and its work items against the dense grid's
    blocks (its counting instance), the per-query 32-group oracle's pairs and
    the bound."""
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
            ("first warp design", cuda_knn.nn_1_pruned_batched_v1(q, qm, prep, md)),
            ("K4 <128, 1024, prod>", cuda_knn.nn_1_pruned_variant(*args, md, cuda_knn.TQ,
                                                                  cuda_knn.TT, "prod")),
            ("block design", cuda_knn.nn_1_pruned_variant_v1(*args, md, cuda_knn.TQ,
                                                            cuda_knn.TT, "prod"))):
        torch.cuda.synchronize()
        err = max(err, compare(f"{name}: {label}", got, want))
    d2 = want[1]
    launch = cuda_knn._pass_launcher(q, qm, prep, thr2)[0]
    warp_v1 = cuda_knn._pass_launcher(q, qm, prep, thr2, v1=True)[0]
    turns = {"alone": [], "v1_alone": []}
    for k in ("alone", "v1_alone", "v1_alone", "alone"):
        turns[k].append(cuda_ms(launch if k == "alone" else warp_v1, reps=50))
    old = cuda_knn._pruned_launcher(q, qm, t, tm, thr2, cuda_knn.TQ, cuda_knn.TT, "prod")[0]
    variant_prep = cuda_knn.prepare_variant_target(t, tm, cuda_knn.TT)
    variant = cuda_knn._variant_launcher(q, qm, variant_prep, t, thr2, cuda_knn.TQ,
                                         cuda_knn.TT, "prod")[0]
    out = {
        **{k: min(v) for k, v in turns.items()},
        "wrapper": cuda_ms(lambda: cuda_knn.nn_1_pruned(q, qm, max_distance=md,
                                                        prepared=prep), reps=50),
        "v1_wrapper": cuda_ms(lambda: cuda_knn.nn_1_pruned_batched_v1(q, qm, prep, md),
                              reps=50),
        "unprepared": cuda_ms(lambda: cuda_knn.nn_1_pruned(*args, max_distance=md), reps=50),
        "prep": cuda_ms(lambda: cuda_knn.prepare_target(t, tm), reps=50),
        "prep_twin": cuda_ms(lambda: cuda_knn.prepare_target_reference(t, tm), reps=5),
        "variant_alone": cuda_ms(variant, reps=50),
        "variant_wrapper": cuda_ms(lambda: cuda_knn.nn_1_pruned_variant(
            *args, md, cuda_knn.TQ, cuda_knn.TT, "prod"), reps=50),
        "variant_prep": cuda_ms(lambda: cuda_knn.prepare_variant_target(t, tm, cuda_knn.TT),
                                reps=50),
        "old_alone": cuda_ms(old, reps=20),
        "old_wrapper": cuda_ms(lambda: cuda_knn.nn_1_pruned_variant_v1(
            *args, md, cuda_knn.TQ, cuda_knn.TT, "prod"), reps=20),
        "twin": cuda_ms(lambda: cuda_knn.nn_1_pruned_reference(*args, max_distance=md),
                        reps=3, warmup=1),
        "err": err, "prep_err": prep_err, "library": None,
    }
    by_kernel = profile_calls(launch, reps=20)[2]
    v1_by_kernel = profile_calls(warp_v1, reps=20)[2]
    variant_by_kernel = profile_calls(variant, reps=20)[2]
    visited, items = cuda_knn.pass_counts(q, qm, prep, md)
    oracle = oracle_pairs(q, qm, d2, prep.group_box, thr2)
    nq, nt = q.shape[0], t.shape[0]
    warps, tiles = -(-nq // 32), prep.tile_box.shape[-1]
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
          f"{out['prep_twin']:.4f} ms); first warp design alone {out['v1_alone']:.4f} ms, with "
          f"wrapper {out['v1_wrapper']:.4f} ms (the two alone in turns, the least of two each); "
          f"work items {items} against the dense grid's {-(-warps // 4) * tiles} blocks of 4 "
          f"warps ({warps * tiles} warp items); K4 <128, 1024, prod> alone {out['variant_alone']:.4f} "
          f"ms, with wrapper {out['variant_wrapper']:.4f} ms (its prep "
          f"{out['variant_prep']:.4f} ms), {out['variant_alone'] / out['alone']:.3f}x K1 "
          f"alone; block design alone {out['old_alone']:.4f} ms, with "
          f"wrapper {out['old_wrapper']:.4f} ms; twin {out['twin']:.4f} ms; pairs visited "
          f"{visited} ({visited / (nq * nt):.6f} of Q·T), oracle {oracle}; bound "
          f"{out['bound']:.6f} ms ({out['bound_by']}: {n_bytes} B, "
          f"{NN_FLOP_PER_PAIR * oracle} flop), reached {out['bound'] / out['alone']:.4f} (first "
          f"warp design {out['bound'] / out['v1_alone']:.4f}, K4 "
          f"<128, 1024, prod> {out['bound'] / out['variant_alone']:.4f}, block design "
          f"{out['bound'] / out['old_alone']:.4f}); prep bound "
          f"{out['prep_bound']:.6f} ms ({out['prep_bound_by']}: {nt * 13 + target_bytes} B); "
          f"device ms by kernel (torch.profiler) "
          f"{ {k: round(v, 6) for k, v in by_kernel.items()} }, the first warp design's "
          f"{ {k: round(v, 6) for k, v in v1_by_kernel.items()} }, K4's "
          f"{ {k: round(v, 6) for k, v in variant_by_kernel.items()} }; card {smi}")
    out["items"] = items
    return out


def batched_nn_case(name: str, q, qm, t, tm, md, smi: str, library: bool = False) -> dict:
    """K1 over a problem axis: P problems ``q`` (P, Q, 3) on Bt targets ``t``
    (Bt, T, 3), problem p in target p // (P / Bt).  The batched prep (one
    launch) and pass (a memset and three launches) bit for bit against the
    twin, the first warp design's pass (``nn_1_pruned_batched_v1``, three
    launches) and Bt / P unbatched kernel calls; then, in turns in this
    call, the batched pass, the first design's and the P unbatched passes
    alone, and the two designs with their wrappers (CUDA events), the prep,
    per-kernel profiler times and what a call puts on the card, the work
    items against the dense grid's blocks, the twin, and the bound: the sum
    of the problems' single bounds, each counted as phase 3 counts one
    pass's (bytes the work needs, 9 flop an oracle pair).  ``library``: ``torch.cdist(q, t).min(1)`` once a problem
    (one call over the batch would hold P·Q·T distances)."""
    from pctpu_torch.experiments.card import (NN_FLOP_PER_PAIR, bound_ms, cuda_ms, oracle_pairs,
                                              profile_calls)
    from pctpu_torch.ops import cuda_knn

    n_problems, n_targets = q.shape[0], t.shape[0]
    per = n_problems // n_targets
    thr2 = cuda_knn._thr2(md)
    prep = cuda_knn.prepare_targets(t, tm)
    ref = cuda_knn.prepare_targets_reference(t, tm)
    prep_err = compare(f"{name}: batched prep kernel", [prep.packed, prep.group_box, prep.tile_box],
                       [ref.packed, ref.group_box, ref.tile_box])
    singles = [cuda_knn.prepare_target(t[b], tm[b]) for b in range(n_targets)]
    compare(f"{name}: batched prep against {n_targets} unbatched preps",
            [prep.packed, prep.group_box, prep.tile_box],
            [torch.stack([getattr(s, f) for s in singles]) for f in ("packed", "group_box",
                                                                     "tile_box")])
    got = cuda_knn.nn_1_pruned_batched(q, qm, prep, md)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cuda_knn.nn_1_pruned_batched_reference(q, qm, t, tm, md)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    err = compare(f"{name}: batched pass against the twin", got, want)
    v1_err = compare(f"{name}: the first warp design against the twin",
                     cuda_knn.nn_1_pruned_batched_v1(q, qm, prep, md), want)
    one = [cuda_knn.nn_1_pruned(q[k], qm[k], prepared=singles[k // per], max_distance=md)
           for k in range(n_problems)]
    compare(f"{name}: batched pass against {n_problems} unbatched kernel calls", got,
            [torch.stack([o[0] for o in one]), torch.stack([o[1] for o in one])])
    batched = cuda_knn._pass_launcher(q, qm, prep, thr2)[0]
    v1 = cuda_knn._pass_launcher(q, qm, prep, thr2, v1=True)[0]
    unbatched = [cuda_knn._pass_launcher(q[k], qm[k], singles[k // per], thr2)[0]
                 for k in range(n_problems)]
    timed = {"batched": batched, "v1": v1, "unbatched": lambda: [f() for f in unbatched],
             "wrapper": lambda: cuda_knn.nn_1_pruned_batched(q, qm, prep, md),
             "v1_wrapper": lambda: cuda_knn.nn_1_pruned_batched_v1(q, qm, prep, md)}
    ms = {k: [] for k in timed}
    for k in ("batched", "v1", "unbatched", "wrapper", "v1_wrapper", "v1_wrapper", "wrapper",
              "unbatched", "v1", "batched"):
        ms[k].append(cuda_ms(timed[k], reps=20))
    ms = {k: min(v) for k, v in ms.items()}
    prep_ms = cuda_ms(lambda: cuda_knn.prepare_targets(t, tm), reps=50)
    prep_twin_ms = cuda_ms(lambda: cuda_knn.prepare_targets_reference(t, tm), reps=2, warmup=1)
    kernels, copies, by_kernel = profile_calls(batched, reps=20)
    v1_kernels, v1_copies, v1_by_kernel = profile_calls(v1, reps=20)
    prep_kernels, prep_copies, _ = profile_calls(lambda: cuda_knn.prepare_targets(t, tm), reps=20)
    if kernels > 3 or copies > 1 or v1_kernels > 3 or v1_copies:
        raise AssertionError(f"{name}: a batched pass puts {kernels} kernels + {copies} copies "
                             f"on the card, the first design's {v1_kernels} + {v1_copies}")
    if prep_kernels != 1 or prep_copies:
        raise AssertionError(f"{name}: the batched prep is {prep_kernels} kernels")
    nq, nt = q.shape[1], t.shape[1]
    pairs, items = cuda_knn.pass_counts(q, qm, prep, md)
    warps, tiles = -(-nq // 32), prep.tile_box.shape[-1]
    target_bytes = nt * 12 + 6 * 4 * (-(-nt // cuda_knn.GROUP) + -(-nt // cuda_knn.TT))
    t_bytes = t_ops = bound = 0.0
    for k in range(n_problems):
        oracle = oracle_pairs(q[k], qm[k], got[1][k], prep.group_box[k // per], thr2)
        b = bound_ms(nq * 13 + target_bytes + nq * 8, NN_FLOP_PER_PAIR * oracle)
        bound += b[0]
        t_bytes += bound_ms(nq * 13 + target_bytes + nq * 8, 0)[0]
        t_ops += bound_ms(0, NN_FLOP_PER_PAIR * oracle)[0]
    prep_bound = bound_ms(n_targets * (nt * 13 + target_bytes), 0)
    lib_ms = None
    if library:
        lib_ms = cuda_ms(lambda: [torch.cdist(q[k], t[k // per]).min(1)
                                  for k in range(n_problems)], reps=1, warmup=1)
        torch.cuda.empty_cache()
    print(f"  {name}: P={n_problems} problems of Q={nq} on Bt={n_targets} targets of T={nt}; "
          f"batched pass alone {ms['batched']:.4f} ms, with wrapper {ms['wrapper']:.4f} ms; "
          f"the first warp design alone {ms['v1']:.4f} ms, with wrapper {ms['v1_wrapper']:.4f} "
          f"ms; the {n_problems} unbatched passes alone {ms['unbatched']:.4f} ms (CUDA events, "
          f"in turns, the least of two turns each); a batched pass puts {kernels} kernels + "
          f"{copies} copies/memsets on the card (the list's count), the first design's "
          f"{v1_kernels} + {v1_copies}; work items {items} against the dense grid's "
          f"{-(-warps // 4) * tiles * n_problems} blocks of 4 warps "
          f"({warps * tiles * n_problems} warp items), pairs visited {pairs}; the batched prep "
          f"{prep_kernels} kernel ({prep_ms:.4f} ms, its twin {prep_twin_ms:.4f} ms, bound "
          f"{prep_bound[0]:.6f} ms by {prep_bound[1]}); device ms by kernel (torch.profiler) "
          f"{ {k: round(v, 6) for k, v in by_kernel.items()} }, the first design's "
          f"{ {k: round(v, 6) for k, v in v1_by_kernel.items()} }; twin {twin_ms:.1f} ms; bound "
          f"{bound:.6f} ms (sum of the single bounds; bytes {t_bytes:.6f}, operations "
          f"{t_ops:.6f}), reached {bound / ms['batched']:.4f} (the first design "
          f"{bound / ms['v1']:.4f})"
          + (f"; torch.cdist(q, t).min(1) a problem, {n_problems} calls {lib_ms:.4f} ms"
             if library else "") + f"; card {smi}")
    return {"err": err, "prep_err": prep_err, "ms": ms["batched"], "unbatched_ms": ms["unbatched"],
            "v1_ms": ms["v1"], "v1_err": v1_err, "wrapper_ms": ms["wrapper"], "v1_wrapper_ms": ms["v1_wrapper"],
            "items": items, "dense_blocks": -(-warps // 4) * tiles * n_problems,
            "by_kernel": by_kernel, "v1_by_kernel": v1_by_kernel,
            "plain_ms": twin_ms, "bound": bound, "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "library_ms": lib_ms, "prep_ms": prep_ms, "prep_plain_ms": prep_twin_ms,
            "prep_bound": prep_bound}


def raster_case(labeled, params, smi: str, ptxas: dict) -> dict:
    """The BEV raster at the path's batch: the new kernels, the first design's
    and the twin byte for byte, and the new ones against a second run; then,
    in turns in this one call, the new C call alone and both wrappers (CUDA
    events), per-kernel device ms and what a call puts on the card
    (torch.profiler), the atomics each raster kernel sends, and the bound."""
    from pctpu_torch.experiments.card import bound_ms, cuda_ms, profile_calls
    from pctpu_torch.ops import bev

    res = params.height_res
    want = bev.fused_multi_single_bev_reference(labeled, res)
    rasters = bev.fused_multi_single_bev(labeled, res)
    err = compare("bev_raster (B = 8)", rasters, want)
    compare("bev_raster (B = 8): first design", bev.fused_multi_single_bev_v1(labeled, res), want)
    compare("bev_raster (B = 8): second run", bev.fused_multi_single_bev(labeled, res), rasters)
    timed = {
        "alone": bev._raster_launcher(labeled, res)[0],
        "wrapper": lambda: bev.fused_multi_single_bev(labeled, res),
        "v1 wrapper": lambda: bev.fused_multi_single_bev_v1(labeled, res),
    }
    ms = {k: [] for k in timed}
    for k in ("alone", "wrapper", "v1 wrapper", "v1 wrapper", "wrapper", "alone"):
        ms[k].append(cuda_ms(timed[k], reps=50))
    ms = {k: min(v) for k, v in ms.items()}
    new_prof = profile_calls(timed["wrapper"])
    old_prof = profile_calls(timed["v1 wrapper"])
    twin_ms = cuda_ms(lambda: bev.fused_multi_single_bev_reference(labeled, res), reps=5)
    sent = {"new": bev.atomics_sent(labeled, res),
           "first design": bev.atomics_sent(labeled, res, v1=True)}
    # xyz and label (16 B a point) read once, both rasters (1 B a cell) written
    bound = bound_ms(labeled.label.numel() * 16 + sum(r.numel() for r in rasters), 0)
    regs = {k: v for k, v in ptxas.items() if k.startswith("bev_")}
    print(f"  bev_raster: alone {ms['alone']:.4f} ms, with wrapper {ms['wrapper']:.4f} ms; first "
          f"design with wrapper {ms['v1 wrapper']:.4f} ms (CUDA events, the least of two turns "
          f"each); twin {twin_ms:.4f} ms; bound {bound[0]:.6f} ms ({bound[1]}), reached "
          f"{bound[0] / ms['alone']:.4f}; a call puts {new_prof[0]} kernels + {new_prof[1]} "
          f"memsets on the card (first design {old_prof[0]} + {old_prof[1]}); device ms "
          f"(torch.profiler) { {k: round(v, 6) for k, v in {**old_prof[2], **new_prof[2]}.items()} }; "
          f"atomics sent {sent}; ptxas {regs}; card {smi}")
    if new_prof[0] > 2 or new_prof[1] > 1:
        raise AssertionError("bev_raster: a call puts more than 2 kernels + 1 memset on the card")
    return {"err": err, "ms": ms["alone"], "wrapper_ms": ms["wrapper"],
            "v1_wrapper_ms": ms["v1 wrapper"], "plain_ms": twin_ms, "bound": bound}


def fused_edge_cases(dev: torch.device) -> list:
    """(name, (query, query_mask, target, target_mask)) of the fused 1-NN's
    exact ties — duplicate targets a chunk, a tile and many tiles apart, the
    first of them masked, and targets mirrored about the query — and of NaN
    and infinite coordinates in unmasked targets and queries."""
    rng = np.random.default_rng(12)
    t = torch.from_numpy(rng.uniform(-70, 70, (9000, 3)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.uniform(-70, 70, (3000, 3)).astype(np.float32)).to(dev)
    qm = torch.ones(3000, dtype=torch.bool, device=dev)
    tm = torch.ones(9000, dtype=torch.bool, device=dev)
    ties = t.clone()
    ties[7] = torch.tensor([0.1, 0.2, 0.3], device=dev)  # nearest to the zero query, with its mirror
    ties[[40, 45, 300, 2000, 8999]] = ties[7].clone()
    ties[5000] = -ties[7]
    tie_q = torch.cat([ties[[7, 45, 8999]], torch.zeros((1, 3), device=dev), q[:200]])
    first_masked = tm.clone()
    first_masked[[7, 40]] = False
    bad_t, bad_q = t.clone(), q.clone()
    bad_t[100, 1] = float("nan")
    bad_t[4000, 0] = float("inf")
    bad_t[8000, 2] = -float("inf")
    bad_q[7, 2] = float("nan")
    bad_q[9, 0] = float("inf")
    return [("exact ties", (tie_q, qm[:204], ties, tm)),
            ("exact ties, the first two masked", (tie_q, qm[:204], ties, first_masked)),
            ("NaN and inf coordinates", (bad_q, qm, bad_t, tm))]


def fused_case(name: str, args: tuple, smi: str, got=None, library: bool = False) -> dict:
    """One shape of the fused unpruned 1-NN: the new kernels (``got`` where
    the caller has run them already), the first design's kernel and the twin
    bit for bit, and a second run; then, in turns in this one call, each C
    call alone and with its wrapper (CUDA events), per-kernel device ms
    (torch.profiler), the main kernel's grid, the twin, ``knn.nn_1``, the
    bound (8 flop a pair on every pair) and, with ``library``,
    ``torch.cdist(q, t).min(1)``."""
    from pctpu_torch.experiments.card import bound_ms, cuda_ms, profile_calls
    from pctpu_torch.ops import cuda_knn, knn

    q, _, t, _ = args
    want = cuda_knn.nn_1_fused_reference(*args)
    got = cuda_knn.nn_1_fused(*args) if got is None else got
    err = compare(name, got, want)
    compare(f"{name}: first design", cuda_knn.nn_1_fused_v1(*args), want)
    compare(f"{name}: second run", cuda_knn.nn_1_fused(*args), got)
    xla = knn.nn_1(*args)
    agree = float((xla[0] == got[0]).float().mean())
    timed = {
        "alone": cuda_knn._fused_launcher(*args)[0],
        "v1 alone": cuda_knn._fused_v1_launcher(*args)[0],
        "wrapper": lambda: cuda_knn.nn_1_fused(*args),
        "v1 wrapper": lambda: cuda_knn.nn_1_fused_v1(*args),
    }
    ms = {k: [] for k in timed}
    for k in ("alone", "v1 alone", "v1 alone", "alone",
              "wrapper", "v1 wrapper", "v1 wrapper", "wrapper"):
        ms[k].append(cuda_ms(timed[k], reps=10))
    ms = {k: min(v) for k, v in ms.items()}
    new_prof = profile_calls(timed["alone"], reps=10)
    old_prof = profile_calls(timed["v1 alone"], reps=10)
    twin_ms = cuda_ms(lambda: cuda_knn.nn_1_fused_reference(*args), reps=2, warmup=1)
    xla_ms = cuda_ms(lambda: knn.nn_1(*args), reps=5)
    bound = bound_ms(q.shape[0] * (13 + 8) + t.shape[0] * 13, 8 * q.shape[0] * t.shape[0])
    grid = cuda_knn.fused_grid(q.shape[0], t.shape[0])
    lib_ms = None
    if library:
        lib_ms = cuda_ms(lambda: torch.cdist(q, t).min(1), reps=3, warmup=1)
        torch.cuda.empty_cache()
    print(f"  {name}: alone {ms['alone']:.4f} ms, with wrapper {ms['wrapper']:.4f} ms; first design "
          f"alone {ms['v1 alone']:.4f} ms, with wrapper {ms['v1 wrapper']:.4f} ms (CUDA events, the "
          f"least of two turns each); twin {twin_ms:.4f} ms, knn.nn_1 {xla_ms:.4f} ms (it picks "
          f"the same index for {agree:.6f} of queries); main grid {grid[0]} query tiles x "
          f"{grid[1]} target splits = {grid[0] * grid[1]} blocks; a call puts {new_prof[0]} "
          f"kernels + {new_prof[1]} memsets on the card; device ms (torch.profiler) "
          f"{ {k: round(v, 6) for k, v in {**old_prof[2], **new_prof[2]}.items()} }; bound "
          f"{bound[0]:.6f} ms ({bound[1]}), reached {bound[0] / ms['alone']:.4f} (first design "
          f"{bound[0] / ms['v1 alone']:.4f})"
          + (f"; torch.cdist(q, t).min(1) {lib_ms:.4f} ms" if library else "") + f"; card {smi}")
    return {"err": err, "ms": ms["alone"], "plain_ms": twin_ms, "bound": bound,
            "library_ms": lib_ms, "wrapper_ms": ms["wrapper"], "v1_ms": ms["v1 alone"]}


def wire_lines(name: str, paths: list, load, dev: torch.device, smi: str) -> list[dict]:
    """The BEV pipelines' wire, one loader batch of 8 at a time, as the
    pipelines batch ``paths`` (the last batch padded with its last cloud):
    ``bench.wire_transfer``, the narrow pinned wire and, in turns, the wide
    pageable one on the same batch.  A line a batch, then their medians."""
    from pctpu_torch.experiments.bench import wire_transfer
    from pctpu_torch.runtime.loader import stack_batch

    out = []
    for k in range(0, len(paths), 8):
        payload = [load(p) for p in paths[k:k + 8]]
        w = wire_transfer(stack_batch(payload + [payload[-1]] * (8 - len(payload))), dev)
        slots = 8 * payload[0]["row"].shape[0]
        if not w["transfer_pinned"] or w["transfer_mb_up"] * 1e6 != 26 * slots + 4 * 8:
            raise AssertionError(f"{name} wire: pinned {w['transfer_pinned']}, "
                                 f"{w['transfer_mb_up']} MB up for {slots} slots")
        print(f"  {name} wire, batch {k // 8}: up {w['transfer_mb_up']:.6f} MB in "
              f"{w['transfer_up_ms']:.4f} ms, back {w['transfer_mb_back']:.6f} MB in "
              f"{w['transfer_back_ms']:.4f} ms, pinned {w['transfer_pinned']}; wide pageable "
              f"{w['wide_transfer_mb_per_batch'] / 2:.6f} MB each way, up "
              f"{w['wide_transfer_up_ms']:.4f} ms, back {w['wide_transfer_back_ms']:.4f} ms "
              f"(host clock, the least of two turns each); card {smi}")
        out.append(w)
    med = {k: float(np.median([w[k] for w in out])) for k in
           ("transfer_ms_per_batch", "wide_transfer_ms_per_batch", "transfer_mb_per_batch",
            "wide_transfer_mb_per_batch")}
    print(f"{name} wire over {len(out)} batches of 8, medians: narrow pinned "
          f"{med['transfer_mb_per_batch']:.6f} MB in {med['transfer_ms_per_batch']:.4f} ms, wide "
          f"pageable {med['wide_transfer_mb_per_batch']:.6f} MB in "
          f"{med['wide_transfer_ms_per_batch']:.4f} ms (up + back); card {smi}")
    return out


def multi_bev_phase(dev: torch.device, smi: str, n_ordered: int = 64, ptxas: dict | None = None,
                    clock_mhz: float = 1980.0) -> list[dict]:
    """Phase 9 (module docstring).  Returns the ``kernels`` entries of the
    BEV raster and the ground sums."""
    from pctpu_torch.cli import batch_multi_bev_gen as bev_cli
    from pctpu_torch.config import GroundConfig, get_sensor_params
    from pctpu_torch.experiments import oracle
    from pctpu_torch.experiments.card import cuda_ms, profile_calls
    from pctpu_torch.experiments.scene import multi_bev_tree
    from pctpu_torch.io.pcd import read_pcd
    from pctpu_torch.io.png import read_gray_png
    from pctpu_torch.ops import _cuda, bev, ground, preprocess, voxel
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
    arrays = stack_batch([load_xyzirct_arrays(p, params.grid_size, params=params)
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
    raster = raster_case(labeled, params, smi, ptxas or {})

    def with_walk(fn):
        """``fn()`` with the sector sums taken by the first design's walk."""
        real = ground.segment_sum_sorted
        ground.segment_sum_sorted = lambda *a, count_as=None, **k: voxel.segment_sum_walk(*a, **k)
        try:
            return fn()
        finally:
            ground.segment_sum_sorted = real

    def with_raster_v1(fn):
        """``fn()`` with both rasters taken by the first design's kernels."""
        real = preprocess.fused_multi_single_bev
        preprocess.fused_multi_single_bev = bev.fused_multi_single_bev_v1
        try:
            return fn()
        finally:
            preprocess.fused_multi_single_bev = real

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
            # and with the first design's raster kernels in the rasters' place
            _cuda.reset_launch_counts()
            turns = {"new": [], "v1": []}
            for k in ("new", "v1", "v1", "new"):
                turns[k].append(cuda_ms(step, reps=10) if k == "new"
                                else with_raster_v1(lambda: cuda_ms(step, reps=10)))
            by_v1, by_new = with_raster_v1(step), step()
            torch.cuda.synchronize()
            require_launched(_cuda.launch_counts, ("bev_raster", "bev_raster_v1"),
                             "preprocess_batch in turns")
            if not all(torch.equal(a, b) for a, b in zip(by_v1[1:], by_new[1:])):
                raise AssertionError("preprocess_batch: the two raster designs disagree")
            print(f"  preprocess_batch B = 8 (bitexact) with the first design's raster kernels: "
                  f"{min(turns['v1']):.4f} ms; with the new ones {min(turns['new']):.4f} ms (CUDA "
                  f"events, the least of two each, in turns); card {smi}")
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

    # --- 9w. the wire of every loader batch, narrow pinned against wide ----
    wire_lines("batch_multi_bev_gen", paths,
               lambda p: load_xyzirct_arrays(p, params.grid_size, params=params), dev, smi)

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

    # --- 9e. the whole card tree against the port's CPU run of every cloud --
    # the CPU run pins no buffer: a pinned host buffer handed out again while
    # a writer still read it would show here
    whole = os.path.join(base, "cpu_all")
    os.makedirs(os.path.join(whole, "keyframe_point_cloud"))
    for p in paths:
        shutil.copy(p, os.path.join(whole, "keyframe_point_cloud"))
    shutil.copy(os.path.join(src, "keyframe_pose.csv"), whole)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        multi_bev.run_multi_bev(whole, "HDL_64E", batch_size=8, device="cpu")
    cpu = tree_files(whole)
    differ = sorted(k for k in exact if exact[k] != cpu.get(k)) + sorted(set(cpu) - set(exact))
    if differ:
        raise AssertionError(f"the whole CPU run differs from the card's tree in {differ[:5]}")
    print(f"card tree byte-identical to the CPU run of all {len(paths)} clouds, "
          f"{-(-len(paths) // 8)} batches of 8 ({len(cpu)} files, CPU "
          f"{time.perf_counter() - t0:.1f} s)")

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
         "max_abs_err": raster["err"], "ms": raster["ms"], "plain_ms": raster["plain_ms"],
         "bound_ms": raster["bound"][0], "bound_by": raster["bound"][1], "library_ms": None,
         "wrapper_ms": raster["wrapper_ms"], "v1_wrapper_ms": raster["v1_wrapper_ms"]},
        sums_entry("ground_sums", "pctpu/ops/ground.py:113", sums_launches, sums),
    ]


def cloud_manip_phase(dev: torch.device, smi: str, n_ordered: int = 29) -> dict:
    """Phase 11 (module docstring).  Returns the hand-kernel launch counts
    of the batch_cloud_manip CLI's bit-exact run."""
    from pctpu_torch.cli import batch_cloud_manip as bcm_cli
    from pctpu_torch.cli import cloud_manip as cm_cli
    from pctpu_torch.config import FloatBevConfig, GroundConfig
    from pctpu_torch.experiments import oracle
    from pctpu_torch.experiments.card import bound_ms, cuda_ms, profile_calls
    from pctpu_torch.experiments.scene import multi_bev_tree
    from pctpu_torch.io import csvfmt
    from pctpu_torch.io.pcd import load_cloud_pcd, read_pcd, write_pcd
    from pctpu_torch.io.png import encode_gray_png, write_gray_png
    from pctpu_torch.ops import _cuda, bev
    from pctpu_torch.ops.transform import make_rigid_transform, transform_cloud, transform_xyz
    from pctpu_torch.pipelines import batch_cloud_manip as bcm
    from pctpu_torch.pipelines.multi_bev import _to_device, _to_host, _wire
    from pctpu_torch.runtime.loader import load_xyzirct_arrays, stack_batch

    params = bcm.HDL64E
    base = os.path.join(ROOT, "build", "chip_smoke_cloud_manip")
    shutil.rmtree(base, ignore_errors=True)
    src = os.path.join(base, "tree")
    t0 = time.perf_counter()
    paths = multi_bev_tree(src, params, n_ordered=n_ordered, n_raw=2, n_over=1, seed=8)
    print(f"batch_cloud_manip drive: {len(paths)} HDL-64E clouds ({n_ordered} grid-ordered, "
          f"2 raw, 1 over capacity) generated in {time.perf_counter() - t0:.1f} s")

    # --- 11a. one batch of 8 on the card against the CPU and the oracle ----
    cpu = torch.device("cpu")
    picked = paths[-8:]  # the raw and over-capacity clouds among them
    arrays = stack_batch([load_xyzirct_arrays(p, params.grid_size) for p in picked])
    clouds = _to_device(arrays, dev)
    ground_cfg, bev_cfg = GroundConfig(), FloatBevConfig(filter_ground=True)

    def step(compat="bitexact"):
        return bcm.process_batch(clouds, params, ground_cfg, bev_cfg, compat=compat)

    labeled, bevs = step()
    want_labeled, want_bevs = bcm.process_batch(_to_device(arrays, cpu), params, ground_cfg,
                                                bev_cfg)
    for field in ("xyz", "intensity", "row", "col", "t", "label"):
        compare(f"ordered + labeled batch of 8 ({field}), card against CPU",
                [getattr(labeled, field).cpu()], [getattr(want_labeled, field)])
    compare("float BEV (B = 8), card against CPU", [bevs.cpu()], [want_bevs])
    lib = oracle.load()
    host_xyz, host_label = labeled.xyz.cpu().numpy(), labeled.label.cpu().numpy()
    oracle_cells = sum(int((bevs[b].cpu().numpy().view(np.uint32) != oracle.float_bev(
        lib, host_xyz[b], host_label[b], True).view(np.uint32)).sum()) for b in range(8))
    print(f"  float BEV (B = 8) against native/ref_oracle.cpp's pctpu_ref_float_bev: "
          f"{oracle_cells} cells differ")
    if oracle_cells:
        raise AssertionError("float BEV differs from the native oracle")
    # NaN heights on in-range non-ground points: one NaN, a sign-set NaN, and
    # three NaNs in one cell, each beside finite heights of its cell
    dirty = labeled.xyz.clone()
    keep = (labeled.label != 0) & (dirty[..., :2].abs() < 90).all(-1)
    rows = torch.nonzero(keep[0]).flatten()[:5]
    dirty[0, rows, 2] = float("nan")
    dirty[0, rows[1], 2] = -float("nan")
    dirty[0, rows[2:], :2] = dirty[0, rows[2], :2]
    nan_cloud = labeled.replace(xyz=dirty)
    nan_bev = bev.float_bev(nan_cloud, bev_cfg)
    compare("float BEV with NaN heights, card against CPU", [nan_bev.cpu()],
            [bev.float_bev(nan_cloud.replace(xyz=dirty.cpu(), label=labeled.label.cpu(),
                                             count=labeled.count.cpu()), bev_cfg)])
    print(f"  float BEV NaN cells: {int(torch.isnan(nan_bev).sum())} (card = CPU, bit for bit)")

    fb_ms = cuda_ms(lambda: bev.float_bev(labeled, bev_cfg), reps=50)
    fb_kernels, fb_copies, fb_by = profile_calls(lambda: bev.float_bev(labeled, bev_cfg))
    # xyz and label (16 B a point) read once, the images (4 B a cell) written
    fb_bound = bound_ms(labeled.label.numel() * 16 + bevs.numel() * 4, 0)
    step_ms = {c: cuda_ms(lambda c=c: step(c), reps=10) for c in ("bitexact", "tolerance")}
    step_prof = {c: profile_calls(lambda c=c: step(c), reps=3) for c in ("bitexact", "tolerance")}
    print(f"  float_bev B = 8: {fb_ms:.4f} ms (CUDA events), bound {fb_bound[0]:.6f} ms "
          f"({fb_bound[1]}), reached {fb_bound[0] / fb_ms:.4f}; {fb_kernels} kernels + "
          f"{fb_copies} copies/memsets a call; device ms (torch.profiler) "
          f"{ {k: round(v, 6) for k, v in fb_by.items()} }; card {smi}")
    for c in step_ms:
        print(f"  batch_cloud_manip device step B = 8 ({c}): {step_ms[c]:.4f} ms (CUDA events), "
              f"{step_prof[c][0]} kernels + {step_prof[c][1]} copies/memsets a batch; card {smi}")
    wire_lines("batch_cloud_manip", paths, lambda p: load_xyzirct_arrays(p, params.grid_size),
               dev, smi)

    # --- 11b. the CLI in both modes, after a warm-up -----------------------
    warm = os.path.join(base, "warm")
    os.makedirs(os.path.join(warm, "keyframe_point_cloud"))
    for p in paths[-9:]:
        shutil.copy(p, os.path.join(warm, "keyframe_point_cloud"))
    for compat in ("bitexact", "tolerance"):
        with contextlib.redirect_stdout(io.StringIO()):
            bcm_cli.main([warm, f"--compat={compat}", f"--device={dev.type}"])
    route = csvfmt.csv_route(bevs[0].cpu().numpy())
    if route != "native":
        raise AssertionError(f"batch_cloud_manip writes its CSVs by the {route} route")
    trees, bcm_launches = {}, {}
    for compat in ("bitexact", "tolerance"):
        captured = io.StringIO()
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = bcm_cli.main([src, f"--compat={compat}", f"--device={dev.type}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.launch_counts)
        if rc != 0:
            raise AssertionError(f"batch_cloud_manip --compat={compat} exited {rc}")
        if compat == "bitexact":
            require_launched(launches, ("ground_sums",), "batch_cloud_manip --compat=bitexact")
            bcm_launches = launches
        log = captured.getvalue()
        timed = [line for line in log.splitlines() if line.startswith("[TIME]")]
        if len(timed) != 1 or "Done. " not in log:
            raise AssertionError(f"batch_cloud_manip --compat={compat}: log lines missing")
        print(f"batch_cloud_manip --compat={compat}: {len(paths)} clouds in {wall:.3f} s = "
              f"{len(paths) / wall:.4f} clouds/s; {timed[0]} (ms a cloud); CSV route {route}; "
              f"hand-kernel launches {launches} ({-(-len(paths) // 8)} batches); card {smi}")
        trees[compat] = os.path.join(base, compat)
        os.makedirs(trees[compat])
        for sub in ("non_ground_point_cloud", "output_bvm"):
            os.rename(os.path.join(src, sub), os.path.join(trees[compat], sub))

    def files(root: str) -> dict[str, bytes]:
        return tree_files(root, ("non_ground_point_cloud", "output_bvm"))

    exact, tol = files(trees["bitexact"]), files(trees["tolerance"])
    if len(exact) != 3 * len(paths):
        raise AssertionError(f"bit-exact tree holds {len(exact)} files")
    differ = sorted(k for k in exact if exact[k] != tol.get(k)) + sorted(set(tol) - set(exact))
    if differ:
        raise AssertionError(f"tolerance tree differs from the bit-exact tree in {differ[:5]}")
    print(f"batch_cloud_manip: tolerance tree byte-identical to the bit-exact tree "
          f"({len(exact)} files)")

    # the host's share of [TIME], stage by stage on the batch of 11a
    split = os.path.join(base, "split")
    os.makedirs(split)
    t0 = time.perf_counter()
    for p in picked:
        load_xyzirct_arrays(p, params.grid_size)
    load_ms = (time.perf_counter() - t0) * 1e3 / 8
    _to_host([{**_wire(labeled), "bev": bevs}])  # the pinned buffers' first allocation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = _to_host([{**_wire(labeled), "bev": bevs}])
    back_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    [getattr(labeled, f).cpu() for f in ("xyz", "intensity", "row", "col", "t", "label")]
    bevs.cpu()
    wide_ms = (time.perf_counter() - t0) * 1e3
    bevs_h = fields["bev"]
    stage_ms = {"CSV": 0.0, "PNG": 0.0, "labeled PCD": 0.0}
    for b in range(8):
        t0 = time.perf_counter()
        csvfmt.write_csv(os.path.join(split, f"{b}.csv"), bevs_h[b])
        t1 = time.perf_counter()
        write_gray_png(os.path.join(split, f"{b}.png"), bevs_h[b])
        t2 = time.perf_counter()
        write_pcd(os.path.join(split, f"{b}.pcd"), {
            "x": fields["xyz"][b, :, 0], "y": fields["xyz"][b, :, 1],
            "z": fields["xyz"][b, :, 2],
            **{k: fields[k][b] for k in ("intensity", "row", "col", "t", "label")}})
        t3 = time.perf_counter()
        for k, dt in zip(stage_ms, (t1 - t0, t2 - t1, t3 - t2)):
            stage_ms[k] += dt * 1e3 / 8
    print(f"  host split a cloud (B = 8, this host): load {load_ms:.4f} ms (the producer "
          f"thread's, outside [TIME]); results back {back_ms / 8:.4f} ms ({back_ms:.4f} a "
          f"batch, narrowed on the card, pinned, one synchronize; the wide pageable copies "
          f"{wide_ms:.4f} a batch); " + ", ".join(f"{k} {v:.4f} ms" for k, v in stage_ms.items())
          + f"; card {smi}")

    # --- 11c. the card's tree against the port's CPU run on 4 clouds -------
    sub = os.path.join(base, "cpu")
    os.makedirs(os.path.join(sub, "keyframe_point_cloud"))
    for p in (paths[0], paths[n_ordered], paths[n_ordered + 1], paths[-1]):
        shutil.copy(p, os.path.join(sub, "keyframe_point_cloud"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        bcm.run_batch_cloud_manip(sub, batch_size=4, device="cpu")
    on_cpu = files(sub)
    differ = sorted(k for k in on_cpu if on_cpu[k] != exact.get(k))
    if differ or len(on_cpu) != 12:
        raise AssertionError(f"batch_cloud_manip: CPU run differs from the card's tree in "
                             f"{differ[:5]}")
    print(f"batch_cloud_manip: card tree byte-identical to the CPU run on 4 clouds "
          f"({len(on_cpu)} files, CPU {time.perf_counter() - t0:.1f} s)")
    # and of every cloud, in the card run's batches of 8
    whole = os.path.join(base, "cpu_all")
    os.makedirs(os.path.join(whole, "keyframe_point_cloud"))
    for p in paths:
        shutil.copy(p, os.path.join(whole, "keyframe_point_cloud"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        bcm.run_batch_cloud_manip(whole, batch_size=8, device="cpu")
    on_cpu = files(whole)
    differ = (sorted(k for k in exact if exact[k] != on_cpu.get(k))
              + sorted(set(on_cpu) - set(exact)))
    if differ:
        raise AssertionError(f"batch_cloud_manip: the whole CPU run differs from the card's tree "
                             f"in {differ[:5]}")
    print(f"batch_cloud_manip: card tree byte-identical to the CPU run of all {len(paths)} "
          f"clouds ({len(on_cpu)} files, CPU {time.perf_counter() - t0:.1f} s)")

    # --- 11d. every written float BEV against the native oracle ------------
    bad = 0
    for p in paths:
        short = os.path.basename(p)[:-4]
        data, _ = read_pcd(os.path.join(trees["bitexact"], "non_ground_point_cloud",
                                        short + ".pcd"))
        want = oracle.float_bev(lib, np.stack([data["x"], data["y"], data["z"]], 1),
                                data["label"].astype(np.int32), True)
        bad += exact[f"output_bvm/{short}.csv"] != csvfmt.format_csv_bytes(want)
        bad += exact[f"output_bvm/{short}.png"] != encode_gray_png(want)
    print(f"batch_cloud_manip: {len(paths)} float BEVs against the native oracle (CSV and PNG "
          f"bytes): {bad} files differ")
    if bad:
        raise AssertionError("batch_cloud_manip: float BEV files differ from the oracle's")

    # --- 11e. cloud_manip on one drive cloud --------------------------------
    pcd, args = paths[n_ordered], ["1.5", "-2.0", "0.25", "30.0"]
    outs = {}
    for kind in ("cuda", "cpu"):
        d = os.path.join(base, f"cloud_manip_{kind}")
        os.makedirs(d)
        t0 = time.perf_counter()
        for view in ("top", "front"):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cm_cli.main([pcd, *args, f"--output_dir={d}",
                                  f"--snapshot={os.path.join(d, view + '.png')}",
                                  f"--snapshot-view={view}",
                                  f"--html={os.path.join(d, 'scene.html')}",
                                  f"--device={dev.type if kind == 'cuda' else 'cpu'}"])
            if rc != 0:
                raise AssertionError(f"cloud_manip on the {kind} exited {rc}")
        outs[kind] = ({n: open(os.path.join(d, n), "rb").read() for n in os.listdir(d)},
                      time.perf_counter() - t0)
    names = sorted(outs["cuda"][0])
    if len(names) != 9 or outs["cuda"][0] != outs["cpu"][0]:
        raise AssertionError(f"cloud_manip: card files differ from the CPU run's in "
                             f"{[n for n in names if outs['cuda'][0][n] != outs['cpu'][0].get(n)]}")
    matrix = make_rigid_transform(1.5, -2.0, 0.25, 30.0 / 180.0 * math.pi)
    on_card, on_host = load_cloud_pcd(pcd, device=dev), load_cloud_pcd(pcd, device="cpu")
    moved = transform_cloud(on_card, matrix).xyz.cpu()
    moved_cpu = transform_cloud(on_host, matrix).xyz
    n_bad = int((moved.view(torch.int32) != moved_cpu.view(torch.int32)).sum())
    cublas_bad = int((transform_xyz(on_card.xyz, matrix.to(dev)).cpu().view(torch.int32)
                      != transform_xyz(on_host.xyz, matrix).view(torch.int32)).sum())
    print(f"cloud_manip ({on_host.count} points, both views, HTML): {len(names)} files "
          f"byte-equal to the CPU run ({names}); card {outs['cuda'][1]:.3f} s, CPU "
          f"{outs['cpu'][1]:.3f} s for the two runs; transform_cloud card against CPU: "
          f"{n_bad} of {moved.numel()} coordinates differ (transform_xyz, the registration's "
          f"cuBLAS product: {cublas_bad}); card {smi}")
    if n_bad:
        raise AssertionError("cloud_manip: the moved cloud differs between card and CPU")
    shutil.rmtree(base)
    return bcm_launches


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def pca_moments_cases(xyz: torch.Tensor, keep: torch.Tensor) -> list:
    """Phase 12a's inputs: (name, rows, mask) — the filtered cloud, ragged
    sizes, all masked, and NaN and ±inf rows."""
    dev = xyz.device
    rng = np.random.default_rng(12)
    cases = [(f"HDL-64E cloud, filtered ({xyz.shape[0]:,} rows, {int(keep.sum()):,} kept)",
              xyz, keep),
             ("HDL-64E cloud, all masked", xyz, torch.zeros_like(keep))]
    for n in (1, 31, 32, 33, 4097):
        rows = torch.from_numpy((rng.normal(size=(n, 3)) * 20).astype(np.float32)).to(dev)
        cases.append((f"N = {n}", rows, torch.from_numpy(rng.random(n) < 0.7).to(dev)))
    dirty = xyz[:20000].clone()
    dirty[5, 0], dirty[9, 1] = float("nan"), float("inf")
    dirty[11, 0], dirty[19990] = -float("inf"), float("nan")
    for name, m in (("NaN and ±inf rows, kept", torch.ones_like(keep[:20000])),
                    ("NaN and ±inf rows, masked", torch.zeros_like(keep[:20000]))):
        cases.append((name, dirty, m))
    return cases


def pca_phase(dev: torch.device, smi: str, clock_mhz: float) -> dict:
    """Phase 12 (module docstring).  Returns the ``kernels`` entry of
    ``pca_moments``."""
    from pctpu_torch.cli import batch_multi_bev_gen as bev_cli
    from pctpu_torch.cli import kitti_point_cloud_select as kitti_cli
    from pctpu_torch.cli import kitti_raw_point_cloud_select as kitti_raw_cli
    from pctpu_torch.cli import mulran_point_cloud_select as mulran_cli
    from pctpu_torch.cli import oxford_point_cloud_select as oxford_cli
    from pctpu_torch.cli import pointcloud_pca_test as pca_cli
    from pctpu_torch.cli import top_part_registration as tp_cli
    from pctpu_torch.config import GroundConfig
    from pctpu_torch.experiments import scene
    from pctpu_torch.experiments.card import cuda_ms, pca_moments_bound, profile_calls
    from pctpu_torch.io.html_viewer import read_back_layers
    from pctpu_torch.io.pcd import load_cloud_pcd, write_pcd
    from pctpu_torch.io.png import decode_rgb_png
    from pctpu_torch.ops import _cuda, pca
    from pctpu_torch.ops.preprocess import order_and_mark_ground
    from pctpu_torch.pipelines.batch_cloud_manip import HDL64E
    from pctpu_torch.pipelines.multi_bev import _to_device
    from pctpu_torch.runtime.loader import load_xyzirct_arrays, stack_batch

    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke_pca")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)

    # --- 12a. pca_moments against its twin ----------------------------------
    # one HDL-64E cloud of the ray-cast drive, ground-marked by the port;
    # the demo keeps label > 0, so non-ground points take label 1
    raw = scene.multi_bev_tree(os.path.join(base, "drive"), HDL64E, n_ordered=1, n_raw=0,
                               n_over=0, seed=12)[0]
    labeled = order_and_mark_ground(
        _to_device(stack_batch([load_xyzirct_arrays(raw, HDL64E.grid_size)]), dev),
        HDL64E, GroundConfig())
    f = {k: getattr(labeled, k)[0].cpu().numpy() for k in ("xyz", "intensity", "row", "col",
                                                            "t", "label")}
    pcd = os.path.join(base, "labeled.pcd")
    write_pcd(pcd, {"x": f["xyz"][:, 0], "y": f["xyz"][:, 1], "z": f["xyz"][:, 2],
                    "intensity": f["intensity"], "row": f["row"].astype(np.uint16),
                    "col": f["col"].astype(np.uint16), "t": f["t"].astype(np.uint32),
                    "label": np.where(f["label"] == -2, 1, f["label"]).astype(np.int16)})
    cloud = load_cloud_pcd(pcd, device=dev)
    xyz, keep = pca.pca_test_filter(cloud)
    print(f"pointcloud_pca_test cloud: {cloud.count:,} points, {int((f['label'] == 0).sum()):,} "
          f"ground, {int(keep.sum()):,} kept by the filter")
    err = 0.0
    for name, rows, m in pca_moments_cases(xyz, keep):
        t0 = time.perf_counter()
        want = pca.pca_moments_reference(rows, m)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        err = max(err, compare(f"pca_moments {name}, kernel against twin",
                               pca.pca_moments(rows, m), want))
        if name.startswith("HDL-64E cloud, filtered"):
            twin_ms = twin_s * 1e3
    n = xyz.shape[0]
    lib = _cuda.library()
    out = torch.empty(12, dtype=torch.float32, device=dev)
    scratch = torch.empty(pca.scratch_words(n), dtype=torch.float32, device=dev)
    stream = _cuda.stream_ptr(dev)

    def alone():
        lib.pctpu_pca_moments(xyz.data_ptr(), keep.data_ptr(), n, scratch.data_ptr(),
                              out.data_ptr(), stream)

    def library_call():
        w = keep.to(torch.float32)[:, None]
        count = torch.clamp_min(w.sum(), 1.0)
        d = (xyz - (xyz * w).sum(0) / count) * w
        return torch.matmul(d.T, d) / count

    # in turns: kernel, wrapper, library, library, wrapper, kernel
    timed = {"alone": [], "wrapper": [], "library": []}
    for key in ("alone", "wrapper", "library", "library", "wrapper", "alone"):
        fn = {"alone": alone, "wrapper": lambda: pca.pca_moments(xyz, keep),
              "library": library_call}[key]
        timed[key].append(cuda_ms(fn, reps=20))
    ms = {k: min(v) for k, v in timed.items()}
    kernels, copies, by_kernel = profile_calls(alone, reps=10)
    live = int(pca.live_rows(xyz, keep, pca.pca_moments(xyz, keep)[0]).sum())
    bound = pca_moments_bound(n, live, clock_mhz)
    print(f"  pca_moments at {n:,} rows: {ms['alone']:.4f} ms alone, {ms['wrapper']:.4f} with "
          f"its wrapper, kernel-only {sum(by_kernel.values()):.6f} ms "
          f"{ {k: round(v, 6) for k, v in by_kernel.items()} } ({kernels} kernels + {copies} "
          f"copies a call); twin {twin_ms:.1f} ms; library "
          f"((xyz·w).sum + torch.matmul(dᵀ, d)) {ms['library']:.4f} ms; bound "
          f"{bound['ms']:.6f} ms ({bound['by']}: {bound['chain']:,} dependent operations, "
          f"{live:,} live rows, at {clock_mhz:.0f} MHz; bytes {bound['bytes']:,} B = "
          f"{bound['bytes'] / 3.35e12 * 1e3:.6f} ms), reached "
          f"{bound['ms'] / ms['alone']:.4f}; card {smi}")

    # --- 12b. pointcloud_pca_test, card against CPU --------------------------
    outs, launches = {}, {}
    for kind in ("cuda", "cpu"):
        files, walls = {}, []
        for view in ("top", "front"):
            png, html = os.path.join(base, f"{kind}_{view}.png"), os.path.join(base, f"{kind}.html")
            captured = io.StringIO()
            if kind == "cuda":
                _cuda.reset_launch_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(captured), contextlib.redirect_stderr(io.StringIO()):
                rc = pca_cli.main([pcd, f"--snapshot={png}", f"--snapshot-view={view}",
                                   f"--html={html}",
                                   f"--device={dev.type if kind == 'cuda' else 'cpu'}"])
            if kind == "cuda":
                torch.cuda.synchronize()
                launches = dict(_cuda.launch_counts)
            walls.append(time.perf_counter() - t0)
            if rc != 0:
                raise AssertionError(f"pointcloud_pca_test --device={kind} exited {rc}")
            files[f"stdout {view}"] = captured.getvalue().encode()
            files[f"{view}.png"] = open(png, "rb").read()
            files["html"] = open(html, "rb").read()
        outs[kind] = (files, walls)
    require_launched(launches, ("pca_moments",), "pointcloud_pca_test --device=cuda")
    differ = [k for k in outs["cuda"][0] if outs["cuda"][0][k] != outs["cpu"][0][k]]
    if differ:
        raise AssertionError(f"pointcloud_pca_test: the card's {differ} differ from the CPU's")
    print(outs["cuda"][0]["stdout top"].decode(), end="")
    print(f"pointcloud_pca_test: stdout, both snapshot views and the HTML viewer byte-equal "
          f"card against CPU; wall a run (top, front) card {outs['cuda'][1][0]:.3f} / "
          f"{outs['cuda'][1][1]:.3f} s, CPU {outs['cpu'][1][0]:.3f} / {outs['cpu'][1][1]:.3f} "
          f"s; hand-kernel launches a card run {nonzero(launches)}; card {smi}")

    # --- 12c. top_part_registration on pair 0 -> 1 of the registration tree --
    tree = os.path.join(base, "registration")
    scene.registration_tree(tree)
    q_i, m_i, off = scene.TREE_PAIRS[0]
    truth = scene.TREE_POSES[m_i] @ np.linalg.inv(scene.TREE_POSES[q_i])
    guess = f"{np.degrees(np.arctan2(truth[1, 0], truth[0, 0])) + off:.3f}"
    clouds = [os.path.join(tree, "clouds", f"{k:06d}.pcd") for k in (q_i, m_i)]
    runs = {}
    for kind in ("cuda", "cuda", "cpu"):  # the first card run warms up
        png, html = os.path.join(base, f"tp_{kind}.png"), os.path.join(base, f"tp_{kind}.html")
        captured = io.StringIO()
        if kind == "cuda":
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = tp_cli.main([*clouds, guess, f"--snapshot={png}", f"--html={html}",
                              f"--device={dev.type if kind == 'cuda' else 'cpu'}"])
        if kind == "cuda":
            torch.cuda.synchronize()
            tp_launches = dict(_cuda.launch_counts)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"top_part_registration --device={kind} exited {rc}")
        log = captured.getvalue()
        nums = [float(v) for v in re.findall(r"-?\d+\.\d*(?:e[-+]\d+)?", log.split(
            "is icp converged:")[1])]
        fine = np.array(nums[1:17]).reshape(4, 4)
        stage = dict(re.findall(r"\[TIME\] (\d)\S* stage .*?: ([0-9.eE+-]+)ms", log))
        runs[kind] = (decode_rgb_png(open(png, "rb").read()), read_back_layers(html), fine,
                      wall, stage, "is icp converged: True" in log)
    require_launched(tp_launches, ("nn_prep", "nn_pruned", "nn_prep_batched",
                                   "nn_pruned_batched", "segment_sum4"),
                     "top_part_registration --device=cuda")
    for kind in ("cuda", "cpu"):
        yaw_err, t_err = pose_error(runs[kind][2], truth)
        print(f"top_part_registration {q_i}->{m_i} --device={kind} (guess {guess}°): converged "
              f"{runs[kind][5]}, yaw error {yaw_err:.6f} deg, translation error {t_err:.6f} m; "
              f"[TIME] coarse {runs[kind][4]['1']} ms, fine {runs[kind][4]['2']} ms; wall "
              f"{runs[kind][3]:.3f} s")
        if not (runs[kind][5] and yaw_err < 0.5 and t_err < 0.10):
            raise AssertionError(f"top_part_registration --device={kind} off the truth")
    img_c, img_h = runs["cuda"][0], runs["cpu"][0]
    pixels = int((img_c != img_h).any(-1).sum())
    lay_c, lay_h = runs["cuda"][1], runs["cpu"][1]
    ends = {k: (lay_c[k].shape, lay_h[k].shape,
                float(np.abs(lay_c[k] - lay_h[k]).max()) if lay_c[k].shape == lay_h[k].shape
                else None) for k in lay_h}
    whiskers = lay_h["normals"].shape[0] // 2
    moved = (int((np.abs(lay_c["normals"] - lay_h["normals"]) > 0).any(-1).sum())
             if ends["normals"][2] is not None else None)
    print(f"top_part_registration snapshot, card against CPU: {pixels} of {img_h.shape[0] * img_h.shape[1]:,} "
          f"pixels differ; HTML layers (shape card, shape CPU, max |Δ|): {ends}; "
          f"{moved} of {2 * whiskers} whisker endpoints differ (D3/D5: the normals' radius "
          f"membership on the card's matmul, the voxel centroids bit-equal); hand-kernel "
          f"launches {nonzero(tp_launches)}; card {smi}")
    if ends["original_cloud"][2] != 0.0:
        raise AssertionError("top_part_registration: the flat cloud differs card against CPU")

    # --- 12d. the selectors into batch_multi_bev_gen -------------------------
    def digest(root: str) -> dict[str, str]:
        import hashlib

        return {k: hashlib.sha256(v).hexdigest()[:16]
                for k, v in sorted(tree_files(root, ("keyframe_point_cloud", "keyframe_pose.csv",
                                                     "keyframe_pose_format.csv")).items())}

    for name, make, select, sensor in (
            ("kitti", scene.kitti_tree, kitti_cli, "HDL_64E"),
            ("mulran", scene.mulran_tree, mulran_cli, "OS1_64")):
        src = os.path.join(base, name)
        make(src)
        with contextlib.redirect_stdout(io.StringIO()):
            if select.main([src]) != 0:
                raise AssertionError(f"{name} selector failed")
        keyframes = os.path.join(src, "selected_keyframes_2.00m")
        trees = {}
        for kind in ("cuda", "cpu"):
            work = os.path.join(base, f"{name}_{kind}")
            shutil.copytree(keyframes, work)
            if kind == "cuda":
                _cuda.reset_launch_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = bev_cli.main([work, sensor,
                                   f"--device={dev.type if kind == 'cuda' else 'cpu'}"])
            if kind == "cuda":
                torch.cuda.synchronize()
                bev_launches = dict(_cuda.launch_counts)
            if rc != 0:
                raise AssertionError(f"batch_multi_bev_gen {sensor} --device={kind} exited {rc}")
            trees[kind] = (tree_files(work), time.perf_counter() - t0)
        require_launched(bev_launches, ("bev_raster", "ground_sums"),
                         f"batch_multi_bev_gen {sensor} on the {name} selection")
        card, cpu = trees["cuda"][0], trees["cpu"][0]
        differ = sorted(k for k in card if card[k] != cpu.get(k)) + sorted(set(cpu) - set(card))
        if differ or not card:
            raise AssertionError(f"{name} -> batch_multi_bev_gen: card tree differs from the "
                                 f"CPU's in {differ[:5]}")
        print(f"{name} selector -> batch_multi_bev_gen {sensor}: {len(card)} files byte-equal "
              f"card against CPU (card {trees['cuda'][1]:.3f} s, CPU {trees['cpu'][1]:.3f} s); "
              f"selection {digest(keyframes)}; hand-kernel launches {nonzero(bev_launches)}")
    for name, make, select, sub in (
            ("oxford", scene.oxford_tree, oxford_cli, "selected_keyframes_2.00m"),
            ("kitti_raw", lambda root: scene.kitti_tree(root, raw=True), kitti_raw_cli,
             "selected_keyframes")):
        src = os.path.join(base, name)
        make(src)
        with contextlib.redirect_stdout(io.StringIO()):
            if select.main([src]) != 0:
                raise AssertionError(f"{name} selector failed")
        print(f"{name} selector: {digest(os.path.join(src, sub))}")
    shutil.rmtree(base)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return {"name": "pca_moments", "route": "cuda", "source": "pctpu_torch/csrc/pca_moments.cu",
            "replaces": "pctpu/ops/pca.py:40-43", "launches": launches["pca_moments"],
            "max_abs_err": err, "ms": ms["alone"], "plain_ms": twin_ms,
            "bound_ms": bound["ms"], "bound_by": "bytes" if bound["by"] == "bytes" else "operations",
            "library_ms": ms["library"], "bound_detail": bound["by"],
            "wrapper_ms": ms["wrapper"]}


def run_logged(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, log)."""
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        out = fn(*args)
    return out, captured.getvalue()


def pair_batched_phase(dev: torch.device, smi: str, capacity: int = 65536) -> tuple[dict, dict]:
    """Phase 10 (module docstring).  Returns the launch counts of the
    top-part CLI's run at ``--pair-batch=16`` (the path's run) and, on a
    card, of the same run with the ICP's batched pass swapped for the first
    warp design's (``nn_1_pruned_batched_v1``), whose pairs must be bit-equal
    to the path's."""
    from torch.profiler import ProfilerActivity, profile

    from pctpu_torch.cli import batch_top_part_registration as top_cli
    from pctpu_torch.cli import batch_whole_registration as whole_cli
    from pctpu_torch.experiments.scene import TREE_PAIRS_20, TREE_POSES, registration_tree
    from pctpu_torch.ops import _cuda, cuda_knn, icp
    from pctpu_torch.pipelines import registration
    from pctpu_torch.runtime import profiler

    tree = os.path.join(ROOT, "build", "chip_smoke_batched")
    shutil.rmtree(tree, ignore_errors=True)
    registration_tree(tree)
    clouds = os.path.join(tree, "clouds")
    match = os.path.join(tree, "match_result_20.txt")
    n = len(TREE_PAIRS_20)
    chunks = [min(16, n - k) for k in range(0, n, 16)]
    specs, whole_calls, seq_fine = [], [], []
    real = {"spec": registration.BucketSpec, "whole": registration.register_whole_pairs,
            "icp": registration.icp_point_to_point, "top": top_cli.run_batch_top_part_registration,
            "pass": icp.nn_1_pruned_batched}

    class Spec(real["spec"]):
        def __init__(self):
            super().__init__()
            specs.append(self)

    def whole_pairs(*args, **kwargs):
        out = real["whole"](*args, **kwargs)
        whole_calls.append(out)
        return out

    def point_to_point(*args, **kwargs):
        out = real["icp"](*args, **kwargs)
        seq_fine.append(out.numpy())
        return out

    reports = []

    def top_run(*args, **kwargs):
        reports.append(real["top"](*args, **kwargs))
        return reports[-1]

    registration.BucketSpec = Spec
    registration.register_whole_pairs = whole_pairs
    registration.icp_point_to_point = point_to_point
    top_cli.run_batch_top_part_registration = top_run

    def run(kind: str, batch: int, match_file: str = match, tag: str = "run"):
        """One CLI run: (wall s, launch counts, log, per-pair (success,
        fitness, transform), report path)."""
        report = os.path.join(tree, f"{kind}_{batch}_{tag}.txt")
        argv = [match_file, clouds, f"--report={report}", f"--capacity={capacity}",
                f"--pair-batch={batch}", f"--device={dev.type}"]
        whole_calls.clear()
        seq_fine.clear()
        reports.clear()
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "top":
            rc, log = run_logged(top_cli.main, argv + ["--flat-cap=32768"])
        else:
            rc, log = run_logged(whole_cli.main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{kind} CLI at --pair-batch={batch} exited {rc}")
        if kind == "top":
            pairs = [(r.success, r.fitness_fine, r.transform_fine) for r in reports[-1]]
        elif batch > 1:
            got = [r for call, size in zip(whole_calls, chunks) for r in call[:size]]
            pairs = [(float(r.fitness) <= 1.5, float(r.fitness), r.transform) for r in got]
        else:
            pairs = [(float(r.fitness) <= 1.5, float(r.fitness), r.transform) for r in seq_fine]
        return wall, dict(_cuda.launch_counts), log, pairs, report

    try:
        # warm-up: both CLIs at both batch sizes on the one-pair list
        for kind in ("top", "whole"):
            for batch in (16, 1):
                run(kind, batch, os.path.join(tree, "warmup.txt"), "warm")
        results = {}
        for kind in ("top", "whole"):
            for batch in (16, 1, 1, 16):  # in turns
                wall, launches, log, pairs, report = run(kind, batch)
                if (kind, batch) not in results or wall < results[kind, batch]["wall"]:
                    results[kind, batch] = {"wall": wall, "launches": launches, "log": log,
                                            "pairs": pairs, "report": report}
        # the first warp design on the same path: the ICP's batched pass
        # swapped for it (it has no CPU mode, so a CPU rehearsal skips this)
        first = None
        if dev.type == "cuda":
            icp.nn_1_pruned_batched = cuda_knn.nn_1_pruned_batched_v1
            try:
                first = run("top", 16, tag="v1")
            finally:
                icp.nn_1_pruned_batched = real["pass"]
        # untimed: host syncs (torch's sync debug mode), ICP iterations and
        # every kernel the card ran (torch.profiler)
        counted = {}
        for kind in ("top", "whole"):
            for batch in (16, 1):
                with warnings.catch_warnings(record=True) as caught, profile(
                        activities=[ProfilerActivity.CUDA]) as prof, \
                        profiler.recording() as rec:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode(1)
                    try:
                        run(kind, batch, tag="counted")
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                # each sync by the line of the port that made it
                sites = collections.Counter(
                    f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message))
                events = [e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset"))]
                counted[kind, batch] = {
                    "syncs": sum(sites.values()), "kernels": len(events), "sites": sites,
                    "loop_syncs": sum(v for k, v in sites.items()
                                      if k.startswith(os.path.join("pctpu_torch", "ops", "icp.py"))),
                    "iterations": rec.total("icp.iterations"),
                    "problem_iterations": rec.total("icp.problem_iterations")}
    finally:
        registration.BucketSpec = real["spec"]
        registration.register_whole_pairs = real["whole"]
        registration.icp_point_to_point = real["icp"]
        top_cli.run_batch_top_part_registration = real["top"]

    def relative(q_i: int, m_i: int) -> np.ndarray:
        return TREE_POSES[m_i] @ np.linalg.inv(TREE_POSES[q_i])

    first_launches = {}
    if first is not None:
        wall, first_launches, _, pairs, report = first
        require_launched(first_launches, ("nn_pruned_batched_v1",), "the top-part CLI at "
                         "--pair-batch=16 on the first warp design")
        want = results["top", 16]["pairs"]
        same = all(a[0] == b[0] and a[1] == b[1] and np.array_equal(
            np.asarray(a[2]).view(np.uint32), np.asarray(b[2]).view(np.uint32))
            for a, b in zip(pairs, want))
        if first_launches.get("nn_pruned_batched") or len(pairs) != n or not same:
            raise AssertionError("the top-part CLI at --pair-batch=16 on the first warp design: "
                                 f"pairs differ from the work-list design's, or launches "
                                 f"{nonzero(first_launches)}")
        lines = [open(r).read().splitlines() for r in (report, results["top", 16]["report"])]
        print(f"batch_top_part_registration --pair-batch=16 on the first warp design (ICP's "
              f"batched pass nn_1_pruned_batched_v1): {n} pairs in {wall:.3f} s = "
              f"{n / wall:.4f} pairs/s (one untimed-order run, after the turns); successes, "
              f"fitnesses and transforms bit-equal to the work-list design's, "
              f"{sum(a == b for a, b in zip(*lines))} of {len(lines[0])} report lines "
              f"byte-equal; launches {nonzero(first_launches)}; card {smi}")

    for kind in ("top", "whole"):
        one, many = results[kind, 1], results[kind, 16]
        for batch, res in ((1, one), (16, many)):
            if len(res["pairs"]) != n or "count_failure: 0," not in res["log"]:
                raise AssertionError(f"{kind} at --pair-batch={batch}: not every pair succeeded")
            for (q_i, m_i, _), (ok, _, tf) in zip(TREE_PAIRS_20, res["pairs"]):
                yaw_err, t_err = pose_error(tf, relative(q_i, m_i))
                if not (ok and np.all(np.isfinite(tf)) and yaw_err < 0.5 and t_err < 0.10):
                    raise AssertionError(f"{kind} pair {q_i}->{m_i} at --pair-batch={batch} off "
                                         f"the truth: {yaw_err} deg, {t_err} m")
        if [p[0] for p in one["pairs"]] != [p[0] for p in many["pairs"]]:
            raise AssertionError(f"{kind}: classification differs between 1 and 16")
        require_launched(many["launches"], ("nn_prep_batched", "nn_pruned_batched",
                                            "segment_sum4"), f"the {kind} CLI at --pair-batch=16")
        delta = max(float(np.abs(a[2] - b[2]).max()) for a, b in zip(one["pairs"], many["pairs"]))
        if kind == "top":
            lines = [open(r["report"]).read().splitlines() for r in (one, many)]
            equal = f"{sum(a == b for a, b in zip(*lines))} of {len(lines[0])} report lines " \
                    "byte-equal"
        else:
            equal = f"{sum(a[1] == b[1] for a, b in zip(one['pairs'], many['pairs']))} of {n} " \
                    "fine fitnesses equal"
        name = {"top": "batch_top_part_registration", "whole": "batch_whole_registration"}[kind]
        for batch, res in ((1, one), (16, many)):
            c = counted[kind, batch]
            times = ", ".join(f"{s} {float(v):.3f}" for s, v in re.findall(
                r"\[TIME\] Avg Tiempo for \S+ Stage \((\w+)\): ([0-9.eE+-]+)", res["log"]))
            hand = {k: v for k, v in res["launches"].items() if v}
            print(f"{name} --pair-batch={batch}: {n} pairs in {res['wall']:.3f} s = "
                  f"{n / res['wall']:.4f} pairs/s (the faster of two turns); [TIME] ms per pair "
                  f"{times}; host syncs {c['syncs']} = {c['syncs'] / n:.2f} a pair, of them in "
                  f"ops/icp.py {c['loop_syncs']} = {c['loop_syncs'] / max(c['iterations'], 1):.3f} "
                  f"per batch iteration ({c['iterations']} batch iterations, "
                  f"{c['problem_iterations']} problem iterations), by line "
                  f"{dict(c['sites'].most_common(8))}; kernels on the card {c['kernels']} = "
                  f"{c['kernels'] / n:.1f} a pair, "
                  f"{c['kernels'] / max(c['problem_iterations'], 1):.1f} a problem iteration; "
                  f"hand-kernel launches {hand}; card {smi}")
        print(f"{name}: every pair within 0.5 deg / 0.10 m at 1 and 16, same classification; "
              f"{equal}; largest |transform delta| between 1 and 16 {delta:.3e}"
              + (f"; BucketSpec hits {specs[-1].hits}, misses {specs[-1].misses} in one run "
                 f"of {len(chunks)} batches" if kind == "top" and specs else ""))
    shutil.rmtree(tree)
    return results["top", 16]["launches"], first_launches


CAMPAIGN_ARGV = ["--start=3000000", "--cases=20", "--sensors", "--native=50", "--adversarial=6",
                 "--misc=10", "--normals=10", "--icp=6", "--twostage=16", "--kitti-raw=10"]
CAMPAIGN_LEGS = ("preprocess", "voxel", "topflatten", "sensors", "native", "adversarial", "misc",
                 "normals", "icp", "twostage", "kitti_raw")
CAMPAIGN_KERNELS = ("bev_raster", "ground_sums", "segment_sum4", "nn_prep", "nn_pruned",
                    "nn_prep_batched", "nn_pruned_batched")


def campaign_phase(dev: torch.device, smi: str, argv=CAMPAIGN_ARGV) -> dict:
    """Phase 14: the campaign on the card; returns its launch counts."""
    from pctpu_torch.experiments import fuzz_campaign
    from pctpu_torch.ops import _cuda

    captured = io.StringIO()
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        summary = fuzz_campaign.run([*argv, f"--device={dev.type}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launch_counts)
    log = captured.getvalue().splitlines()
    for line in log:
        if line.startswith(("FAIL", "KNIFE", "leg ", "DONE", "icp ", "twostage: asserted",
                            "fuzz campaign")):
            print(f"  {line}")
    ran = {k for k, t in summary["legs"].items() if t["cases"]}
    if set(CAMPAIGN_LEGS) - ran:
        raise AssertionError(f"campaign legs that ran no case: {sorted(set(CAMPAIGN_LEGS) - ran)}")
    unattributed = [line for line in log if line.startswith("KNIFE")
                    and not re.match(r"KNIFE \S+ seed=.* D\d+ \S", line)]
    if unattributed:
        raise AssertionError(f"KNIFE lines without a D-row: {unattributed[:3]}")
    if summary["failures"] or any(line.startswith("FAIL") for line in log):
        raise AssertionError(f"the campaign found {summary['failures']} divergences")
    require_launched(launches, CAMPAIGN_KERNELS, "the differential campaign")
    print(f"campaign: {sum(t['cases'] for t in summary['legs'].values())} cases in {wall:.1f} s, "
          f"KNIFE {summary['knife_edges']}, FAIL 0; hand-kernel launches {nonzero(launches)}; "
          f"card {smi}")
    return launches


# a fresh interpreter on the card: ``<module>.main(<warm-up argv>)`` with its
# output dropped (CUDA context, library handles, kernels loaded), the launch
# counts set to 0, then ``<module>.main(argv)``; prints the launch counts
WORKER = r"""
import contextlib, importlib, io, json, sys
sys.path.insert(0, sys.argv[1])
from pctpu_torch.ops import _cuda
cli = importlib.import_module(sys.argv[2])
warm = json.loads(sys.argv[3])
if warm:
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(warm)
_cuda.reset_launch_counts()
rc = cli.main(sys.argv[4:])
print("LAUNCHES " + json.dumps({k: v for k, v in _cuda.launch_counts.items() if v}), flush=True)
sys.exit(rc)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(module: str, runs: list, timeout: float = 300.0) -> list[tuple[str, dict]]:
    """Start one ``WORKER`` process per (warm-up argv, argv) of ``runs`` at
    once and wait for all; every one must exit 0.  Returns (output, launch
    counts) per process."""
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, ROOT, module, json.dumps(warm),
                               *argv], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for warm, argv in runs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{module} {runs} exited {p.returncode}:\n{out[-3000:]}")
    return [(out, json.loads(out.rsplit("LAUNCHES ", 1)[1].splitlines()[0])) for out in outs]


def loop_wall_s(log: str) -> tuple[int, float]:
    """(clouds converted, the loop's measured wall in s) from a
    batch_multi_bev_gen log."""
    done = sum(line.startswith("Converting file:") for line in log.splitlines())
    per = float(re.search(r"\[TIME\] Measured end-to-end loop wall: ([0-9.eE+-]+)", log).group(1))
    return done, per * done / 1e3


def parallel_phase(dev: torch.device, smi: str, n_ordered: int = 29) -> dict:
    """Phase 13 (module docstring).  Returns the hand-kernel launches of its
    mesh runs and of its two-process runs, as ``{"mesh": ..., "processes":
    ...}``, each summed over runs counted from 0 on their own."""
    from pctpu_torch.cli import batch_multi_bev_gen as bev_cli
    from pctpu_torch.cli import batch_top_part_registration as top_cli
    from pctpu_torch.cli import batch_whole_registration as whole_cli
    from pctpu_torch.config import get_sensor_params
    from pctpu_torch.experiments.scene import TREE_PAIRS_20, TREE_POSES, registration_tree
    from pctpu_torch.experiments.scene import multi_bev_tree
    from pctpu_torch.io.pcd import load_cloud_pcd
    from pctpu_torch.ops import _cuda, knn, voxel
    from pctpu_torch.parallel.mesh import make_mesh, sharded_nn_1
    from pctpu_torch.pipelines import multi_bev, registration

    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke_parallel")
    shutil.rmtree(base, ignore_errors=True)
    src = os.path.join(base, "tree")
    paths = multi_bev_tree(src, get_sensor_params("HDL_64E"), n_ordered=n_ordered, n_raw=2,
                           n_over=1)
    n_clouds = len(paths)

    def bev_tree(name: str, picked=paths) -> str:
        root = os.path.join(base, name)
        os.makedirs(os.path.join(root, "keyframe_point_cloud"))
        for p in picked:
            shutil.copy(p, os.path.join(root, "keyframe_point_cloud"))
        shutil.copy(os.path.join(src, "keyframe_pose.csv"), root)
        return root

    def same_tree(a: str, b: str, n: int, what: str) -> int:
        fa, fb = tree_files(a), tree_files(b)
        differ = sorted(k for k in fa if fa[k] != fb.get(k)) + sorted(set(fb) - set(fa))
        if differ or len(fa) != n * 28 + 1:
            raise AssertionError(f"{what}: {len(fa)} files, differs in {differ[:5]}")
        return len(fa)

    logical = make_mesh(devices=[dev] * 2)
    on = f"--device={dev.type}"
    # hand-kernel launches of the mesh runs and of the processes, each run
    # counted from 0 on its own; the unsharded references are in neither
    sharded, in_procs = collections.Counter(), collections.Counter()

    def mesh_launches(names, path: str) -> dict:
        torch.cuda.synchronize()
        launches = nonzero(_cuda.launch_counts)
        require_launched(launches, names, path)
        sharded.update(launches)
        return launches

    # --- 13a. run_multi_bev on a logical data mesh of two -------------------
    one, meshed = bev_tree("one"), bev_tree("meshed")
    timed = {}
    for root, mesh_ in ((one, None), (meshed, logical), (meshed, logical), (one, None)):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = multi_bev.run_multi_bev(root, "HDL_64E", batch_size=8, mesh=mesh_, device=dev)
        torch.cuda.synchronize()
        key = "mesh" if mesh_ else "one"
        timed[key] = min(timed.get(key, math.inf), time.perf_counter() - t0)
        if mesh_ is not None:
            mesh_launches(("bev_raster", "ground_sums"), "run_multi_bev on the mesh")
        if out.num_clouds != n_clouds:
            raise AssertionError(f"run_multi_bev ({key}) converted {out.num_clouds} clouds")
    files = same_tree(one, meshed, n_clouds, "run_multi_bev on a 2-device mesh")
    print(f"13a. run_multi_bev, {n_clouds} HDL-64E clouds at batch 8: the tree on a data mesh "
          f"[cuda:0] * 2 byte-identical to the unsharded run ({files} files); "
          f"{n_clouds / timed['one']:.4f} clouds/s unsharded, {n_clouds / timed['mesh']:.4f} "
          f"on the mesh (the faster of two, in turns); card {smi}")

    # --- 13b. batch_multi_bev_gen as two processes on the card -------------
    one_p, two_p = bev_tree("one_process"), bev_tree("two_processes")
    warm = [bev_tree(f"warm{k}", paths[:8]) for k in range(3)]
    cli = "pctpu_torch.cli.batch_multi_bev_gen"
    rates = {"one": [], "two": []}
    bev_sub = {}
    for turn in ("one", "two", "two", "one"):
        if turn == "one":
            (log, launches), = run_workers(cli, [([warm[2], "HDL_64E", on], [one_p, "HDL_64E", on])])
            done, wall = loop_wall_s(log)
            if done != n_clouds:
                raise AssertionError(f"one process converted {done} clouds")
            rates["one"].append(n_clouds / wall)
            bev_sub["one"] = launches
            continue
        coord = f"127.0.0.1:{free_port()}"
        res = run_workers(cli, [([warm[k], "HDL_64E", on],
                                 [two_p, "HDL_64E", on, "--num-processes=2", f"--process-id={k}",
                                  f"--coordinator={coord}"]) for k in (0, 1)])
        walls = [loop_wall_s(log) for log, _ in res]
        if [w[0] for w in walls] != [len(range(k, n_clouds, 2)) for k in (0, 1)]:
            raise AssertionError(f"two processes converted {[w[0] for w in walls]} clouds")
        if "One-hot label has length" in res[1][0] or "One-hot" not in res[0][0]:
            raise AssertionError("the label phase ran on the wrong process")
        rates["two"].append(n_clouds / max(w[1] for w in walls))
        bev_sub["two"] = [launches for _, launches in res]
        for _, launches in res:
            in_procs.update(launches)
    for launches in (bev_sub["one"], *bev_sub["two"]):
        require_launched(launches, ("bev_raster", "ground_sums"), "a batch_multi_bev_gen process")
    same_tree(one, one_p, n_clouds, "batch_multi_bev_gen in one process")
    files = same_tree(one, two_p, n_clouds, "batch_multi_bev_gen in two processes")
    print(f"13b. batch_multi_bev_gen --num-processes=2 on one card: the merged tree "
          f"byte-identical to the one-process run ({files} files); clouds/s, loop wall after a "
          f"warm-up, in turns: one process {rates['one']}, two processes (clouds over the slower "
          f"process's loop wall) {rates['two']}; best {max(rates['two']) / max(rates['one']):.3f}x;"
          f" launches one {bev_sub['one']}, two {bev_sub['two']}; card {smi}")

    # --- 13c. both registration drivers on a data mesh and in two processes --
    rtree = os.path.join(base, "registration")
    registration_tree(rtree)
    clouds = os.path.join(rtree, "clouds")
    match = os.path.join(rtree, "match_result_20.txt")
    common = ["--capacity=65536", "--pair-batch=16", on]
    whole_seen: list = []
    real = {"mesh": registration.make_mesh, "whole": registration.register_whole_pairs}

    def whole_pairs(*args, **kwargs):
        out = real["whole"](*args, **kwargs)
        whole_seen.extend(out)
        return out

    def relative(q_i: int, m_i: int) -> np.ndarray:
        return TREE_POSES[m_i] @ np.linalg.inv(TREE_POSES[q_i])

    def check_pairs(what: str, transforms) -> None:
        if len(transforms) != len(TREE_PAIRS_20):
            raise AssertionError(f"{what}: {len(transforms)} pairs")
        for (q_i, m_i, _), tf in zip(TREE_PAIRS_20, transforms):
            yaw_err, t_err = pose_error(tf, relative(q_i, m_i))
            if not (np.all(np.isfinite(tf)) and yaw_err < 0.5 and t_err < 0.10):
                raise AssertionError(f"{what}: pair {q_i}->{m_i} off by {yaw_err} deg, {t_err} m")

    # a logical mesh of two in the drivers' --devices=2 place
    registration.make_mesh = lambda n_data, devices=None: make_mesh(devices=[dev] * n_data)
    registration.register_whole_pairs = whole_pairs
    reg_runs = {}
    try:
        for kind in ("top", "whole"):
            for devices in (None, 2, 2, None):  # in turns; the first is the warm-up
                report = os.path.join(rtree, f"{kind}_{devices}.txt")
                whole_seen.clear()
                kw = dict(report_path=report, capacity=65536, pair_batch=16, devices=devices,
                          device=dev)
                torch.cuda.synchronize()
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as log:
                    if kind == "top":
                        out = registration.run_batch_top_part_registration(
                            match, clouds, flat_cap=32768, **kw)
                        tfs = [r.transform_fine for r in out]
                    else:
                        registration.run_batch_whole_registration(match, clouds, **kw)
                        # two calls of 16: the second's last 12 are the tail's padding
                        tfs = [r.transform for r in whole_seen[:20]]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if devices is not None:
                    mesh_launches(("nn_prep_batched", "nn_pruned_batched", "segment_sum4"),
                                  f"the {kind} driver on the mesh")
                check_pairs(f"{kind} devices={devices}", tfs)
                if (kind, devices) in reg_runs:  # the second turn: the faster of the two
                    wall = min(wall, reg_runs[kind, devices]["wall"])
                reg_runs[kind, devices] = {"wall": wall, "report": report,
                                           "log": log.getvalue(), "tfs": tfs}
    finally:
        registration.make_mesh = real["mesh"]
        registration.register_whole_pairs = real["whole"]
    top_lines = {d: open(reg_runs["top", d]["report"]).read().splitlines() for d in (None, 2)}
    if top_lines[None] != top_lines[2] or len(top_lines[None]) != len(TREE_PAIRS_20):
        differ = [(a, b) for a, b in zip(top_lines[None], top_lines[2]) if a != b]
        deltas = {kind: [float(np.abs(a - b).max()) for a, b in
                         zip(reg_runs[kind, None]["tfs"], reg_runs[kind, 2]["tfs"])]
                  for kind in ("top", "whole")}
        raise AssertionError(f"top-part report on the mesh differs from the unsharded report in "
                             f"{len(differ)} of {len(top_lines[None])} lines {differ}; transform "
                             f"deltas by pair {deltas}")
    for kind in ("top", "whole"):
        if "count_failure: 0," not in reg_runs[kind, 2]["log"]:
            raise AssertionError(f"{kind} on the mesh: a pair failed")
        deltas = [float(np.abs(a - b).max())
                  for a, b in zip(reg_runs[kind, None]["tfs"], reg_runs[kind, 2]["tfs"])]
        if max(deltas) != 0.0:
            raise AssertionError(f"{kind}: the transforms on the mesh differ from the unsharded "
                                 f"ones, by pair {deltas}")

    def fitnesses(log: str) -> list[str]:
        return re.findall(r"fitness score: ([0-9.eE+-]+|nan|inf)", log)

    whole_fit = fitnesses(reg_runs["whole", None]["log"])
    if len(whole_fit) != len(TREE_PAIRS_20) or fitnesses(reg_runs["whole", 2]["log"]) != whole_fit:
        raise AssertionError("whole-cloud fitness lines on the mesh differ from the unsharded run")
    # two processes, each its strided ten pairs
    top_mod, whole_mod = ("pctpu_torch.cli.batch_top_part_registration",
                          "pctpu_torch.cli.batch_whole_registration")
    reg_sub = {}
    for kind, module in (("top", top_mod), ("whole", whole_mod)):
        coord = f"127.0.0.1:{free_port()}"
        report = os.path.join(rtree, f"{kind}_mp.txt")
        extra = ["--flat-cap=32768"] if kind == "top" else []
        res = run_workers(module, [([], [match, clouds, f"--report={report}", *common, *extra,
                                         "--num-processes=2", f"--process-id={k}",
                                         f"--coordinator={coord}"]) for k in (0, 1)])
        for k, (log, launches) in enumerate(res):
            if "count_success: 10, count_failure: 0," not in log:
                raise AssertionError(f"{kind} process {k}: not every pair succeeded")
            require_launched(launches, ("nn_prep_batched", "nn_pruned_batched", "segment_sum4"),
                             f"the {kind} CLI as process {k}")
            in_procs.update(launches)
        reg_sub[kind] = [launches for _, launches in res]
        progress = [open(f"{report}.shard{k}.progress").read().splitlines() for k in (0, 1)]
        merged = [line for pair in zip(*progress) for line in pair]
        if merged != [f"{q} {m}" for q, m, _ in TREE_PAIRS_20]:
            raise AssertionError(f"{kind}: the shards' pairs are not the strided halves")
        if kind == "top":
            shards = [open(f"{report}.shard{k}").read().splitlines() for k in (0, 1)]
            merged = [line for pair in zip(*shards) for line in pair]
            if merged != top_lines[None]:
                raise AssertionError("top-part: the two shard reports, interleaved, differ from "
                                     "the one-process report")
        else:  # the whole driver's report is empty: its fitness lines, interleaved
            merged = [f for pair in zip(*(fitnesses(log) for log, _ in res)) for f in pair]
            if merged != whole_fit:
                raise AssertionError(f"whole-cloud: the two processes' fitness lines, interleaved,"
                                     f" differ from the one-process run's: {merged} {whole_fit}")
    print(f"13c. both registration drivers on the 20-pair list at --pair-batch=16: on a data "
          f"mesh [cuda:0] * 2 every pair within 0.5 deg / 0.10 m, the top-part report "
          f"byte-equal to the unsharded one ({len(top_lines[None])} lines), both drivers' "
          f"transforms and the whole driver's fitness lines bit-equal to the unsharded run's; "
          f"walls unsharded / mesh (the faster of two, in turns): top "
          f"{reg_runs['top', None]['wall']:.3f} / {reg_runs['top', 2]['wall']:.3f} s, whole "
          f"{reg_runs['whole', None]['wall']:.3f} / {reg_runs['whole', 2]['wall']:.3f} s; as two "
          f"processes the .shard0/.shard1 reports (top) and fitness lines (whole) interleaved = "
          f"the one-process run's, launches {reg_sub}; card {smi}")

    # --- 13d. the fine stage's search over a 'points' axis of two ----------
    c1, c2 = (load_cloud_pcd(os.path.join(clouds, f"{k:06d}.pcd"), 65536, device=dev)
              for k in (0, 1))
    guess = next(float(line.split()[2]) for line in open(os.path.join(rtree, "warmup.txt")))
    point_mesh = make_mesh(n_data=1, n_points=2, devices=[dev] * 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, fine = registration.register_pair(c1, c2, guess)
    t1 = time.perf_counter()
    _, fine_s = registration.register_pair(c1, c2, guess, point_mesh=point_mesh)
    t2 = time.perf_counter()
    yaw_d, t_d = pose_error(fine_s.transform, fine.transform)
    if not (yaw_d < 0.01 and t_d < 0.01):
        raise AssertionError(f"point-sharded fine stage off the unsharded one: {yaw_d} deg, {t_d} m")
    a = voxel.voxel_downsample(c1.xyz, c1.valid_mask(), 0.2)
    b = voxel.voxel_downsample(c2.xyz, c2.valid_mask(), 0.2)
    fb = registration._fine_bucket(int(max(a[2], b[2])), 65536)
    tf = torch.from_numpy(best.transform).to(dev)
    q = a[0][:fb] @ tf[:3, :3].T + tf[:3, 3]
    args = (q, a[1][:fb], b[0][:fb], b[1][:fb])
    nn_err = compare(f"sharded_nn_1 over 2 point shards against knn.nn_1 (fine bucket {fb})",
                     list(sharded_nn_1(point_mesh)(*args)), list(knn.nn_1(*args)))
    print(f"13d. register_pair 0 -> 1 with the fine search over a 'points' axis of two: fine "
          f"transform {yaw_d:.6f} deg / {t_d:.6f} m from the unsharded run; {t1 - t0:.3f} s "
          f"unsharded, {t2 - t1:.3f} s point-sharded (knn.nn_1 per shard); card {smi}")

    # --- 13e. more devices than cards ----------------------------------------
    for name, main, argv in (("batch_multi_bev_gen", bev_cli.main, [src, "HDL_64E"]),
                             ("batch_top_part_registration", top_cli.main, [match, clouds]),
                             ("batch_whole_registration", whole_cli.main, [match, clouds])):
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
                main(argv + ["--devices=2"])
        except SystemExit as exc:
            code = exc.code
        else:
            code = 0
        if code != 2 or "needs 2 CUDA cards" not in err.getvalue():
            raise AssertionError(f"{name} --devices=2 on one card: exit {code}, {err.getvalue()!r}")
    print(f"13e. --devices=2 on one card: all three CLIs exit 2 ({err.getvalue().strip()})")

    # --- 13f. --profile on 8 clouds ------------------------------------------
    eight = bev_tree("profiled", paths[:8])
    prof_dir = os.path.join(base, "trace")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = bev_cli.main([eight, "HDL_64E", on, f"--profile={prof_dir}"])
    if rc != 0:
        raise AssertionError(f"batch_multi_bev_gen --profile exited {rc}")
    (trace_name,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, trace_name)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "batch_multi_bev_gen"]
    kernels = collections.Counter(e.get("name") for e in events if e.get("cat") == "kernel")
    raster = sum(v for k, v in kernels.items() if "bev_raster" in k)
    if not spans or not raster:
        raise AssertionError(f"--profile trace: {len(spans)} spans, {raster} bev_raster kernels")
    print(f"13f. batch_multi_bev_gen --profile on 8 clouds: {trace_name} "
          f"({os.path.getsize(os.path.join(prof_dir, trace_name))} bytes, {len(events)} events) "
          f"holds {len(spans)} batch_multi_bev_gen spans and {sum(kernels.values())} kernel "
          f"events, {raster} of them bev_raster's")

    shutil.rmtree(base)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s; hand-kernel launches of the mesh "
          f"runs (13a, 13c) {dict(sharded)}, of the two-process runs (13b, 13c) "
          f"{dict(in_procs)}; sharded_nn_1 max_abs_err {nn_err}")
    return {"mesh": sharded, "processes": in_procs}


def parallel_launches(counts: dict, name: str) -> dict:
    """A kernel's launches in phase 13's mesh runs and two-process runs."""
    return {"sharded_launches": counts["mesh"][name],
            "process_launches": counts["processes"][name]}


FLOOR_STEPS = 3


def tools_phase(dev: torch.device, smi: str) -> collections.Counter:
    """Phase 15: pctpu's tools outside the package, ported, on the card.
    Returns the hand-kernel launches of its paths, summed."""
    from pctpu_torch.experiments import (reference_parity, registration_floor, scaling_bench,
                                         sort_ordering)
    from pctpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke_tools")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    total: collections.Counter = collections.Counter()

    def path(names, what: str, fn, *args):
        """``fn(*args)`` counted from 0; its launches must name ``names``."""
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, log = run_logged(fn, *args)
        torch.cuda.synchronize()
        launches = nonzero(_cuda.launch_counts)
        require_launched(launches, names, what)
        total.update(launches)
        return out, log, launches, time.perf_counter() - t0

    # --- 15a. the reference-parity harness's native-oracle tier -----------
    # its CLIs run as processes of their own (``WORKER``), each reporting
    # its launches
    in_procs: collections.Counter = collections.Counter()

    def counted_cli(tool, *args, device):
        argv = [*map(str, args)] + ([f"--device={device}"]
                                    if tool in reference_parity.DEVICE_TOOLS else [])
        (_, launches), = run_workers(f"pctpu_torch.cli.{tool}", [([], argv)])
        in_procs.update(launches)

    verdict, log, _, wall = path((), "the parity tier", reference_parity.native_oracle_tier,
                                 os.path.join(base, "parity"), "cuda",
                                 os.path.join(base, "parity.json"), counted_cli)
    require_launched(in_procs, ("bev_raster", "ground_sums"), "the parity tier's CLIs")
    total.update(in_procs)
    if verdict["tier"] != "native-oracle" or verdict["outside_window"] or \
            verdict["comparisons"] != 15:
        raise AssertionError(f"parity tier: {verdict['tier']}, {verdict['comparisons']} "
                             f"comparisons, {verdict['outside_window']} diverging:\n{log[-2000:]}")
    print(f"15a parity (native-oracle tier, KITTI select + batch_multi_bev_gen HDL_64E on the "
          f"card): {verdict['comparisons']} comparisons, 0 diverging, {wall:.1f} s; launches "
          f"{nonzero(in_procs)}; verdict device {verdict['device']}")

    # --- 15b. the registration chain's device floor ------------------------
    floor, _, launches, wall = path(("nn_prep_batched", "nn_pruned_batched", "segment_sum4"),
                                    "registration_floor", registration_floor.run,
                                    [str(FLOOR_STEPS), "--device=cuda"], dev)
    if not floor["register_pairs_bit_equal"]:
        raise AssertionError("registration_floor: the chain's transforms differ from "
                             f"register_pairs by {floor['max_abs_err_vs_register_pairs']}")
    print(f"15b registration_floor ({FLOOR_STEPS} batches of {floor['n_pairs']} pairs, buckets "
          f"{floor['bucket_coarse']}/{floor['bucket_fine']}): first batch bit-equal to "
          f"register_pairs; device busy {floor['ms_per_pair_device_serial']:.4f} ms a pair "
          f"(ceiling {floor['pairs_per_sec_ceiling']:.2f} pairs/s), wall "
          f"{floor['ms_per_pair_wall']:.4f} ms a pair (profiled "
          f"{floor['ms_per_pair_wall_profiled']:.4f}), busy share "
          f"{floor['device_busy_share']:.4f} of the wall, estimated (of the profiled window "
          f"{floor['device_busy_share_profiled_window']:.4f}); kernels "
          f"{floor['kernels_per_pair']:.1f} and host "
          f"syncs {floor['host_syncs_per_pair']:.2f} a pair; {wall:.1f} s; launches {launches}")
    top = list(floor["launches_per_pair"].items())[:10]
    print("  kernels a pair, most launched: " + ", ".join(f"{k} {v:.2f}" for k, v in top))
    busy = floor["ms_per_pair_device_serial"]
    print("  device ms a pair by kernel, largest first (share of the busy time): " + ", ".join(
        f"{k} {v:.6f} ({v / busy:.4f})"
        for k, v in list(floor["device_ms_per_pair_by_kernel"].items())[:10]))
    print(f"  host syncs a pair by line: {floor['sync_sites_per_pair']}")

    # --- 15c. the scaling harness: one device and a logical mesh of two ----
    (results, summary), log, launches, wall = path(
        ("bev_raster", "ground_sums", "nn_prep_batched", "nn_pruned_batched", "segment_sum4"),
        "scaling_bench", scaling_bench.run,
        ["--device-counts", "1,2", "--registration", "--compat", "bitexact"])
    two = results[1]
    if any("ERROR" in r for r in results) or not (
            two["outputs_byte_identical_to_single_device"]
            and two["registration_identical_to_single_device"]):
        raise AssertionError(f"scaling_bench: the mesh of two differs from one device:\n{log}")
    print(f"15c scaling_bench (HDL-64E bitexact, logical mesh [cuda:0] * 2): BEVs, labels and "
          f"transforms identical to one device; " + "; ".join(
              f"{r['devices']}: {r['clouds_per_sec']:.2f} clouds/s, "
              f"{r['registration_pairs_per_sec']:.2f} pairs/s" for r in results)
          + f" (distinct devices {summary['distinct_devices']}, not a scaling claim); "
          f"{wall:.1f} s; launches {launches}")

    # --- 15d. sort-based ordering against scatter-max + gather ------------
    sort, _, _, wall = path((), "sort_ordering", sort_ordering.run, ["--device=cuda"], dev)
    if not sort["bit_equal"]:
        raise AssertionError("sort_ordering: the sort variant differs from get_ordered_cloud")
    print(f"15d sort_ordering ({sort['clouds']} HDL-64E clouds, {sort['n_points']} points "
          f"each): bit-equal; {sort['ms_per_cloud_segment_max_gather']:.4f} ms a cloud "
          f"scatter-max + gather ({sort['kernels_per_batch_incumbent']} kernels a batch), "
          f"{sort['ms_per_cloud_sort_based']:.4f} sort-based "
          f"({sort['kernels_per_batch_sort']}); {wall:.1f} s")

    # --- 15e. the port's two examples on the card --------------------------
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_end_to_end_demo
    import torch_library_quickstart

    rc, log, launches, wall = path(
        ("bev_raster", "ground_sums", "nn_pruned_batched", "segment_sum4"), "the demo",
        torch_end_to_end_demo.main, [os.path.join(base, "demo"), "--device=cuda"])
    if rc != 0 or "count_success: 2, count_failure: 0" not in log:
        raise AssertionError(f"torch_end_to_end_demo exited {rc}:\n{log[-2000:]}")
    print(f"15e torch_end_to_end_demo --device=cuda: exit 0, 2 of 2 pairs, {wall:.1f} s; "
          f"launches {launches}")
    rc, log, launches, wall = path(("bev_raster", "nn_pruned"), "the quickstart",
                                   torch_library_quickstart.main,
                                   [os.path.join(base, "quickstart"), "--device=cuda"])
    if rc != 0 or "quickstart OK" not in log:
        raise AssertionError(f"torch_library_quickstart exited {rc}:\n{log[-2000:]}")
    print(f"    torch_library_quickstart --device=cuda: exit 0, {wall:.1f} s; launches "
          f"{launches}")
    shutil.rmtree(base)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s; hand-kernel launches "
          f"{dict(total)}; card {smi}")
    return total


# the keys of the benchmark's line and details block: bench.py's
# (bench.py:1115-1165, :1170-1211), the tunnel's transfer keys renamed
BENCH_LINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "compat", "bitexact_clouds_per_sec",
    "bitexact_vs_baseline", "full_span_clouds_per_sec", "baseline_full_span_clouds_per_sec",
    "vs_baseline_full_span", "vs_baseline_interval", "vs_baseline_full_span_interval",
    "pipeline_full_span_clouds_per_sec", "pipeline_write_overlap_hidden_pct",
    "transfer_ms_per_batch", "transfer_mb_per_batch", "verify", "device")
BENCH_DETAILS_KEYS = (
    "hdl64e_multibev_clouds_per_sec_tolerance", "hdl64e_multibev_clouds_per_sec_bitexact",
    "hdl64e_multibev_general_path_clouds_per_sec",
    "hdl64e_multibev_general_path_clouds_per_sec_tolerance", "hdl32e_multibev_clouds_per_sec",
    "os1_64_multibev_clouds_per_sec", "baseline_single_core_clouds_per_sec",
    "baseline_ms_per_cloud", "baseline_full_span_clouds_per_sec",
    "baseline_full_span_ms_per_cloud", "pctpu_bev_write_ms_per_cloud",
    "full_span_clouds_per_sec_tolerance", "full_span_clouds_per_sec_bitexact",
    "vs_baseline_full_span", "vs_baseline_full_span_bitexact", "registration_pairs_per_sec_65k",
    "registration_stage_wall_ms_per_pair", "registration_baseline_single_core_pairs_per_sec",
    "registration_baseline_ms_per_pair", "registration_baseline_stage_ms",
    "registration_vs_baseline", "pipeline_full_span_clouds_per_sec",
    "pipeline_wall_ms_per_cloud", "pipeline_device_ms_per_cloud_incl_transfers",
    "pipeline_bev_write_ms_per_cloud", "pipeline_serial_sum_ms_per_cloud",
    "pipeline_write_overlap_hidden_pct", "transfer_ms_per_batch", "transfer_mb_per_batch",
    "transfer_up_ms", "transfer_back_ms", "transfer_mb_up", "transfer_mb_back", "transfer_pinned",
    "wide_transfer_ms_per_batch", "wide_transfer_mb_per_batch", "wide_transfer_up_ms",
    "wide_transfer_back_ms", "vs_baseline_interval", "vs_baseline_full_span_interval",
    "baseline_ms_spread", "utilization", "verify")
BENCH_KERNELS = ("bev_raster", "ground_sums", "nn_pruned", "nn_prep_batched",
                 "nn_pruned_batched", "segment_sum4")


def finite_leaves(value, where: str) -> None:
    """Every number under ``value`` finite, and no None."""
    if isinstance(value, dict):
        for k, v in value.items():
            finite_leaves(v, f"{where}.{k}")
    elif isinstance(value, list):
        for k, v in enumerate(value):
            finite_leaves(v, f"{where}[{k}]")
    elif value is None or (isinstance(value, float) and not math.isfinite(value)):
        raise AssertionError(f"{where} is {value}")


def bench_phase(dev: torch.device, smi: str) -> collections.Counter:
    """Phase 16: pctpu's benchmark driver and driver entry, ported, on the
    card.  Returns the hand-kernel launches of its paths, summed."""
    from pctpu_torch.experiments import bench, graft_entry
    from pctpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke_bench")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    total: collections.Counter = collections.Counter()

    def path(names, what: str, fn, *args):
        """``fn(*args)`` counted from 0; its launches must name ``names``."""
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, log = run_logged(fn, *args)
        torch.cuda.synchronize()
        launches = nonzero(_cuda.launch_counts)
        require_launched(launches, names, what)
        total.update(launches)
        return out, log, launches, time.perf_counter() - t0

    # --- 16a. the benchmark driver, --details, at full size -----------------
    details_path = os.path.join(base, "bench_details.json")
    rc, log, launches, wall = path(BENCH_KERNELS, "bench_torch --details", bench.main,
                                   ["--details", "--details-path", details_path])
    line = json.loads(log.strip().splitlines()[-1])
    with open(details_path) as f:
        details = json.load(f)
    if rc != 0 or line.get("verify") != "ok" or details.get("verify") != "ok":
        raise AssertionError(f"bench_torch --details: exit {rc}, verify {line.get('verify')}")
    for name, got, keys in (("line", line, BENCH_LINE_KEYS),
                            ("details", details, BENCH_DETAILS_KEYS)):
        missing = [k for k in keys if k not in got]
        if missing or "pipeline_span_error" in got:
            raise AssertionError(f"bench_torch's {name}: missing {missing}, "
                                 f"{got.get('pipeline_span_error')}")
        finite_leaves({k: got[k] for k in keys}, name)
    util = details["utilization"]
    rows = {**util["stages"], **util["substages_isolated"]}
    over = {k: r["pct_of_roofline"] for k, r in rows.items() if not r["pct_of_roofline"] <= 100}
    if over:
        raise AssertionError(f"utilization rows over their roofline: {over}")
    print(f"16a bench_torch --details (full size): exit 0, verify ok, every key finite; "
          f"{wall:.1f} s; launches {launches}; card {smi}")
    if details["transfer_pinned"] is not True:
        raise AssertionError("bench_torch: the span's copy back was not pinned")
    print(f"16a the span's loader batch of 8: up {details['transfer_mb_up']:.6f} MB in "
          f"{details['transfer_up_ms']:.4f} ms, back {details['transfer_mb_back']:.6f} MB in "
          f"{details['transfer_back_ms']:.4f} ms, pinned; wide pageable "
          f"{details['wide_transfer_mb_per_batch']:.6f} MB in "
          f"{details['wide_transfer_ms_per_batch']:.4f} ms (up "
          f"{details['wide_transfer_up_ms']:.4f}, back {details['wide_transfer_back_ms']:.4f}); "
          f"card {smi}")
    print(json.dumps(line))
    print(json.dumps(details))

    # --- 16b. the driver entry's flagship step --------------------------------
    def step():
        fn, (example,) = graft_entry.entry()
        return fn(example)

    (labeled, multi, single), _, launches, wall = path(("bev_raster", "ground_sums"),
                                                       "graft_entry.entry", step)
    if multi.shape != (1, 24, 224, 224) or single.shape != (1, 224, 224) or \
            not int(multi.sum()) or labeled.label.device != dev:
        raise AssertionError(f"graft_entry.entry(): multi {tuple(multi.shape)}, "
                             f"sum {int(multi.sum())}")
    print(f"16b graft_entry.entry() step on the card: multi {tuple(multi.shape)}, "
          f"{int((multi > 0).sum())} occupied cells, {int((labeled.label == 0).sum())} ground "
          f"points; {wall:.1f} s; launches {launches}")

    # --- 16c. the multichip dry run on a logical mesh of two ------------------
    _, log, launches, wall = path(("bev_raster", "ground_sums", "nn_pruned_batched",
                                   "segment_sum4"), "dryrun_multichip",
                                  graft_entry.dryrun_multichip, 2, [dev] * 2)
    summary = [ln for ln in log.splitlines() if ln.startswith("dryrun_multichip OK")]
    if not summary:
        raise AssertionError(f"dryrun_multichip printed no summary:\n{log[-2000:]}")
    print(f"16c {summary[0]} ([cuda:0] * 2); {wall:.1f} s; launches {launches}")
    shutil.rmtree(base)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s; hand-kernel launches "
          f"{dict(total)}")
    return total


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
    from pctpu_torch.experiments.card import (cuda_ms, nvidia_smi_line, profile_calls,
                                              sm_clock_mhz)
    from pctpu_torch.experiments.scene import (TREE_PAIRS, TREE_POSES, pose, registration_scene,
                                               registration_tree)
    from pctpu_torch.ops import _cuda, cuda_knn, voxel
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
    # F13: NaN coordinates in valid targets, in a masked one and in a query
    nan_q, nan_t, nan_tm = fine_q.clone(), fine_t.clone(), fine_tm.clone()
    nan_t[[100, 20000, 20001], [1, 0, 2]] = float("nan")
    nan_tm[[100, 20000, 20001]] = True
    nan_t[300, 0] = float("nan")
    nan_tm[300] = False
    nan_q[7, 2] = float("nan")

    nn_cases = [
        ("fine thr 1 m", (fine_q, fine_qm, fine_t, fine_tm), 1.0),
        ("fine fitness (no thr)", (fine_q, fine_qm, fine_t, fine_tm), None),
        ("fine thr 1 m, 10% masked", (fine_q, fine_qm & ~drop_q, fine_t, fine_tm & ~drop_t), 1.0),
        ("fine thr 1 m, NaN in valid targets", (nan_q, fine_qm, nan_t, nan_tm), 1.0),
        ("coarse 8192 thr 10 m", (flat_q, ones, flat_t, ones), 10.0),
        ("whole thr 4 m, yaw guess", whole_guess, 4.0),
        ("whole fitness (no thr), yaw guess", whole_guess, None),
        ("whole thr 4 m, near the truth", whole_near, 4.0),
        (f"{big_t.shape[0]} targets, no thr", (big_q, big_qm, big_t, big_tm), None),
        (f"{big_t.shape[0]} targets, thr 2 m", (big_q, big_qm, big_t, big_tm), 2.0),
    ]
    print("bbox-pruned 1-NN (K1/K2): the warp design (csrc/nn_pruned_warp.cu), K4's "
          "<128, 1024, prod> instance (csrc/nn_variant.cu) and the earlier block design (its "
          "first design, csrc/nn_pruned.cu) against the twin, bit for bit; ms per pass "
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
          f"{copies} copies/memsets (the work list's count), kernels {sorted(by_kernel)}; "
          f"unprepared: {bare[0]} kernels + {bare[1]} copies/memsets")
    if kernels > 3 or copies > 1:
        raise AssertionError("a pass on a prepared target launches more than 3 kernels and "
                             "the list's memset")
    # the library yardstick: torch.cdist(q, t).min(1) at the fine and whole shapes
    for name in ("fine thr 1 m", "fine fitness (no thr)", "whole thr 4 m, yaw guess"):
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

    # K1 over a problem axis: 16 fine problems, each on a target of its own
    # (the fine pass moved by 16 poses), and 32 coarse problems, the two yaw
    # guesses of 16 flat targets
    moves = [pose(2.0 * k, 0.5 * k, -0.3 * k) for k in range(16)]

    def moved(x: torch.Tensor, ms) -> torch.Tensor:
        return transform_xyz(x, torch.from_numpy(np.stack(ms)).float().to(dev))

    def sorted_batch(x: torch.Tensor, m: torch.Tensor):
        return cuda_knn.spatial_sort_payload(x, m.expand(x.shape[0], -1).contiguous())

    near_np = pose(17.2, 1.53, -2.04)
    b_fq, b_fqm = sorted_batch(moved(src_v[:fbucket].expand(16, -1, -1),
                                     [m @ near_np for m in moves]), src_vm[:fbucket])
    b_ft, b_ftm = sorted_batch(moved(tgt_v[:fbucket].expand(16, -1, -1), moves), tgt_vm[:fbucket])
    flip = pose(180.0, 0.0, 0.0)
    b_cq, b_cqm = sorted_batch(moved(flat_q.expand(32, -1, -1),
                                     [m @ g for m in moves for g in (np.eye(4), flip)]), ones)
    b_ct, b_ctm = sorted_batch(moved(flat_t.expand(16, -1, -1), moves), ones)
    print("bbox-pruned 1-NN over a problem axis (csrc/nn_pruned_warp.cu: one prep launch for "
          "the targets, one pass of a memset and 3 launches for all problems; the first warp "
          "design's pass, 3 launches with a dense main grid, beside it)")
    batched_fine = batched_nn_case("batched fine thr 1 m", b_fq, b_fqm, b_ft, b_ftm, 1.0, smi,
                                   library=True)
    batched_coarse = batched_nn_case("batched coarse thr 10 m", b_cq, b_cqm, b_ct, b_ctm, 10.0, smi)

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
    argv = ["--capacity=65536", "--flat-cap=32768", "--pair-batch=1"]
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
    require_launched(launches, ("nn_prep", "nn_pruned", "nn_prep_batched", "nn_pruned_batched",
                                "segment_sum4"), "the top-part CLI run")
    print(f"slice: {len(pairs)} pairs in {wall:.3f} s = {len(pairs) / wall:.4f} pairs/s; "
          f"[TIME] per pair coarse {stage_ms['coarse']:.3f} ms, fine {stage_ms['fine']:.3f} ms; "
          f"NN passes per pair {(launches['nn_pruned'] + launches['nn_pruned_batched']) / len(pairs):.1f} "
          f"(the coarse guesses' {launches['nn_pruned_batched'] / len(pairs):.1f} batched, two "
          f"problems each), target preps per pair "
          f"{(launches['nn_prep'] + launches['nn_prep_batched']) / len(pairs):.1f}; launches "
          f"{launches}; card {smi}")

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
        whole_cli.main([warm, clouds, "--capacity=65536", "--pair-batch=1",
                        f"--report={os.path.join(tree, 'warmup_whole.txt')}"])
        whole_transforms.clear()
        whole_report = os.path.join(tree, "whole_report.txt")
        captured = io.StringIO()
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = whole_cli.main([match, clouds, "--capacity=65536", "--pair-batch=1",
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
    print("fused 1-NN (K3): the new kernels (csrc/nn_fused.cu: prep, main grid of query tiles x "
          "target splits, finish) and the first design's kernel against the twin, bit for bit; "
          "ms per pass (CUDA events)")
    fused = [fused_case(name, args, smi, got=fused_out if k == 0 else None, library=k < 2)
             for k, (name, args) in enumerate(fused_cases)]
    fused_err = max(c["err"] for c in fused)
    for name, args in fused_edge_cases(dev):
        want = cuda_knn.nn_1_fused_reference(*args)
        fused_err = max(fused_err, compare(name, cuda_knn.nn_1_fused(*args), want))
        compare(f"{name}: first design", cuda_knn.nn_1_fused_v1(*args), want)
        for splits in (1, 3, 1 << 15):  # one split, ragged splits, one a tile
            launch, idx, _ = cuda_knn._fused_launcher(*args, splits=splits)
            launch()
            compare(f"{name}: {cuda_knn.fused_grid(len(args[0]), len(args[2]), splits)[1]} "
                    "target splits", [idx], [want[0]])
    print(f"  ptxas { {k: v for k, v in ptxas.items() if k.startswith('nn_fused')} }")

    # --- 8. the argmin and tile-shape experiment (K4) ------------------------
    _cuda.reset_launch_counts()
    exp = nn_argmin.run(["--quick"])
    torch.cuda.synchronize()
    variant_launches = {k: _cuda.launch_counts[k]
                        for k in ("nn_variant", "nn_variant_prep", "nn_variant_v1")}
    require_launched(variant_launches, tuple(variant_launches), "nn_argmin --quick")
    shapes = {(v["mode"], v["tq"], v["tt"]) for v in exp["variants"]}
    missing = {(m, 256, 1024) for m in nn_argmin.ALL_MODES} | {
        ("prod", tq, tt) for tq, tt in cuda_knn.VARIANT_TILES}
    if missing - shapes:
        raise AssertionError(f"nn_argmin skipped {sorted(missing - shapes)}")
    by_key = {v["key"]: v for v in exp["variants"]}
    anchor, k1 = by_key["prod_thr"], by_key["prod_op_thr"]
    # the new design's prep at every compiled (tt, bf16), on the fine pass's
    # target
    variant_prep_err = 0.0
    for tt, bf16 in sorted(cuda_knn.VARIANT_PREPS):
        got = cuda_knn.prepare_variant_target(fine_t, fine_tm, tt, bf16)
        want = cuda_knn.prepare_target_reference(fine_t, fine_tm, tt, bf16)
        variant_prep_err = max(variant_prep_err, compare(
            f"K4 prep, tt {tt}{', bf16' if bf16 else ''}",
            [got.packed, got.group_box, got.tile_box],
            [want.packed, want.group_box, want.tile_box]))
    print(f"nn_argmin: {len(exp['variants'])} variants, each bit-equal to its twin in the new "
          f"design and the first; prod thr=1m (256,1024) {anchor['ms_per_pass']:.4f} ms per "
          f"pass (kernel {anchor['kernel_ms']:.4f} ms), first design "
          f"{anchor['v1_ms_per_pass']:.4f} (kernel {anchor['v1_kernel_ms']:.4f}); K1 "
          f"{k1['ms_per_pass']:.4f} (kernel {k1['kernel_ms']:.4f}); twin "
          f"{exp['twin_ms']:.4f} ms; launches {variant_launches}; card {smi}")
    for name, line in ptxas.items():
        if name.startswith(("nn_variant", "nn_pruned_kernel")):
            print(f"  ptxas {name}: {line}")
    spilled = [n for n, line in ptxas.items() if n.startswith("nn_variant")
               and not line.endswith("spill stores 0 B, loads 0 B")]
    if spilled or not any(n.startswith("nn_variant_main_kernel") for n in ptxas):
        raise AssertionError(f"K4's new kernels spill or are missing from ptxas's report: "
                             f"{spilled}")

    # --- 9. batch_multi_bev_gen ----------------------------------------------
    bev_kernels = multi_bev_phase(dev, smi, ptxas=ptxas, clock_mhz=clock_mhz)

    # --- 10. pair-batched registration ---------------------------------------
    batched_launches, v1_launches = pair_batched_phase(dev, smi)

    # --- 11. batch_cloud_manip and cloud_manip -------------------------------
    cloud_manip_phase(dev, smi)

    # --- 12. pointcloud_pca_test, top_part_registration, the selectors --------
    pca_kernel = pca_phase(dev, smi, clock_mhz)

    # --- 13. the parallel paths on the one card --------------------------------
    sharded = parallel_phase(dev, smi)

    # --- 14. the differential campaign on the card -----------------------------
    campaign = campaign_phase(dev, smi)

    # --- 15. pctpu's tools outside the package ---------------------------------
    tools = tools_phase(dev, smi)

    # --- 16. pctpu's benchmark driver and driver entry ----------------------------
    bench_launches = bench_phase(dev, smi)

    def with_campaign(entry: dict) -> dict:
        return {**entry, "campaign_launches": campaign[entry["name"]],
                "tools_launches": tools[entry["name"]],
                "bench_launches": bench_launches[entry["name"]]}

    # K1, the prep and K4's <128, 1024, prod> on the fine pass at thr 1 m (K4
    # also on the fitness pass)
    fine, fit = nn_ms["fine thr 1 m"], nn_ms["fine fitness (no thr)"]
    big_fused = fused[0]
    print(json.dumps({"kernels": [with_campaign(k) for k in [
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
        {"name": "nn_pruned_batched", "route": "cuda",
         "source": "pctpu_torch/csrc/nn_pruned_warp.cu",
         "replaces": "pctpu/ops/pallas_knn.py:275", "launches": batched_launches["nn_pruned_batched"],
         **parallel_launches(sharded, "nn_pruned_batched"),
         "max_abs_err": max(batched_fine["err"], batched_coarse["err"]), "ms": batched_fine["ms"],
         "plain_ms": batched_fine["plain_ms"], "bound_ms": batched_fine["bound"],
         "bound_by": batched_fine["bound_by"], "library_ms": batched_fine["library_ms"],
         "unbatched_ms": batched_fine["unbatched_ms"], "coarse_ms": batched_coarse["ms"],
         "coarse_unbatched_ms": batched_coarse["unbatched_ms"],
         "wrapper_ms": batched_fine["wrapper_ms"], "v1_ms": batched_fine["v1_ms"],
         "coarse_v1_ms": batched_coarse["v1_ms"], "items": batched_fine["items"],
         "dense_blocks": batched_fine["dense_blocks"],
         "coarse_items": batched_coarse["items"],
         "coarse_dense_blocks": batched_coarse["dense_blocks"]},
        {"name": "nn_pruned_batched_v1", "route": "cuda",
         "source": "pctpu_torch/csrc/nn_pruned_warp.cu",
         "replaces": "pctpu/ops/pallas_knn.py:275",
         "launches": v1_launches["nn_pruned_batched_v1"],
         "max_abs_err": max(batched_fine["v1_err"], batched_coarse["v1_err"]),
         "ms": batched_fine["v1_ms"], "plain_ms": batched_fine["plain_ms"],
         "bound_ms": batched_fine["bound"], "bound_by": batched_fine["bound_by"],
         "library_ms": batched_fine["library_ms"], "wrapper_ms": batched_fine["v1_wrapper_ms"],
         "coarse_ms": batched_coarse["v1_ms"], "design": "first (dense main grid), kept"},
        {"name": "nn_prep_batched", "route": "cuda",
         "source": "pctpu_torch/csrc/nn_pruned_warp.cu",
         "replaces": "pctpu/ops/pallas_knn.py:275", "launches": batched_launches["nn_prep_batched"],
         **parallel_launches(sharded, "nn_prep_batched"),
         "max_abs_err": max(batched_fine["prep_err"], batched_coarse["prep_err"]),
         "ms": batched_fine["prep_ms"], "plain_ms": batched_fine["prep_plain_ms"],
         "bound_ms": batched_fine["prep_bound"][0], "bound_by": batched_fine["prep_bound"][1],
         "library_ms": None},
        {**sums_entry("segment_sum4", "pctpu/ops/voxel.py:80", launches["segment_sum4"],
                      seg_sums), **parallel_launches(sharded, "segment_sum4")},
        {"name": "nn_fused", "route": "cuda", "source": "pctpu_torch/csrc/nn_fused.cu",
         "replaces": "pctpu/ops/pallas_knn.py:38", "launches": fused_launches,
         "max_abs_err": fused_err, "ms": big_fused["ms"], "plain_ms": big_fused["plain_ms"],
         "bound_ms": big_fused["bound"][0], "bound_by": big_fused["bound"][1],
         "library_ms": big_fused["library_ms"], "wrapper_ms": big_fused["wrapper_ms"],
         "v1_ms": big_fused["v1_ms"]},
        {"name": "nn_variant", "route": "cuda", "source": "pctpu_torch/csrc/nn_variant.cu",
         "replaces": "scripts/exp_nn_argmin.py:118", "launches": variant_launches["nn_variant"],
         "max_abs_err": max(exp["max_abs_err"], nn_err), "ms": fine["variant_alone"],
         "plain_ms": fine["twin"], "bound_ms": fine["bound"], "bound_by": fine["bound_by"],
         "library_ms": fine["library"], "wrapper_ms": fine["variant_wrapper"],
         "v1_ms": fine["old_alone"], "v1_wrapper_ms": fine["old_wrapper"],
         "v1_launches": variant_launches["nn_variant_v1"], "k1_ms": fine["alone"],
         "fitness_ms": fit["variant_alone"], "fitness_v1_ms": fit["old_alone"],
         "fitness_plain_ms": fit["twin"], "fitness_bound_ms": fit["bound"],
         "fitness_bound_by": fit["bound_by"], "fitness_library_ms": fit["library"],
         "fitness_k1_ms": fit["alone"]},
        {"name": "nn_variant_prep", "route": "cuda", "source": "pctpu_torch/csrc/nn_variant.cu",
         "replaces": "scripts/exp_nn_argmin.py:118",
         "launches": variant_launches["nn_variant_prep"], "max_abs_err": variant_prep_err,
         "ms": fine["variant_prep"], "plain_ms": fine["prep_twin"],
         "bound_ms": fine["prep_bound"], "bound_by": fine["prep_bound_by"],
         "library_ms": None},
        *({**k, **parallel_launches(sharded, k["name"])} for k in bev_kernels),
        pca_kernel,
    ]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
