"""The device floor of the two-stage registration chain — the port of
``scripts/probe_registration_floor.py``.

    python -m pctpu_torch.experiments.registration_floor [n_steps] [--pairs=16]
        [--small] [--device=cuda|cpu]

The chain a batch of pairs runs in production — flat prep (top part +
voxel), both coarse point-to-plane ICPs and the best of two, the full-cloud
voxel, the fine point-to-point ICP (``pipelines/registration.py``:
``_stage_flat``, ``_stage_coarse``, ``_stage_voxel_full``, ``_stage_fine``;
reference span BatchTopPartRegistration.cpp:396-506) — over ``n_steps``
batches of ``--pairs`` pairs of the bench scene (``scene.registration_scene``
and ``scene.moved_copy``, capacity 65,536; pair i's first cloud shifted by
i·1e-4, each batch by its own offset), at the capacity buckets that one
verified production batch (``_coarse_stage_batched`` + ``_fine_dispatch``)
learned first, so the chain runs what production runs.

pctpu scans the chain inside one jitted program, so its wall is device
time.  Here the ICP loop reads the host every iteration (the ``done``
count, and ``torch.linalg.svd`` / ``det``), so no CUDA graph can hold the
chain, and the wall is host and device together.  The floor is therefore
the card's own busy time: the timed batches run twice more under
torch.profiler (``card.profile_window``: only the events inside its span,
a window retaken when its events are no whole number a pass) and the device
durations of their kernels, copies and memsets are summed (one stream: they
do not overlap).  The host syncs are counted in one more pass, outside the
profiled window (torch's sync debug mode).

Prints one JSON line: pctpu's keys (``ms_per_pair_device_serial`` is that
busy time a pair, ``pairs_per_sec_ceiling`` 1000 over it, ``checksum``
the chain's outputs summed over the timed batches) and
``ms_per_pair_wall`` (the unprofiled run's), ``ms_per_pair_wall_profiled``,
``device_busy_share_profiled_window`` (busy over the profiled wall: both
from one window), ``device_busy_share`` (busy over the unprofiled wall: an
estimate, which takes the profiler to lengthen the host's work and not the
card's — unchecked), ``device_ms_per_pair_by_kernel`` (that busy time a pair
split by kernel, copy and memset name, largest first: the floor's shares),
kernels and hand-kernel launches a pair by name, host syncs a pair by the
line that made them, ICP batch and problem iterations (the timed batches
once more, untimed, under ``profiler.recording()``), the card's name and power
limit, and ``register_pairs_bit_equal``: the first timed batch's fine
transforms against ``register_pairs`` on the same pairs, bit for bit.  On
the CPU (``--device=cpu``; ``--small`` keeps every 15th point of the scene
at capacity and flat cap 4,096, for a short run) the device numbers are
null.  Exit 1 when the
transforms differ, 2 for ``--device=cuda`` without a card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

N_PAIRS = 16  # the bench's batch and the CLIs' --pair-batch on the card
GUESS_DEG = 17.0
FLOOR_REPS = 2  # profiled passes over the timed batches (a whole number a pass)
# (every k-th point of the scene, capacity, flat cap): the bench's, --small's
FULL, SMALL = (1, 65536, 32768), (15, 4096, 4096)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pctpu_torch.experiments.registration_floor")
    ap.add_argument("n_steps", nargs="?", type=int, default=12, help="timed batches")
    ap.add_argument("--pairs", type=int, default=N_PAIRS, help="pairs a batch")
    ap.add_argument("--small", action="store_true",
                    help="every 15th point at capacity 4,096 (short CPU runs)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the chain runs (default: the card)")
    return ap


def scene_pairs(dev: torch.device, n_pairs: int, every: int, capacity: int) -> list:
    """The bench pair ``n_pairs`` times, pair i's first cloud shifted by
    i·1e-4 (bench.py's ``registration_scene`` batch)."""
    from pctpu_torch.cloud import make_cloud
    from pctpu_torch.experiments import scene

    xyz, lab = scene.registration_scene()
    xyz, lab = xyz[::every], lab[::every]
    c1 = make_cloud(xyz, label=lab, capacity=capacity, device=dev)
    c2 = make_cloud(scene.moved_copy(xyz), label=lab, capacity=capacity, device=dev)
    return [(c1.replace(xyz=c1.xyz + i * 1e-4), c2, GUESS_DEG) for i in range(n_pairs)]


def chain(c1b, c2b, guesses, cfg, flat_cap: int, bucket_coarse: int, bucket_fine: int):
    """One batch through the production chain at fixed buckets: (fine
    IcpResult, f64 checksum of its outputs and the voxel counts)."""
    from pctpu_torch.pipelines import registration as R

    s, t, _ = R._stage_flat(c1b, c2b, flat_cap, cfg.voxel_leaf)
    win = R._stage_coarse(s[0], s[1], t[0], t[1], guesses, cfg, bucket_coarse)
    a, b = R._stage_voxel_full(c1b, c2b, cfg.voxel_leaf)
    fin = R._stage_fine(a[0], a[1], b[0], b[1], win.transform, cfg, bucket_fine)
    chk = (fin.transform.double().sum() + fin.fitness.double().sum()
           + s[2].sum() + t[2].sum() + a[2].sum() + b[2].sum())
    return fin, chk


@contextlib.contextmanager
def counting_syncs(dev: torch.device, sites: collections.Counter):
    """Count the host syncs of a block by the line of the port that made
    them (torch's sync debug mode; the card only)."""
    if dev.type != "cuda":
        yield
        return
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchroniz" in str(w.message):
            rel = os.path.relpath(w.filename, root)
            if rel.startswith(".."):  # torch's own, e.g. torch.cuda.synchronize
                rel = "(torch) " + "/".join(w.filename.split(os.sep)[-3:])
            sites[f"{rel}:{w.lineno}"] += 1


def run(argv: list[str] | None = None, dev: torch.device | None = None) -> dict:
    """The probe with ``argv``'s flags on ``dev`` (default: the flag's
    device); returns the JSON line's dict."""
    from pctpu_torch.config import RegistrationConfig
    from pctpu_torch.experiments import card
    from pctpu_torch.ops import _cuda
    from pctpu_torch.pipelines import registration as R
    from pctpu_torch.runtime import profiler
    from pctpu_torch.runtime.profiler import StageTimer

    args = parser().parse_args(argv)
    dev = dev or card.tool_device(args.device, "registration_floor")
    on_card = dev.type == "cuda"
    n_pairs, n_steps = args.pairs, args.n_steps
    every, capacity, flat_cap = SMALL if args.small else FULL

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cfg = RegistrationConfig()
    t0 = time.perf_counter()
    pairs = scene_pairs(dev, n_pairs, every, capacity)
    # learn the production buckets from one verified batch
    spec = R.BucketSpec()
    timer = StageTimer()
    shards = R._shard_pairs(pairs, None)
    best = R._coarse_stage_batched(shards, cfg, flat_cap, timer, spec=spec)
    fine = R._fine_dispatch(shards, R._transforms(best), cfg, timer, spec=spec)
    float(fine[0].fitness[0])
    cb, fb = spec.coarse, spec.fine
    print(f"buckets: coarse={cb} fine={fb}", file=sys.stderr, flush=True)
    c1b, c2b, _ = shards[0]
    guesses = torch.from_numpy(np.stack([R._guess_pair_np(GUESS_DEG)] * n_pairs)).to(dev)
    offs = (np.arange(1, n_steps + 1, dtype=np.float32) * 1e-4).tolist()

    def batches(shift: float):
        """The chain over n_steps batches at offsets offs + shift; returns
        (the first batch's fine result, the summed checksum on the device)."""
        acc, first = None, None
        for k, off in enumerate(offs):
            fin, chk = chain(c1b.replace(xyz=c1b.xyz + (off + shift)), c2b, guesses, cfg,
                             flat_cap, cb, fb)
            first = fin if k == 0 else first
            acc = chk if acc is None else acc + chk
        return first, acc

    batches(0.0)  # warm-up
    sync()
    warm_s = time.perf_counter() - t0

    _cuda.reset_launch_counts()
    sync()
    t1 = time.perf_counter()
    first, acc = batches(7e-3)
    checksum = float(acc)
    sync()
    wall_ms = (time.perf_counter() - t1) * 1e3
    hand = {k: v for k, v in _cuda.launch_counts.items() if v}
    # the ICP loops' counters (batch and problem iterations) of the same
    # pass, run again untimed: tracing stays off while the wall is timed
    with profiler.recording() as rec:
        batches(7e-3)
    n = n_steps * n_pairs

    # the first timed batch against register_pairs on the same pairs
    shift = offs[0] + 7e-3
    same_pairs = [(pairs[i][0].replace(xyz=c1b.xyz[i] + shift), pairs[i][1], GUESS_DEG)
                  for i in range(n_pairs)]
    reg = R.register_pairs(same_pairs, cfg, flat_cap=flat_cap)
    want = np.stack([f.transform for _, f in reg])
    got = first.transform.cpu().numpy()
    bit_equal = bool(np.array_equal(got.view(np.uint32), want.view(np.uint32)))

    out = {
        "ms_per_pair_device_serial": None, "pairs_per_sec_ceiling": None,
        "n_steps": n_steps, "n_pairs": n_pairs, "bucket_coarse": cb, "bucket_fine": fb,
        "compile_s": warm_s, "checksum": checksum,
        "ms_per_pair_wall": wall_ms / n, "pairs_per_sec_wall": 1e3 * n / wall_ms,
        "ms_per_pair_wall_profiled": None, "device_busy_share": None,
        "device_busy_share_profiled_window": None, "kernels_per_pair": None,
        "copies_per_pair": None, "launches_per_pair": None,
        "device_ms_per_pair_by_kernel": None,
        "hand_launches_per_pair": {k: v / n for k, v in hand.items()},
        "host_syncs_per_pair": None, "sync_sites_per_pair": None,
        "icp_batch_iterations_per_batch": rec.total("icp.iterations") / n_steps,
        "icp_problem_iterations_per_pair": rec.total("icp.problem_iterations") / n,
        "register_pairs_bit_equal": bit_equal,
        "max_abs_err_vs_register_pairs": float(np.abs(got - want).max()),
        "points": int(pairs[0][0].count), "device": card.device_record(dev),
    }
    if on_card:
        # the same batches twice more at other offsets under torch.profiler
        # (card.profile_window: its span, filter and retries): the card's
        # busy time and the profiled window's own wall
        events, prof_wall = card.profile_window(lambda: float(batches(14e-3)[1]), FLOOR_REPS,
                                                mark="registration_floor")
        counts, ms = card.by_name(events, FLOOR_REPS)
        floor = sum(ms.values()) / n
        # the host syncs in a pass of their own, outside the profiled window
        sites: collections.Counter = collections.Counter()
        with counting_syncs(dev, sites):
            float(batches(21e-3)[1])
        out.update({
            "ms_per_pair_device_serial": floor, "pairs_per_sec_ceiling": 1e3 / floor,
            "ms_per_pair_wall_profiled": prof_wall / FLOOR_REPS / n,
            # busy time over the unprofiled run's wall: an estimate that
            # takes the profiler to lengthen the host's work and not the
            # card's, which no measurement here checks
            "device_busy_share": floor / out["ms_per_pair_wall"],
            "device_busy_share_profiled_window": floor * FLOOR_REPS * n / prof_wall,
            "kernels_per_pair": sum(v for k, v in counts.items() if not card.is_copy(k)) / n,
            "copies_per_pair": sum(v for k, v in counts.items() if card.is_copy(k)) / n,
            "launches_per_pair": {k: v / n for k, v in
                                  sorted(counts.items(), key=lambda kv: -kv[1])},
            "device_ms_per_pair_by_kernel": {k: v / n for k, v in
                                             sorted(ms.items(), key=lambda kv: -kv[1])},
            "host_syncs_per_pair": sum(sites.values()) / n,
            "sync_sites_per_pair": {k: v / n for k, v in sites.most_common()},
        })
    return out


def main(argv: list[str] | None = None) -> int:
    from pctpu_torch.experiments import card

    argv = sys.argv[1:] if argv is None else argv
    dev = card.tool_device(parser().parse_args(argv).device, "registration_floor")
    if dev is None:
        return 2
    out = run(argv, dev)
    print(json.dumps(out))
    return 0 if out["register_pairs_bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
