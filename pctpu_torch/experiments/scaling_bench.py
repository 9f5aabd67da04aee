"""Throughput against device count — the port of ``scripts/run_scaling_bench.py``.

    python -m pctpu_torch.experiments.scaling_bench [--device-counts 1,2,4]
        [--cpu N] [--compat bitexact|tolerance] [--registration]
        [--no-identity-check] [--small] [--device=cuda|cpu]

For each device count n: clouds/s of the HDL-64E preprocess (ordering,
ground marking, both BEV rasters, ``assume_ordered``) with the batch axis
split over a data mesh of n devices (``parallel.mesh.make_mesh`` +
``preprocess_shards``), the batch a device held at 8 (weak scaling, as
``--devices=N`` splits a longer file list); with ``--registration`` also
pairs/s of ``register_pairs(mesh=...)``, 16 pairs a device on a
65,536-capacity scene.  Both are held against one device: the sharded BEVs
and labels byte-equal to one ``preprocess_batch``, the sharded transforms
bit-equal to the unsharded ``register_pairs`` (``--no-identity-check``
skips both).

Timing follows pctpu's: 16 distinct batches × 8 perturbed passes (4 × 4
with ``--small``), a checksum of every output read once at the end, the
round trip of one trivial op subtracted, best of three.

A count above the cards this process sees is a logical mesh that repeats
them (``[cuda:0] * n`` on one card): its shards take turns in one thread
(``parallel/mesh.py``), so the numbers say what sharding costs, not how it
scales.  ``--cpu N`` runs on N logical CPU devices (functional only, small
geometry); it implies ``--device=cpu``, and ``--device=cpu`` alone is
``--cpu 1``.  ``--cpu N`` with ``--device=cuda`` exits 1.  Each count
prints one JSON line, then a summary line with ``distinct_devices`` and
``perf_meaningful`` (true only when every count had distinct cards).  Exit 1 when an identity check fails, 2 for
``--device=cuda`` without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _sync(devs) -> None:
    for d in {d for d in devs if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _round_trip_s(dev: torch.device) -> float:
    """The median of three round trips of one trivial op (launch and read)."""
    x = torch.zeros((), dtype=torch.int32, device=dev)
    int(x + 1)
    lats = []
    for i in range(3):
        t0 = time.perf_counter()
        int(x + (i + 1))
        lats.append(time.perf_counter() - t0)
    return sorted(lats)[1]


def _geometry(small: bool):
    from pctpu_torch.config import SensorParams, get_sensor_params
    from pctpu_torch.experiments import scene

    if small:
        # functional-only geometry for CPU runs
        return SensorParams(n_scan=8, horizon_scan=64, ground_upper_scan=6, height_res=0.5), 256
    params = get_sensor_params("HDL_64E")
    return params, min(scene.BENCH_N_POINTS, int(params.grid_size * 0.9))


def measure_sharded(devices: list[torch.device], compat: str, check_identity: bool,
                    small: bool = False) -> dict:
    """clouds/s with the batch axis split over a data mesh of ``devices``."""
    from pctpu_torch.experiments import scene
    from pctpu_torch.ops.preprocess import preprocess_batch
    from pctpu_torch.parallel.mesh import (make_mesh, preprocess_shards, shard_cloud_batch,
                                           sharded_preprocess)

    n = len(devices)
    params, n_points = _geometry(small)
    mesh = make_mesh(devices=devices)
    dev0 = mesh.data_devices[0]
    global_batch = scene.BENCH_BATCH * n
    k_stack, reps = (4, 4) if small else (16, 8)
    stacked = [shard_cloud_batch(scene.synth_batch(params, global_batch, n_points, seed,
                                                   ordered=True, device=dev0), mesh)
               for seed in range(k_stack)]

    def run(offset: float) -> int:
        acc = []
        for shards in stacked:
            for rep in range(reps):
                scale = 1.0 + 1e-7 * (rep + offset)
                outs = preprocess_shards([s.replace(xyz=s.xyz * scale) for s in shards], params,
                                         assume_ordered=True, compat=compat)
                acc.extend((multi.sum() + single.sum() + labeled.label.sum()).to(dev0)
                           for labeled, multi, single in outs)
        return int(torch.stack(acc).sum())

    latency = _round_trip_s(dev0)
    run(0.0)
    dt = float("inf")
    for k in range(3):  # best of three, each at its own offset
        _sync(devices)
        t0 = time.perf_counter()
        checksum = run(1000.0 * (k + 1))
        dt = min(dt, time.perf_counter() - t0)
        assert checksum != 0
    cps = k_stack * reps * global_batch / max(dt - latency, 1e-6)
    out = {"devices": n, "clouds_per_sec": cps, "compat": compat, "global_batch": global_batch}

    if check_identity and n > 1:
        # one batch on one device against the same batch sharded: no
        # exchange between shards, so not a byte may change
        clouds = scene.synth_batch(params, global_batch, n_points, seed=99, ordered=True,
                                   device=dev0)
        ref = preprocess_batch(clouds, params, assume_ordered=True, compat=compat)
        got = sharded_preprocess(mesh, params)(shard_cloud_batch(clouds, mesh),
                                               assume_ordered=True, compat=compat)
        same = (torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
                and torch.equal(got[0].label, ref[0].label))
        out["outputs_byte_identical_to_single_device"] = bool(same)
        if not same:
            out["ERROR"] = "sharded outputs diverge from single-device"
    return out


def registration_scene(small: bool):
    """pctpu's scaling scene (run_scaling_bench.py:186-206): clusters over
    a flat ground, the second cloud turned 17° and shifted; (xyz, xyz2,
    labels, capacity, flat_cap, pairs a device)."""
    n_clusters, cluster_pts, ng, capacity, flat_cap, per_dev = (
        (6, 80, 1000, 2048, 2048, 2) if small else (40, 150, 45000, 65536, 32768, 16))
    rng = np.random.default_rng(0)
    pts, labels = [], []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(-60, 60, 2)
        pts.append(np.stack([cx + rng.normal(0, 2.5, cluster_pts),
                             cy + rng.normal(0, 2.5, cluster_pts),
                             rng.uniform(0, 9, cluster_pts)], 1))
        labels.append(np.full(cluster_pts, -2))
    pts.append(np.stack([rng.uniform(-70, 70, ng), rng.uniform(-70, 70, ng),
                         rng.uniform(-2.0, -1.9, ng)], 1))
    labels.append(np.zeros(ng))
    xyz = np.concatenate(pts).astype(np.float32)
    th = np.radians(17.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                   np.float32)
    xyz2 = xyz @ rot.T + np.array([1.5, -2.0, 0], np.float32)
    return xyz, xyz2, np.concatenate(labels).astype(np.int32), capacity, flat_cap, per_dev


def measure_registration_sharded(devices: list[torch.device], small: bool = False,
                                 check_identity: bool = True) -> dict:
    """Registration pairs/s with the pair axis split over a data mesh of
    ``devices`` (the registration CLIs' ``--devices`` path), the pairs a
    device held constant."""
    from pctpu_torch.cloud import make_cloud
    from pctpu_torch.parallel.mesh import make_mesh
    from pctpu_torch.pipelines.registration import register_pairs

    n = len(devices)
    xyz, xyz2, lab, capacity, flat_cap, per_dev = registration_scene(small)
    c1 = make_cloud(xyz, label=lab, capacity=capacity, device=devices[0])
    c2 = make_cloud(xyz2, label=lab, capacity=capacity, device=devices[0])
    mesh = make_mesh(devices=devices) if n > 1 else None
    n_pairs = per_dev * n

    def batch(off: int) -> list:
        return [(c1.replace(xyz=c1.xyz + (off + i) * 1e-4), c2, 17.0) for i in range(n_pairs)]

    register_pairs(batch(1), flat_cap=flat_cap, mesh=mesh)  # warm-up
    built = [batch(100 + n_pairs * i) for i in range(2)]
    _sync(devices)
    t0 = time.perf_counter()
    results = [register_pairs(b, flat_cap=flat_cap, mesh=mesh) for b in built]
    pps = len(built) * n_pairs / (time.perf_counter() - t0)
    out = {"devices": n, "registration_pairs_per_sec": pps, "pair_batch": n_pairs}
    if check_identity and n > 1:
        alone = register_pairs(built[0], flat_cap=flat_cap)
        same = all(np.array_equal(a[1].transform.view(np.uint32), b[1].transform.view(np.uint32))
                   and np.array_equal(a[0].transform.view(np.uint32),
                                      b[0].transform.view(np.uint32))
                   for a, b in zip(results[0], alone))
        out["registration_identical_to_single_device"] = bool(same)
        if not same:
            out["ERROR"] = "sharded registration diverges from single-device"
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pctpu_torch.experiments.scaling_bench")
    ap.add_argument("--device-counts", type=str, default=None,
                    help="comma-separated device counts (default: 2^k <= the cards)")
    ap.add_argument("--cpu", type=int, default=0,
                    help="N logical CPU devices (functional check only); implies --device=cpu")
    ap.add_argument("--compat", default="tolerance", choices=("bitexact", "tolerance"))
    ap.add_argument("--registration", action="store_true",
                    help="also measure registration pairs/s against device count")
    ap.add_argument("--no-identity-check", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="tiny sensor geometry (functional-only runs)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the cards (default) or the CPU (one logical device unless --cpu N)")
    return ap


def parse(argv: list[str] | None) -> argparse.Namespace:
    """``argv``'s flags, with the one rule that picks the pool: ``--cpu N``
    is ``--device=cpu`` on N logical CPU devices, ``--device=cpu`` alone is
    one, else the cards.  Raises ValueError for ``--cpu N`` with
    ``--device=cuda``."""
    args = parser().parse_args(argv)
    if args.cpu:
        if args.device == "cuda":
            raise ValueError("--cpu N runs on N logical CPU devices: it takes no --device=cuda")
        args.device = "cpu"
    args.device = args.device or "cuda"
    args.cpu = args.cpu or (1 if args.device == "cpu" else 0)
    return args


def run(argv: list[str] | None = None) -> tuple[list[dict], dict]:
    """Each count's result and the summary; raises ValueError for more CPU
    devices than ``--cpu`` gives, or for ``--cpu N`` with ``--device=cuda``."""
    args = parse(argv)
    if args.device == "cpu":
        n_avail = args.cpu
        pool = [torch.device("cpu")] * n_avail
    else:
        n_avail = torch.cuda.device_count()
        first = torch.cuda.current_device()
        pool = [torch.device("cuda", (first + j) % n_avail) for j in range(n_avail)]
    if args.device_counts:
        counts = [int(c) for c in args.device_counts.split(",")]
    else:
        counts = [1]
        while counts[-1] * 2 <= n_avail:
            counts.append(counts[-1] * 2)
    if pool[0].type == "cpu" and max(counts) > n_avail:
        raise ValueError(f"requested {max(counts)} devices but only {n_avail} available "
                         f"(--cpu {n_avail})")
    small = args.small or pool[0].type == "cpu"
    # a count above the cards repeats them: a logical mesh
    meshes = {c: [pool[j % len(pool)] for j in range(c)] for c in counts}
    distinct = max(len(set(devs)) for devs in meshes.values())
    perf_meaningful = pool[0].type == "cuda" and all(len(set(d)) == len(d)
                                                     for d in meshes.values())
    if not perf_meaningful:
        print("# " + ("CPU devices" if pool[0].type == "cpu" else
                      f"{distinct} distinct card(s): counts above it are logical meshes whose "
                      "shards take turns") + ": numbers are functional-only, not a scaling "
              "claim", flush=True)
    results = []
    for c in counts:
        r = measure_sharded(meshes[c], args.compat, not args.no_identity_check, small=small)
        if args.registration:
            r.update(measure_registration_sharded(meshes[c], small=small,
                                                  check_identity=not args.no_identity_check))
        results.append(r)
        print(json.dumps(r), flush=True)
    base = results[0]["clouds_per_sec"] / results[0]["devices"]
    summary = {
        "backend": pool[0].type, "distinct_devices": distinct, "perf_meaningful": perf_meaningful,
        "scaling": [
            {"devices": r["devices"], "clouds_per_sec": r["clouds_per_sec"],
             "efficiency_vs_1dev": r["clouds_per_sec"] / (base * r["devices"]),
             **({"registration_pairs_per_sec": r["registration_pairs_per_sec"]}
                if "registration_pairs_per_sec" in r else {})}
            for r in results],
    }
    if not perf_meaningful:
        summary["note"] = "functional only: not a scaling claim"
    if pool[0].type == "cuda":
        from pctpu_torch.experiments import card

        summary["device"] = card.device_record(pool[0])
    print(json.dumps(summary), flush=True)
    return results, summary


def main(argv: list[str] | None = None) -> int:
    from pctpu_torch.experiments import card

    argv = sys.argv[1:] if argv is None else argv
    try:
        args = parse(argv)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 1
    if card.tool_device(args.device, "scaling_bench") is None:
        return 2
    try:
        results, _ = run(argv)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 1
    return 1 if any("ERROR" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
