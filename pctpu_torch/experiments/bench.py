"""pctpu's benchmark driver on the card — the port of ``bench.py``.

    python3 bench_torch.py [--verify] [--details] [--details-path=PATH]
        [--small] [--device=cuda|cpu]

(``bench_torch.py`` at the checkout's root calls :func:`main`; so does
``python -m pctpu_torch.experiments.bench``.)  It prints one JSON line, the
keys of bench.py's (bench.py:1170-1211): the on-device clouds/s of the fused
preprocess (``ops.preprocess.preprocess_batch``) on synthetic ordered
HDL-64E batches in tolerance mode (``value``) and bit-exact mode, each
against a single-core C++ baseline of the same algorithm
(``native/baseline_bev.cpp``) built and timed on the same machine, the
full-span rates with the per-cloud artifact writes added on both sides, the
real ``run_multi_bev`` span, the ``verify`` gate, and ``device`` (the card's
name and power limit).  ``--details`` also writes the details block
(bench.py:1115-1165: the general path, HDL-32E and OS1-64, pair-batched
registration pairs/s against ``native/baseline_registration.cpp``, the
per-stage utilization block) to ``--details-path`` (default
``build/pctpu_torch/bench_details.json``).  ``--verify`` runs the gate
alone.  ``--small`` takes the tiny sensor (8 × 64) and short runs, for the
CPU.  Without a card, ``--device=cuda`` (the default) exits 2.

What differs from bench.py, and why: the card is local (PCIe), so no
dispatch latency is subtracted, no input is perturbed against a value
cache, and the pipeline span needs no tunnel adjustment (the transfer of
one loader batch is measured, ``transfer_ms_per_batch``); the loops run
rep-outer and batch-inner, and each stage probe rotates over distinct inputs
of more than 200 MB, so that no input is still in the card's 50 MB L2 when
it comes round again; the baselines' error bar is the spread of this run's
three baseline runs, not a spread pinned from another machine; and every
file the driver builds or writes goes under ``build/pctpu_torch/``, never
into ``native/`` or the checkout's root.  The baselines run on the host's
CPU: their numbers are that host's.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

_REPO = Path(__file__).resolve().parent.parent.parent
BUILD_DIR = _REPO / "build" / "pctpu_torch"
DETAILS_PATH = BUILD_DIR / "bench_details.json"

N_POINTS = 120_000
BATCH = 8
BASELINE_CLOUDS = 10
# distinct inputs a stage probe rotates over, in bytes: four times the L2,
# counted over whole argument sets (a stage may read only part of each)
ROTATION_BYTES = 200e6
# the card's probe in a fresh interpreter (a failed CUDA init cannot be
# retried in-process)
PROBE = "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What a run measures on: the full sizes, or ``--small``'s."""

    small: bool
    k_stack: int  # distinct batches of ``measure_device``
    reps: int  # passes over them
    pipeline_clouds: int
    write_clouds: int
    baseline_clouds: int
    baseline_points: int
    baseline_pairs: int
    reg_every: int  # every k-th point of the registration scene
    reg_capacity: int
    reg_flat_cap: int
    reg_pairs: int  # pairs a batch of ``measure_registration``
    reg_batches: int
    nn_points: int  # ``verify``'s 1-NN size
    stage_target_ms: float


FULL = Sizes(False, 16, 8, 64, 12, BASELINE_CLOUDS, N_POINTS, 5, 1, 65536, 32768, 16, 6,
             49_000, 250.0)
SMALL = Sizes(True, 2, 2, 8, 2, 2, 2000, 1, 15, 4096, 4096, 2, 2, 2000, 20.0)


def _params(sensor):
    from pctpu_torch.config import get_sensor_params

    return get_sensor_params(sensor) if isinstance(sensor, str) else sensor


def _small_params():
    from pctpu_torch.config import SensorParams

    return SensorParams(n_scan=8, horizon_scan=64, ground_upper_scan=6, height_res=0.5)


def _bench_points(params) -> int:
    return min(N_POINTS, int(params.grid_size * 0.9))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _scratch(prefix: str) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=BUILD_DIR)


def _ratio_interval(pctpu_cps: float, session_ms: float, hist_ms: tuple) -> list:
    """[min, max] of pctpu_cps / baseline_cps over the union of this
    session's baseline measurement and the spread ``hist_ms`` (bench.py:41,
    the same function).  The port passes the min and max of this run's
    best-of-3 baseline runs as ``hist_ms``.  ratio = pctpu_cps *
    baseline_ms / 1000."""
    lo_ms = min(session_ms, hist_ms[0])
    hi_ms = max(session_ms, hist_ms[1])
    return [round(pctpu_cps * lo_ms / 1000.0, 3), round(pctpu_cps * hi_ms / 1000.0, 3)]


# --- the single-core C++ baselines -------------------------------------------

_LINK = {"baseline_bev": ["-lz"], "baseline_registration": []}


def build_native(name: str) -> Path:
    """``native/<name>.cpp`` built with bench.py's ``g++ -O2 -std=c++14``
    into ``build/pctpu_torch/<name>_<source hash>``, once per source, and
    published by a rename so that no run executes a half-written binary."""
    src = _REPO / "native" / f"{name}.cpp"
    exe = BUILD_DIR / f"{name}_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}"
    if not exe.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_name(f"{exe.name}.build{os.getpid()}")
        subprocess.run(["g++", "-O2", "-std=c++14", "-o", str(tmp), str(src), *_LINK[name]],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, exe)
    return exe


def measure_baseline(full_span: bool = False, sizes: Sizes = FULL) -> tuple[float, list]:
    """Single-core C++ ms a cloud (``native/baseline_bev.cpp``, bench.py:53):
    (best of 3 runs, [min, max] of the 3).  ``full_span=True`` adds the
    artifact writes the reference's [TIME] bracket covers (.bin, 24 + 1
    PNGs, the CSV) into a scratch directory."""
    exe = build_native("baseline_bev")
    runs = []
    for _ in range(3):
        argv = [str(exe), str(sizes.baseline_clouds), str(sizes.baseline_points)]
        io_dir = _scratch("baseline_span_") if full_span else None
        if io_dir is not None:
            argv.append(io_dir)
        try:
            out = subprocess.run(argv, check=True, capture_output=True, text=True,
                                 timeout=600).stdout
        finally:
            if io_dir is not None:
                shutil.rmtree(io_dir, ignore_errors=True)
        runs.append(float(json.loads(out)["ms_per_cloud"]))
    return min(runs), [min(runs), max(runs)]


def measure_registration_baseline(n_pairs: int = 5) -> dict:
    """Single-core C++ two-stage ICP ms a pair on the bench scene
    (``native/baseline_registration.cpp``, bench.py:750): the binary's JSON
    of the best of 3 runs, which must have solved the scene's known
    (17°, (1.5, −2)) inside the north-star window."""
    exe = build_native("baseline_registration")
    best = None
    for _ in range(3):
        out = json.loads(subprocess.run([str(exe), str(n_pairs)], check=True,
                                        capture_output=True, text=True, timeout=600).stdout)
        if best is None or out["ms_per_pair"] < best["ms_per_pair"]:
            best = out
    if not (best["successes"] == best["n_pairs"]
            and abs(best["last_fine_yaw_deg"] - 17.0) < 0.5
            and abs(best["last_fine_tx"] - 1.5) < 0.1
            and abs(best["last_fine_ty"] + 2.0) < 0.1):
        raise AssertionError(f"the registration baseline did not solve the scene: {best}")
    return best


def _wait_for_backend(max_wait_s: float | None = None, probe_timeout_s: float = 120.0,
                      device: str = "cuda") -> None:
    """Wait for the card before measuring (bench.py:100): probe it in
    short-lived interpreters (``PROBE``) until one answers or the budget
    (``PCTPU_BENCH_BACKEND_WAIT_S``, default 1,800 s) runs out, then go on
    either way — a measurement without a card then fails loudly; nothing
    falls back to the CPU.  ``device="cpu"`` returns at once."""
    if device == "cpu":
        return
    if max_wait_s is None:
        max_wait_s = float(os.environ.get("PCTPU_BENCH_BACKEND_WAIT_S", 1800))
    deadline = time.monotonic() + max_wait_s
    attempt = 0
    while True:
        attempt += 1
        try:
            r = subprocess.run([sys.executable, "-c", PROBE], timeout=probe_timeout_s,
                               capture_output=True)
            if r.returncode == 0:
                if attempt > 1:
                    print(f"bench: CUDA card up after {attempt} probes", file=sys.stderr)
                return
        except subprocess.TimeoutExpired:
            pass
        if time.monotonic() >= deadline:
            print(f"bench: CUDA card still unavailable after {attempt} probes; attempting "
                  "the measurement anyway", file=sys.stderr)
            return
        time.sleep(60.0)


# --- the device preprocess ----------------------------------------------------

def _scale(rep: int, offset: float) -> float:
    """pctpu's multiplicative perturbation 1 + 1e-7·(rep + offset), in f32
    as pctpu computes it: empty slots stay bit-zero and ordered clouds stay
    ordered."""
    s = np.float32(1.0) + np.float32(1e-7) * np.float32(rep + offset)
    return float(np.float32(s))


def bench_checksum(batch, params, ordered: bool, compat: str, scale: float) -> torch.Tensor:
    """One rep of :func:`measure_device` (bench.py:222-236): ``batch`` with
    its xyz scaled by ``scale`` through ``preprocess_batch``, then
    sum(multi) + sum(single) + sum(label) as an int64 on the batch's
    device (pctpu sums in int32, which these sizes do not overflow)."""
    from pctpu_torch.ops.preprocess import preprocess_batch

    labeled, multi, single = preprocess_batch(batch.replace(xyz=batch.xyz * scale), params,
                                              assume_ordered=ordered, compat=compat)
    return (multi.sum(dtype=torch.int64) + single.sum(dtype=torch.int64)
            + labeled.label.sum(dtype=torch.int64))


def measure_device(ordered: bool = True, sensor="HDL_64E", n_points: int | None = None,
                   compat: str = "bitexact", device="cuda", sizes: Sizes = FULL) -> float:
    """Sustained clouds/s of ``preprocess_batch`` on ``device`` (the
    counterpart of ``measure_tpu``, bench.py:186): ``k_stack`` distinct
    ``scene.synth_batch`` batches of ``BATCH`` clouds, ``reps`` perturbed
    passes over them, rep-outer and batch-inner (one batch is ≈ 38 MB of
    inputs at HDL-64E, the L2 50 MB: batch-outer, a batch's reps would hit
    it), the checksum accumulated on the device and read once after the
    loop.  Best of 3 timed runs at distinct offsets after a warm-up, the
    clock stopped after a synchronize; no latency is subtracted."""
    from pctpu_torch.experiments import scene

    dev = torch.device(device)
    params = _params(sensor)
    if n_points is None:
        n_points = _bench_points(params)
    batches = [scene.synth_batch(params, BATCH, n_points, seed, ordered=ordered, device=dev)
               for seed in range(sizes.k_stack)]

    def run(offset: float) -> int:
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for rep in range(sizes.reps):
            scale = _scale(rep, offset)
            for b in batches:
                acc += bench_checksum(b, params, ordered, compat, scale)
        return int(acc)

    run(0.0)
    dt = float("inf")
    for k in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        checksum = run(1000.0 * (k + 1))
        _sync(dev)
        dt = min(dt, time.perf_counter() - t0)
        if checksum == 0:
            raise AssertionError("measure_device: the checksum is 0")
    return sizes.k_stack * sizes.reps * BATCH / dt


def measure_write_ms(n_clouds: int = 12, sensor="HDL_64E", device="cuda") -> float:
    """The per-cloud artifact-write cost in ms (bench.py:279): the rasters
    of one preprocessed bench batch written through the port's writer,
    ``runtime.native_io.write_cloud_artifacts`` (.bin, 24 layer PNGs, the
    single PNG and CSV), best of 3 runs of ``n_clouds`` after a warm-up.
    The port's pipeline ships the occupancy BEV unpacked (ROADMAP: no bit
    packing on PCIe), so the writer takes the (24, 224, 224) raster."""
    from pctpu_torch.experiments import scene
    from pctpu_torch.ops.preprocess import preprocess_batch
    from pctpu_torch.runtime.native_io import write_cloud_artifacts

    params = _params(sensor)
    cloud = scene.synth_batch(params, BATCH, _bench_points(params), seed=3, ordered=True,
                              device=device)
    _, multi, single = preprocess_batch(cloud, params, assume_ordered=True)
    multi, single = multi.cpu().numpy(), single.cpu().numpy()
    io_dir = _scratch("write_")
    try:
        for sub in ("binary", "image", "single_image", "single_csv"):
            os.makedirs(os.path.join(io_dir, sub))

        def write(short: str, b: int) -> None:
            write_cloud_artifacts(os.path.join(io_dir, "binary", short + ".bin"),
                                  os.path.join(io_dir, "image", short + "/"),
                                  os.path.join(io_dir, "single_image", short + ".png"),
                                  os.path.join(io_dir, "single_csv", short + ".csv"),
                                  single[b], multi[b])

        write("warm", 0)  # the library's build and load, the page cache
        best = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            for i in range(n_clouds):
                write(f"{rep}_{i:06d}", i % BATCH)
            best = min(best, time.perf_counter() - t0)
    finally:
        shutil.rmtree(io_dir, ignore_errors=True)
    return best * 1000.0 / n_clouds


def _write_bench_tree(root: str, n_clouds: int, seed0: int, sensor="HDL_64E") -> None:
    """A selected-keyframe tree of bench-shaped clouds (bench.py:350): the
    selectors' layout (dense grid, empty slots all-zero with label 0) and a
    pose file, 3 m a frame."""
    from pctpu_torch.experiments import scene
    from pctpu_torch.geom.se3 import Pose6f
    from pctpu_torch.io.pcd import write_pcd
    from pctpu_torch.io.poses import format_pose_entry

    params = _params(sensor)
    n_points = _bench_points(params)
    os.makedirs(os.path.join(root, "keyframe_point_cloud"), exist_ok=True)
    lines = []
    idx = 0
    for seed in range(seed0, seed0 + (n_clouds + BATCH - 1) // BATCH):
        batch = scene.synth_batch(params, BATCH, n_points, seed, ordered=True, device="cpu")
        xyz = batch.xyz.numpy()
        intensity = batch.intensity.numpy()
        row = batch.row.numpy().astype(np.uint16)
        col = batch.col.numpy().astype(np.uint16)
        label = batch.label.numpy().astype(np.int16)
        for b in range(BATCH):
            if idx >= n_clouds:
                break
            write_pcd(os.path.join(root, "keyframe_point_cloud", f"{idx:06d}.pcd"), {
                "x": xyz[b, :, 0], "y": xyz[b, :, 1], "z": xyz[b, :, 2],
                "intensity": intensity[b], "row": row[b], "col": col[b],
                "t": np.zeros(xyz.shape[1], np.uint32), "label": label[b],
            }, width=xyz.shape[1])
            lines.append(format_pose_entry(
                idx, Pose6f.from_matrix(np.eye(3), np.array([3.0 * idx, 0, 0]))))
            idx += 1
    with open(os.path.join(root, "keyframe_pose.csv"), "w") as f:
        f.writelines(lines)


# the wide wire, kept beside the pipelines' narrow one for comparison: every
# field widened on the host (36 B a slot, 8 B a cloud) and copied each way
# pageable and blocking, one field at a time
_WIDE = {"xyz": np.float32, "intensity": np.float32, "row": np.int32, "col": np.int32,
         "t": np.int64, "label": np.int32, "count": np.int64}


def to_device_wide(arrays: dict, device, rows: slice = slice(None)):
    """The wide wire's upload: ``multi_bev._to_device``'s result, widened on
    the host and copied pageable."""
    from pctpu_torch.cloud import Cloud

    return Cloud(**{k: torch.from_numpy(np.ascontiguousarray(arrays[k][rows], w)).to(device)
                    for k, w in _WIDE.items()})


def wire_transfer(arrays: dict, device="cuda") -> dict:
    """One loader batch's wire as the BEV pipelines move it: up through
    ``multi_bev._to_device`` (on-disk widths, pinned on a card, widened
    there), back through ``_to_host(_wire(...))`` (narrowed on the device,
    pinned on a card, one synchronize); each direction on the host clock,
    the upload ended by a synchronize.  Beside it the same batch over the
    wide wire (:func:`to_device_wide`, each field copied back blocking).  In turns (narrow, wide, wide, narrow) after
    a warm-up of each, the least of each side's two."""
    from pctpu_torch.pipelines.multi_bev import _UP, _to_device, _to_host, _wire

    dev = torch.device(device)

    # each turn lets go of what it copied back, as the pipeline does once its
    # writers are done: a later turn's pinned blocks then come from the cache
    def narrow():
        t0 = time.perf_counter()
        cloud = _to_device(arrays, dev)
        _sync(dev)
        t1 = time.perf_counter()
        host = _to_host([_wire(cloud)])
        t2 = time.perf_counter()
        return (t1 - t0, t2 - t1, sum(a.nbytes for a in host.values()),
                torch.from_numpy(host["xyz"]).is_pinned())

    def wide():
        t0 = time.perf_counter()
        cloud = to_device_wide(arrays, dev)
        fields = [getattr(cloud, k) for k in _WIDE]
        _sync(dev)
        t1 = time.perf_counter()
        back = [x.cpu() for x in fields]
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, sum(x.numel() * x.element_size() for x in back)

    narrow(), wide()
    runs = {"narrow": [], "wide": []}
    for side in ("narrow", "wide", "wide", "narrow"):
        runs[side].append((narrow if side == "narrow" else wide)())
    up, back = (min(r[i] for r in runs["narrow"]) for i in (0, 1))
    wide_up, wide_back = (min(r[i] for r in runs["wide"]) for i in (0, 1))
    up_bytes = sum(arrays[k].size * np.dtype(w).itemsize for k, w in _UP.items())
    back_bytes, pinned = runs["narrow"][0][2:]
    wide_bytes = runs["wide"][0][2]
    return {
        "transfer_ms_per_batch": (up + back) * 1e3,
        "transfer_mb_per_batch": (up_bytes + back_bytes) / 1e6,
        "transfer_up_ms": up * 1e3,
        "transfer_back_ms": back * 1e3,
        "transfer_mb_up": up_bytes / 1e6,
        "transfer_mb_back": back_bytes / 1e6,
        "transfer_pinned": pinned,
        "wide_transfer_ms_per_batch": (wide_up + wide_back) * 1e3,
        "wide_transfer_mb_per_batch": 2 * wide_bytes / 1e6,
        "wide_transfer_up_ms": wide_up * 1e3,
        "wide_transfer_back_ms": wide_back * 1e3,
    }


def measure_pipeline_span(n_clouds: int = 64, sensor="HDL_64E", device="cuda") -> dict:
    """The real ``run_multi_bev`` span (bench.py:392): the tool (prefetch
    loader → batched preprocess → writer threads, PNGs on, tolerance mode)
    over a warm tree of one batch, then a timed tree of ``n_clouds`` other
    clouds; its own loop wall a cloud is the span (the writes overlap the
    device loop in it).  Beside it: :func:`wire_transfer` of one loader
    batch, through the pipeline's own upload and copy back."""
    from pctpu_torch.pipelines.multi_bev import run_multi_bev
    from pctpu_torch.runtime.loader import list_pcd_files, load_xyzirct_arrays, stack_batch

    dev = torch.device(device)
    params = _params(sensor)
    warm_dir, timed_dir = _scratch("pipe_warm_"), _scratch("pipe_")
    try:
        _write_bench_tree(warm_dir, BATCH, seed0=100, sensor=params)
        _write_bench_tree(timed_dir, n_clouds, seed0=200, sensor=params)
        run_multi_bev(warm_dir, params, batch_size=BATCH, compat="tolerance", device=dev)
        out = run_multi_bev(timed_dir, params, batch_size=BATCH, compat="tolerance", device=dev)
        if out.num_clouds != n_clouds:
            raise AssertionError(f"run_multi_bev wrote {out.num_clouds} of {n_clouds} clouds")
        files = list_pcd_files(os.path.join(warm_dir, "keyframe_point_cloud"))[:BATCH]
        wire = wire_transfer(stack_batch([load_xyzirct_arrays(f, params.grid_size, params=params)
                                          for f in files]), dev)
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)
        shutil.rmtree(timed_dir, ignore_errors=True)

    wall_ms = out.wall_ms_per_cloud
    device_ms = out.avg_device_ms_per_cloud  # the in-stage transfers included
    write_ms = out.avg_bev_write_ms_per_cloud
    hidden_pct = max(0.0, 100.0 * (1.0 - max(wall_ms - device_ms, 0.0) / max(write_ms, 1e-9)))
    return {
        "pipeline_full_span_clouds_per_sec": 1000.0 / wall_ms,
        "pipeline_wall_ms_per_cloud": wall_ms,
        "pipeline_device_ms_per_cloud_incl_transfers": device_ms,
        "pipeline_bev_write_ms_per_cloud": write_ms,
        "pipeline_serial_sum_ms_per_cloud": device_ms + write_ms,
        "pipeline_write_overlap_hidden_pct": hidden_pct,
        **wire,
    }


# --- the utilization block -----------------------------------------------------

def _stage_ms(fn, arg_sets: list, reps: int = 8, target_ms: float = 250.0,
              device="cuda") -> float:
    """ms a call of ``fn(*args)``, ``args`` taken in turn from ``arg_sets``
    (bench.py:491): a pilot run of ``reps`` calls, one rescale of the rep
    count toward ``target_ms``, then the best of 3 runs; each run timed with
    a CUDA-event pair around its calls (a host clock ended by a synchronize
    on the CPU); no latency subtracted.  The rotation over distinct inputs
    takes the place of pctpu's perturbed offsets: ``arg_sets`` together
    exceed the L2 (:func:`_rotation`), so no call finds its input there."""
    dev = torch.device(device)

    def run(n: int) -> float:
        if dev.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                fn(*arg_sets[i % len(arg_sets)])
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop)
        t0 = time.perf_counter()
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
        return (time.perf_counter() - t0) * 1e3

    run(len(arg_sets))  # warm-up: every input once
    ms = run(reps)
    if ms < target_ms:
        per_rep = max(ms / reps, 1e-4)
        reps = min(int(target_ms / per_rep) + 1, reps * 1024)
    return min(run(reps) for _ in range(3)) / reps


def _nbytes(args) -> int:
    total = 0
    for a in args:
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif dataclasses.is_dataclass(a):
            total += _nbytes([getattr(a, f.name) for f in dataclasses.fields(a)])
    return total


def _rotation(make, max_sets: int = 64) -> list:
    """Argument sets ``make(k)`` for k = 0, 1, … until together they hold
    ``ROTATION_BYTES`` (at most ``max_sets``)."""
    sets, total = [], 0
    while total < ROTATION_BYTES and len(sets) < max_sets:
        sets.append(make(len(sets)))
        total += _nbytes(sets[-1])
    return sets


def utilization_block(tol_cps: float | None = None, exact_cps: float | None = None,
                      sensor="HDL_64E", device="cuda", target_ms: float = 250.0) -> dict:
    """Per-stage device time against primitive peaks measured fresh on the
    card and against the card's roofline (bench.py:547).  Primitive peaks
    (library calls as yardsticks): ``torch.sort`` of 24-bit keys with a
    payload gather at L = G + 224², ``index_add_`` of 2-wide rows into
    (8192, 2), a 1024² f32 ``torch.matmul`` (TF32 off) and a 128 MB
    read-and-sum.  Stages at kernel shapes (``BATCH`` clouds): the fused
    raster (``bev.fused_multi_single_bev``, the ``bev_raster`` kernel), both
    ground marks, and the sector sums alone (``ground._grid_sums_bitexact``,
    the ``ground_sums`` kernel, and ``_grid_sums_tolerance``).  Each row
    keeps pctpu's ``primitive_bound_ms`` / ``pct_of_primitive_peak`` (which
    may pass 100: a kernel can beat the generic probe) and adds
    ``roofline_bound_ms`` (``card.bound_ms`` of the bytes and operations the
    stage's work needs, whatever implements it) and ``pct_of_roofline``,
    which cannot pass 100 unless the timing is wrong.  On the CPU the
    roofline share is None: the bound is the card's."""
    from pctpu_torch.config import GroundConfig, MultiBevConfig
    from pctpu_torch.experiments import card, scene
    from pctpu_torch.ops import ground
    from pctpu_torch.ops.bev import fused_multi_single_bev

    dev = torch.device(device)
    params = _params(sensor)
    cfg = GroundConfig()
    n_points = _bench_points(params)
    g = params.grid_size
    swept = min((params.ground_upper_scan + 1) * params.horizon_scan, g)
    s_bev = MultiBevConfig().mat_size
    L = g + s_bev * s_bev  # the fused BEV's sort length: points + one sentinel a cell
    gen = torch.Generator(device=dev)

    def stage(fn, make, reps=8):
        return _stage_ms(fn, _rotation(make), reps=reps, target_ms=target_ms, device=dev)

    def rand_int(seed, high, shape):
        gen.manual_seed(seed)
        return torch.randint(0, high, shape, generator=gen, device=dev, dtype=torch.int32)

    def rand(seed, shape):
        gen.manual_seed(seed)
        return torch.rand(shape, generator=gen, device=dev)

    # ---- primitive peaks, measured in this run on this card ----
    def f_sort(keys, payload):
        sk, order = torch.sort(keys, dim=1)
        return sk, payload.gather(1, order)

    sort_ms = stage(f_sort, lambda k: (rand_int(2 * k, 1 << 24, (BATCH, L)),
                                       rand_int(2 * k + 1, 1 << 30, (BATCH, L))))
    sort_ns = sort_ms * 1e6 / (BATCH * L * 2)  # per element per operand
    rows = (torch.arange(BATCH, device=dev, dtype=torch.int64) * 8192)[:, None]

    def f_scatter(idx, vals):
        out = torch.zeros((BATCH * 8192, 2), device=dev)
        return out.index_add_(0, (idx + rows).reshape(-1), vals.reshape(-1, 2))

    scatter_ms = stage(f_scatter, lambda k: (rand_int(2 * k, 8192, (BATCH, swept)).long(),
                                             rand(2 * k + 1, (BATCH, swept, 2))))
    scatter_ns = scatter_ms * 1e6 / (BATCH * swept)  # per 2-wide update row
    mm = 1024
    matmul_ms = stage(torch.matmul, lambda k: (rand(2 * k, (mm, mm)), rand(2 * k + 1, (mm, mm))),
                      reps=16)
    matmul_tmacs = mm**3 / (matmul_ms * 1e-3) / 1e12  # f32 MAC/s, TF32 off
    big = [(rand(k, (1 << 25,)),) for k in range(2)]  # 128 MB each
    hbm_ms = _stage_ms(torch.sum, big, reps=8, target_ms=target_ms, device=dev)
    hbm_gbps = big[0][0].numel() * 4 / (hbm_ms * 1e-3) / 1e9  # one read pass
    del big

    # ---- stage times at kernel shapes (ms a cloud) ----
    def batch(seed):
        return scene.synth_batch(params, BATCH, n_points, seed, ordered=True, device=dev)

    def labeled(seed):
        return (ground.mark_ground(batch(seed), params, cfg)[0],)

    def f_bev(lb):
        return fused_multi_single_bev(lb, params.height_res)

    bev_ms = stage(f_bev, lambda k: labeled(3 + k)) / BATCH

    def grid_args(seed):
        b = batch(3 + seed)
        x, y, z = (b.xyz[:, :swept, i].contiguous() for i in range(3))
        srow, scol = ground._belonging_grid(x, y, cfg)
        return srow, scol, z, b.label[:, :swept] == -2

    def f_grid_exact(sector, z, gr):
        return ground._grid_sums_bitexact(sector, z, gr, cfg)

    def exact_args(k):
        srow, scol, z, gr = grid_args(k)
        return srow * cfg.grid_cols + scol, z, gr

    grid_exact_ms = stage(f_grid_exact, exact_args) / BATCH

    def f_grid_tol(srow, scol, z, gr):
        return ground._grid_sums_tolerance(srow, scol, z, gr, cfg)

    grid_tol_ms = stage(f_grid_tol, grid_args) / BATCH

    def f_mark(compat):
        return lambda b: ground.mark_ground(b, params, cfg, compat=compat)

    mark_tol_ms = stage(f_mark("tolerance"), lambda k: (batch(3 + k),)) / BATCH
    mark_exact_ms = stage(f_mark("bitexact"), lambda k: (batch(3 + k),)) / BATCH

    # ---- pctpu's primitive bounds a stage ----
    bev_bound = 2 * L * 2 * sort_ns / 1e6  # two sorts, 2 operands each
    scatter_bound = swept * scatter_ns / 1e6  # one 2-wide update a point
    macs = swept * 2 * cfg.grid_rows * cfg.grid_cols  # (P, 2R) @ (P, C)
    grid_tol_bound = macs / (matmul_tmacs * 1e12) * 1e3
    # ~30 elementwise passes over the swept planes, read + write each
    sweep_bound = 30 * (swept * 4 * 2) / (hbm_gbps * 1e9) * 1e3

    # ---- the card's roofline a cloud: each input read once, each output
    # written once, the operations the work needs ----
    sectors = cfg.grid_rows * cfg.grid_cols
    roof = {
        # xyz and label read (16 B a point), both rasters written (1 B a cell)
        "bev": card.bound_ms(16 * g + (24 + 1) * s_bev * s_bev, 0),
        # sector id, z and the ground flag (9 B) a swept point; (z sum,
        # count) a sector; one add each a ground point
        "grid_exact": card.bound_ms(9 * swept + 8 * sectors, 2 * swept),
        # sector row, column, z and the flag (13 B) a swept point
        "grid_tol": card.bound_ms(13 * swept + 8 * sectors, 2 * swept),
        # xyz, intensity and label read (20 B) a point, label and ground
        # mark written (5 B); ≈ 30 flops a swept point (the slope's
        # differences, length, atan2 and test) and the sector sums
        "mark": card.bound_ms(25 * g, 32 * swept),
    }

    def row(measured, bound, rb):
        return {
            "measured_ms_per_cloud": measured,
            "primitive_bound_ms": bound,
            "pct_of_primitive_peak": 100.0 * bound / measured if measured > 0 else None,
            "roofline_bound_ms": rb[0],
            "roofline_bound_by": rb[1],
            "pct_of_roofline": (100.0 * rb[0] / measured
                                if measured > 0 and dev.type == "cuda" else None),
        }

    out = {
        "primitive_peaks": {
            "sort_ns_per_elem_per_operand": sort_ns,
            "scatter_ns_per_update_row": scatter_ns,
            "matmul_f32_highest_tmacs": matmul_tmacs,
            "hbm_read_gbps": hbm_gbps,
        },
        "stages": {
            "fused_multi_single_bev": row(bev_ms, bev_bound, roof["bev"]),
            "mark_ground_bitexact": row(mark_exact_ms, scatter_bound + sweep_bound,
                                        roof["mark"]),
            "mark_ground_tolerance": row(mark_tol_ms, grid_tol_bound + sweep_bound,
                                         roof["mark"]),
        },
        "substages_isolated": {
            "ground_grid_scatter_bitexact": row(grid_exact_ms, scatter_bound,
                                                roof["grid_exact"]),
            "ground_grid_mxu_tolerance": row(grid_tol_ms, grid_tol_bound, roof["grid_tol"]),
        },
        "stage_sum_tolerance_ms": bev_ms + mark_tol_ms,
    }
    if tol_cps:
        kernel_ms = 1000.0 / tol_cps
        out["kernel_tolerance_ms_per_cloud"] = kernel_ms
        out["stage_sum_vs_kernel"] = out["stage_sum_tolerance_ms"] / kernel_ms
    if exact_cps and tol_cps:
        out["kernel_bitexact_ms_per_cloud"] = 1000.0 / exact_cps
    return out


# --- the verify gate --------------------------------------------------------------

def _one(cloud):
    """The first cloud of a batched Cloud."""
    from pctpu_torch.cloud import Cloud

    return Cloud(**{f.name: None if (v := getattr(cloud, f.name)) is None else v[0]
                    for f in dataclasses.fields(Cloud)})


def verify(device="cuda", sizes: Sizes = FULL) -> str:
    """The on-device gate (``verify_on_device``, bench.py:786): "ok", or
    AssertionError.

    1. K1 (``cuda_knn.nn_1_pruned``, spatially sorted) at thr 1 m and
       without against ``knn.nn_1`` at 49,000²: every index and d² equal
       outside pctpu's score window, at most 0.1% swaps inside it;
    2. the fused rasters (``bev_raster``) against ``multi_bev`` +
       ``single_bev`` at HDL-64E, both compat modes, byte for byte;
    3. ``register_pair`` on three known-transform scenes (seeds 500-502,
       capacity 4,096): yaw < 0.5°, translation < 0.10 m, fitness ≤ 1.5;
    4. ``register_pairs`` of the three against the single pairs (atol 2e-3);
    5. the pinned two-stage scene 1 against the composed oracle
       (``tests/ref_impl.py`` by path, ``experiments.oracle``) under the
       campaign's two-stage contract (``fuzz_campaign.two_stage_contract``).

    ``sizes.small`` cuts the 1-NN to 2,000² and the rasters to the tiny
    sensor."""
    from pctpu_torch.cloud import make_cloud
    from pctpu_torch.config import get_sensor_params
    from pctpu_torch.experiments import fuzz_campaign, fuzz_scenes, oracle, scene
    from pctpu_torch.ops import cuda_knn, knn
    from pctpu_torch.ops.bev import fused_multi_single_bev, multi_bev, single_bev
    from pctpu_torch.ops.ground import mark_ground
    from pctpu_torch.ops.ordering import get_ordered_cloud
    from pctpu_torch.pipelines.registration import register_pair, register_pairs

    dev = torch.device(device)

    # --- 1. the pruned 1-NN against the blocked argmin -------------------------
    rng = np.random.default_rng(7)
    n = sizes.nn_points
    pts = rng.uniform(-70, 70, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 8, n).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    q, qm, _ = cuda_knn.spatial_sort(torch.from_numpy(pts).to(dev), ones)
    t, tm, _ = cuda_knn.spatial_sort(torch.from_numpy(tgt).to(dev), ones)
    i_ref, d_ref = (a.cpu().numpy() for a in knn.nn_1(q, qm, t, tm))
    i_thr, d_thr = (a.cpu().numpy() for a in cuda_knn.nn_1_pruned(q, qm, t, tm, max_distance=1.0))
    i_fit, d_fit = (a.cpu().numpy() for a in cuda_knn.nn_1_pruned(q, qm, t, tm))
    # knn.nn_1 ranks |t|² − 2q·t scores, absolute error ~|p|²·2⁻²³: targets
    # closer than that window may resolve either way (bench.py:831-838)
    window = 8.0 * float((t.double() ** 2).sum(dim=1).max()) * 2.0**-23

    def check(name, i2, d2, sel):
        swap = (i2 != i_ref) & sel
        if not np.all(np.abs(d2[swap] - d_ref[swap]) <= window):
            raise AssertionError(f"pruned NN ({name}): winner swap outside the score window")
        if swap.sum() > max(1, int(0.001 * n)):
            raise AssertionError(f"pruned NN ({name}): {swap.sum()} swaps — not near-tie noise")
        same = sel & ~swap
        if not np.array_equal(i2[same], i_ref[same]):
            raise AssertionError(f"pruned NN ({name}) idx")
        if not np.array_equal(d2[same], d_ref[same]):
            raise AssertionError(f"pruned NN ({name}) d2")

    within = d_ref <= 1.0
    check("thr", i_thr, d_thr, within)
    beyond = ~within
    if not np.all(~np.isfinite(d_thr[beyond]) | (d_thr[beyond] > 1.0 - window)):
        raise AssertionError("pruned NN (thr) beyond-gate")
    check("fitness", i_fit, d_fit, np.ones(n, bool))

    # --- 2. fused against unfused rasters at HDL-64E, both compat modes ---------
    params = _small_params() if sizes.small else get_sensor_params("HDL_64E")
    cloud = _one(scene.synth_batch(params, 1, min(N_POINTS, params.grid_size), seed=11,
                                   device=dev))
    ordered = get_ordered_cloud(cloud, params)
    for compat in ("bitexact", "tolerance"):
        lab, _ = mark_ground(ordered, params, compat=compat)
        fm, fs = fused_multi_single_bev(lab, params.height_res)
        if not torch.equal(fm, multi_bev(lab, params.height_res)):
            raise AssertionError(f"fused multi BEV ({compat})")
        if not torch.equal(fs, single_bev(lab)):
            raise AssertionError(f"fused single BEV ({compat})")

    # --- 3. the north star's precision: known-transform registration ------------
    batched_inputs, single_fine = [], []
    for seed in range(3):
        rng = np.random.default_rng(500 + seed)
        pts_l, labels = [], []
        for _ in range(12):
            cx, cy = rng.uniform(-50, 50, 2)
            k = 150
            pts_l.append(np.stack([cx + rng.normal(0, 2.5, k), cy + rng.normal(0, 2.5, k),
                                   rng.uniform(0, 9, k)], 1))
            labels.append(np.full(k, -2))
        ng = 1500
        pts_l.append(np.stack([rng.uniform(-70, 70, ng), rng.uniform(-70, 70, ng),
                               rng.uniform(-2.0, -1.9, ng)], 1))
        labels.append(np.zeros(ng))
        xyz = np.concatenate(pts_l).astype(np.float32)
        lab = np.concatenate(labels).astype(np.int32)
        true_yaw = float(rng.uniform(-60, 60))
        tx, ty = rng.uniform(-3, 3, 2)
        th = math.radians(true_yaw)
        rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                       np.float32)
        xyz2 = (xyz @ rot.T + np.float32([tx, ty, 0])
                + rng.normal(0, 0.01, xyz.shape)).astype(np.float32)
        c1 = make_cloud(xyz, label=lab, capacity=4096, device=dev)
        c2 = make_cloud(xyz2, label=lab, capacity=4096, device=dev)
        guess = true_yaw + float(rng.uniform(-8, 8))
        _, fine = register_pair(c1, c2, angle_guess_deg=guess, flat_cap=4096)
        if not float(fine.fitness) <= 1.5:
            raise AssertionError(f"registration failed (seed {seed}): {float(fine.fitness)}")
        tf = np.asarray(fine.transform)
        yaw_err = abs(math.degrees(math.atan2(tf[1, 0], tf[0, 0])) - true_yaw)
        t_err = float(np.hypot(tf[0, 3] - tx, tf[1, 3] - ty))
        if not yaw_err < 0.5:
            raise AssertionError(f"yaw error {yaw_err}° (seed {seed})")
        if not t_err < 0.10:
            raise AssertionError(f"translation error {t_err} m (seed {seed})")
        batched_inputs.append((c1, c2, guess))
        single_fine.append(tf)

    # --- 4. batched against single pairs ---------------------------------------
    for k, (_, fine_b) in enumerate(register_pairs(batched_inputs, flat_cap=4096)):
        if not np.allclose(np.asarray(fine_b.transform), single_fine[k], atol=2e-3):
            raise AssertionError(f"batched fine transform diverges from single-pair (scene {k})")

    # --- 5. the two-stage differential against the composed oracle ---------------
    xyz1, lab1, xyz2, lab2, guess, _ = fuzz_scenes.twostage_scene(1)
    ref, stable = fuzz_campaign.twostage_oracle_stable(oracle.ref_impl(), xyz1, lab1, xyz2,
                                                       lab2, guess)
    if not stable:
        raise AssertionError("verify scene became a knife edge (pin a different seed)")
    best_ts, fine_ts = register_pair(make_cloud(xyz1, label=lab1, capacity=4096, device=dev),
                                     make_cloud(xyz2, label=lab2, capacity=4096, device=dev),
                                     angle_guess_deg=guess, flat_cap=4096)
    fuzz_campaign.two_stage_contract(best_ts, fine_ts, ref)
    return "ok"


# --- registration --------------------------------------------------------------

def registration_scene(device="cuda", sizes: Sizes = FULL):
    """The bench's registration pair (bench.py:968; ``scene.registration_scene``:
    40 clusters over flat ground, the second cloud turned 17° and shifted
    by (1.5, −2)) as two clouds on ``device`` at capacity 65,536 (``--small``:
    every 15th point at 4,096)."""
    from pctpu_torch.cloud import make_cloud
    from pctpu_torch.experiments import scene

    xyz, lab = scene.registration_scene()
    xyz, lab = xyz[::sizes.reg_every], lab[::sizes.reg_every]
    return (make_cloud(xyz, label=lab, capacity=sizes.reg_capacity, device=device),
            make_cloud(scene.moved_copy(xyz), label=lab, capacity=sizes.reg_capacity,
                       device=device))


def measure_registration(return_stages: bool = False, depth: int = 1, offset_base: int = 100,
                         device="cuda", sizes: Sizes = FULL):
    """Pair-batched two-stage registration pairs/s (bench.py:1002): after a
    ``register_pairs`` warm-up, ``register_pairs_pipelined`` (``depth``
    batches ahead) over ``reg_batches`` prebuilt batches of ``reg_pairs``
    pairs (pair i's first cloud shifted by (offset + i)·1e-4, no offset
    twice), ``RegistrationConfig()``, flat cap 32,768, a ``StageTimer``.
    ``return_stages=True`` also returns its per-pair stage walls
    ("coarse", "fine")."""
    from pctpu_torch.config import RegistrationConfig
    from pctpu_torch.pipelines.registration import register_pairs, register_pairs_pipelined
    from pctpu_torch.runtime.profiler import StageTimer

    dev = torch.device(device)
    c1, c2 = registration_scene(dev, sizes)
    n_pairs = sizes.reg_pairs

    def batch(off: int) -> list:
        return [(c1.replace(xyz=c1.xyz + (off + i) * 1e-4), c2, 17.0) for i in range(n_pairs)]

    cfg = RegistrationConfig()
    register_pairs(batch(1), cfg, flat_cap=sizes.reg_flat_cap)  # warm-up
    stage_timer = StageTimer()
    built = [batch(offset_base + n_pairs * i) for i in range(sizes.reg_batches)]
    _sync(dev)  # input prep is no pipeline work
    t0 = time.perf_counter()
    for _ in register_pairs_pipelined(iter([lambda b=b: b for b in built]), cfg,
                                      flat_cap=sizes.reg_flat_cap, timer=stage_timer,
                                      depth=depth):
        pass
    pps = sizes.reg_batches * n_pairs / (time.perf_counter() - t0)
    if return_stages:
        return pps, {k: stage_timer.average_ms(k) for k in sorted(stage_timer.totals_ms)}
    return pps


# --- the driver ------------------------------------------------------------------

def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 bench_torch.py",
                                 description="pctpu's benchmark driver on the card")
    ap.add_argument("--verify", action="store_true", help="the on-device gate alone")
    ap.add_argument("--details", action="store_true",
                    help="also write the details block to --details-path")
    ap.add_argument("--details-path", default=str(DETAILS_PATH))
    ap.add_argument("--small", action="store_true",
                    help="the tiny sensor (8 x 64) and short runs, for the CPU")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs (default: the card)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from pctpu_torch.experiments import card

    args = parser().parse_args(sys.argv[1:] if argv is None else argv)
    dev = card.tool_device(args.device, "bench_torch")
    if dev is None:
        return 2
    _wait_for_backend(device=dev.type)
    sizes = SMALL if args.small else FULL
    where = card.device_record(dev)
    if args.verify:
        print(json.dumps({"verify": verify(dev, sizes), "device": where}))
        return 0
    sensor = _small_params() if sizes.small else "HDL_64E"
    n_points = 256 if sizes.small else None
    baseline_ms, spread = measure_baseline(sizes=sizes)
    baseline_cps = 1000.0 / baseline_ms
    baseline_span_ms, span_spread = measure_baseline(full_span=True, sizes=sizes)
    baseline_span_cps = 1000.0 / baseline_span_ms
    # headline: tolerance mode (bench.py:1090-1094); bit-exact beside it
    tol_cps = measure_device(True, sensor, n_points, "tolerance", dev, sizes)
    exact_cps = measure_device(True, sensor, n_points, "bitexact", dev, sizes)
    write_ms = measure_write_ms(sizes.write_clouds, sensor, dev)
    tol_span_cps = 1000.0 / (1000.0 / tol_cps + write_ms)
    exact_span_cps = 1000.0 / (1000.0 / exact_cps + write_ms)
    # the tool's own span; its failure is recorded, not fatal (bench.py:1100)
    try:
        pipe = measure_pipeline_span(sizes.pipeline_clouds, sensor, dev)
    except Exception as e:  # the line must still be printed
        traceback.print_exc()
        pipe = {"pipeline_span_error": f"{type(e).__name__}: {e}"}
    verified = verify(dev, sizes)
    interval = _ratio_interval(tol_cps, baseline_ms, spread)
    span_interval = _ratio_interval(tol_span_cps, baseline_span_ms, span_spread)
    if args.details:
        general_cps = measure_device(False, sensor, n_points, "bitexact", dev, sizes)
        general_tol_cps = measure_device(False, sensor, n_points, "tolerance", dev, sizes)
        hdl32_cps = measure_device(True, sensor if sizes.small else "HDL_32E",
                                   n_points, "bitexact", dev, sizes)
        os1_cps = measure_device(True, sensor if sizes.small else "OS1_64",
                                 n_points, "bitexact", dev, sizes)
        pairs_per_sec, reg_stages = measure_registration(return_stages=True, device=dev,
                                                         sizes=sizes)
        reg_base = measure_registration_baseline(sizes.baseline_pairs)
        reg_base_pps = 1000.0 / reg_base["ms_per_pair"]
        details = {
            "hdl64e_multibev_clouds_per_sec_tolerance": tol_cps,
            "hdl64e_multibev_clouds_per_sec_bitexact": exact_cps,
            "hdl64e_multibev_general_path_clouds_per_sec": general_cps,
            "hdl64e_multibev_general_path_clouds_per_sec_tolerance": general_tol_cps,
            "hdl32e_multibev_clouds_per_sec": hdl32_cps,
            "os1_64_multibev_clouds_per_sec": os1_cps,
            "baseline_single_core_clouds_per_sec": baseline_cps,
            "baseline_ms_per_cloud": baseline_ms,
            "baseline_full_span_clouds_per_sec": baseline_span_cps,
            "baseline_full_span_ms_per_cloud": baseline_span_ms,
            "pctpu_bev_write_ms_per_cloud": write_ms,
            "full_span_clouds_per_sec_tolerance": tol_span_cps,
            "full_span_clouds_per_sec_bitexact": exact_span_cps,
            "vs_baseline_full_span": tol_span_cps / baseline_span_cps,
            "vs_baseline_full_span_bitexact": exact_span_cps / baseline_span_cps,
            "registration_pairs_per_sec_65k": pairs_per_sec,
            "registration_stage_wall_ms_per_pair": reg_stages,
            "registration_baseline_single_core_pairs_per_sec": reg_base_pps,
            "registration_baseline_ms_per_pair": reg_base["ms_per_pair"],
            "registration_baseline_stage_ms": {"coarse": reg_base["coarse_ms"],
                                               "fine": reg_base["fine_ms"]},
            "registration_vs_baseline": pairs_per_sec / reg_base_pps,
            **pipe,
            "vs_baseline_interval": interval,
            "vs_baseline_full_span_interval": span_interval,
            "baseline_ms_spread": spread,
            "utilization": utilization_block(tol_cps, exact_cps, sensor, dev,
                                             target_ms=sizes.stage_target_ms),
            "verify": verified,
            "small": sizes.small,
            "device": where,
            # the baselines ran on this host's CPU, one core
            "baseline_host": {"machine": platform.machine(), "cpu_count": os.cpu_count()},
        }
        path = Path(args.details_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(details, indent=2) + "\n")
    print(json.dumps({
        "metric": "hdl64e_multibev_clouds_per_sec",
        "value": tol_cps,
        "unit": "clouds/s",
        "vs_baseline": tol_cps / baseline_cps,
        "compat": "tolerance",
        "bitexact_clouds_per_sec": exact_cps,
        "bitexact_vs_baseline": exact_cps / baseline_cps,
        # both sides with the reference's in-[TIME] artifact writes
        "full_span_clouds_per_sec": tol_span_cps,
        "baseline_full_span_clouds_per_sec": baseline_span_cps,
        "vs_baseline_full_span": tol_span_cps / baseline_span_cps,
        # the ratios over this run's spread of baseline runs
        "vs_baseline_interval": interval,
        "vs_baseline_full_span_interval": span_interval,
        # the tool's own span (run_multi_bev's loop wall)
        "pipeline_full_span_clouds_per_sec": pipe.get("pipeline_full_span_clouds_per_sec"),
        "pipeline_write_overlap_hidden_pct": pipe.get("pipeline_write_overlap_hidden_pct"),
        "transfer_ms_per_batch": pipe.get("transfer_ms_per_batch"),
        "transfer_mb_per_batch": pipe.get("transfer_mb_per_batch"),
        **({"pipeline_span_error": pipe["pipeline_span_error"]}
           if "pipeline_span_error" in pipe else {}),
        "verify": verified,
        "small": sizes.small,
        "device": where,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
