"""The registration pipelines — the sequential paths of
``pctpu/pipelines/registration.py``.

batch_top_part_registration
(reference/BatchTopPartRegistration.cpp:311-541), per pair:
top-part extraction + 0.2 m voxel of both clouds, 2-D normals of the target,
point-to-plane ICP from the two yaw guesses {θ, θ+180°} (best fitness wins),
then a 0.2 m voxel of the full clouds and a point-to-point fine ICP seeded
with the coarse winner; the precision report carries the coarse-vs-fine
Δxy/Δyaw with the reference's f32 arithmetic.

batch_whole_registration (reference/BatchWholeRegistration.cpp:311-418), the
ablation: a 0.2 m voxel of both full clouds and one point-to-point ICP
(``WHOLE_ICP``: 4 m, up to 200 iterations) from the yaw guess; only the
success and failure counts are reported.

The top-part stage inputs are cut to capacity buckets (a power of two for the flat
clouds, a multiple of 8,192 for the full ones), as pctpu does: results
depend on the padded width through f32 reduction shapes (D5), so the port
pads the same way.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os

import numpy as np
import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import WHOLE_ICP, RegistrationConfig
from pctpu_torch.geom.se3 import eigen_inverse3_f32, matmul3_f32, yaw_rotation_4x4
from pctpu_torch.io.pcd import load_cloud_pcd, read_pcd_point_count
from pctpu_torch.io.poses import _ostream_float  # C++ ostream<<float emulation
from pctpu_torch.ops.icp import IcpResult, icp_point_to_plane, icp_point_to_point
from pctpu_torch.ops.normals2d import normals_2d
from pctpu_torch.ops.topflatten import extract_top_and_flatten
from pctpu_torch.ops.voxel import voxel_downsample
from pctpu_torch.runtime.profiler import StageTimer
from pctpu_torch.utils import logging as log


@dataclasses.dataclass
class MatchResult:
    """One row of match_result.txt
    (reference/BatchTopPartRegistration.cpp:250-272)."""

    query_idx: int
    match_idx: int
    angle_guess: float


def load_match_results(path: str) -> list[MatchResult]:
    """Parse match_result.txt (``query_idx match_idx yaw_guess`` per row).
    Empty lines are skipped and short rows raise (D12).  The guess is kept
    as its f32 value, like the reference's ``ss >> float``."""
    matches = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            tok = line.split()
            if not tok:
                continue
            if len(tok) < 3:
                raise ValueError(
                    f"malformed match_result line {lineno}: {line.strip()!r} "
                    "(want 'query_idx match_idx yaw_guess')"
                )
            matches.append(
                MatchResult(int(tok[0]), int(tok[1]), float(np.float32(tok[2])))
            )
    return matches


@dataclasses.dataclass
class PairReport:
    query_idx: int
    match_idx: int
    success: bool
    fitness_coarse: float
    fitness_fine: float
    diff_xy: float
    diff_yaw: float
    transform_fine: np.ndarray


def _guess_angle_rad(angle_guess_deg: float, offset_deg: float = 0.0) -> float:
    """The reference's exact mixed f32/f64 guess-angle chain
    (reference/BatchTopPartRegistration.cpp:416-420): ``angle_guess``
    is a C float, ``(angle + 180.0f) / 180.0f`` evaluates in f32, and only
    the ``* M_PI`` promotes to double."""
    a = np.float32(angle_guess_deg)
    if offset_deg:
        a = np.float32(a + np.float32(offset_deg))
    return float(np.float32(a / np.float32(180.0))) * math.pi


def _guess_pair_np(angle_guess_deg: float) -> np.ndarray:
    g1 = yaw_rotation_4x4(_guess_angle_rad(angle_guess_deg)).astype(np.float32)
    g2 = yaw_rotation_4x4(
        _guess_angle_rad(angle_guess_deg, 180.0)
    ).astype(np.float32)
    return np.stack([g1, g2])


_BUCKET_FLOOR = 1024


def _warn_flat_cap(nkept_raw: int, flat_cap: int) -> None:
    """Warn when the fixed flat-cloud capacity dropped kept top-part points
    (the reference has no cap)."""
    if nkept_raw > flat_cap:
        log.red(
            f"WARNING: top-part extraction kept {nkept_raw} points but "
            f"flat_cap={flat_cap} truncated them; coarse ICP runs on a "
            "partial flat cloud — raise --flat_cap for full parity"
        )


def _pow2_bucket(n: int, cap: int) -> int:
    b = _BUCKET_FLOOR
    while b < n:
        b *= 2
    return min(b, cap)


def _fine_bucket(n: int, cap: int, step: int = 8192) -> int:
    return min(-(-max(n, 1) // step) * step, cap)


def _stage_flat(cloud_1: Cloud, cloud_2: Cloud, flat_cap: int, leaf: float):
    """Top-part extraction + voxel of both flat clouds (reference 1st-stage
    prep, BatchTopPartRegistration.cpp:397-409).  Returns the two voxel
    results and the larger raw top-part count."""

    def one(c):
        fx, fm, nkept = extract_top_and_flatten(c)
        return voxel_downsample(fx[:flat_cap], fm[:flat_cap], leaf), nkept

    s, nk1 = one(cloud_1)
    t, nk2 = one(cloud_2)
    return s, t, torch.maximum(nk1, nk2)


def _stage_coarse(s_xyz, s_mask, t_xyz, t_mask, guesses, cfg: RegistrationConfig,
                  bucket: int) -> IcpResult:
    """Target normals + the two coarse point-to-plane ICPs + best-of-two, at
    bucket size.  Only the target's normals are built: PointToPlaneLLS
    consumes no others."""
    s_xyz, s_mask = s_xyz[:bucket], s_mask[:bucket]
    t_xyz, t_mask = t_xyz[:bucket], t_mask[:bucket]
    t_nrm, _, n_ok = normals_2d(t_xyz, t_mask, radius=cfg.normal_radius)
    res = [
        icp_point_to_plane(s_xyz, s_mask, t_xyz, t_mask, t_nrm, n_ok, g, cfg.coarse)
        for g in guesses
    ]
    # a tie picks the second guess, like the C++ ternary (:464); a NaN
    # fitness ranks worst (+inf), as in pctpu (registration.py:217)
    fit = [float(r.fitness) for r in res]
    fit = [math.inf if math.isnan(f) else f for f in fit]
    return res[0] if fit[0] < fit[1] else res[1]


def _stage_voxel_full(cloud_1: Cloud, cloud_2: Cloud, leaf: float):
    """Full-cloud voxel downsample (reference 2nd-stage prep, :483-487)."""
    a = voxel_downsample(cloud_1.xyz, cloud_1.valid_mask(), leaf)
    b = voxel_downsample(cloud_2.xyz, cloud_2.valid_mask(), leaf)
    return a, b


def _stage_fine(s_xyz, s_mask, t_xyz, t_mask, guess, cfg: RegistrationConfig,
                bucket: int) -> IcpResult:
    return icp_point_to_point(
        s_xyz[:bucket], s_mask[:bucket], t_xyz[:bucket], t_mask[:bucket],
        guess, cfg.fine,
    )


def register_pair(
    cloud_1: Cloud,
    cloud_2: Cloud,
    angle_guess_deg: float,
    cfg: RegistrationConfig = RegistrationConfig(),
    flat_cap: int = 32768,
    timer: StageTimer | None = None,
) -> tuple[IcpResult, IcpResult | None]:
    """Returns (best coarse IcpResult, fine IcpResult or None) as host numpy
    values.  Both clouds must lie on one device; the work runs there.

    "coarse" times flat prep + normals + both coarse ICPs, "fine" the
    full-cloud voxel + fine ICP (BatchTopPartRegistration.cpp:471-506); each
    stage ends on the host, so the numbers are measured, not apportioned."""
    timer = timer or StageTimer()
    dev = cloud_1.device
    guesses = torch.from_numpy(_guess_pair_np(angle_guess_deg)).to(dev)

    with timer.stage("coarse"):
        s, t, nk_raw = _stage_flat(cloud_1, cloud_2, flat_cap, cfg.voxel_leaf)
        n_s, n_t, nk = torch.stack([s[2], t[2], nk_raw]).tolist()
        _warn_flat_cap(nk, flat_cap)
        bucket = _pow2_bucket(max(n_s, n_t), flat_cap)
        best = _stage_coarse(s[0], s[1], t[0], t[1], guesses, cfg, bucket)
        best_np = best.numpy()

    if not cfg.use_refinement:
        return best_np, None

    with timer.stage("fine"):
        a, b = _stage_voxel_full(cloud_1, cloud_2, cfg.voxel_leaf)
        n_a, n_b = torch.stack([a[2], b[2]]).tolist()
        fbucket = _fine_bucket(max(n_a, n_b), cloud_1.capacity)
        fine = _stage_fine(a[0], a[1], b[0], b[1], best.transform, cfg, fbucket)
        fine_np = fine.numpy()
    return best_np, fine_np


def _rotmat_to_euler_f32(r: np.ndarray) -> np.ndarray:
    """float32 euler extraction
    (reference/BatchTopPartRegistration.cpp:290-309)."""
    r = np.asarray(r, np.float32)
    sy = np.sqrt(r[0, 0] * r[0, 0] + r[1, 0] * r[1, 0])
    if sy >= 1e-6:
        return np.array(
            [np.arctan2(r[2, 1], r[2, 2]), np.arctan2(-r[2, 0], sy), np.arctan2(r[1, 0], r[0, 0])],
            np.float32,
        )
    return np.array(
        [np.arctan2(-r[1, 2], r[1, 1]), np.arctan2(-r[2, 0], sy), 0.0], np.float32
    )


def _pair_precision(t_coarse: np.ndarray, t_fine: np.ndarray) -> tuple[float, float]:
    """The precision-report Δxy/Δyaw with the reference's exact f32/f64
    arithmetic (reference/BatchTopPartRegistration.cpp:512-524):
    f32 differences and sqrt; ``fine_rot.inverse() * coarse_rot`` in Eigen
    f32 order; the f32 euler extraction; ``angles(2) / M_PI * 180.0f``
    promoted to double and assigned to f32; the ±360° wrap in f32."""
    diff_x = np.float32(t_fine[0, 3]) - np.float32(t_coarse[0, 3])
    diff_y = np.float32(t_fine[1, 3]) - np.float32(t_coarse[1, 3])
    diff_xy = float(np.sqrt(diff_x * diff_x + diff_y * diff_y))
    rela_rot = matmul3_f32(eigen_inverse3_f32(t_fine[:3, :3]), t_coarse[:3, :3])
    diff_yaw = np.float32(float(_rotmat_to_euler_f32(rela_rot)[2]) / math.pi * 180.0)
    if diff_yaw > np.float32(180.0):
        diff_yaw = np.float32(diff_yaw - np.float32(360.0))
    if diff_yaw < np.float32(-180.0):
        diff_yaw = np.float32(diff_yaw + np.float32(360.0))
    return diff_xy, float(diff_yaw)


def _auto_capacity(matches: list[MatchResult], point_cloud_dir: str,
                   step: int = 8192) -> int:
    """Shared cloud capacity: the max POINTS over every cloud the match list
    references (header-only reads), rounded up to a ``step`` multiple."""
    idxs = {m.query_idx for m in matches} | {m.match_idx for m in matches}
    biggest = max(
        (read_pcd_point_count(os.path.join(point_cloud_dir, f"{i:06d}.pcd"))
         for i in idxs),
        default=1,
    )
    return max(-(-biggest // step) * step, step)


def _filter_resumed(matches, report_path: str, resume: bool):
    """Drop matches recorded in the ``<report_path>.progress`` sidecar (as a
    multiset) and pick the report open mode."""
    if not resume:
        return matches, "w"
    done: collections.Counter = collections.Counter()
    prog = report_path + ".progress"
    if os.path.exists(prog):
        with open(prog) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    done[(int(parts[0]), int(parts[1]))] += 1
    remaining = []
    for m in matches:
        key = (m.query_idx, m.match_idx)
        if done[key] > 0:
            done[key] -= 1
        else:
            remaining.append(m)
    if len(remaining) != len(matches):
        log.info(
            f"--resume: skipping {len(matches) - len(remaining)} "
            "already-processed pairs"
        )
    return remaining, ("a" if os.path.exists(report_path) else "w")


def run_batch_top_part_registration(
    match_results_filename: str,
    point_cloud_dir: str,
    cfg: RegistrationConfig = RegistrationConfig(),
    report_path: str = "./icp_precision_report.txt",
    capacity: int | None = None,
    flat_cap: int = 32768,
    resume: bool = False,
    device: torch.device | str = "cpu",
) -> list[PairReport]:
    """The batch evaluator, one pair after another on ``device``.  Returns
    per-pair reports; writes the precision report (same bytes as pctpu's)
    and prints the reference-style summary.

    When ``capacity`` is None a shared one is derived from the PCD headers
    of the full match list.  ``resume=True`` skips pairs listed in the
    ``<report_path>.progress`` sidecar and appends to the report."""
    matches = load_match_results(match_results_filename)
    if capacity is None:
        capacity = _auto_capacity(matches, point_cloud_dir)
        log.info(f"capacity auto-derived from headers: {capacity}")
    matches, report_mode = _filter_resumed(matches, report_path, resume)
    timer = StageTimer()
    reports: list[PairReport] = []
    count_success = 0
    count_failure = 0

    def load(idx: int) -> Cloud:
        path = os.path.join(point_cloud_dir, f"{idx:06d}.pcd")
        return load_cloud_pcd(path, capacity, device=device)

    with open(report_path, report_mode) as report, open(
        report_path + ".progress", report_mode
    ) as progress:

        def _mark_done(m):
            progress.write(f"{m.query_idx} {m.match_idx}\n")
            progress.flush()

        for m in matches:
            best, fine = register_pair(
                load(m.query_idx), load(m.match_idx), m.angle_guess, cfg,
                flat_cap=flat_cap, timer=timer,
            )
            log.green(f"Processing match: {m.query_idx} and {m.match_idx}")
            if fine is None:  # use_refinement=False: coarse only, no report
                reports.append(
                    PairReport(m.query_idx, m.match_idx, False,
                               float(best.fitness), np.nan, np.nan, np.nan,
                               best.transform)
                )
                _mark_done(m)
                continue
            fit_fine = float(fine.fitness)
            log.info(
                f"is icp converged: {bool(fine.converged)}, fitness score: {fit_fine}"
            )
            if fit_fine > cfg.failure_fitness:
                log.red("3D ICP Failed. ")
                count_failure += 1
                reports.append(
                    PairReport(m.query_idx, m.match_idx, False, float(best.fitness),
                               fit_fine, np.nan, np.nan, fine.transform)
                )
                _mark_done(m)
                continue

            diff_xy, diff_yaw = _pair_precision(best.transform, fine.transform)
            log.info(f"diff_xy: {diff_xy}, diff_yaw: {diff_yaw}")
            report.write(f"{_ostream_float(diff_xy)} {_ostream_float(diff_yaw)}\n")
            report.flush()  # before the progress mark: re-run beats lost line
            count_success += 1
            reports.append(
                PairReport(m.query_idx, m.match_idx, True, float(best.fitness),
                           fit_fine, diff_xy, diff_yaw, fine.transform)
            )
            _mark_done(m)

    n = max(len(matches), 1)
    log.green(f"[TIME] Avg Tiempo for 1st Stage (coarse): {timer.totals_ms['coarse'] / n}")
    log.green(f"[TIME] Avg Tiempo for 2nd Stage (fine): {timer.totals_ms['fine'] / n}")
    total = count_success + count_failure
    sr = count_success / total if total else float("nan")
    log.info(
        f"count_success: {count_success}, count_failure: {count_failure}, SR: {sr}. "
    )
    return reports


def run_batch_whole_registration(
    match_results_filename: str,
    point_cloud_dir: str,
    cfg: RegistrationConfig | None = None,
    report_path: str = "./icp_precision_report_3d_icp_directly.txt",
    capacity: int | None = None,
    resume: bool = False,
    device: torch.device | str = "cpu",
) -> tuple[int, int]:
    """The ablation driver, one pair after another on ``device``: direct
    3-D ICP from the yaw guess on the whole downsampled clouds, at the full
    cloud capacity (no bucket cut, as in pctpu).  The report file is created
    but — like the reference — never written to; only the success/failure
    counts are printed.  Returns (success, failure).

    ``resume=True`` skips pairs recorded in the ``<report_path>.progress``
    sidecar (the contract of :func:`run_batch_top_part_registration`); the
    returned and printed counts cover only this invocation's pairs."""
    if cfg is None:
        cfg = RegistrationConfig(fine=WHOLE_ICP)
    matches = load_match_results(match_results_filename)
    if capacity is None:
        capacity = _auto_capacity(matches, point_cloud_dir)
        log.info(f"capacity auto-derived from headers: {capacity}")
    matches, report_mode = _filter_resumed(matches, report_path, resume)
    timer = StageTimer()
    count_success = 0
    count_failure = 0
    if report_mode == "w":
        open(report_path, "w").close()

    def load(idx: int) -> Cloud:
        path = os.path.join(point_cloud_dir, f"{idx:06d}.pcd")
        return load_cloud_pcd(path, capacity, device=device)

    with open(report_path + ".progress", report_mode) as progress:
        for m in matches:
            c1, c2 = load(m.query_idx), load(m.match_idx)
            with timer.stage("fine"):
                guess = torch.from_numpy(
                    yaw_rotation_4x4(_guess_angle_rad(m.angle_guess)).astype(np.float32)
                ).to(c1.device)
                a, b = _stage_voxel_full(c1, c2, cfg.voxel_leaf)
                fine = icp_point_to_point(a[0], a[1], b[0], b[1], guess, cfg.fine).numpy()
            log.green(f"Processing match: {m.query_idx} and {m.match_idx}")
            fit = float(fine.fitness)
            log.info(f"is icp converged: {bool(fine.converged)}, fitness score: {fit}")
            if fit > cfg.failure_fitness:
                log.red("3D ICP Failed. ")
                count_failure += 1
            else:
                log.green("3D ICP Passed. ")
                count_success += 1
            progress.write(f"{m.query_idx} {m.match_idx}\n")
            progress.flush()

    n = max(len(matches), 1)
    log.green(f"[TIME] Avg Tiempo for 2nd Stage (fine): {timer.totals_ms['fine'] / n}")
    total = count_success + count_failure
    sr = count_success / total if total else float("nan")
    log.info(
        f"count_success: {count_success}, count_failure: {count_failure}, SR: {sr}. "
    )
    return count_success, count_failure
