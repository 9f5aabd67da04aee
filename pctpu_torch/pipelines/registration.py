"""The registration pipelines of ``pctpu/pipelines/registration.py``.

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

Every stage runs over a batch of B pairs at once (pctpu's ``jax.vmap`` over
the pair axis): the clouds are stacked (``cloud.stack_clouds``), the two
coarse guesses of all pairs are one ICP batch of 2·B problems sharing each
pair's prepared target, and each stage reads its stats on the host in one
``.tolist()``.  A single pair (``register_pair``, ``pair_batch=1``) is the
B = 1 case; ``register_pairs``, ``register_pairs_pipelined`` and
``register_whole_pairs`` are pctpu's pair-batched drivers, and the ``run_*``
drivers take ``pair_batch`` (default 16 on a CUDA device, 1 on the CPU).

A batch is a list of data shards, each on its own device: one without a
mesh; with one (``mesh=``, ``--devices``), the pair axis split over its data
devices.  The shards' buckets are the whole batch's (the largest counts over
every shard), so a pair's result does not depend on the split.  The shards
run one after the other in the calling thread, each under its device: on a
logical mesh of one card that is all there is to it, and on distinct cards
a shard's ICP loop, which reads the host once an iteration, does not
overlap the next shard's.  The ``run_*`` drivers also split the match list
over processes (``process_id``, ``num_processes``): each writes
``<report>.shard<pid>``.

The stage inputs are cut to capacity buckets (a power of two for the flat
clouds, a multiple of 8,192 for the full ones), taken from the batch's
largest counts, as pctpu does: results depend on the padded width through
f32 reduction shapes (D5), so the port pads the same way, and a batched pair
whose buckets equal its own sequential ones gets the same report.

Traced (``runtime.profiler``), the stages are ``registration.*`` spans:
``load`` (a pipelined batch's pair list), ``stack``, ``flat``, ``coarse``,
``voxel``, ``fine``, ``verify.wait`` (a stage's stats read on the host),
``worker.wait`` (the caller waiting on the pipelined worker) and
``fetch.wait`` (results to the host); ``BucketSpec`` counts
``registration.bucket_hit.<stage>`` and ``registration.bucket_miss.<stage>``.
A ``StageTimer`` is optional: given one, its stages synchronise the card to
time it; without one, nothing synchronises for timing.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import math
import os
import time

import numpy as np
import torch

from pctpu_torch.cloud import Cloud, stack_clouds
from pctpu_torch.config import WHOLE_ICP, RegistrationConfig
from pctpu_torch.geom.se3 import eigen_inverse3_f32, matmul3_f32, yaw_rotation_4x4
from pctpu_torch.io.pcd import load_cloud_pcd, read_pcd_point_count
from pctpu_torch.io.poses import _ostream_float  # C++ ostream<<float emulation
from pctpu_torch.ops.icp import IcpResult, icp_batched, icp_point_to_point
from pctpu_torch.ops.normals2d import normals_2d
from pctpu_torch.ops.topflatten import extract_top_and_flatten
from pctpu_torch.ops.voxel import voxel_downsample
from pctpu_torch.parallel.distributed import process_count, process_index, process_shard
from pctpu_torch.parallel.mesh import Mesh, cloud_to, data_slices, device_guard, make_mesh
from pctpu_torch.runtime import profiler
from pctpu_torch.runtime.profiler import StageTimer
from pctpu_torch.utils import logging as log

# one data shard of a pair batch: (cloud_1 batch, cloud_2 batch, guesses)
Shard = tuple[Cloud, Cloud, torch.Tensor]


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


def _both(c1: Cloud, c2: Cloud) -> Cloud:
    """Two batched clouds as one batch of 2·B (c1's first)."""
    fields = {f: torch.cat([getattr(c1, f), getattr(c2, f)])
              for f in ("xyz", "intensity", "row", "col", "t", "label")}
    return Cloud(**fields, count=torch.cat([c1.count, c2.count]))


def _halves(xs, b: int):
    return tuple(x[:b] for x in xs), tuple(x[b:] for x in xs)


def _stage_flat(c1: Cloud, c2: Cloud, flat_cap: int, leaf: float):
    """Top-part extraction + voxel of both flat clouds of every pair
    (reference 1st-stage prep, BatchTopPartRegistration.cpp:397-409), all
    2·B clouds in one call of each.  Returns the two voxel results (xyz,
    mask, count; leading B) and each pair's larger raw top-part count."""
    b = c1.xyz.shape[0]
    fx, fm, nkept = extract_top_and_flatten(_both(c1, c2))
    s, t = _halves(voxel_downsample(fx[:, :flat_cap], fm[:, :flat_cap], leaf), b)
    return s, t, torch.maximum(nkept[:b], nkept[b:])


def _coarse_two_guesses(src, src_mask, tgt, tgt_mask, tgt_normals, normal_ok, guesses,
                        cfg: RegistrationConfig) -> IcpResult:
    """Both yaw guesses of every pair as one point-to-plane ICP batch of 2·B
    problems (guess and guess + 180°, BatchTopPartRegistration.cpp:416-425;
    pctpu's vmap, registration.py:95-105): problem 2b + g is pair b's source
    from guess g, and both of a pair's problems search its one target."""
    return icp_batched(src.repeat_interleave(2, dim=0), src_mask.repeat_interleave(2, dim=0),
                       tgt, tgt_mask, guesses.reshape(-1, 4, 4), cfg.coarse,
                       tgt_normals=tgt_normals, normal_mask=normal_ok)


def _stage_coarse(s_xyz, s_mask, t_xyz, t_mask, guesses, cfg: RegistrationConfig,
                  bucket: int) -> IcpResult:
    """Target normals + the two coarse point-to-plane ICPs + best-of-two, at
    bucket size, for a batch: (B, N, ·) clouds, guesses (B, 2, 4, 4).  Only
    the target's normals are built: PointToPlaneLLS consumes no others.
    The winners stay on the device."""
    s_xyz, s_mask = s_xyz[:, :bucket], s_mask[:, :bucket]
    t_xyz, t_mask = t_xyz[:, :bucket], t_mask[:, :bucket]
    t_nrm, _, n_ok = normals_2d(t_xyz, t_mask, radius=cfg.normal_radius)
    res = _coarse_two_guesses(s_xyz, s_mask, t_xyz, t_mask, t_nrm, n_ok, guesses, cfg)
    # a tie picks the second guess, like the C++ ternary (:464); a NaN
    # fitness ranks worst (+inf), as in pctpu (registration.py:217-219)
    fit = res.fitness.reshape(-1, 2)
    fit = torch.where(torch.isnan(fit), torch.inf, fit)
    pick = torch.where(fit[:, 0] < fit[:, 1], 0, 1)
    return res.select(pick + 2 * torch.arange(fit.shape[0], device=fit.device))


def _stage_voxel_full(c1: Cloud, c2: Cloud, leaf: float):
    """Full-cloud voxel downsample of every pair's two clouds (reference
    2nd-stage prep, :483-487), all 2·B in one call."""
    both = _both(c1, c2)
    return _halves(voxel_downsample(both.xyz, both.valid_mask(), leaf), c1.xyz.shape[0])


def _stage_fine(s_xyz, s_mask, t_xyz, t_mask, guesses, cfg: RegistrationConfig,
                bucket: int, point_mesh: Mesh | None = None) -> IcpResult:
    return icp_batched(s_xyz[:, :bucket], s_mask[:, :bucket], t_xyz[:, :bucket],
                       t_mask[:, :bucket], guesses, cfg.fine,
                       nn_impl="auto" if point_mesh is None else "sharded", mesh=point_mesh)


def _timed(timer: StageTimer | None, name: str, items: int = 1):
    """``timer``'s stage ``name`` (a span that ends with a device
    synchronize), or nothing without a timer."""
    return contextlib.nullcontext() if timer is None else timer.stage(name, items)


def _stack_pairs(pairs, guess_fn) -> Shard:
    """(cloud_1 batch, cloud_2 batch, each pair's ``guess_fn(yaw)``) of
    (cloud_1, cloud_2, yaw guess) pairs on one device."""
    c1 = stack_clouds([p[0] for p in pairs])
    c2 = stack_clouds([p[1] for p in pairs])
    guesses = torch.from_numpy(np.stack([guess_fn(p[2]) for p in pairs])).to(c1.device)
    return c1, c2, guesses


def _whole_guess_np(angle_guess_deg: float) -> np.ndarray:
    return yaw_rotation_4x4(_guess_angle_rad(angle_guess_deg)).astype(np.float32)


def _shard_pairs(pairs, mesh: Mesh | None, guess_fn=_guess_pair_np) -> list[Shard]:
    """A pair batch as shards (module docstring): one on the pairs' device
    without a mesh, else the pair axis split over the mesh's data devices,
    each shard stacked and moved to its device."""
    with profiler.span("registration.stack"):
        if mesh is None:
            return [_stack_pairs(pairs, guess_fn)]
        return [tuple(cloud_to(x, dev) if isinstance(x, Cloud) else x.to(dev)
                      for x in _stack_pairs(pairs[rows], guess_fn))
                for rows, dev in data_slices(len(pairs), mesh, "len(pairs)")]


def _on_shards(shards: list[Shard], fn, *columns) -> list:
    """``fn(shard, *row)`` for each shard and its row of ``columns``, under
    the shard's device."""
    out = []
    for shard, *row in zip(shards, *columns):
        with device_guard(shard[0].device):
            out.append(fn(shard, *row))
    return out


def _batch_max(stats: list[torch.Tensor]) -> list:
    """Each stat's largest value over the shards (one host read a shard):
    the buckets of a sharded batch are those of the whole batch."""
    with profiler.span("registration.verify.wait"):
        return [max(col) for col in zip(*(s.tolist() for s in stats))]


def _synchronize(shards: list[Shard]) -> None:
    for dev in {s[0].device for s in shards}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _flat_stats(s, t, nk_raw) -> torch.Tensor:
    """[max source count, max target count, max raw top-part count], read
    on the host in one ``.tolist()`` at the stage boundary."""
    return torch.stack([s[2].max(), t[2].max(), nk_raw.max()])


def _coarse_bucket(stats: list, flat_cap: int) -> int:
    n_s, n_t, nk = stats
    _warn_flat_cap(nk, flat_cap)
    return _pow2_bucket(max(n_s, n_t), flat_cap)


def _fine_bucket_for(n: int, capacity: int, point_mesh: Mesh | None) -> int:
    """The fine bucket; with a point mesh, rounded up so the 'points' axis
    divides it (pctpu's capacity check and rounding)."""
    fbucket = _fine_bucket(n, capacity)
    if point_mesh is not None:
        n_pts = point_mesh.shape["points"]
        if capacity % n_pts:
            raise ValueError(
                f"point_mesh needs cloud capacity ({capacity}) to "
                f"be a multiple of the 'points' axis ({n_pts})"
            )
        fbucket = -(-fbucket // n_pts) * n_pts
    return fbucket


def _transforms(results: list[IcpResult]) -> list[torch.Tensor]:
    return [r.transform for r in results]


def _join(results: list[IcpResult]) -> IcpResult:
    """The shards' results as one host numpy IcpResult, in pair order."""
    with profiler.span("registration.fetch.wait"):
        parts = [r.numpy() for r in results]
    return IcpResult(*(np.concatenate([getattr(p, f) for p in parts])
                       for f in ("converged", "fitness", "transform")))


def register_pair(
    cloud_1: Cloud,
    cloud_2: Cloud,
    angle_guess_deg: float,
    cfg: RegistrationConfig = RegistrationConfig(),
    flat_cap: int = 32768,
    timer: StageTimer | None = None,
    point_mesh: Mesh | None = None,
) -> tuple[IcpResult, IcpResult | None]:
    """Returns (best coarse IcpResult, fine IcpResult or None) as host numpy
    values: :func:`register_pairs` of this one pair.  Both clouds must lie on
    one device; the work runs there.

    ``point_mesh`` (a mesh with a 'points' axis) splits the fine stage's
    correspondence search over the target's points (``nn_impl="sharded"``),
    the fine bucket rounded up to a multiple of that axis.

    "coarse" times flat prep + normals + both coarse ICPs, "fine" the
    full-cloud voxel + fine ICP (BatchTopPartRegistration.cpp:471-506); each
    stage ends on the host, so the numbers are measured, not apportioned."""
    shards = _shard_pairs([(cloud_1, cloud_2, angle_guess_deg)], None)
    best = _coarse_stage_batched(shards, cfg, flat_cap, timer)
    return _pair_results(1, shards, best, cfg, timer, point_mesh=point_mesh)[0]


def register_pairs(
    pairs: list[tuple[Cloud, Cloud, float]],
    cfg: RegistrationConfig = RegistrationConfig(),
    flat_cap: int = 32768,
    timer: StageTimer | None = None,
    mesh: Mesh | None = None,
) -> list[tuple[IcpResult, IcpResult | None]]:
    """Batch several (cloud_1, cloud_2, yaw_guess_deg) pairs: each stage runs
    once over the pair axis, with capacity buckets chosen from the batch
    maxima.  Returns a list of (best coarse, fine or None) numpy IcpResults
    in input order.  All clouds must share one capacity and device.  With
    ``mesh`` the pair axis is split over its data devices (len(pairs) a
    multiple of them); the results are the unsharded run's."""
    shards = _shard_pairs(pairs, mesh)
    best = _coarse_stage_batched(shards, cfg, flat_cap, timer)
    return _pair_results(len(pairs), shards, best, cfg, timer)


def _pair_results(n, shards, best, cfg, timer, spec=None, point_mesh=None):
    """Coarse winners (still on the devices) → per-pair (best coarse,
    fine-or-None) numpy tuples: the tail shared by ``register_pairs`` and
    ``register_pair``.  The fine stage seeds from the device-resident
    coarse transforms."""
    fine = (
        _fine_dispatch(shards, _transforms(best), cfg, timer, spec=spec, point_mesh=point_mesh)
        if cfg.use_refinement
        else None
    )
    return _fetch_pair_results(n, best, fine, timer)


def _fetch_pair_results(n, best, fine, timer):
    """Bring a batch's results (one IcpResult a shard) to the host and
    split them per pair.  With a timer the fetches extend the stage totals
    with items=0, so they do not count the pairs twice in the per-pair
    averages."""
    fine_h = None
    if fine is not None:
        with _timed(timer, "fine", items=0):
            fine_h = _join(fine)
    with _timed(timer, "coarse", items=0):
        best_h = _join(best)
    return [(best_h.select(i), None if fine_h is None else fine_h.select(i)) for i in range(n)]


class BucketSpec:
    """Cross-batch capacity-bucket predictor for speculative dispatch
    (pctpu's, registration.py:320-352).

    A stage's bucket depends on counts that live on the device, so picking
    it needs a host read.  With a prediction (the previous batch's bucket)
    the stage runs at once at the predicted bucket and the read comes after;
    a mispredict runs the stage again at the right bucket.  A speculative
    result is kept only when the predicted bucket EQUALS the one the counts
    dictate (a merely sufficient larger bucket would change f32 reduction
    shapes, D5), so results are those of the plain path in every case."""

    __slots__ = ("coarse", "fine", "hits", "misses")

    def __init__(self):
        self.coarse: int | None = None
        self.fine: int | None = None
        self.hits = 0
        self.misses = 0

    def record(self, predicted: int | None, actual: int, stage: str) -> bool:
        """True when the speculative result can be kept.  Counts
        ``registration.bucket_hit.<stage>`` or ``..._miss.<stage>``."""
        if predicted == actual:
            self.hits += 1
            profiler.count(f"registration.bucket_hit.{stage}")
            return True
        if predicted is not None:
            self.misses += 1
            profiler.count(f"registration.bucket_miss.{stage}")
        return False


def _flat(shards, cfg, flat_cap):
    """The flat clouds of every shard and their stats (:func:`_flat_stats`),
    still on the devices."""
    with profiler.span("registration.flat"):
        flats = _on_shards(shards, lambda sh: _stage_flat(sh[0], sh[1], flat_cap,
                                                          cfg.voxel_leaf))
        return flats, [_flat_stats(*f) for f in flats]


def _coarse_runner(shards, flats, cfg):
    """bucket → the coarse winners of every shard at that bucket."""
    def run(bucket):
        with profiler.span("registration.coarse"):
            return _on_shards(shards, lambda sh, f: _stage_coarse(
                f[0][0], f[0][1], f[1][0], f[1][1], sh[2], cfg, bucket), flats)
    return run


def _fine_runner(shards, voxels, cfg, point_mesh=None):
    """(bucket, guesses a shard) → the fine results of every shard."""
    stage = _stage_fine if point_mesh is None else functools.partial(
        _stage_fine, point_mesh=point_mesh)

    def run(fbucket, guesses):
        with profiler.span("registration.fine"):
            return _on_shards(shards, lambda sh, v, g: stage(
                v[0][0], v[0][1], v[1][0], v[1][1], g, cfg, fbucket), voxels, guesses)
    return run


def _coarse_stage_batched(shards, cfg, flat_cap, timer, spec=None):
    """Flat prep + both coarse ICPs for one pair batch (the reference's
    1st-stage span).  Returns the coarse winners of each shard, still on
    the devices.  With ``spec`` the coarse ICP first runs at the previous
    batch's bucket (:class:`BucketSpec`)."""
    with _timed(timer, "coarse", items=sum(sh[0].xyz.shape[0] for sh in shards)):
        flats, stats = _flat(shards, cfg, flat_cap)
        run_coarse = _coarse_runner(shards, flats, cfg)
        predicted = spec.coarse if spec is not None else None
        best = run_coarse(predicted) if predicted is not None else None
        bucket = _coarse_bucket(_batch_max(stats), flat_cap)
        if spec is not None:
            spec.coarse = bucket
        if spec is None or not spec.record(predicted, bucket, "coarse"):
            best = run_coarse(bucket)
    return best


def _voxels(shards, cfg):
    with profiler.span("registration.voxel"):
        voxels = _on_shards(shards, lambda sh: _stage_voxel_full(sh[0], sh[1], cfg.voxel_leaf))
        return voxels, [torch.stack([a[2].max(), b[2].max()]) for a, b in voxels]


def _fine_dispatch(shards, guesses, cfg, timer, spec=None, point_mesh=None):
    """Full-cloud voxel of every pair + one stats read a shard + the
    bucketed fine ICP batch, shared by the top-part fine stage (guesses =
    the coarse winners' transforms, on the devices) and the whole-cloud
    ablation (guesses = the yaw rotations).  ``spec`` runs the fine ICP
    first at the previous batch's fine bucket.  Returns the fine results of
    each shard, on the devices."""
    with _timed(timer, "fine", items=sum(int(g.shape[0]) for g in guesses)):
        voxels, stats = _voxels(shards, cfg)
        run_fine = _fine_runner(shards, voxels, cfg, point_mesh)
        predicted = spec.fine if spec is not None else None
        fine = run_fine(predicted, guesses) if predicted is not None else None
        fbucket = _fine_bucket_for(max(_batch_max(stats)), shards[0][0].capacity, point_mesh)
        if spec is not None:
            spec.fine = fbucket
        if spec is None or not spec.record(predicted, fbucket, "fine"):
            fine = run_fine(fbucket, guesses)
    return fine


def _dispatch_batch_speculative(pairs, cfg, flat_cap, timer, spec: BucketSpec, mesh=None):
    """One batch's whole chain — flat, coarse, voxel, fine — at the previous
    batch's buckets, then the two stats reads that verify them (pctpu's,
    registration.py:444-535).  A mispredicted stage, and every stage after it
    (the fine guesses are the coarse winners), runs again at the verified
    bucket, so results are the plain path's.  Cold starts (no recorded
    buckets) take the plain path, which fills the spec.  Only with a
    ``timer`` is the card synchronised at the end and the stages' times
    added to it."""
    if spec.coarse is None or spec.fine is None or not cfg.use_refinement:
        shards = _shard_pairs(pairs, mesh)
        best = _coarse_stage_batched(shards, cfg, flat_cap, timer, spec=spec)
        fine = (_fine_dispatch(shards, _transforms(best), cfg, timer, spec=spec)
                if cfg.use_refinement else None)
        return len(pairs), best, fine

    t0 = time.perf_counter()
    shards = _shard_pairs(pairs, mesh)
    n = len(pairs)
    flats, stats = _flat(shards, cfg, flat_cap)
    run_coarse = _coarse_runner(shards, flats, cfg)
    pc = spec.coarse
    best = run_coarse(pc)
    t1 = time.perf_counter()
    voxels, stats2 = _voxels(shards, cfg)
    run_fine = _fine_runner(shards, voxels, cfg)
    pf = spec.fine
    fine = run_fine(pf, _transforms(best))
    t2 = time.perf_counter()

    # --- verification (the whole chain has run) ------------------------------
    bucket = _coarse_bucket(_batch_max(stats), flat_cap)
    spec.coarse = bucket
    coarse_ok = spec.record(pc, bucket, "coarse")
    if not coarse_ok:
        best = run_coarse(bucket)
    t3 = time.perf_counter()
    fbucket = _fine_bucket(max(_batch_max(stats2)), shards[0][0].capacity)
    spec.fine = fbucket
    fine_ok = spec.record(pf, fbucket, "fine")
    if not (fine_ok and coarse_ok):
        # a coarse mispredict invalidates the speculative fine too: its
        # guesses were the mispredicted coarse winners
        fine = run_fine(fbucket, _transforms(best))
    if timer is not None:
        _synchronize(shards)
        t4 = time.perf_counter()
        timer.add("coarse", ((t1 - t0) + (t3 - t2)) * 1e3, items=n)
        timer.add("fine", ((t2 - t1) + (t4 - t3)) * 1e3, items=n)
    return n, best, fine


def register_pairs_pipelined(
    batch_loaders,
    cfg: RegistrationConfig = RegistrationConfig(),
    flat_cap: int = 32768,
    timer: StageTimer | None = None,
    mesh: Mesh | None = None,
    depth: int = 1,
):
    """Software-pipelined batch registration over a stream of pair batches
    (pctpu's, registration.py:538-598).

    ``batch_loaders`` yields thunks; each returns one ``register_pairs``-style
    pair list.  Batch k+1's whole chain — load, stack, flat/coarse, voxel,
    fine and its stats reads — runs on one worker thread while this thread
    brings batch k's results to the host, and each stage first runs at the
    previous batch's bucket (:class:`BucketSpec`).  ``depth`` (≥ 1) batches
    may have their chain done beyond the one being fetched.  ``mesh`` splits
    each batch over its data devices, as in :func:`register_pairs`.
    Per-batch results are ``register_pairs``' at any depth.  Yields one
    result list per batch, in order.  Traced, batch k's spans on both
    threads carry batch index k."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    # one spec across the stream; only the worker thread writes it
    spec = BucketSpec()

    def dispatch_half(loader, context):
        with profiler.adopt(context):
            with profiler.span("registration.load"):
                pairs = loader()
            return _dispatch_batch_speculative(pairs, cfg, flat_cap, timer, spec, mesh)

    def fetch(k, fut):
        with profiler.batch(k):
            with profiler.span("registration.worker.wait"):
                done = fut.result()
            return _fetch_pair_results(*done, timer)

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        futs = collections.deque()
        fetched = 0
        for k, loader in enumerate(batch_loaders):
            futs.append(ex.submit(dispatch_half, loader, profiler.handoff(k)))
            if len(futs) > depth:
                yield fetch(fetched, futs.popleft())
                fetched += 1
        while futs:
            yield fetch(fetched, futs.popleft())
            fetched += 1


def register_whole_pairs(
    pairs: list[tuple[Cloud, Cloud, float]],
    cfg: RegistrationConfig,
    timer: StageTimer | None = None,
    mesh: Mesh | None = None,
) -> list[IcpResult]:
    """Batch several whole-cloud ablation pairs (voxel + direct fine ICP from
    the yaw guess, BatchWholeRegistration.cpp:342-412): both stages once over
    the pair axis, at the fine bucket of the batch's largest voxel count, as
    pctpu's.  ``mesh`` splits the pair axis over its data devices.  Returns
    the numpy fine IcpResults in input order."""
    shards = _shard_pairs(pairs, mesh, _whole_guess_np)
    fine = _fine_dispatch(shards, [sh[2] for sh in shards], cfg, timer)
    with _timed(timer, "fine", items=0):
        fine_h = _join(fine)
    return [fine_h.select(i) for i in range(len(pairs))]


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


def _load_pair_chunk(chunk, point_cloud_dir: str, capacity: int | None, pair_batch: int,
                     device):
    """One chunk's PCDs as ``register_pairs``-style (cloud_1, cloud_2,
    yaw_guess) tuples on ``device``.  A short tail repeats its last loaded
    pair to fill ``pair_batch``; the drivers drop the padded results by
    zipping against the unpadded chunk."""
    def load(idx):
        return load_cloud_pcd(os.path.join(point_cloud_dir, f"{idx:06d}.pcd"), capacity,
                              device=device)

    pairs = [(load(m.query_idx), load(m.match_idx), m.angle_guess) for m in chunk]
    pairs += [pairs[-1]] * (pair_batch - len(chunk))
    return pairs


def default_pair_batch(device: torch.device | str = "cuda") -> int:
    """``pair_batch`` when none is given, by pctpu's backend rule with the
    card in the TPU's place: 16 on a CUDA device (the batched path), 1 on
    the CPU, which pays real compute for every padded pair."""
    return 16 if torch.device(device).type == "cuda" else 1


def _prepare_batch_driver(match_results_filename, point_cloud_dir, report_path, capacity,
                          pair_batch, devices, process_id, num_processes, resume, device,
                          mesh=None):
    """The shared preamble of the two drivers: resolve ``pair_batch``, load
    the match list and take this process's strided share of it (writing
    ``<report_path>.shard<pid>`` when there are several processes), derive
    the shared capacity from that share's FULL list of PCD headers (so a
    resumed run pads like the run it continues), filter resumed pairs, and
    build the data mesh of ``devices`` (N CUDA cards, or the CPU N times)
    unless ``mesh`` is given, rounding ``pair_batch`` up to a multiple of its
    data axis.  Returns (matches, report path, report mode, capacity,
    pair_batch, mesh)."""
    device = torch.device(device)
    if pair_batch is None:
        pair_batch = default_pair_batch(device)
        log.info(f"pair_batch auto-selected for {device.type}: {pair_batch}")
    matches = load_match_results(match_results_filename)
    pid = process_index() if process_id is None else process_id
    nproc = process_count() if num_processes is None else num_processes
    if nproc > 1:
        matches = process_shard(matches, pid, nproc)
        report_path = f"{report_path}.shard{pid}"
    if capacity is None:
        capacity = _auto_capacity(matches, point_cloud_dir)
        log.info(f"capacity auto-derived from headers: {capacity}")
    matches, report_mode = _filter_resumed(matches, report_path, resume)
    if mesh is None and devices is not None and devices > 1:
        mesh = make_mesh(n_data=devices,
                         devices=None if device.type == "cuda" else [device] * devices)
    if mesh is not None and pair_batch % mesh.shape["data"]:
        pair_batch = -(-pair_batch // mesh.shape["data"]) * mesh.shape["data"]
    return matches, report_path, report_mode, capacity, pair_batch, mesh


def _chunks(matches, pair_batch: int):
    return [matches[k:k + pair_batch] for k in range(0, len(matches), pair_batch)]


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
    pair_batch: int | None = None,
    devices: int | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    resume: bool = False,
    device: torch.device | str = "cuda",
) -> list[PairReport]:
    """The batch evaluator on ``device``.  Returns per-pair reports; writes
    the precision report (same bytes as pctpu's) and prints the
    reference-style summary.

    ``pair_batch`` > 1 runs that many pairs as one batch through every stage
    (``register_pairs_pipelined``; a short tail is padded with its last
    pair); None picks :func:`default_pair_batch` — 16 on a CUDA device, 1 on
    the CPU; 1 runs one pair after another.  When ``capacity`` is None a
    shared one is derived from the PCD headers of the full match list.
    ``resume=True`` skips pairs listed in the ``<report_path>.progress``
    sidecar and appends to the report.

    ``devices=N`` splits every pair batch over an N-way data mesh
    (``pair_batch`` rounded up to a multiple of N); ``process_id`` /
    ``num_processes`` give each process a strided share of the match list
    and its own ``<report_path>.shard<pid>`` and summary."""
    matches, report_path, report_mode, capacity, pair_batch, mesh = _prepare_batch_driver(
        match_results_filename, point_cloud_dir, report_path, capacity, pair_batch, devices,
        process_id, num_processes, resume, device)
    if mesh is not None:
        device = mesh.data_devices[0]
    timer = StageTimer()
    reports: list[PairReport] = []
    count_success = 0
    count_failure = 0

    def load(idx: int) -> Cloud:
        path = os.path.join(point_cloud_dir, f"{idx:06d}.pcd")
        return load_cloud_pcd(path, capacity, device=device)

    def result_stream():
        """Yield (match, best, fine) — sequentially or pair-batched."""
        if pair_batch <= 1:
            for m in matches:
                best, fine = register_pair(load(m.query_idx), load(m.match_idx), m.angle_guess,
                                           cfg, flat_cap=flat_cap, timer=timer)
                yield m, best, fine
            return
        chunks = _chunks(matches, pair_batch)
        stream = register_pairs_pipelined(
            (functools.partial(_load_pair_chunk, c, point_cloud_dir, capacity, pair_batch,
                               device) for c in chunks),
            cfg, flat_cap=flat_cap, timer=timer, mesh=mesh,
        )
        for chunk, results in zip(chunks, stream):
            for m, (best, fine) in zip(chunk, results):
                yield m, best, fine

    with open(report_path, report_mode) as report, open(
        report_path + ".progress", report_mode
    ) as progress:

        def _mark_done(m):
            progress.write(f"{m.query_idx} {m.match_idx}\n")
            progress.flush()

        for m, best, fine in result_stream():
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
    pair_batch: int | None = None,
    devices: int | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    resume: bool = False,
    device: torch.device | str = "cuda",
    mesh: Mesh | None = None,
) -> tuple[int, int]:
    """The ablation driver on ``device``: direct 3-D ICP from the yaw guess
    on the whole downsampled clouds.  One pair after another
    (``pair_batch=1``) it runs at the full cloud capacity (no bucket cut, as
    in pctpu); pair-batched (``register_whole_pairs``, the next chunk's PCDs
    loading on a worker thread meanwhile) at the batch's fine bucket, as
    pctpu's.  ``pair_batch=None`` picks :func:`default_pair_batch`.  The
    report file is created but — like the reference — never written to;
    only the success/failure counts are printed.  Returns (success,
    failure).

    ``resume=True`` skips pairs recorded in the ``<report_path>.progress``
    sidecar (the contract of :func:`run_batch_top_part_registration`); the
    returned and printed counts cover only this invocation's pairs.
    ``devices``, ``process_id`` and ``num_processes`` split the work as in
    :func:`run_batch_top_part_registration` (an empty report a process); an
    explicit ``mesh`` takes the place of ``devices``' mesh, as in
    ``run_multi_bev``."""
    if cfg is None:
        cfg = RegistrationConfig(fine=WHOLE_ICP)
    matches, report_path, report_mode, capacity, pair_batch, mesh = _prepare_batch_driver(
        match_results_filename, point_cloud_dir, report_path, capacity, pair_batch, devices,
        process_id, num_processes, resume, device, mesh)
    if mesh is not None:
        device = mesh.data_devices[0]
    timer = StageTimer()
    count_success = 0
    count_failure = 0
    if report_mode == "w":
        open(report_path, "w").close()

    def load(idx: int) -> Cloud:
        path = os.path.join(point_cloud_dir, f"{idx:06d}.pcd")
        return load_cloud_pcd(path, capacity, device=device)

    def result_stream():
        """Yield (match, fine IcpResult) — sequentially or pair-batched."""
        if pair_batch <= 1:
            for m in matches:
                c1, c2 = load(m.query_idx), load(m.match_idx)
                with timer.stage("fine"):
                    guess = torch.from_numpy(
                        yaw_rotation_4x4(_guess_angle_rad(m.angle_guess)).astype(np.float32)
                    ).to(c1.device)
                    a, b = _stage_voxel_full(stack_clouds([c1]), stack_clouds([c2]),
                                             cfg.voxel_leaf)
                    fine = icp_point_to_point(a[0][0], a[1][0], b[0][0], b[1][0], guess,
                                              cfg.fine).numpy()
                yield m, fine
            return
        chunks = _chunks(matches, pair_batch)

        def load_chunk(chunk, context):
            with profiler.adopt(context), profiler.span("registration.load"):
                return _load_pair_chunk(chunk, point_cloud_dir, capacity, pair_batch, device)

        def submit(k):
            return ex.submit(load_chunk, chunks[k], profiler.handoff(k))

        # chunk k+1's PCDs load on a worker thread under chunk k's run
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            fut = submit(0) if chunks else None
            for k, chunk in enumerate(chunks):
                with profiler.batch(k):
                    with profiler.span("registration.worker.wait"):
                        pairs = fut.result()
                    fut = submit(k + 1) if k + 1 < len(chunks) else None
                    fine = register_whole_pairs(pairs, cfg, timer=timer, mesh=mesh)
                for m, f in zip(chunk, fine):
                    yield m, f

    with open(report_path + ".progress", report_mode) as progress:
        for m, fine in result_stream():
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
