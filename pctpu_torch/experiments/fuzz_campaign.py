"""The differential campaign on the card — the port of
``scripts/fuzz_campaign.py``: fresh seed ranges through every op of the
port, against the plain-loop oracle ``tests/ref_impl.py`` and the native
oracle ``native/ref_oracle.cpp`` (both through ``experiments.oracle``).

    python -m pctpu_torch.experiments.fuzz_campaign --start=20000 --cases=500
        [--sensors] [--prep-every=4] [--icp=N] [--normals=N] [--misc=N]
        [--twostage=N] [--adversarial=N] [--native=N] [--kitti-raw=N]
        [--device=cuda|cpu]

The flags are the script's; ``--device`` (default ``cuda``; exit 2 without
a card, never a fall-back to the CPU) is where the port runs.  On the card
every case is checked twice: (a) against the oracle with pctpu's contract
for the leg, and (b) against the port's own CPU run of the same case, bit
for bit where the contract is bit-exact, else within the leg's window —
the check that finds faults of the card alone (atomics, fma contraction,
reductions split by the output's shape, the radix sort's −0.0).

Legs (pctpu's line numbers in ``scripts/fuzz_campaign.py``):

- ``preprocess`` (:94-182): the 7 REGIMES × ``--cases`` through ordering,
  ground marking (bit-exact, and tolerance mode against it: D1) and the
  fused rasters; labels and both BEVs equal to the oracle; every
  ``--prep-every``-th case also ``voxel`` (within 1e-5) and ``topflatten``
  (equal as sets);
- ``sensors`` (:183-209): HDL-32E, HDL-64E and OS1-64 at their full grids;
- ``native`` (:334): ``--native`` cases a regime byte-equal to the C++
  oracle (ordered xyz too), the Python oracle every 4th case, and the float
  BEV and top-flatten (in the reference's order) every 4th case — the top
  part also on the scene's heights tied on a 0.5 m ladder with ±0.0 among
  them (the port's addition: the radix sort's −0.0, D14's ties);
- ``adversarial`` (:235): over-capacity clouds through the host's
  ``compact_last_wins``, dropped azimuth bands, all- and no-ground shapes,
  against the oracle on the full uncompacted list;
- ``misc`` (:440): the float BEV (both ground filters) and PCA2D;
- ``normals`` (:521): radius and k search within the oracle's knife-edge
  families (D3) and the conditioning window (D4);
- ``icp`` (:644): ``icp_trace`` per iteration in both estimation modes on
  seeds the oracle's stability filter keeps (D5, D8); a step that parts
  from the oracle is D3 when one correspondence near-tie explains it;
- ``twostage`` (:739): ``register_pair`` against ``two_stage_ref`` (and
  ``register_whole_pairs`` against ``whole_ref`` every 3rd case), basin-gated
  (D19), with the yaw delta compared modulo 360° and the classification
  asserted only on anchored or same-basin scenes; then the asserted cases
  again as ``register_pairs`` batches of 16 (and the whole cases as one
  ``register_whole_pairs`` batch), held to the oracle and to the pair-by-pair
  runs;
- ``kitti_raw`` (:807): ``assign_rings_raw`` + ``structure_cloud`` (host
  numpy) byte-equal to the oracle.

Output: a ``FAIL <leg> seed=<s> ...`` line per divergence, a ``KNIFE <leg>
seed=<s> D<k> <evidence>`` line per divergence that a README D-row covers
(with the evidence that ties it to that row: a D2 slope flip inside
1e-5° of the limit, a D3 neighbour set on the decision boundary or an ICP
correspondence whose two nearest targets tie within the score's window, a
D4 ill-conditioned neighbourhood, a D19 basin split), progress lines, one
summary line a leg, and ``DONE``.  Exit 1 on any FAIL.

The ICP oracles run ``ref_impl`` with its 1-NN loop in C
(``oracle.ref_impl``), checked against the Python loop at start-up.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import sys
import time
import traceback

import numpy as np
import torch

from pctpu_torch.cloud import make_cloud
from pctpu_torch.config import (WHOLE_ICP, FloatBevConfig, IcpConfig, RegistrationConfig,
                                get_sensor_params)
from pctpu_torch.experiments import fuzz_scenes as fs
from pctpu_torch.experiments import oracle
from pctpu_torch.io import kitti
from pctpu_torch.ops.bev import float_bev, fused_multi_single_bev
from pctpu_torch.ops.ground import mark_ground
from pctpu_torch.ops.icp import icp_trace
from pctpu_torch.ops.normals2d import normals_2d, normals_2d_knn
from pctpu_torch.ops.ordering import compact_last_wins, get_ordered_cloud
from pctpu_torch.ops.pca2d import PCA2D
from pctpu_torch.ops.topflatten import extract_top_and_flatten
from pctpu_torch.ops.voxel import voxel_downsample
from pctpu_torch.pipelines.registration import (_pair_precision, register_pair, register_pairs,
                                                register_whole_pairs)

CPU = torch.device("cpu")
SMALL = fs.SMALL
PAIR_BATCH = 16


@dataclasses.dataclass
class Tally:
    cases: int = 0
    knife: int = 0
    fail: int = 0
    seconds: float = 0.0


class Campaign:
    """The run's state: the device, the oracles, and per-leg counts."""

    def __init__(self, device: torch.device | str):
        self.dev = torch.device(device)
        self.cross = self.dev.type != "cpu"  # (b): the card against the CPU
        self.ref = oracle.ref_impl()
        self.legs: dict[str, Tally] = {}
        self.tol_flips = self.tol_px = 0
        self._lib = None

    @property
    def lib(self):
        if self._lib is None:
            self._lib = oracle.load()
        return self._lib

    def tally(self, leg: str) -> Tally:
        return self.legs.setdefault(leg, Tally())

    def fail(self, leg: str, seed, what: str) -> None:
        self.tally(leg).fail += 1
        print(f"FAIL {leg} seed={seed} {what}", flush=True)

    def knife(self, leg: str, seed, drow: str, evidence: str) -> None:
        self.tally(leg).knife += 1
        print(f"KNIFE {leg} seed={seed} {drow} {evidence}", flush=True)

    @contextlib.contextmanager
    def case(self, leg: str, seed):
        """One case: counted and timed; an exception in it is a FAIL."""
        t0 = time.perf_counter()
        try:
            yield
        except AssertionError as e:  # a contract does not hold
            self.fail(leg, seed, f"{type(e).__name__}: {' '.join(str(e).split())[:400]}")
        except Exception as e:  # the port raised: a divergence too, with its trace
            self.fail(leg, seed, f"{type(e).__name__}: {' '.join(str(e).split())[:400]}")
            traceback.print_exc(limit=-4, file=sys.stdout)
        finally:
            t = self.tally(leg)
            t.cases += 1
            t.seconds += time.perf_counter() - t0

    def spent(self, leg: str, t0: float) -> None:
        """Add the time since ``t0`` spent outside a case (an oracle's
        filter on a seed it then skips) to the leg's seconds."""
        self.tally(leg).seconds += time.perf_counter() - t0

    @property
    def failures(self) -> int:
        return sum(t.fail for t in self.legs.values())

    def summary(self) -> dict:
        return {"legs": {k: dataclasses.asdict(v) for k, v in self.legs.items()},
                "failures": self.failures,
                "knife_edges": sum(t.knife for t in self.legs.values()),
                "tolerance_label_flips": self.tol_flips, "tolerance_bev_px": self.tol_px}


def require(ok: bool, what: str) -> None:
    """A contract check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


# --- the preprocess chain ----------------------------------------------------

def _cloud(arrays: dict, dev, capacity=None):
    xyz = np.stack([arrays["x"], arrays["y"], arrays["z"]], 1).reshape(-1, 3)
    return make_cloud(xyz, intensity=arrays["intensity"], row=arrays["row"], col=arrays["col"],
                      t=arrays["t"], label=arrays["label"], capacity=capacity, device=dev)


def port_preprocess(arrays: dict, params, dev, capacity=None) -> dict:
    """Ordering, bit-exact ground marking and the fused rasters on ``dev``:
    the ordered cloud, its labelled form, and host copies of what the
    oracles give (``xyz`` the ordered grid, ``labels``, ``multi``,
    ``single``)."""
    ordered = get_ordered_cloud(_cloud(arrays, dev, capacity), params)
    labeled, _ = mark_ground(ordered, params)
    multi, single = fused_multi_single_bev(labeled, params.height_res)
    return {"ordered": ordered, "labeled": labeled, "xyz": ordered.xyz.cpu().numpy(),
            "labels": labeled.label.cpu().numpy(), "multi": multi.cpu().numpy(),
            "single": single.cpu().numpy()}


def python_oracle(ref, points: list[dict], params) -> dict:
    """``ref_impl``'s ordering, ground marking and rasters."""
    cloud = ref.ordered_cloud_ref(points, params.n_scan, params.horizon_scan)
    xyz = np.array([[p["x"], p["y"], p["z"]] for p in cloud], np.float32)
    ref.mark_ground_ref(cloud, params.n_scan, params.horizon_scan, params.ground_upper_scan)
    return {"xyz": xyz, "labels": np.array([p["label"] for p in cloud], np.int32),
            "multi": ref.multi_bev_ref(cloud, params.height_res),
            "single": ref.single_bev_ref(cloud)}


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _diffs(got: dict, want: dict, keys, bits: bool = False) -> dict[str, int]:
    """Entries that differ, by key (only keys with differences)."""
    out = {}
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape:
            out[k] = -1
            continue
        n = int((_bits(a) != _bits(b)).sum()) if bits else int((a != b).sum())
        if n:
            out[k] = n
    return out


def check_preprocess(camp: Campaign, leg: str, seed, arrays: dict, params, want: dict,
                     capacity=None, against: str = "oracle") -> dict:
    """(a) the port on the campaign's device against ``want``; (b) on the
    card, against the port's CPU run, bit for bit.  A difference is D2
    only where the slope test decides otherwise than the C++'s f64 test
    (or than the CPU) in swept cells all inside 1e-5° of the limit and the
    ordered grids are equal."""
    out = port_preprocess(arrays, params, camp.dev, capacity)
    keys = ("labels", "multi", "single") + (("xyz",) if "xyz" in want else ())
    diffs = _diffs(out, want, keys)
    if diffs:
        n_d2, n_far = oracle.slope_disagreements(out["ordered"].xyz, out["ordered"].intensity,
                                                 params)
        if "xyz" not in diffs and n_d2 and not n_far:
            camp.knife(leg, seed, "D2", f"vs {against} {diffs}: {n_d2} slope decisions off the "
                       "C++'s f64 test, all within 1e-5 deg of the limit")
        else:
            camp.fail(leg, seed, f"vs {against} {diffs}; slope decisions off the f64 test "
                      f"{n_d2}, outside D2's window {n_far}")
    if camp.cross:
        cpu = port_preprocess(arrays, params, CPU, capacity)
        diffs = _diffs(out, cpu, ("xyz", "labels", "multi", "single"), bits=True)
        if diffs:
            o = out["ordered"]
            n_d2, n_far = oracle.slope_flips((o.xyz, o.intensity),
                                             (cpu["ordered"].xyz, cpu["ordered"].intensity), params)
            if "xyz" not in diffs and n_d2 and not n_far:
                camp.knife(leg, seed, "D2", f"card vs CPU {diffs}: {n_d2} slope decisions differ, "
                           "all within 1e-5 deg of the limit")
            else:
                camp.fail(leg, seed, f"card vs CPU {diffs}; slope decisions differing {n_d2}, "
                          f"outside D2's window {n_far}")
    return out


def tolerance_flips(camp: Campaign, leg: str, seed, out: dict, params) -> None:
    """Tolerance mode against bit-exact on the same ordered cloud: label
    flips are D1's window, counted and shown, never a failure."""
    lab_t, _ = mark_ground(out["ordered"], params, compat="tolerance")
    fm_t, fs_t = fused_multi_single_bev(lab_t, params.height_res)
    flips = int((lab_t.label.cpu().numpy() != out["labels"]).sum())
    if flips:
        px = int((fm_t.cpu().numpy() != out["multi"]).sum()) + int(
            (fs_t.cpu().numpy() != out["single"]).sum())
        camp.tol_flips += flips
        camp.tol_px += px
        camp.knife(leg, seed, "D1", f"tolerance mode: label_flips={flips} bev_px={px}")


def _lexsorted(a: np.ndarray) -> np.ndarray:
    return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]


def _top_flatten(xyz, lab, dev) -> tuple[np.ndarray, ...]:
    """The top part of a 1,024-capacity cloud on ``dev``: (kept points, their
    count, the whole padded output, its mask), on the host."""
    out, mask, cnt = extract_top_and_flatten(make_cloud(xyz, label=lab, capacity=1024,
                                                        device=dev))
    out, mask = out.cpu().numpy(), mask.cpu().numpy()
    return out[mask], int(cnt), out, mask


def check_prep_ops(camp: Campaign, seed: int) -> None:
    """The registration prep ops on the case's ``seed ^ 0x5EED`` draws:
    voxel centroids within 1e-5 of the oracle, the top part equal to it as
    a set; on the card both bit-equal to the CPU (order included)."""
    prng = np.random.default_rng(seed ^ 0x5EED)
    p3 = prng.uniform(-60, 60, (400, 3)).astype(np.float32)
    p3[:, 2] = prng.uniform(-2, 10, 400).astype(np.float32)
    with camp.case("voxel", seed):
        ref_v = camp.ref.voxel_ref(p3, 0.2)

        def vox(dev):
            out = voxel_downsample(torch.from_numpy(p3).to(dev),
                                   torch.ones(400, dtype=torch.bool, device=dev), 0.2)
            return [t.cpu().numpy() for t in out]

        out, valid, count = got = vox(camp.dev)
        if int(count) != len(ref_v) or not np.allclose(out[: int(count)], ref_v, atol=1e-5):
            camp.fail("voxel", seed, f"{int(count)} voxels against the oracle's {len(ref_v)}")
        if camp.cross:
            cpu = vox(CPU)
            if not all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(got, cpu)):
                camp.fail("voxel", seed, "card vs CPU: centroids differ")
    scene = fs.scene_cloud(prng)
    xyz, lab = fs.xyz_labels(scene)
    with camp.case("topflatten", seed):
        ref_f = np.asarray(camp.ref.top_flatten_ref(scene), np.float32).reshape(-1, 3)
        got, cnt, full, mask = _top_flatten(xyz, lab, camp.dev)
        if cnt != len(ref_f) or not np.array_equal(_lexsorted(got), _lexsorted(ref_f)):
            camp.fail("topflatten", seed, f"{cnt} points against the oracle's {len(ref_f)}")
        if camp.cross:
            c_full, c_mask = _top_flatten(xyz, lab, CPU)[2:]
            if not (np.array_equal(mask, c_mask) and np.array_equal(_bits(full), _bits(c_full))):
                camp.fail("topflatten", seed, "card vs CPU: kept points or their order differ")


# --- legs --------------------------------------------------------------------

def run_regimes(camp: Campaign, start: int, n_cases: int, prep_every: int) -> None:
    """Each regime's cases against the Python oracle, tolerance mode beside
    bit-exact, and the prep ops every ``prep_every``-th case."""
    t0 = time.perf_counter()
    for case in range(n_cases):
        for regime, (n, neg1, z_lo, z_hi, r_lo, r_hi) in enumerate(fs.REGIMES):
            seed = start + 100_000 * regime + case
            pts = fs.regime_points(np.random.default_rng(seed), n, neg1, z_lo, z_hi, r_lo, r_hi,
                                   SMALL)
            with camp.case("preprocess", seed):
                out = check_preprocess(camp, "preprocess", seed, fs.point_arrays(pts), SMALL,
                                       python_oracle(camp.ref, pts, SMALL))
                tolerance_flips(camp, "preprocess", seed, out, SMALL)
            if case % prep_every == 0:
                check_prep_ops(camp, seed)
        if case % 10 == 9:
            done = (case + 1) * len(fs.REGIMES)
            print(f"preprocess [{time.perf_counter() - t0:7.1f}s] {done} cases "
                  f"({done / (time.perf_counter() - t0):.1f}/s) failures={camp.failures} "
                  f"tol_flips={camp.tol_flips} tol_bev_px={camp.tol_px}", flush=True)


def run_sensors(camp: Campaign, start: int) -> None:
    """The regime sweep once per real sensor at its full grid."""
    for i, sensor in enumerate(("HDL_32E", "HDL_64E", "OS1_64")):
        params = get_sensor_params(sensor)
        seed = start + 900_000 + i
        pts = fs.regime_points(np.random.default_rng(seed), 600, 0.15, -2.5, 4.0, 2.0, 90.0,
                               params)
        with camp.case("sensors", seed):
            check_preprocess(camp, "sensors", seed, fs.point_arrays(pts), params,
                             python_oracle(camp.ref, pts, params), against=f"oracle {sensor}")
        print(f"sensor {sensor} ({params.grid_size} cells) checked", flush=True)


def run_native(camp: Campaign, start: int, n_cases: int) -> None:
    """Each regime's cases against the C++ oracle (the Python oracle too
    every 4th), and every 4th case a scene's float BEVs and top part."""
    t0 = time.perf_counter()
    for case in range(n_cases):
        for regime, (n, neg1, z_lo, z_hi, r_lo, r_hi) in enumerate(fs.REGIMES):
            seed = start + 500_000 + 100_000 * regime + case
            pts = fs.regime_points(np.random.default_rng(seed), n, neg1, z_lo, z_hi, r_lo, r_hi,
                                   SMALL)
            arrays = fs.point_arrays(pts)
            with camp.case("native", seed):
                nat = dict(zip(("labels", "multi", "single", "xyz"),
                               oracle.preprocess(camp.lib, arrays, SMALL, ordered=True)))
                check_preprocess(camp, "native", seed, arrays, SMALL, nat, against="C++ oracle")
                if case % 4 == 0:
                    diffs = _diffs(nat, python_oracle(camp.ref, pts, SMALL),
                                   ("labels", "multi", "single", "xyz"))
                    if diffs:
                        camp.fail("native", seed, f"C++ oracle vs Python oracle {diffs}")
        if case % 4 == 0:
            seed = start + 500_000 + case
            scene = fs.scene_cloud(np.random.default_rng(seed))
            xyz, lab = fs.xyz_labels(scene)
            with camp.case("native", seed):
                for fg in (False, True):
                    want = oracle.float_bev(camp.lib, xyz, lab, fg)
                    got = _float_bev(xyz, lab, fg, camp.dev)
                    if not np.array_equal(got, want):
                        camp.fail("native", seed, f"float_bev filter_ground={fg} vs C++ oracle: "
                                  f"{int((got != want).sum())} cells")
                    if camp.cross and not np.array_equal(_bits(got),
                                                         _bits(_float_bev(xyz, lab, fg, CPU))):
                        camp.fail("native", seed, f"float_bev filter_ground={fg} card vs CPU")
                # the top part in the reference's order, on the scene and on
                # its heights tied (equal z, ±0.0: D14's stable order)
                tied = fs.tied_heights(xyz, np.random.default_rng(seed ^ 0x7135))
                for what, top_xyz in (("", xyz), (" tied heights", tied)):
                    want = oracle.top_flatten(camp.lib, top_xyz, lab)
                    got, _, full, mask = _top_flatten(top_xyz, lab, camp.dev)
                    if not np.array_equal(_bits(got), _bits(want)):
                        camp.fail("native", seed, f"top_flatten{what} in the reference's order: "
                                  f"{len(got)} points against the C++ oracle's {len(want)}")
                    if camp.cross:
                        c_full, c_mask = _top_flatten(top_xyz, lab, CPU)[2:]
                        if not (np.array_equal(mask, c_mask)
                                and np.array_equal(_bits(full), _bits(c_full))):
                            camp.fail("native", seed, f"top_flatten{what} card vs CPU")
        if case % 20 == 19:
            print(f"native [{time.perf_counter() - t0:6.1f}s] {(case + 1) * len(fs.REGIMES)} "
                  f"cases failures={camp.failures}", flush=True)


def _float_bev(xyz, lab, fg: bool, dev) -> np.ndarray:
    cloud = make_cloud(xyz, label=lab, device=dev)
    return float_bev(cloud, FloatBevConfig(filter_ground=fg)).cpu().numpy()


def run_adversarial(camp: Campaign, start: int, n_cases: int) -> None:
    """Over-capacity clouds compacted on the host (last wins), dropped
    azimuth bands, all- and no-ground shapes: the port on the compacted
    cloud bit-equal to the oracle on the full list."""
    g = SMALL.grid_size
    for case in range(n_cases):
        seed = start + 700_000 + case
        pts = fs.adversarial_points(seed, case)
        with camp.case("adversarial", seed):
            want = python_oracle(camp.ref, pts, SMALL)
            full = fs.point_arrays(pts)
            compacted, n_keep = compact_last_wins(full, len(pts), SMALL)
            require(n_keep <= g, f"compaction kept {n_keep} points for {g} cells")
            check_preprocess(camp, "adversarial", f"{seed} shape={case % 4}", compacted, SMALL,
                             want, capacity=g)


def run_misc(camp: Campaign, start: int, n_cases: int) -> None:
    """The float BEV (both ground filters) bit-equal to the oracle, and the
    PCA2D fit (with and without indices) within pctpu's tolerance."""
    for case in range(n_cases):
        seed = start + case
        rng = np.random.default_rng(seed)
        pts = fs.misc_points(rng)
        xyz, lab = fs.xyz_labels(pts)
        with camp.case("misc", seed):
            for filt in (False, True):
                want = camp.ref.float_bev_ref(pts, filter_ground=filt).astype(np.float32)
                got = _float_bev(xyz, lab, filt, camp.dev)
                if not np.array_equal(got, want):
                    camp.fail("misc", seed, f"float_bev filter_ground={filt}: "
                              f"{int((got != want).sum())} cells")
                if camp.cross and not np.array_equal(_bits(got),
                                                     _bits(_float_bev(xyz, lab, filt, CPU))):
                    camp.fail("misc", seed, f"float_bev filter_ground={filt} card vs CPU")
            p_xyz, indices = fs.pca2d_points(rng, case, len(pts))
            ref_fit = camp.ref.pca2d_ref(p_xyz, indices)
            fit = _pca2d(p_xyz, indices, camp.dev)
            if not _pca2d_close(fit, ref_fit):
                camp.fail("misc", seed, f"pca2d: {fit} against the oracle's {ref_fit}")
            if camp.cross and not _pca2d_close(fit, _pca2d(p_xyz, indices, CPU)):
                camp.fail("misc", seed, "pca2d card vs CPU")


def _pca2d(xyz, indices, dev) -> tuple[np.ndarray, ...]:
    pca = PCA2D(device=dev)
    pca.set_input_cloud(xyz)
    pca.set_indices(indices)
    return tuple(t.cpu().numpy() for t in (pca.get_mean(), pca.get_eigen_values(),
                                           pca.get_eigen_vectors()))


def _pca2d_close(fit, ref_fit) -> bool:
    """pctpu's window: mean 1e-4, eigenvalues 1e-3 relative + 1e-2, each
    eigenvector within 1e-2 up to its sign."""
    mean, w, v = fit
    ref_mean, ref_w, ref_v = ref_fit
    ok = (np.allclose(mean, ref_mean, atol=1e-4)
          and np.allclose(w, ref_w, rtol=1e-3, atol=1e-2))
    for col in range(2):
        ok = ok and min(np.linalg.norm(v[:, col] - ref_v[:, col]),
                        np.linalg.norm(v[:, col] + ref_v[:, col])) < 1e-2
    return bool(ok)


# --- normals -----------------------------------------------------------------

class NormalsScene:
    """One normals scene and the windows of pctpu's sweep: D4's
    conditioning-aware tolerance and D3's decision-boundary window a point."""

    def __init__(self, ref, seed: int):
        self.ref = ref
        self.p2, self.xyz = fs.normals_scene(seed)
        p2 = self.p2
        bbox_c = 0.5 * (p2.min(axis=0) + p2.max(axis=0))
        self.r_sq = float(np.max(np.sum((p2 - bbox_c) ** 2, axis=1)))
        self.r2_pts = np.sum((p2.astype(np.float64) - bbox_c) ** 2, axis=1)
        self.d2_all = np.sum((p2.astype(np.float64)[None] - p2.astype(np.float64)[:, None]) ** 2,
                             axis=2)

    def allowed(self, neighborhood: np.ndarray) -> float:
        """D4: the eigenvector's error ~|p−c|²·n·2⁻²³ amplified by 1/(λ₁−λ₀)."""
        sel = neighborhood.astype(np.float64)
        d = sel - sel.mean(axis=0)
        w = np.linalg.eigvalsh(d.T @ d)
        gap = max(float(w[1] - w[0]), 1e-12)
        return max(5e-3, min(0.1, 4.0 * self.r_sq * len(sel) * 2.0**-23 / gap))

    def window(self, i: int) -> np.ndarray:
        """D3: the score's rounding window for each (query i, candidate) pair."""
        return 32.0 * np.maximum(self.r2_pts[i], self.r2_pts) * 2.0**-23

    def mode(self, case: int):
        """(name, run(dev) -> (normals, ok), oracle, neighbourhood(i), knife sets(i))
        for the radius mode and the k mode of ``case``."""
        p2, ref = self.p2, self.ref
        r = (1.0, 2.0, 4.0)[case % 3]
        k = (2, 5, 9, 30)[case % 4]

        def run(fn, **kw):
            def go(dev):
                nrm, _, ok = fn(torch.from_numpy(self.xyz).to(dev),
                                torch.ones(len(p2), dtype=torch.bool, device=dev), **kw)
                return nrm.cpu().numpy()[:, :2], ok.cpu().numpy()
            return go

        return [
            (f"radius={r}", run(normals_2d, radius=r),
             lambda: ref.normals2d_ref(self.xyz, radius=r),
             lambda i: p2[self.d2_all[i] < r * r],
             lambda i: ref.normals2d_knife_edge_sets(p2, i, self.window(i), radius=r)),
            (f"k={k}", run(normals_2d_knn, k=k),
             lambda: ref.normals2d_knn_ref(self.xyz, k),
             lambda i: p2[np.argsort(self.d2_all[i], kind="stable")[:k]],
             lambda i: ref.normals2d_knife_edge_sets(p2, i, self.window(i), k=k)),
        ]

    def judge(self, ours: np.ndarray, want: np.ndarray, i: int, nbr, alt_sets) -> tuple[str, float]:
        """('ok' | 'D4' | 'D3' | 'fail', distance up to sign) for point i."""
        d = min(np.linalg.norm(ours - want), np.linalg.norm(ours + want))
        if d < 5e-3:
            return "ok", d
        if d < self.allowed(nbr(i)):
            return "D4", d
        for alt in alt_sets(i):
            alt_n = self.ref.normal2d_from_set(self.p2, i, alt)
            if alt_n is None:
                continue
            d_alt = min(np.linalg.norm(ours - alt_n), np.linalg.norm(ours + alt_n))
            if d_alt < 5e-3 or d_alt < self.allowed(self.p2[alt]):
                return "D3", d
        return "fail", d


def run_normals(camp: Campaign, start: int, n_cases: int) -> None:
    """Validity masks equal to the oracle; each normal within 5e-3 up to
    sign, or inside D4's conditioning window, or equal to the oracle on a
    neighbour set that D3's boundary window allows.  On the card, the card
    and the CPU judged by the same rules against each other."""
    for case in range(n_cases):
        seed = start + case
        scene = NormalsScene(camp.ref, seed)
        for name, run, ref_fn, nbr, alts in scene.mode(case):
            with camp.case("normals", f"{seed} {name}"):
                ref_n, ref_ok = ref_fn()
                ours, ok = run(camp.dev)
                if not np.array_equal(ok, ref_ok):
                    camp.fail("normals", seed, f"{name}: validity mask "
                              f"({int((ok != ref_ok).sum())} points)")
                    continue
                for i in np.flatnonzero(ref_ok):
                    verdict, d = scene.judge(ours[i], ref_n[i], i, nbr, alts)
                    if verdict == "fail":
                        camp.fail("normals", seed, f"{name} i={i} d={d:.4g}")
                        break
                    if verdict != "ok":
                        camp.knife("normals", seed, verdict,
                                   f"{name} i={i} d={d:.4g} " + (
                                       "(ill-conditioned neighbourhood)" if verdict == "D4" else
                                       "(the oracle on a boundary-window neighbour set agrees)"))
                if camp.cross:
                    c_ours, c_ok = run(CPU)
                    if not np.array_equal(ok, c_ok):
                        camp.fail("normals", seed, f"{name}: card vs CPU validity mask")
                        continue
                    for i in np.flatnonzero(ok):
                        verdict, d = scene.judge(ours[i], c_ours[i], i, nbr, lambda i: ())
                        if verdict == "D4":
                            camp.knife("normals", seed, "D4", f"{name} i={i} card vs CPU "
                                       f"d={d:.4g} (ill-conditioned neighbourhood)")
                        elif verdict == "fail":
                            # each must then lie in the oracle's knife-edge family
                            both = [scene.judge(o[i], ref_n[i], i, nbr, alts)[0]
                                    for o in (ours, c_ours)]
                            if "fail" in both:
                                camp.fail("normals", seed, f"{name} i={i} card vs CPU d={d:.4g}")
                                break
                            camp.knife("normals", seed, "D3", f"{name} i={i} card vs CPU "
                                       f"d={d:.4g}, each within the oracle's family ({both})")
    print(f"normals2d: {n_cases} cases per mode, failures={camp.tally('normals').fail}, "
          f"knife edges={camp.tally('normals').knife}", flush=True)


# --- ICP ---------------------------------------------------------------------

def assert_traces_match(trace: dict, ref: dict, atol_t=5e-4, rtol_mse=5e-4, check_mse=True,
                        atol_mse=0.0) -> None:
    """pctpu's per-iteration contract (tests/test_icp_differential.py): the
    same iteration count, each step's transform within ``atol_t`` and MSE
    within ``rtol_mse`` + ``atol_mse`` (the NN score's d² window)."""
    done = np.asarray(trace["done"])
    n = int(np.argmax(done)) + 1 if done.any() else len(done)
    require(n == len(ref["trace"]),
            f"iteration counts differ: port {n} vs oracle {len(ref['trace'])}")
    for i, (t_ref, mse_ref, _) in enumerate(ref["trace"]):
        np.testing.assert_allclose(np.asarray(trace["transform"])[i], t_ref, atol=atol_t, rtol=0,
                                   err_msg=f"iteration {i} transform")
        if check_mse and np.isfinite(mse_ref):
            np.testing.assert_allclose(float(np.asarray(trace["mse"])[i]), mse_ref,
                                       rtol=rtol_mse, atol=atol_mse,
                                       err_msg=f"iteration {i} mse")


def icp_case(seed: int, mode: str):
    """(src, tgt, normals, normal_ok, cfg) of the ICP leg's seed."""
    if mode == "point":
        yaw = 2.0 + (seed % 11) * 1.7
        shift = (0.2 + 0.04 * (seed % 6), -0.25 + 0.09 * (seed % 4), 0.05 * (seed % 3))
        src, tgt = fs.icp_scene(seed, yaw_deg=yaw, shift=shift)
        return src, tgt, None, None, IcpConfig(max_correspondence_distance=4.0, max_iterations=8)
    yaw = 1.5 + (seed % 7) * 1.3
    shift = (0.1 + 0.05 * (seed % 5), -0.15 + 0.07 * (seed % 4), 0.0)
    src, tgt, nrm, ok = fs.plane_scene(seed, yaw, shift)
    return src, tgt, nrm, ok, IcpConfig(max_correspondence_distance=10.0, max_iterations=4,
                                        point_to_plane=True)


def icp_oracle_stable(ref, src, tgt, nrm, ok, cfg) -> dict | None:
    """The oracle's result when its exit is stable: the same iteration
    count and flag under a 1e-6 shift of the source, and no MSE plateau
    closer than 5e-7 relative (D8); else None."""
    def run(s):
        return ref.icp_ref(s, tgt, np.eye(4, dtype=np.float32), cfg.max_correspondence_distance,
                           cfg.max_iterations, cfg.transformation_epsilon,
                           cfg.euclidean_fitness_epsilon, tgt_normals=nrm, normal_ok=ok)

    a, b = run(src), run(src + np.float32(1e-6))
    if len(a["trace"]) != len(b["trace"]) or a["converged"] != b["converged"]:
        return None
    mses = [m for _, m, _ in a["trace"] if np.isfinite(m)]
    if any(abs(y - x) < 5e-7 * max(y, 1e-9) for x, y in zip(mses, mses[1:])):
        return None
    return a


def port_icp_trace(src, tgt, nrm, ok, cfg, dev):
    def t(a, dtype=torch.float32):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev, dtype)

    res, trace = icp_trace(t(src), torch.ones(len(src), dtype=torch.bool, device=dev), t(tgt),
                           torch.ones(len(tgt), dtype=torch.bool, device=dev),
                           torch.eye(4, device=dev), cfg, tgt_normals=t(nrm),
                           normal_mask=t(ok, torch.bool))
    return res.numpy(), {k: v.cpu().numpy() for k, v in trace.items()}


def icp_contract(res, trace: dict, ref: dict, mode: str, win: float) -> None:
    """pctpu's ICP leg contract (``scripts/fuzz_campaign.py:712-726``): the
    trace within 1e-3 (point) / 3e-3 (plane) a step and the NN score's
    window on the MSE, the converged flag, and the point mode's fitness."""
    atol = 1e-3 if mode == "point" else 3e-3
    assert_traces_match(trace, ref, atol_t=atol, rtol_mse=atol, atol_mse=win)
    require(bool(res.converged) == ref["converged"], "converged flag")
    if mode == "point":
        np.testing.assert_allclose(float(res.fitness), ref["fitness"], rtol=2e-3, atol=1e-7,
                                   err_msg="fitness")


class _OracleNn:
    """The oracle's 1-NN, recording each call's query and answer, and
    answering call ``swap[0]`` with target ``swap[1]`` instead (its d² as
    the oracle computes it)."""

    def __init__(self, base, swap: tuple[int, int] | None = None):
        self.base, self.swap, self.calls = base, swap, []

    def __call__(self, q, target, target_ok):
        if self.swap is not None and len(self.calls) == self.swap[0]:
            only = np.zeros(len(target), bool)
            only[self.swap[1]] = True
            out = self.base(q, target, only)
        else:
            out = self.base(q, target, target_ok)
        self.calls.append((np.array(q, np.float32), np.asarray(target_ok, bool), out))
        return out


def icp_near_tie(ref_mod, src, tgt, nrm, ok, cfg, res, trace: dict, mode: str,
                 win: float) -> str | None:
    """D3's evidence for a trace that parts from the oracle's: at the first
    step where the transforms part, a source point whose two nearest targets
    lie within the NN score's window ``win`` of each other in d², such that
    the oracle, given the other one at that step, meets the whole contract.
    Returns that evidence, or None (a fault)."""
    base = ref_mod._nn_1_ref

    def oracle_with(nn):
        ref_mod._nn_1_ref = nn
        try:
            return ref_mod.icp_ref(src, tgt, np.eye(4, dtype=np.float32),
                                   cfg.max_correspondence_distance, cfg.max_iterations,
                                   cfg.transformation_epsilon, cfg.euclidean_fitness_epsilon,
                                   tgt_normals=nrm, normal_ok=ok)
        finally:
            ref_mod._nn_1_ref = base

    atol = 1e-3 if mode == "point" else 3e-3
    record = _OracleNn(base)
    plain = oracle_with(record)
    steps = min(len(plain["trace"]), len(trace["transform"]))
    parted = [k for k in range(steps)
              if np.abs(trace["transform"][k] - plain["trace"][k][0]).max() > atol]
    if not parted:
        return None
    k, n = parted[0], len(src)
    for i in range(n):
        q, allowed, (j, d) = record.calls[k * n + i]
        others = allowed.copy()
        others[j] = False
        j2, d2 = base(q, tgt, others)
        if not d2 - d <= win:
            continue
        try:
            icp_contract(res, trace, oracle_with(_OracleNn(base, swap=(k * n + i, j2))), mode,
                         win)
        except AssertionError:
            continue
        return (f"step {k}, source point {i}: targets {j} and {j2} {d2 - d:.3g} apart in d² "
                f"(score window {win:.3g}); the oracle given {j2} there agrees")
    return None


def run_icp(camp: Campaign, start: int, target: int) -> None:
    """Per-iteration ICP on seeds the oracle's filter keeps, both modes,
    walking seeds until ``target`` a mode assert (at most 5× examined).  A
    trace that parts from the oracle's is D3 when one correspondence near-tie
    explains it (:func:`icp_near_tie`); on the card, the card and the CPU
    that part from each other must each be the oracle's or so explained."""
    for mode in ("point", "plane"):
        asserted = examined = 0
        seed = start
        while asserted < target and examined < 5 * target:
            seed += 1
            examined += 1
            t0 = time.perf_counter()
            src, tgt, nrm, ok, cfg = icp_case(seed, mode)
            ref = icp_oracle_stable(camp.ref, src, tgt, nrm, ok, cfg)
            camp.spent("icp", t0)
            if ref is None:
                continue
            asserted += 1
            name = f"{seed} mode={mode}"
            win = 8.0 * float(np.max(np.sum(tgt * tgt, axis=1))) * 2.0**-23

            def verdict(res, trace):
                """None when the run meets the contract, else D3's evidence
                (AssertionError when there is none)."""
                try:
                    icp_contract(res, trace, ref, mode, win)
                    return None
                except AssertionError:
                    evidence = icp_near_tie(camp.ref, src, tgt, nrm, ok, cfg, res, trace, mode,
                                            win)
                    if evidence is None:
                        raise
                    return evidence

            with camp.case("icp", name):
                res, trace = port_icp_trace(src, tgt, nrm, ok, cfg, camp.dev)
                evidence = verdict(res, trace)
                if evidence:
                    camp.knife("icp", name, "D3", evidence)
                if camp.cross:
                    c_res, c_trace = port_icp_trace(src, tgt, nrm, ok, cfg, CPU)
                    cpu_as_ref = {"trace": [(c_trace["transform"][i], float(c_trace["mse"][i]), 0)
                                            for i in range(int(np.argmax(c_trace["done"])) + 1)],
                                  "converged": bool(c_res.converged)}
                    atol = 1e-3 if mode == "point" else 3e-3
                    try:
                        assert_traces_match(trace, cpu_as_ref, atol_t=atol, rtol_mse=atol,
                                            atol_mse=win)
                        require(bool(res.converged) == cpu_as_ref["converged"],
                                "card vs CPU converged")
                    except AssertionError:
                        sides = [e or "the oracle's" for e in (evidence, verdict(c_res, c_trace))]
                        camp.knife("icp", name, "D3", f"card vs CPU: card {sides[0]}; CPU "
                                   f"{sides[1]}")
        print(f"icp {mode}: asserted {asserted}/{examined} examined (seeds {start + 1}..{seed})",
              flush=True)


# --- two-stage registration --------------------------------------------------

# an estimation step with fewer correspondences is ill-posed (D7)
MIN_WELLPOSED_NCORR = 16
# winner coarse fitness below this: a matched ("anchored") scene
ANCHORED_FITNESS = 1.0
# the classification of a degenerate scene is held only this far from 1.5
CLASSIFY_MARGIN = 0.3
FAILURE_FITNESS = 1.5


def _well_posed(res: dict) -> bool:
    return all(nc >= MIN_WELLPOSED_NCORR for _, mse, nc in res["trace"] if np.isfinite(mse))


def twostage_oracle_stable(ref, xyz1, lab1, xyz2, lab2, guess_deg) -> tuple[dict, bool]:
    """``two_stage_ref`` and whether the asserts may use it: well-posed
    winner and fine trajectories, a robust best-of-two, and the same
    discrete outcomes under a 1e-6 shift of the source
    (tests/test_twostage_differential.py: ``oracle_stable``)."""
    d1, d2 = fs.to_dicts(xyz1, lab1), fs.to_dicts(xyz2, lab2)
    out = ref.two_stage_ref(d1, d2, guess_deg)
    win, lose = out["best_i"], 1 - out["best_i"]
    if not (_well_posed(out["coarse"][win]) and _well_posed(out["fine"])):
        return out, False
    f_win, f_lose = out["coarse"][win]["fitness"], out["coarse"][lose]["fitness"]
    if _well_posed(out["coarse"][lose]):
        gap_ok = abs(f_win - f_lose) > 1e-3 * max(f_win, f_lose, 1e-9)
    else:
        gap_ok = f_lose > 4.0 * max(f_win, 1e-9)
    if not gap_ok:
        return out, False
    other = ref.two_stage_ref(fs.to_dicts(xyz1 + np.float32(1e-6), lab1), d2, guess_deg)
    stable = (out["best_i"] == other["best_i"]
              and len(out["fine"]["trace"]) == len(other["fine"]["trace"])
              and out["fine"]["converged"] == other["fine"]["converged"]
              and out["success"] == other["success"])
    return out, stable


def whole_oracle_stable(ref, xyz1, lab1, xyz2, lab2, guess_deg) -> tuple[dict, bool]:
    """``whole_ref`` and its stability under the same rules."""
    d1, d2 = fs.to_dicts(xyz1, lab1), fs.to_dicts(xyz2, lab2)
    out = ref.whole_ref(d1, d2, guess_deg)
    if not _well_posed(out["fine"]):
        return out, False
    other = ref.whole_ref(fs.to_dicts(xyz1 + np.float32(1e-6), lab1), d2, guess_deg)
    stable = (len(out["fine"]["trace"]) == len(other["fine"]["trace"])
              and out["fine"]["converged"] == other["fine"]["converged"]
              and out["success"] == other["success"])
    return out, stable


def pair_clouds(xyz1, lab1, xyz2, lab2, dev, capacity=2048):
    return (make_cloud(xyz1, label=lab1, capacity=capacity, device=dev),
            make_cloud(xyz2, label=lab2, capacity=capacity, device=dev))


def run_pair(scene, dev):
    """``register_pair`` of a two-stage scene: (best coarse, fine) numpy."""
    xyz1, lab1, xyz2, lab2, guess = scene[:5]
    return register_pair(*pair_clouds(xyz1, lab1, xyz2, lab2, dev), angle_guess_deg=guess,
                         flat_cap=2048)


def run_pairs_batched(scenes, dev):
    """The scenes as ``register_pairs`` batches of ``PAIR_BATCH``."""
    out = []
    for k in range(0, len(scenes), PAIR_BATCH):
        pairs = [(*pair_clouds(*s[:4], dev), s[4]) for s in scenes[k:k + PAIR_BATCH]]
        out.extend(register_pairs(pairs, flat_cap=2048))
    return out


def run_whole(scenes, dev):
    """``register_whole_pairs`` of the scenes in one call: fine results."""
    pairs = [(*pair_clouds(*s[:4], dev), s[4]) for s in scenes]
    return register_whole_pairs(pairs, RegistrationConfig(fine=WHOLE_ICP))


def yaw_delta(a: float, b: float) -> float:
    """|a − b| in degrees, modulo 360."""
    return abs(((a - b) + 180.0) % 360.0 - 180.0)


def two_stage_contract(best, fine, ref: dict) -> list[str]:
    """pctpu's two-stage contract (tests/test_twostage_differential.py:
    ``assert_two_stage_matches``) with two changes: the report's yaw delta
    is compared modulo 360°, and the success classification is held on
    anchored scenes and on degenerate scenes in the oracle's basin (outside
    the 30% margin), not on basin-split ones, where D19 makes fitness values
    incomparable.  Raises AssertionError on a fault; returns the D19
    evidence of a basin split (then only the sanity net is held)."""
    notes = []
    anchored = ref["best"]["fitness"] < ANCHORED_FITNESS
    t_best, t_fine = np.asarray(best.transform), np.asarray(fine.transform)
    d_win = float(np.abs(t_best - ref["best"]["transform"]).max())
    d_lose = float(np.abs(t_best - ref["coarse"][1 - ref["best_i"]]["transform"]).max())
    same_basin = d_win < 0.5
    if anchored or same_basin:
        require(d_win < d_lose, f"coarse winner disagrees with the oracle's (d_win={d_win:.4g} "
                                f"vs d_lose={d_lose:.4g})")
    else:
        f_ref = max(ref["best"]["fitness"], ref["coarse"][1 - ref["best_i"]]["fitness"])
        require(float(best.fitness) <= 4.0 * f_ref,
                f"basin-split coarse winner fitness {float(best.fitness):.4g} implausibly worse "
                f"than the oracle pair ({f_ref:.4g})")
        notes.append(f"basin split: coarse winner {d_win:.3g} from the oracle's, fine fitness "
                     f"{float(fine.fitness):.4g} vs {ref['fine']['fitness']:.4g}")
    if anchored:
        np.testing.assert_allclose(t_best, ref["best"]["transform"], atol=0.03, rtol=0,
                                   err_msg="coarse winner transform")
        np.testing.assert_allclose(t_fine, ref["fine"]["transform"], atol=5e-3, rtol=0,
                                   err_msg="fine transform")
        require(bool(fine.converged) == ref["fine"]["converged"], "fine converged flag")
        np.testing.assert_allclose(float(fine.fitness), ref["fine"]["fitness"], rtol=5e-2,
                                   atol=1e-6, err_msg="fine fitness")
        # the report's deltas move with the (asserted-small) transform deltas
        d_fine = float(np.abs(t_fine - ref["fine"]["transform"]).max())
        tol_xy = math.sqrt(2.0) * (d_win + d_fine) + 1e-3
        tol_yaw = 81.0 * (d_win + d_fine) + 0.01
        dxy_p, dyaw_p = _pair_precision(t_best, t_fine)
        dxy_r, dyaw_r = _pair_precision(ref["best"]["transform"], ref["fine"]["transform"])
        require(abs(dxy_p - dxy_r) < tol_xy, f"report dxy {dxy_p} vs {dxy_r} (tol {tol_xy:.3g})")
        require(yaw_delta(dyaw_p, dyaw_r) < tol_yaw,
                f"report dyaw {dyaw_p} vs {dyaw_r} (tol {tol_yaw:.3g})")
    elif same_basin:
        np.testing.assert_allclose(float(fine.fitness), ref["fine"]["fitness"], rtol=0.5,
                                   err_msg="degenerate-scene fine fitness (order of magnitude)")
    ref_fit = ref["fine"]["fitness"]
    if anchored or (same_basin and abs(ref_fit - FAILURE_FITNESS)
                    > CLASSIFY_MARGIN * FAILURE_FITNESS):
        require((float(fine.fitness) <= FAILURE_FITNESS) == ref["success"],
                f"success classification: fitness {float(fine.fitness):.4g} vs oracle "
                f"{ref_fit:.4g}")
    return notes


def whole_contract(fine, ref: dict) -> None:
    """pctpu's ``assert_whole_matches``."""
    anchored = ref["fine"]["fitness"] < ANCHORED_FITNESS
    if anchored:
        np.testing.assert_allclose(np.asarray(fine.transform), ref["fine"]["transform"],
                                   atol=5e-3, rtol=0, err_msg="whole-cloud fine transform")
        require(bool(fine.converged) == ref["fine"]["converged"], "whole converged flag")
        np.testing.assert_allclose(float(fine.fitness), ref["fine"]["fitness"], rtol=5e-2,
                                   atol=1e-6, err_msg="whole fitness")
    else:
        np.testing.assert_allclose(float(fine.fitness), ref["fine"]["fitness"], rtol=0.5,
                                   err_msg="degenerate-scene whole fitness (order of magnitude)")
    ref_fit = ref["fine"]["fitness"]
    if anchored or abs(ref_fit - FAILURE_FITNESS) > CLASSIFY_MARGIN * FAILURE_FITNESS:
        require((float(fine.fitness) <= FAILURE_FITNESS) == ref["success"],
                f"whole success classification: fitness {float(fine.fitness):.4g} vs oracle "
                f"{ref_fit:.4g}")


def same_classification(a, b, ref: dict, what: str) -> str | None:
    """Two runs on one scene (batched and single, card and CPU, port and
    pctpu): on anchored scenes or where their coarse winners share a basin
    the classification must agree, and on anchored scenes the fine
    transforms too, within 5e-3 (else AssertionError); a split between
    basins is D19 — returns its evidence, or None."""
    (best_a, fine_a), (best_b, fine_b) = a, b
    d = float(np.abs(np.asarray(best_a.transform) - np.asarray(best_b.transform)).max())
    agree = (float(fine_a.fitness) <= FAILURE_FITNESS) == (float(fine_b.fitness) <= FAILURE_FITNESS)
    anchored = ref["best"]["fitness"] < ANCHORED_FITNESS
    if anchored or d < 0.5:
        require(agree, f"{what}: classification differs (fitness {float(fine_a.fitness):.4g} vs "
                       f"{float(fine_b.fitness):.4g}, coarse winners {d:.3g} apart)")
        if anchored:
            np.testing.assert_allclose(np.asarray(fine_a.transform), np.asarray(fine_b.transform),
                                       atol=5e-3, rtol=0, err_msg=f"{what}: fine transform")
        return None
    return f"{what}: coarse winners {d:.3g} apart, fitness {float(fine_a.fitness):.4g} vs " \
           f"{float(fine_b.fitness):.4g}"


def run_twostage(camp: Campaign, start: int, target: int) -> None:
    """``register_pair`` against the composed oracle on seeds the oracle's
    filter keeps (every 3rd asserted seed also the whole-cloud driver), then
    the asserted scenes as ``register_pairs`` batches of 16 and the whole
    scenes as one ``register_whole_pairs`` batch."""
    asserted, whole = [], []
    examined = 0
    seed = start
    t0 = time.perf_counter()
    while len(asserted) < target and examined < 5 * target:
        seed += 1
        examined += 1
        t1 = time.perf_counter()
        scene = fs.twostage_scene(seed)
        ref, stable = twostage_oracle_stable(camp.ref, *scene[:5])
        camp.spent("twostage", t1)
        if not stable:
            continue
        single = None
        with camp.case("twostage", seed):
            single = run_pair(scene, camp.dev)
            for note in two_stage_contract(*single, ref):
                camp.knife("twostage", seed, "D19", note)
            if camp.cross:
                note = same_classification(single, run_pair(scene, CPU), ref, "card vs CPU")
                if note:
                    camp.knife("twostage", seed, "D19", note)
        if len(asserted) % 3 == 0:
            t1 = time.perf_counter()
            ref_w, stable_w = whole_oracle_stable(camp.ref, *scene[:5])
            camp.spent("twostage", t1)
            if stable_w:
                with camp.case("twostage", f"{seed} whole"):
                    (fine_w,) = run_whole([scene], camp.dev)
                    whole_contract(fine_w, ref_w)
                    whole.append((seed, scene, ref_w, fine_w))
        asserted.append((seed, scene, ref, single))
        if len(asserted) % 5 == 0:
            print(f"twostage: {len(asserted)}/{examined} examined "
                  f"({(time.perf_counter() - t0) / len(asserted):.2f} s/case) "
                  f"failures={camp.failures}", flush=True)
    print(f"twostage: asserted {len(asserted)}/{examined} examined (seeds {start + 1}..{seed})",
          flush=True)
    if asserted:
        batched = run_pairs_batched([a[1] for a in asserted], camp.dev)
        for (seed, scene, ref, single), res in zip(asserted, batched):
            with camp.case("twostage", f"{seed} batched"):
                for note in two_stage_contract(*res, ref):
                    camp.knife("twostage", f"{seed} batched", "D19", note)
                if single is not None:
                    note = same_classification(res, single, ref, "batch of 16 vs single")
                    if note:
                        camp.knife("twostage", f"{seed} batched", "D19", note)
    if whole:
        fines = run_whole([w[1] for w in whole], camp.dev)
        for (seed, _, ref_w, fine_w), fine_b in zip(whole, fines):
            with camp.case("twostage", f"{seed} whole batched"):
                whole_contract(fine_b, ref_w)
                require((float(fine_b.fitness) <= FAILURE_FITNESS)
                        == (float(fine_w.fitness) <= FAILURE_FITNESS),
                        "whole batch vs single classification")


# --- KITTI raw ---------------------------------------------------------------

def run_kitti_raw(camp: Campaign, start: int, n_cases: int) -> None:
    """The raw-variant structuring (host numpy) byte-equal to the oracle."""
    for case in range(n_cases):
        seed = start + case
        scan = fs.kitti_raw_scan(seed, case)
        with camp.case("kitti_raw", f"{seed} regime={case % 4}"):
            got = kitti.structure_cloud(scan, rings=kitti.assign_rings_raw(scan))
            want = camp.ref.kitti_raw_structured_ref(scan)
            bad = [k for k in want if not np.array_equal(got[k], want[k])]
            if bad:
                camp.fail("kitti_raw", seed, f"fields {bad} differ")


# --- entry points --------------------------------------------------------------

def check_c_nn(ref_c, ref_plain, n: int = 200) -> None:
    """The oracle's C 1-NN loop equal to the Python loop on this machine."""
    rng = np.random.default_rng(0)
    for k in range(n):
        m = int(rng.integers(1, 200))
        t = rng.uniform(-60, 60, (m, 3)).astype(np.float32)
        q = t[rng.integers(0, m)].copy() if k % 4 == 0 else rng.uniform(-60, 60, 3).astype(
            np.float32)
        ok = list(rng.random(m) > 0.2)
        if ref_c._nn_1_ref(q, t, ok) != ref_plain._nn_1_ref(q, t, ok):
            raise RuntimeError("the oracle's C 1-NN loop differs from tests/ref_impl.py's")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pctpu_torch.experiments.fuzz_campaign",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--start", type=int, default=20000, help="first seed (a fresh range a run)")
    ap.add_argument("--cases", type=int, default=500, help="cases per regime")
    ap.add_argument("--sensors", action="store_true", help="also the full-grid sensor presets")
    ap.add_argument("--prep-every", type=int, default=4,
                    help="voxel and top-flatten every Nth case")
    ap.add_argument("--icp", type=int, default=0, help="N asserted ICP cases per mode")
    ap.add_argument("--normals", type=int, default=0, help="N normals cases per search mode")
    ap.add_argument("--misc", type=int, default=0, help="N float-BEV + PCA2D cases")
    ap.add_argument("--twostage", type=int, default=0, help="N asserted two-stage cases")
    ap.add_argument("--adversarial", type=int, default=0, help="N adversarial-shape cases")
    ap.add_argument("--native", type=int, default=0,
                    help="N cases per regime against the C++ oracle")
    ap.add_argument("--kitti-raw", type=int, default=0, help="N raw KITTI structuring cases")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs (default: the card)")
    return ap


def run(argv: list[str] | None = None) -> dict:
    """The campaign with ``argv``'s flags; returns its summary (per-leg
    cases, KNIFE and FAIL counts and seconds, ``failures``, ``seconds``)."""
    args = parser().parse_args(argv)
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else CPU
    camp = Campaign(dev)
    check_c_nn(camp.ref, oracle.ref_impl(c_nn=False))
    print(f"fuzz campaign on {dev}"
          f"{' (' + torch.cuda.get_device_name(dev) + ')' if dev.type == 'cuda' else ''}, "
          f"seeds from {args.start}", flush=True)
    run_regimes(camp, args.start, args.cases, max(args.prep_every, 1))
    if args.sensors:
        run_sensors(camp, args.start)
    if args.icp:
        run_icp(camp, args.start, args.icp)
    if args.normals:
        run_normals(camp, args.start, args.normals)
    if args.misc:
        run_misc(camp, args.start, args.misc)
    if args.twostage:
        run_twostage(camp, args.start, args.twostage)
    if args.adversarial:
        run_adversarial(camp, args.start, args.adversarial)
    if args.native:
        run_native(camp, args.start, args.native)
    if args.kitti_raw:
        run_kitti_raw(camp, args.start, args.kitti_raw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    summary = camp.summary()
    summary["seconds"] = time.perf_counter() - t0
    for name, t in camp.legs.items():
        print(f"leg {name}: {t.cases} cases, KNIFE {t.knife}, FAIL {t.fail}, {t.seconds:.1f} s"
              f" ({t.cases / max(t.seconds, 1e-9):.1f} cases/s)", flush=True)
    print(f"DONE: {sum(t.cases for t in camp.legs.values())} cases in {summary['seconds']:.0f} s, "
          f"failures={summary['failures']}, knife edges={summary['knife_edges']}, tolerance "
          f"label flips={camp.tol_flips} (bev px delta {camp.tol_px})", flush=True)
    return summary


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if parser().parse_args(argv).device == "cuda" and not torch.cuda.is_available():
        print("fuzz_campaign: no CUDA card (pass --device=cpu to run the port on the CPU)",
              file=sys.stderr)
        return 2
    return 1 if run(argv)["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
