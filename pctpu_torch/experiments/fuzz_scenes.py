"""The differential campaign's inputs, in numpy: the port's own copies of
the scene generators of pctpu's differential suites, which import pctpu
and so cannot be imported here.  Each draws the same numbers from the same
seed as its original, so a seed pinned in pctpu's suite names the same
scene here (``tests/test_torch_fuzz_differential.py`` holds every copy
equal to its original):

- ``REGIMES`` / :func:`regime_points` — ``tests/test_fuzz_differential.py:20-51``;
- :func:`scene_cloud` — ``tests/test_ops_registration.py:20-44``;
- :func:`icp_scene` / :func:`plane_scene` — ``tests/test_icp_differential.py``
  ``scene`` and ``_plane_scene``;
- :func:`twostage_scene` / :func:`to_dicts` — ``tests/test_twostage_differential.py:39-108``;
- :func:`normals_scene` — ``scripts/fuzz_campaign.py:504``;
- :func:`adversarial_points`, :func:`misc_points` and :func:`kitti_raw_scan`
  — the clouds that ``scripts/fuzz_campaign.py`` builds inline in its
  ``--adversarial``, ``--misc`` and ``--kitti-raw`` legs.

:func:`tied_heights` is the port's own: equal and signed-zero heights for
the top part's sort on the card.
"""

from __future__ import annotations

import math

import numpy as np

from pctpu_torch.config import SensorParams

# pctpu's differential suites' small sensor grid (tests/test_ops_preprocess.py:20)
SMALL = SensorParams(n_scan=16, horizon_scan=32, ground_upper_scan=10, height_res=0.5)

REGIMES = [
    # (n_points, neg1_frac, z_lo, z_hi, r_lo, r_hi)
    (20, 0.0, -2.5, 4.0, 2.0, 60.0),      # sparse
    (400, 0.2, -2.5, 4.0, 2.0, 60.0),     # dense mixed
    (400, 1.0, -2.5, 4.0, 2.0, 60.0),     # KITTI quirk: all intensity -1
    (300, 0.05, -2.1, -1.7, 2.0, 60.0),   # nearly all ground-height
    (300, 0.05, 5.0, 60.0, 2.0, 60.0),    # all high (layer out of range)
    (300, 0.1, -2.5, 4.0, 70.0, 140.0),   # far points (grid/BEV boundary)
    (300, 0.1, -2.5, 4.0, 0.01, 3.0),     # all near origin (sector 37,25)
]


def regime_points(rng, n, neg1, z_lo, z_hi, r_lo, r_hi, params) -> list[dict]:
    """``n`` raw points of one regime: polar in [r_lo, r_hi), z uniform,
    a ``neg1`` share of intensity -1, rows and cols one past the grid on
    both sides, label -2."""
    pts = []
    for _ in range(n):
        r = float(rng.uniform(r_lo, r_hi))
        az = float(rng.uniform(-np.pi, np.pi))
        pts.append(
            {
                "x": float(np.float32(r * np.cos(az))),
                "y": float(np.float32(r * np.sin(az))),
                "z": float(np.float32(rng.uniform(z_lo, z_hi))),
                "intensity": -1.0
                if rng.random() < neg1
                else float(np.float32(rng.random())),
                "row": int(rng.integers(-1, params.n_scan + 1)),
                "col": int(rng.integers(-1, params.horizon_scan + 1)),
                "t": int(rng.integers(0, 1000)),
                "label": -2,
            }
        )
    return pts


def point_arrays(points: list[dict]) -> dict[str, np.ndarray]:
    """Dict points as a PCD-style field dict (x, y, z, intensity f32; row,
    col, label int32; t int64) in input order."""
    out = {k: np.array([p[k] for p in points], np.float32) for k in ("x", "y", "z", "intensity")}
    out.update({k: np.array([p[k] for p in points], np.int32) for k in ("row", "col", "label")})
    out["t"] = np.array([p["t"] for p in points], np.int64)
    return out


def scene_cloud(rng, n_clusters=6, pts_per_cluster=80, ground_frac=0.3) -> list[dict]:
    """Clustered 'building' points (label -2) + scattered ground (label 0)."""
    pts = []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(-60, 60, 2)
        for _ in range(pts_per_cluster):
            pts.append(
                {
                    "x": float(np.float32(cx + rng.normal(0, 3))),
                    "y": float(np.float32(cy + rng.normal(0, 3))),
                    "z": float(np.float32(rng.uniform(0, 8))),
                    "label": -2,
                }
            )
    n_ground = int(len(pts) * ground_frac)
    for _ in range(n_ground):
        pts.append(
            {
                "x": float(np.float32(rng.uniform(-80, 80))),
                "y": float(np.float32(rng.uniform(-80, 80))),
                "z": float(np.float32(rng.uniform(-2.0, -1.8))),
                "label": 0,
            }
        )
    return pts


def xyz_labels(points: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    """(xyz (n, 3) f32, labels (n,) int32) of dict points."""
    xyz = np.array([[p["x"], p["y"], p["z"]] for p in points], np.float32).reshape(-1, 3)
    return xyz, np.array([p["label"] for p in points], np.int32)


def tied_heights(xyz: np.ndarray, rng) -> np.ndarray:
    """``xyz`` with its heights on a 0.5 m ladder (runs of equal z in every
    top-part cell) and one point in ten at z = −0.0 or +0.0 — the ties that
    the top part's stable sort keeps in input order (D14)."""
    out = xyz.copy()
    out[:, 2] = np.round(out[:, 2] * 2.0) / 2.0
    zero = rng.random(len(out)) < 0.1
    out[zero, 2] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(-0.0), np.float32(0.0))
    return out


def _yaw3(deg: float) -> np.ndarray:
    th = np.radians(deg)
    return np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                     [0, 0, 1]], np.float32)


def icp_scene(seed, n_src=60, n_tgt=90, yaw_deg=8.0, shift=(0.4, -0.3, 0.1), noise=0.03):
    """Three walls + scatter with a known rigid offset: (src, tgt) f32."""
    rng = np.random.default_rng(seed)
    pts = []
    for k in range(3):
        n = n_tgt // 3
        u = rng.uniform(-5, 5, n)
        if k == 0:
            pts.append(np.stack([u, np.full(n, 4.0) + rng.normal(0, 0.02, n),
                                 rng.uniform(0, 2, n)], 1))
        elif k == 1:
            pts.append(np.stack([np.full(n, -4.0) + rng.normal(0, 0.02, n), u,
                                 rng.uniform(0, 2, n)], 1))
        else:
            pts.append(np.stack([u, u * 0.5 + rng.normal(0, 0.05, n),
                                 rng.uniform(0, 1, n)], 1))
    tgt = np.concatenate(pts).astype(np.float32)
    src = (tgt[rng.permutation(n_tgt)[:n_src]] - np.asarray(shift, np.float32)) @ _yaw3(yaw_deg)
    src = src + rng.normal(0, noise, src.shape)
    return src.astype(np.float32), tgt


def plane_scene(seed, yaw_deg, shift):
    """Two-wall z = 0 scene with known normals (the coarse stage's shape):
    (src, tgt, normals, normal_ok)."""
    rng = np.random.default_rng(seed)
    n = 90
    u = rng.uniform(-6, 6, n)
    wall = rng.integers(0, 2, n)
    x = np.where(wall == 0, u, -4.0 + rng.normal(0, 0.01, n))
    y = np.where(wall == 0, 4.0 + rng.normal(0, 0.01, n), u)
    tgt = np.stack([x, y, np.zeros(n)], 1).astype(np.float32)
    nrm = np.where(
        wall[:, None] == 0,
        np.array([[0.0, 1.0, 0.0]], np.float32),
        np.array([[1.0, 0.0, 0.0]], np.float32),
    ).astype(np.float32)
    ok = rng.random(n) > 0.1
    src = (tgt[rng.permutation(n)[:60]] - np.asarray(shift, np.float32)) @ _yaw3(yaw_deg)
    src = (src + rng.normal(0, 0.02, src.shape) * np.float32([1, 1, 0])).astype(np.float32)
    return src, tgt, nrm, ok


def twostage_scene(seed: int, n_clusters: int = 6, pts_per_cluster: int = 110,
                   n_ground: int = 900):
    """Buildings (label -2, >= 20 points per 20 m top-part cell) + ground
    (label 0); cloud 2 is the scene under a known yaw + shift with 2 cm
    noise, or, for seeds ≡ 4 (mod 5), an unrelated scene.  Returns (xyz1,
    labels1, xyz2, labels2, guess_deg, true_yaw_deg or NaN)."""
    rng = np.random.default_rng(seed)
    pts, labels = [], []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(-45, 45, 2)
        pts.append(np.stack([cx + rng.normal(0, 2.0, pts_per_cluster),
                             cy + rng.normal(0, 2.0, pts_per_cluster),
                             rng.uniform(0.5, 8.0, pts_per_cluster)], axis=1))
        labels.append(np.full(pts_per_cluster, -2))
    pts.append(np.stack([rng.uniform(-60, 60, n_ground), rng.uniform(-60, 60, n_ground),
                         rng.uniform(-2.0, -1.9, n_ground)], axis=1))
    labels.append(np.zeros(n_ground))
    xyz = np.concatenate(pts).astype(np.float32)
    lab = np.concatenate(labels).astype(np.int32)

    if seed % 5 == 4:
        xyz2, lab2, _, _, _, _ = twostage_scene(seed + 77_001)
        guess = float(rng.uniform(-180, 180))
        return xyz, lab, xyz2, lab2, guess, float("nan")

    true_yaw = float(rng.uniform(-40, 40))
    shift = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
    shift[2] = 0.0
    th = math.radians(true_yaw)
    c, s = math.cos(th), math.sin(th)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    xyz2 = (xyz @ rot.T + shift).astype(np.float32)
    xyz2 = xyz2 + rng.normal(0, 0.02, xyz2.shape).astype(np.float32)
    guess = true_yaw + float(rng.uniform(-12, 12))
    if seed % 2:  # half the seeds approach through the +180° flip
        guess -= 180.0
    return xyz, lab, xyz2, lab, guess, true_yaw


def to_dicts(xyz: np.ndarray, labels: np.ndarray) -> list[dict]:
    return [{"x": float(p[0]), "y": float(p[1]), "z": float(p[2]), "label": int(l)}
            for p, l in zip(xyz, labels)]


def normals_scene(seed: int):
    """An anisotropic cluster + a noisy line, density and scale varied by
    seed: (p2 (n, 2) f32, xyz (n, 3) f32 with z = 0)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 200))
    a = rng.normal(0, [rng.uniform(0.5, 4.0), rng.uniform(0.1, 1.0)], (n // 2, 2))
    t = rng.uniform(-5, 5, n - n // 2)
    b = np.stack([t, rng.uniform(-1, 1) * t + rng.normal(0, 0.1, len(t))], 1)
    p2 = np.concatenate([a, b]).astype(np.float32)
    xyz = np.concatenate([p2, np.zeros((n, 1), np.float32)], axis=1)
    return p2, xyz


def adversarial_points(seed: int, case: int, params: SensorParams = SMALL) -> list[dict]:
    """One over-capacity cloud of the adversarial shapes: shape ``case % 4``
    (0 and 3 mixed z, 1 a flat plane, 2 a steep wall band), one or two
    azimuth bands of columns absent, rows and cols one past the grid."""
    g = params.grid_size
    rng = np.random.default_rng(seed)
    shape = case % 4
    n = int(rng.integers(g + 1, 3 * g))  # always over capacity
    rows = rng.integers(-1, params.n_scan + 1, n)
    cols = rng.integers(-1, params.horizon_scan + 1, n)
    for _ in range(int(rng.integers(1, 3))):
        lo = int(rng.integers(0, params.horizon_scan - 2))
        hi = lo + int(rng.integers(1, params.horizon_scan // 3))
        dead = (cols >= lo) & (cols < hi)
        cols[dead] = (hi + 1) % params.horizon_scan
    if shape == 1:  # all ground: a flat plane
        z = rng.uniform(-1.95, -1.85, n)
    elif shape == 2:  # no ground: a steep wall band
        z = 2.0 + 0.8 * (params.n_scan - rows)
    else:
        z = rng.uniform(-2.5, 4.0, n)
    r = rng.uniform(2.0, 60.0, n)
    az = rng.uniform(-np.pi, np.pi, n)
    return [
        {"x": float(np.float32(r[i] * np.cos(az[i]))),
         "y": float(np.float32(r[i] * np.sin(az[i]))),
         "z": float(np.float32(z[i])),
         "intensity": -1.0 if rng.random() < 0.2 else float(np.float32(rng.random())),
         "row": int(rows[i]), "col": int(cols[i]),
         "t": int(rng.integers(0, 1000)), "label": -2}
        for i in range(n)
    ]


def misc_points(rng) -> list[dict]:
    """The float-BEV leg's cloud: 30-500 points in ±110 m, 30% ground."""
    n = int(rng.integers(30, 500))
    return [
        {"x": float(np.float32(rng.uniform(-110, 110))),
         "y": float(np.float32(rng.uniform(-110, 110))),
         "z": float(np.float32(rng.uniform(-2.5, 6.0))),
         "intensity": 0.5, "row": 0, "col": 0, "t": 0,
         "label": 0 if rng.random() < 0.3 else -2}
        for _ in range(n)
    ]


def pca2d_points(rng, case: int, n: int):
    """The PCA2D leg's input after :func:`misc_points` drew from ``rng``:
    (xyz (m, 3) f32 with z = 0, sorted indices or None on even cases)."""
    p2 = rng.normal(0, [rng.uniform(0.5, 4.0), rng.uniform(0.1, 2.0)],
                    (max(n, 4), 2)).astype(np.float32)
    xyz = np.concatenate([p2, np.zeros((len(p2), 1), np.float32)], axis=1)
    indices = (np.sort(rng.choice(len(p2), max(3, len(p2) // 2), replace=False))
               if case % 2 else None)
    return xyz, indices


def kitti_raw_scan(seed: int, case: int) -> np.ndarray:
    """One raw KITTI scan (n, 4) f32: regime ``case % 4`` — clean descending
    sweeps, pure noise, zero-azimuth knife edges, more than 64 rings — and
    an empty scan every 16th case."""
    rng = np.random.default_rng(seed)
    regime = case % 4
    if case % 16 == 15:
        return np.zeros((0, 4), np.float32)
    if regime == 0:
        rings = int(rng.integers(1, 10))
        per = int(rng.integers(5, 900))
        pts = []
        for _ in range(rings):
            az = np.linspace(179.0, -179.0, per) + rng.normal(0, 0.5, per)
            r = rng.uniform(2.0, 70.0, per)
            pts.append(np.stack([r * np.cos(np.radians(az)), r * np.sin(np.radians(az)),
                                 rng.uniform(-2, 6, per), rng.random(per)], 1))
        return np.concatenate(pts).astype(np.float32)
    if regime == 1:
        return rng.normal(0, 25, (int(rng.integers(1, 2500)), 4)).astype(np.float32)
    if regime == 2:
        n = int(rng.integers(4, 400))
        x = rng.uniform(1.0, 50.0, n)
        y = np.where(rng.random(n) < 0.5, 0.0,
                     rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-8, -1, n))
        return np.stack([x, y, rng.uniform(-2, 6, n), rng.random(n)], 1).astype(np.float32)
    per = int(rng.integers(2, 30))
    pts = []
    for _ in range(int(rng.integers(60, 90))):
        az = np.linspace(170.0, -170.0, per)
        r = rng.uniform(2.0, 70.0, per)
        pts.append(np.stack([r * np.cos(np.radians(az)), r * np.sin(np.radians(az)),
                             rng.uniform(-2, 6, per), rng.random(per)], 1))
    return np.concatenate(pts).astype(np.float32)
