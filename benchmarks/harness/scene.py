"""The benchmark's inputs: ray-cast LiDAR scans written in the layouts the
dataset selectors write.  Frozen copies, so that a change to the program
cannot move the yardstick:

- the ray caster (``_hdl64e_elevations``, ``_os1_64_elevations``,
  ``_world_boxes``, ``_ray_lengths``, ``_scan``) from
  ``pctpu_torch/experiments/scene.py`` at commit 88a1f7c;
- the KITTI selector's structuring rule (``assign_rings``,
  ``structure_cloud``, ``c_round_np``) from ``pctpu_torch/io/kitti.py`` and
  ``pctpu_torch/ops/rounding.py`` at 88a1f7c
  (reference/KittiPointCloudSelect.cpp:174-240): a dense 64 x 2083 grid,
  later points win, label -2 and intensity -1;
- the MulRan selector's rule (``mulran_points``) from
  ``pctpu_torch/io/mulran.py``'s ``read_bin`` at 88a1f7c
  (reference/MulranPointCloudSelect.cpp:113-128): the raw column-major
  Ouster sequence, row = k mod 64, real intensity.

Everything here is numpy and imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

# --- the ray caster (pctpu_torch/experiments/scene.py @ 88a1f7c) -----------------


def _hdl64e_elevations(n_scan: int) -> np.ndarray:
    upper = 2.0 - np.arange(32) / 3.0
    lower = -8.83 - np.arange(32) * 0.5
    both = np.concatenate([upper, lower])
    return np.interp(np.linspace(0, 63, n_scan), np.arange(64), both)


def _os1_64_elevations() -> np.ndarray:
    return 16.6 - np.arange(64) * (33.2 / 63.0)


def _world_boxes(rng: np.random.Generator, length: float) -> np.ndarray:
    """(K, 6) boxes (xmin, xmax, ymin, ymax, zmin, zmax): building blocks on
    both sides of a road along x, and cars on it; the ground is z = 0."""
    boxes = []
    for side in (-1.0, 1.0):
        x = -60.0
        while x < length + 60.0:
            w = rng.uniform(10.0, 30.0)
            near = rng.uniform(12.0, 25.0)
            boxes.append((x, x + w, *sorted((side * near, side * (near + rng.uniform(8, 20)))),
                          0.0, rng.uniform(5.0, 25.0)))
            x += w + rng.uniform(2.0, 12.0)
    for _ in range(int(length / 6) + 10):
        cx, cy = rng.uniform(-40.0, length + 40.0), rng.choice([-1, 1]) * rng.uniform(2.5, 7.0)
        boxes.append((cx - 2.25, cx + 2.25, cy - 0.9, cy + 0.9, 0.0, rng.uniform(1.4, 1.9)))
    return np.asarray(boxes, np.float64)


def _ray_lengths(d: np.ndarray, origin: np.ndarray, boxes: np.ndarray,
                 sensor_height: float, max_range: float) -> np.ndarray:
    """Distance along each unit ray of ``d`` (M, 3) to the ground or the
    nearest box; +inf where nothing is hit."""
    o = np.array([origin[0], origin[1], sensor_height])
    reach = np.hypot(np.clip(o[0], boxes[:, 0], boxes[:, 1]) - o[0],
                     np.clip(o[1], boxes[:, 2], boxes[:, 3]) - o[1]) < max_range
    d32 = d.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        t = np.where(d32[:, 2] < 0, -sensor_height / d32[:, 2], np.inf).astype(np.float32)
        inv = (1.0 / d32).astype(np.float32)
        for b in boxes[reach]:
            t1 = (b[0::2] - o).astype(np.float32) * inv
            t2 = (b[1::2] - o).astype(np.float32) * inv
            lo, hi = np.minimum(t1, t2), np.maximum(t1, t2)
            near = np.fmax(np.fmax(lo[:, 0], lo[:, 1]), lo[:, 2])
            far = np.fmin(np.fmin(hi[:, 0], hi[:, 1]), hi[:, 2])
            t = np.where((far >= near) & (near > 0) & (near < t), near, t)
    return t


def _scan(boxes: np.ndarray, origin: np.ndarray, yaw: float, elevations: np.ndarray,
          cols: int, rng: np.random.Generator, sensor_height: float = 1.73,
          max_range: float = 120.0):
    """One sweep in the sensor frame: (rings, cols, 3) returns, the
    (rings, cols) hit mask (a 7% dropout besides the sky) and intensities."""
    el = np.radians(elevations)[:, None]
    az = (np.arange(cols) * (2.0 * np.pi / cols) + yaw)[None, :]
    d = np.stack(np.broadcast_arrays(np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                                     np.sin(el)), -1).reshape(-1, 3)
    t = _ray_lengths(d, origin, boxes, sensor_height, max_range)
    m = d.shape[0]
    hit = (t < max_range) & (rng.random(m) >= 0.07)
    rel = d * np.where(hit, t + rng.normal(0.0, 0.02, m), 0.0)[:, None]
    c, s = np.cos(-yaw), np.sin(-yaw)
    local = np.stack([c * rel[:, 0] - s * rel[:, 1], s * rel[:, 0] + c * rel[:, 1],
                      rel[:, 2]], 1).astype(np.float32)
    shape = (len(elevations), cols)
    return (local.reshape(*shape, 3), hit.reshape(shape),
            rng.uniform(0.05, 1.0, m).astype(np.float32).reshape(shape))


# --- the selectors' structuring rules ---------------------------------------------


def c_round_np(v) -> np.ndarray:
    """C ``round()`` (half away from zero) of float64 values
    (pctpu_torch/ops/rounding.py @ 88a1f7c)."""
    v = np.asarray(v)
    a = np.abs(v)
    k = np.floor(a)
    r = k + (a - k >= 0.5)
    return np.where(v < 0, -r, r)


KITTI_N_SCAN, KITTI_HORIZON_SCAN = 64, 2083


def kitti_bin_rows(pts: np.ndarray, hit: np.ndarray, inten: np.ndarray) -> np.ndarray:
    """A KITTI velodyne ``.bin`` as the sensor writes it: ring by ring, each
    ring sweeping azimuth from +180 down to -180 degrees, (N, 4) f32 rows of
    the hits (pctpu_torch/experiments/scene.py ``kitti_tree`` @ 88a1f7c)."""
    h = pts.shape[1]
    ang = np.arange(h) * (2.0 * np.pi / h)
    sweep = np.argsort(-np.where(ang > np.pi, ang - 2.0 * np.pi, ang), kind="stable")
    pts, hit, inten = pts[:, sweep], hit[:, sweep], inten[:, sweep]
    rows = np.concatenate([pts[hit], inten[hit][:, None]], 1).astype(np.float32)
    return rows[:KITTI_N_SCAN * KITTI_HORIZON_SCAN]


def assign_rings(points: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row, col, assigned) of each point by the KITTI selector's rule: a new
    ring where the azimuth crosses zero upward, accepted only after more than
    0.6 x Horizon_SCAN points; point 0 never assigned; col = C-round of the
    semi-positive azimuth over 360/2083, wrapped (pctpu_torch/io/kitti.py
    @ 88a1f7c)."""
    n = len(points)
    az = (np.arctan2(points[:, 1], points[:, 0]).astype(np.float64) / np.pi * 180.0
          ).astype(np.float32)
    row = np.full(n, -1, np.int32)
    if n == 0:
        return row, np.empty(0, np.int32), np.zeros(0, bool)
    boundary = np.zeros(n, bool)
    boundary[1:] = (az[:-1] <= 0) & (az[1:] > 0)
    ring = 0 if az[0] > 0 else -1
    last_reset = 1
    ring_at = np.empty(n, np.int32)
    guard = KITTI_HORIZON_SCAN * np.float32(0.60)
    prev = 1
    for b in np.flatnonzero(boundary):
        ring_at[prev:b] = ring
        if ring == -1:
            ring = 0
            last_reset = b
        elif (b - last_reset) > guard:
            ring += 1
            last_reset = b
        prev = b
    ring_at[prev:] = ring
    ring_at[0] = -1
    row[1:] = ring_at[1:]
    semi = np.where(az >= 360.0, az - np.float32(360.0), az)
    semi = np.where(semi < 0.0, semi + np.float32(360.0), semi)
    col = c_round_np(semi.astype(np.float64) / (360.0 / KITTI_HORIZON_SCAN)).astype(np.int32)
    col = np.where(col >= KITTI_HORIZON_SCAN, col - KITTI_HORIZON_SCAN, col)
    col = np.where(col < 0, col + KITTI_HORIZON_SCAN, col)
    return row, col, (row >= 0) & (row < KITTI_N_SCAN)


def structure_cloud(points: np.ndarray) -> dict[str, np.ndarray]:
    """The KITTI selector's keyframe: the dense 64 x 2083 grid, later points
    win, assigned slots label -2 and intensity -1, the rest all-zero
    (pctpu_torch/io/kitti.py @ 88a1f7c, keep_intensity=False)."""
    g = KITTI_N_SCAN * KITTI_HORIZON_SCAN
    out = {"x": np.zeros(g, np.float32), "y": np.zeros(g, np.float32),
           "z": np.zeros(g, np.float32), "intensity": np.zeros(g, np.float32),
           "row": np.zeros(g, np.uint16), "col": np.zeros(g, np.uint16),
           "t": np.zeros(g, np.uint32), "label": np.zeros(g, np.int16)}
    row, col, assigned = assign_rings(points)
    sel = np.flatnonzero(assigned)
    idx = row[sel] * KITTI_HORIZON_SCAN + col[sel]
    out["x"][idx] = points[sel, 0]
    out["y"][idx] = points[sel, 1]
    out["z"][idx] = points[sel, 2]
    out["intensity"][idx] = -1.0
    out["row"][idx] = row[sel].astype(np.uint16)
    out["col"][idx] = col[sel].astype(np.uint16)
    out["label"][idx] = -2
    return out


MULRAN_N_SCAN, MULRAN_HORIZON_SCAN = 64, 1024


def mulran_bin_rows(pts: np.ndarray, hit: np.ndarray, inten: np.ndarray) -> np.ndarray:
    """An Ouster ``.bin`` as MulRan stores it: every ray, column by column
    (ring = index mod 64), (0, 0, 0, 0) where nothing was hit
    (pctpu_torch/experiments/scene.py ``mulran_tree`` @ 88a1f7c)."""
    rows = np.where(hit[..., None], np.concatenate([pts, inten[..., None]], -1), 0.0)
    return rows.transpose(1, 0, 2).reshape(-1, 4).astype(np.float32)


def mulran_points(pts: np.ndarray) -> dict[str, np.ndarray]:
    """The MulRan selector's keyframe of (N, 4) f32 rows: the raw sequence,
    row = k mod 64, col = C-round of the f32 azimuth ratio (not wrapped),
    label -2, real intensity (pctpu_torch/io/mulran.py ``read_bin``
    @ 88a1f7c)."""
    pts = pts[:MULRAN_N_SCAN * MULRAN_HORIZON_SCAN]
    n = len(pts)
    az = (np.arctan2(pts[:, 1], pts[:, 0]).astype(np.float64) / np.pi * 180.0
          ).astype(np.float32)
    az = np.where(az > 360.0, az - np.float32(360.0), az)
    az = np.where(az < 0.0, az + np.float32(360.0), az)
    ratio = (az / np.float32(360.0) * np.float32(MULRAN_HORIZON_SCAN)).astype(np.float32)
    col = c_round_np(ratio.astype(np.float64)).astype(np.int32)
    return {"x": pts[:, 0].copy(), "y": pts[:, 1].copy(), "z": pts[:, 2].copy(),
            "intensity": pts[:, 3].copy(),
            "row": (np.arange(n, dtype=np.int64) % MULRAN_N_SCAN).astype(np.uint16),
            "col": col.astype(np.uint16), "t": np.zeros(n, np.uint32),
            "label": np.full(n, -2, np.int16)}


def perturbation(rep: int) -> float:
    """pctpu's multiplicative perturbation 1 + 1e-7·rep in f32
    (pctpu_torch/experiments/bench.py ``_scale`` @ 88a1f7c): scaling xyz by
    it keeps empty slots bit-zero and ordered clouds ordered."""
    return float(np.float32(np.float32(1.0) + np.float32(1e-7) * np.float32(rep)))


# --- keyframes of a configuration ---------------------------------------------------

_LAYOUTS = {
    # layout: (elevations, columns, .bin writer, selector)
    "kitti_select": (lambda: _hdl64e_elevations(KITTI_N_SCAN), KITTI_HORIZON_SCAN,
                     kitti_bin_rows, structure_cloud),
    "mulran_select": (_os1_64_elevations, MULRAN_HORIZON_SCAN, mulran_bin_rows, mulran_points),
}


def keyframe(layout: str, boxes: np.ndarray, x: float, y: float, yaw: float,
             rng: np.random.Generator) -> dict[str, np.ndarray]:
    """One keyframe (the selector's XYZIRCT field dict, on-disk dtypes) of a
    scan taken at (x, y) facing ``yaw`` radians in the world of ``boxes``."""
    elevations, cols, write_bin, select = _LAYOUTS[layout]
    pts, hit, inten = _scan(boxes, np.array([x, y]), yaw, elevations(), cols, rng)
    return select(write_bin(pts, hit, inten))


def world(rng: np.random.Generator, length: float) -> np.ndarray:
    return _world_boxes(rng, length)
