"""Scenes for the card's measurements, in numpy: the registration bench
scene — the port's copy of ``bench.py``'s ``registration_scene``
(bench.py:968-999), which builds pctpu clouds and so cannot be imported
here — the registration CLIs' tree of moved copies of it, and a ray-cast
LiDAR drive for batch_multi_bev_gen."""

from __future__ import annotations

import os

import numpy as np


def registration_scene() -> tuple[np.ndarray, np.ndarray]:
    """40 vertical clusters of 150 points + 45,000 ground points, 51,000 in
    all: (xyz (51000, 3) f32, labels (51000,) int32)."""
    rng = np.random.default_rng(0)
    pts, labels = [], []
    for _ in range(40):
        cx, cy = rng.uniform(-60, 60, 2)
        n = 150
        pts.append(np.stack([cx + rng.normal(0, 2.5, n), cy + rng.normal(0, 2.5, n),
                             rng.uniform(0, 9, n)], 1))
        labels.append(np.full(n, -2))
    ng = 45000
    pts.append(np.stack([rng.uniform(-70, 70, ng), rng.uniform(-70, 70, ng),
                         rng.uniform(-2.0, -1.9, ng)], 1))
    labels.append(np.zeros(ng))
    return np.concatenate(pts).astype(np.float32), np.concatenate(labels).astype(np.int32)


def moved_copy(xyz: np.ndarray) -> np.ndarray:
    """The bench pair's second cloud (bench.py:991-994): ``xyz`` turned 17°
    about z and shifted by (1.5, −2.0, 0), in f32."""
    th = np.radians(17.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]], np.float32)
    return xyz @ rot.T + np.array([1.5, -2.0, 0], np.float32)


def pose(yaw_deg: float, tx: float, ty: float) -> np.ndarray:
    """A 4×4 f64 pose: a turn of ``yaw_deg`` about z, then (tx, ty, 0)."""
    th = np.radians(yaw_deg)
    m = np.eye(4)
    m[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    m[:2, 3] = tx, ty
    return m


# the registration tree: the poses of its four clouds, and its five pairs
# (query, match, degrees by which the yaw guess misses the truth)
TREE_POSES = (pose(0.0, 0.0, 0.0), pose(17.0, 1.5, -2.0), pose(-25.0, -3.0, 1.0),
              pose(178.0, 2.0, 2.5))
TREE_PAIRS = ((0, 1, 3.0), (1, 2, -2.0), (2, 0, 4.0), (0, 3, -3.0), (3, 1, 2.5))


def registration_tree(root: str, seed: int = 3) -> None:
    """Write the input tree of both registration CLIs under ``root``: the
    bench scene moved to each of ``TREE_POSES`` with 1 cm noise
    (``clouds/000000.pcd`` ...), ``match_result.txt`` with ``TREE_PAIRS``
    and their yaw guesses, and ``warmup.txt`` with the first pair alone."""
    from pctpu_torch import make_cloud
    from pctpu_torch.io.pcd import save_cloud_pcd

    rng = np.random.default_rng(seed)
    xyz, lab = registration_scene()
    os.makedirs(os.path.join(root, "clouds"))
    for k, m in enumerate(TREE_POSES):
        moved = xyz @ m[:3, :3].T.astype(np.float32) + m[:3, 3].astype(np.float32)
        moved = moved + rng.normal(0, 0.01, moved.shape).astype(np.float32)
        save_cloud_pcd(os.path.join(root, "clouds", f"{k:06d}.pcd"),
                       make_cloud(moved, label=lab, device="cpu"))

    def guess(q: int, m: int, off: float) -> str:
        r = TREE_POSES[m] @ np.linalg.inv(TREE_POSES[q])
        return f"{q} {m} {np.degrees(np.arctan2(r[1, 0], r[0, 0])) + off:.3f}\n"

    with open(os.path.join(root, "match_result.txt"), "w") as f:
        f.writelines(guess(*p) for p in TREE_PAIRS)
    with open(os.path.join(root, "warmup.txt"), "w") as f:
        f.write(guess(*TREE_PAIRS[0]))


def _hdl64e_elevations(n_scan: int) -> np.ndarray:
    """Ring elevations in degrees, row 0 the top ring: the HDL-64E's upper
    block (+2° to -8.33° in 1/3° steps) and lower block (-8.83° to -24.33° in
    1/2° steps), resampled to ``n_scan`` rings."""
    upper = 2.0 - np.arange(32) / 3.0
    lower = -8.83 - np.arange(32) * 0.5
    both = np.concatenate([upper, lower])
    return np.interp(np.linspace(0, 63, n_scan), np.arange(64), both)


def _world_boxes(rng: np.random.Generator, length: float) -> np.ndarray:
    """(K, 6) boxes (xmin, xmax, ymin, ymax, zmin, zmax), metres, in a world
    whose ground is z = 0: building blocks on both sides of a road along x,
    and parked or moving cars on it."""
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


def raycast_frame(params, boxes: np.ndarray, origin: np.ndarray, yaw: float,
                  rng: np.random.Generator, sensor_height: float = 1.73,
                  max_range: float = 120.0) -> dict:
    """One grid-ordered scan: slot ``r*H + c`` holds ring r's return at
    azimuth bin c, in the sensor frame (ground at z = -sensor_height), or
    all-zero where the ray hit nothing (sky, and a 7% dropout).  Returns
    the XYZIRCT field dict (row/col u16, t u32, label i16)."""
    n, h = params.n_scan, params.horizon_scan
    el = np.radians(_hdl64e_elevations(n))[:, None]
    az = (np.arange(h) * (2.0 * np.pi / h) + yaw)[None, :]
    d = np.stack(np.broadcast_arrays(np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                                     np.sin(el)), -1).reshape(-1, 3)
    o = np.array([origin[0], origin[1], sensor_height])
    # boxes out of reach are skipped; f32 and fmax keep a 64-ring scan at
    # a fraction of a second
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
    hit = (t < max_range) & (rng.random(n * h) >= 0.07)
    t = np.where(hit, t + rng.normal(0.0, 0.02, n * h), 0.0)
    rel = d * t[:, None]
    c, s = np.cos(-yaw), np.sin(-yaw)
    local = np.stack([c * rel[:, 0] - s * rel[:, 1], s * rel[:, 0] + c * rel[:, 1],
                      rel[:, 2]], 1)
    slot = np.arange(n * h)
    intensity = np.where(rng.random(n * h) < 0.03, -1.0, rng.uniform(0.05, 1.0, n * h))
    # np.where, not a multiply: 0.0 * negative is -0.0, a real point
    return {
        "x": np.where(hit, local[:, 0], 0.0).astype(np.float32),
        "y": np.where(hit, local[:, 1], 0.0).astype(np.float32),
        "z": np.where(hit, local[:, 2], 0.0).astype(np.float32),
        "intensity": np.where(hit, intensity, 0.0).astype(np.float32),
        "row": np.where(hit, slot // h, 0).astype(np.uint16),
        "col": np.where(hit, slot % h, 0).astype(np.uint16),
        "t": np.where(hit, slot * 7 + 11, 0).astype(np.uint32),
        "label": np.where(hit, -2, 0).astype(np.int16),
    }


def _raw(frame: dict, rng: np.random.Generator, n_out: int, dup_frac: float) -> dict:
    """A raw (sensor-order-free) cloud from a scan: its real points
    shuffled, ``dup_frac`` of them repeated later with moved coordinates
    (duplicate cells: the last one wins), plus ``n_out`` points with an
    out-of-range ring or column, which ordering drops."""
    real = np.flatnonzero(frame["label"] != 0)
    dup = rng.choice(real, int(len(real) * dup_frac))
    idx = np.concatenate([rng.permutation(real), dup])
    out = {k: v[idx].copy() for k, v in frame.items()}
    m = len(real)
    for k in ("x", "y", "z"):
        out[k][m:] += rng.normal(0.0, 0.05, len(dup)).astype(np.float32)
    bad = rng.choice(len(idx), n_out, replace=False)
    out["row"][bad[: n_out // 2]] = 65535
    out["col"][bad[n_out // 2:]] = 60000
    return out


def multi_bev_tree(root: str, params, n_ordered: int, n_raw: int = 2, n_over: int = 1,
                   spacing: float = 3.0, seed: int = 0) -> list[str]:
    """Write a batch_multi_bev_gen input tree under ``root``: a ray-cast
    drive through a street of buildings and cars, one scan every
    ``spacing`` metres.  The first ``n_ordered`` clouds are grid-ordered
    (the selector tools' layout), then ``n_raw`` raw clouds with duplicate
    cells and ``n_over`` raw clouds holding more points than the grid
    (the host last-wins compaction route).  Also writes
    ``keyframe_pose.csv``.  Returns the cloud paths."""
    from pctpu_torch.io.pcd import write_pcd

    rng = np.random.default_rng(seed)
    total = n_ordered + n_raw + n_over
    boxes = _world_boxes(rng, spacing * total)
    cloud_dir = os.path.join(root, "keyframe_point_cloud")
    os.makedirs(cloud_dir, exist_ok=True)
    paths, poses = [], []
    for k in range(total):
        yaw = 0.15 * np.sin(k / 9.0)
        origin = np.array([spacing * k, 0.5 * np.sin(k / 7.0)])
        frame = raycast_frame(params, boxes, origin, yaw, rng)
        if k >= n_ordered + n_raw:  # over capacity
            extra = params.grid_size - int(np.sum(frame["label"] != 0)) + 5000
            frame = _raw(frame, rng, 64, extra / max(int(np.sum(frame["label"] != 0)), 1))
        elif k >= n_ordered:
            frame = _raw(frame, rng, 64, 0.05)
        path = os.path.join(cloud_dir, f"{k:06d}.pcd")
        write_pcd(path, frame)
        paths.append(path)
        c, s = np.cos(yaw), np.sin(yaw)
        vals = [origin[0], origin[1], 0.0, 0.0, 0.0, yaw, c, -s, 0.0, s, c, 0.0, 0.0, 0.0, 1.0]
        poses.append(f"{k:06d}," + ",".join(f"{float(v):.6f}" for v in vals) + "\n")
    with open(os.path.join(root, "keyframe_pose.csv"), "w") as f:
        f.writelines(poses)
    return paths
