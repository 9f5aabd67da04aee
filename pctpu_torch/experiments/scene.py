"""Scenes for the card's measurements, in numpy: the registration bench
scene — the port's copy of ``bench.py``'s ``registration_scene``
(bench.py:968-999), which builds pctpu clouds and so cannot be imported
here — the registration CLIs' tree of moved copies of it, a ray-cast
LiDAR drive for batch_multi_bev_gen, and raw dataset trees of such a drive
for the four selectors (KITTI and KITTI-raw with an HDL-64E, MulRan with an
Ouster OS1-64, Oxford with an HDL-32E, each at its real width;
``tests/fixtures.py`` builds small trees of the same layouts, but imports
pctpu)."""

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
# the 20-pair list of the pair-batched runs (one batch of 16 and a tail of
# 4): the 12 ordered pairs of the four clouds, then 8 of them again with
# other guess offsets, every offset within ±4°
_ORDERED = tuple((q, m) for q in range(4) for m in range(4) if q != m)
TREE_PAIRS_20 = tuple(
    (q, m, off) for (q, m), off in zip(
        _ORDERED, (3.0, -2.0, 4.0, -3.0, 2.5, -1.5, 3.5, -4.0, 1.0, -2.5, 2.0, -3.5))
) + tuple(
    (*_ORDERED[k], off) for k, off in zip(
        (0, 2, 4, 6, 8, 10, 1, 3), (-1.0, 1.5, -3.0, 0.5, -0.5, 2.5, 3.0, -2.0))
)


def registration_tree(root: str, seed: int = 3) -> None:
    """Write the input tree of both registration CLIs under ``root``: the
    bench scene moved to each of ``TREE_POSES`` with 1 cm noise
    (``clouds/000000.pcd`` ...), ``match_result.txt`` with ``TREE_PAIRS``
    and their yaw guesses, ``match_result_20.txt`` with ``TREE_PAIRS_20``,
    and ``warmup.txt`` with the first pair alone."""
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
    with open(os.path.join(root, "match_result_20.txt"), "w") as f:
        f.writelines(guess(*p) for p in TREE_PAIRS_20)
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


def _ray_lengths(d: np.ndarray, origin: np.ndarray, boxes: np.ndarray,
                 sensor_height: float, max_range: float) -> np.ndarray:
    """Distance along each unit ray of ``d`` (M, 3) from a sensor at
    ``origin`` (x, y), ``sensor_height`` above the ground plane, to the
    ground or the nearest box; +inf where nothing is hit."""
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
    return t


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
    t = _ray_lengths(d, origin, boxes, sensor_height, max_range)
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


# the selectors' sensors: ring elevations in degrees (top ring first)
def _os1_64_elevations() -> np.ndarray:
    return 16.6 - np.arange(64) * (33.2 / 63.0)


def _hdl32e_elevations() -> np.ndarray:
    return 10.67 - np.arange(32) * 1.3335


def _scan(boxes: np.ndarray, origin: np.ndarray, yaw: float, elevations: np.ndarray,
          cols: int, rng: np.random.Generator, sensor_height: float = 1.73,
          max_range: float = 120.0):
    """One sweep in the sensor frame: (rings, cols, 3) returns, the
    (rings, cols) hit mask (a 7% dropout besides the sky) and intensities;
    column c looks along local azimuth c·360°/cols."""
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


def _drive_pose(u: float, spacing: float) -> tuple[float, float, float]:
    """The selectors' drive: the true (x, y, yaw) at drive parameter u
    (frames); 2.5 m off the road's axis, so that MulRan's and Oxford's
    gate, which starts from the origin, keeps the first frame."""
    return spacing * u, 2.5 + 0.5 * np.sin(u / 7.0), 0.02 * u


def _matrix(x: float, y: float, yaw: float) -> np.ndarray:
    t = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    t[:2, :2] = [[c, -s], [s, c]]
    t[0, 3], t[1, 3] = x, y
    return t


def kitti_tree(root: str, n_frames: int = 5, spacing: float = 3.0, seed: int = 9,
               raw: bool = False) -> None:
    """A KITTI odometry tree (``velodyne/*.bin``, ``times.txt``,
    ``global_pose.txt``) of an HDL-64E drive, each scan in the sensor's
    order: ring by ring, each ring sweeping azimuth from +180° down to
    −180°, so that the selector's ring segmentation finds the rings (up to
    64 × 2083 = 133,312 slots).  ``global_pose.txt`` holds camera poses,
    the lidar poses conjugated by the KITTI extrinsic; with ``raw`` it holds
    the lidar poses themselves (the raw variant's reading)."""
    from pctpu_torch.io.kitti import CAM_WRT_LIDAR, HORIZON_SCAN, N_SCAN

    rng = np.random.default_rng(seed)
    boxes = _world_boxes(rng, spacing * n_frames)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    ang = np.arange(HORIZON_SCAN) * (2.0 * np.pi / HORIZON_SCAN)
    sweep = np.argsort(-np.where(ang > np.pi, ang - 2.0 * np.pi, ang), kind="stable")
    rows = []
    for k in range(n_frames):
        x, y, yaw = _drive_pose(k, spacing)
        pts, hit, inten = _scan(boxes, np.array([x, y]), yaw,
                                _hdl64e_elevations(N_SCAN), HORIZON_SCAN, rng)
        pts, hit, inten = pts[:, sweep], hit[:, sweep], inten[:, sweep]
        np.concatenate([pts[hit], inten[hit][:, None]], 1).astype(np.float32).tofile(
            os.path.join(root, "velodyne", f"{k:06d}.bin"))
        lidar = _matrix(x, y, yaw)
        pose = lidar if raw else np.linalg.inv(CAM_WRT_LIDAR) @ lidar @ CAM_WRT_LIDAR
        rows.append(" ".join(f"{v:.9e}" for v in pose[:3, :4].reshape(-1)))
    with open(os.path.join(root, "global_pose.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(f"{k * 0.1:.6e}" for k in range(n_frames)) + "\n")


def _bracketing_gt(n_frames: int, spacing: float, t0: int):
    """Ground-truth stamps and poses half a frame before and after each
    cloud's stamp ``t0 + k·100,000``, so that the selector interpolates
    every cloud's pose."""
    stamps = [t0 - 50_000 + k * 100_000 for k in range(n_frames + 1)]
    return stamps, [_matrix(*_drive_pose(k - 0.5, spacing)) for k in range(n_frames + 1)]


def mulran_tree(root: str, n_frames: int = 5, spacing: float = 3.0, seed: int = 10) -> None:
    """A MulRan tree (``sensor_data/Ouster/<stamp>.bin``,
    ``sensor_data/ouster_front_stamp.csv``, ``global_pose.csv``) of an
    Ouster OS1-64 drive: 64 × 1024 = 65,536 returns a scan in the sensor's
    order (column by column, ring = index mod 64), (0, 0, 0, 0) where a ray
    hit nothing."""
    rng = np.random.default_rng(seed)
    boxes = _world_boxes(rng, spacing * n_frames)
    data = os.path.join(root, "sensor_data")
    os.makedirs(os.path.join(data, "Ouster"), exist_ok=True)
    t0 = 1_000_000_000
    stamps = [t0 + k * 100_000 for k in range(n_frames)]
    for k, stamp in enumerate(stamps):
        x, y, yaw = _drive_pose(k, spacing)
        pts, hit, inten = _scan(boxes, np.array([x, y]), yaw, _os1_64_elevations(), 1024, rng)
        rows = np.where(hit[..., None], np.concatenate([pts, inten[..., None]], -1), 0.0)
        rows.transpose(1, 0, 2).astype(np.float32).tofile(
            os.path.join(data, "Ouster", f"{stamp:010d}.bin"))
    gt_stamps, gt = _bracketing_gt(n_frames, spacing, t0)
    with open(os.path.join(root, "global_pose.csv"), "w") as f:
        for stamp, m in zip(gt_stamps, gt):
            f.write(f"{stamp}," + ",".join(f"{v:.9e}" for v in m[:3, :4].reshape(-1)) + "\n")
    with open(os.path.join(data, "ouster_front_stamp.csv"), "w") as f:
        f.write("\n".join(str(s) for s in stamps) + "\n")


def oxford_tree(root: str, n_frames: int = 5, spacing: float = 3.0, seed: int = 11) -> None:
    """An Oxford Radar RobotCar tree (``velodyne_left/<stamp>.bin``,
    ``velodyne_left.timestamps``, ``gps/ins.csv``) of an HDL-32E drive,
    32 × 1056 rays a scan: the returns stored column-wise (all x, then y,
    z and intensity) as the upside-down sensor gives them (x and z
    negated), and INS rows (UTM easting and northing) bracketing the
    scans."""
    rng = np.random.default_rng(seed)
    boxes = _world_boxes(rng, spacing * n_frames)
    os.makedirs(os.path.join(root, "velodyne_left"), exist_ok=True)
    os.makedirs(os.path.join(root, "gps"), exist_ok=True)
    t0 = 1_500_000_000
    stamps = [t0 + k * 100_000 for k in range(n_frames)]
    for k, stamp in enumerate(stamps):
        x, y, yaw = _drive_pose(k, spacing)
        pts, hit, inten = _scan(boxes, np.array([x, y]), yaw, _hdl32e_elevations(), 1056, rng)
        p, i = pts[hit], inten[hit]
        np.concatenate([-p[:, 0], p[:, 1], -p[:, 2], i]).astype(np.float32).tofile(
            os.path.join(root, "velodyne_left", f"{stamp:010d}.bin"))
    gt_stamps, gt = _bracketing_gt(n_frames, spacing, t0)
    lines = ["timestamp,ins_status,latitude,longitude,altitude,northing,easting,down,"
             "utm_zone,velocity_north,velocity_east,velocity_down,roll,pitch,yaw"]
    for stamp, m in zip(gt_stamps, gt):
        yaw = np.arctan2(m[1, 0], m[0, 0])
        # the reader takes yaw from token 12 and roll from token 14
        lines.append(f"{stamp},INS_SOLUTION_GOOD,51.76,-1.26,110.0,"
                     f"{5735800.0 + m[1, 3]:.6f},{620000.0 + m[0, 3]:.6f},-110.0,30U,"
                     f"0.0,0.0,0.0,{yaw:.9f},0.0,0.0")
    with open(os.path.join(root, "gps", "ins.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "velodyne_left.timestamps"), "w") as f:
        f.write("\n".join(f"{s} 1" for s in stamps) + "\n")


# bench.py's synthetic HDL-64E batches: points a cloud, clouds a batch
BENCH_N_POINTS = 120_000
BENCH_BATCH = 8


def synth_batch(params, batch: int, n_points: int, seed: int, ordered: bool = False,
                device="cuda"):
    """The port's copy of ``bench.synth_batch`` (bench.py:142): ``batch``
    random clouds as one batched Cloud on ``device``, the same values from
    the same seed.  ``ordered=True`` is the selectors' layout (dense grid,
    slot = row·H + col, empty slots all-zero with label 0, about
    ``n_points`` kept); ``ordered=False`` places ``n_points`` points at
    random rows and columns (the general path of the ordering)."""
    import torch

    from pctpu_torch.cloud import Cloud

    rng = np.random.default_rng(seed)
    g = params.grid_size
    rangev = rng.uniform(3, 100, (batch, g)).astype(np.float32)
    az = rng.uniform(0, 2 * np.pi, (batch, g)).astype(np.float32)
    ground = rng.random((batch, g)) < 0.5
    z = np.where(ground, rng.uniform(-2.0, -1.8, (batch, g)),
                 rng.uniform(-1.0, 6.0, (batch, g))).astype(np.float32)
    xyz = np.stack([rangev * np.cos(az), rangev * np.sin(az), z], axis=-1)
    if ordered:
        mask = rng.random((batch, g)) < (n_points / g)
        slot = np.arange(g)
        row = np.broadcast_to(slot // params.horizon_scan, (batch, g)).astype(np.int32)
        col = np.broadcast_to(slot % params.horizon_scan, (batch, g)).astype(np.int32)
        count = np.full((batch,), g, np.int32)
        intensity = np.maximum(rng.random((batch, g)).astype(np.float32), 1e-3)
    else:
        mask = np.broadcast_to(np.arange(g)[None, :] < n_points, (batch, g))
        row = rng.integers(0, params.n_scan, (batch, g)).astype(np.int32)
        col = rng.integers(0, params.horizon_scan, (batch, g)).astype(np.int32)
        count = np.full((batch,), n_points, np.int32)
        intensity = rng.random((batch, g)).astype(np.float32)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return Cloud(xyz=t(xyz * mask[..., None], torch.float32),
                 intensity=t(intensity * mask, torch.float32),
                 row=t(row * mask, torch.int32), col=t(col * mask, torch.int32),
                 t=torch.zeros((batch, g), dtype=torch.int64, device=device),
                 label=t(np.where(mask, -2, 0).astype(np.int32), torch.int32),
                 count=t(count, torch.int64))
