"""KITTI Odometry ingest: velodyne ``.bin`` reader with ring structuring, and
``global_pose.txt`` camera-pose parsing (the port of ``pctpu/io/kitti.py``).

Reproduces reference/KittiPointCloudSelect.cpp:
  * ``.bin`` is N×4 float32 rows (x, y, z, intensity), capped at
    64*2083 points (:174).
  * Ring segmentation from azimuth sign flips: a new ring starts where
    az[i-1] <= 0 and az[i] > 0, accepted only if the current ring already has
    more than ``0.60 * Horizon_SCAN`` points (:212-221).  Point 0 is never
    assigned (the loop starts at i=1, :212).
  * col = round(semi_positive(az) / (360/2083)) with C round (:225-226),
    wrapped into [0, H).
  * Structured cloud: dense 64×2083 grid, later points overwrite earlier
    ones; assigned points get label=-2 and **intensity=-1** (:237-238) — the
    reference quirk that later disables ground marking on KITTI clouds (see
    SURVEY.md §2.4.2).  We reproduce it bit-for-bit by default and expose
    ``keep_intensity`` to opt out.
"""

from __future__ import annotations

import numpy as np

from pctpu_torch.ops.rounding import c_round_np

N_SCAN = 64
HORIZON_SCAN = 2083
MAX_NUM_POINTS = N_SCAN * HORIZON_SCAN
# the dead raw-variant selector reads up to 64*2250 points
# (reference/KittiRawPointCloudSelect.cpp:141) into the same
# 64×2083 structured grid
RAW_MAX_NUM_POINTS = N_SCAN * 2250

# KITTI camera↔lidar extrinsic (reference/KittiPointCloudSelect.cpp:399-403)
LIDAR_WRT_CAM = np.array(
    [
        [7.967514e-03, -9.999679e-01, -8.462264e-04, -1.377769e-02],
        [-2.771053e-03, 8.241710e-04, -9.999958e-01, -5.542117e-02],
        [9.999644e-01, 7.969825e-03, -2.764397e-03, -2.918589e-01],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float64,
)
CAM_WRT_LIDAR = np.linalg.inv(LIDAR_WRT_CAM)


def read_bin(path: str, max_points: int = MAX_NUM_POINTS) -> np.ndarray:
    """Read a KITTI velodyne .bin as an (N, 4) float32 array (x, y, z, i)."""
    raw = np.fromfile(path, np.float32)
    pts = raw[: (len(raw) // 4) * 4].reshape(-1, 4)
    return pts[:max_points]


def assign_rings(points: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute (row, col, assigned) for each point per the reference logic.

    Returns int32 row/col arrays and a boolean 'assigned' mask (points the
    reference writes into the structured cloud).
    """
    n = len(points)
    # f32 atan2, promoted /M_PI*180.0f in double, stored back in a float
    # (reference/KittiPointCloudSelect.cpp:189-193)
    az = (
        np.arctan2(points[:, 1], points[:, 0]).astype(np.float64) / np.pi * 180.0
    ).astype(np.float32)

    row = np.full(n, -1, np.int32)
    # Ring transitions: candidate boundaries where az crosses 0 upward.
    boundary = np.zeros(n, bool)
    if n > 1:
        boundary[1:] = (az[:-1] <= 0) & (az[1:] > 0)
    ring = 0 if (n > 0 and az[0] > 0) else -1
    last_reset = 1  # iteration count since reset == i - last_reset
    ring_at = np.empty(n, np.int32)
    if n == 0:
        # empty/truncated .bin → no rings, matching the 3-tuple contract
        return row, np.empty(0, np.int32), np.zeros(0, bool)
    ring_at[0] = -1  # point 0 is never assigned
    guard = HORIZON_SCAN * np.float32(0.60)
    b_idx = np.flatnonzero(boundary)
    prev = 1
    for b in b_idx:
        ring_at[prev:b] = ring
        if ring == -1:
            ring = 0
            last_reset = b
        elif (b - last_reset) > guard:
            ring += 1
            last_reset = b
        prev = b
    ring_at[prev:] = ring
    if n > 0:
        ring_at[0] = -1
    row[1:] = ring_at[1:]

    # makeAngleSemiPositive is f32 (:137-146); the column divide promotes to
    # double (360.0 literal) and uses std::round (:225-226)

    semi = np.where(az >= 360.0, az - np.float32(360.0), az)
    semi = np.where(semi < 0.0, semi + np.float32(360.0), semi)
    col = c_round_np(semi.astype(np.float64) / (360.0 / HORIZON_SCAN)).astype(np.int32)
    col = np.where(col >= HORIZON_SCAN, col - HORIZON_SCAN, col)
    col = np.where(col < 0, col + HORIZON_SCAN, col)

    assigned = (row >= 0) & (row < N_SCAN)
    return row, col, assigned


def assign_rings_raw(points: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The dead raw-variant's ring segmentation: every upward zero crossing
    of the azimuth starts a new ring — there is NO minimum-ring-length guard
    (reference/KittiRawPointCloudSelect.cpp:180-204, contrast the live
    selector's ``0.60 * Horizon_SCAN`` gate).  ring starts at 0 when the
    first azimuth is positive, else -1 (:165-170); point 0 is never assigned
    (the loop starts at i=1).  Column math is shared with the live selector
    (same round/wrap expressions, :187-195)."""
    n = len(points)
    az = (
        np.arctan2(points[:, 1], points[:, 0]).astype(np.float64) / np.pi * 180.0
    ).astype(np.float32)
    row = np.full(n, -1, np.int32)
    if n == 0:
        return row, np.empty(0, np.int32), np.zeros(0, bool)
    boundary = np.zeros(n, np.int32)
    boundary[1:] = ((az[:-1] <= 0) & (az[1:] > 0)).astype(np.int32)
    init = 0 if az[0] > 0 else -1
    ring_at = init + np.cumsum(boundary, dtype=np.int32)
    row[1:] = ring_at[1:]


    semi = np.where(az >= 360.0, az - np.float32(360.0), az)
    semi = np.where(semi < 0.0, semi + np.float32(360.0), semi)
    col = c_round_np(semi.astype(np.float64) / (360.0 / HORIZON_SCAN)).astype(np.int32)
    col = np.where(col >= HORIZON_SCAN, col - HORIZON_SCAN, col)
    col = np.where(col < 0, col + HORIZON_SCAN, col)

    assigned = (row >= 0) & (row < N_SCAN)
    return row, col, assigned


def structure_cloud(
    points: np.ndarray,
    keep_intensity: bool = False,
    rings: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
) -> dict[str, np.ndarray]:
    """Scatter points into the dense 64×2083 grid (later points win),
    returning XYZIRCT field arrays of length 64*2083.

    ``keep_intensity=False`` reproduces the reference's intensity=-1
    overwrite (reference/KittiPointCloudSelect.cpp:238).  ``rings``
    overrides the (row, col, assigned) assignment — the raw-variant selector
    passes :func:`assign_rings_raw`'s output here."""
    g = MAX_NUM_POINTS
    out = {
        "x": np.zeros(g, np.float32),
        "y": np.zeros(g, np.float32),
        "z": np.zeros(g, np.float32),
        "intensity": np.zeros(g, np.float32),
        "row": np.zeros(g, np.uint16),
        "col": np.zeros(g, np.uint16),
        "t": np.zeros(g, np.uint32),
        "label": np.zeros(g, np.int16),
    }
    row, col, assigned = assign_rings(points) if rings is None else rings
    sel = np.flatnonzero(assigned)
    idx = row[sel] * HORIZON_SCAN + col[sel]
    # numpy fancy assignment applies in order → later duplicate indices win,
    # same as the reference's sequential overwrite.
    out["x"][idx] = points[sel, 0]
    out["y"][idx] = points[sel, 1]
    out["z"][idx] = points[sel, 2]
    out["intensity"][idx] = points[sel, 3] if keep_intensity else -1.0
    out["row"][idx] = row[sel].astype(np.uint16)
    out["col"][idx] = col[sel].astype(np.uint16)
    out["label"][idx] = -2
    return out


def _read_pose_matrices(path: str) -> np.ndarray:
    """Parse a KITTI 12-fields-per-row pose file into (N, 4, 4) float64
    homogeneous matrices; a short row ends the parse (the references'
    ``row.size()!=12 break``, KittiPointCloudSelect.cpp:270-272 /
    KittiRawPointCloudSelect.cpp:239-240)."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) < 12:
                break
            rows.append([float(v) for v in vals[:12]])
    mats = np.zeros((len(rows), 4, 4), np.float64)
    mats[:, 3, 3] = 1.0
    if rows:
        mats[:, :3, :4] = np.asarray(rows, np.float64).reshape(-1, 3, 4)
    return mats


def read_global_poses(path: str) -> np.ndarray:
    """Parse KITTI ``global_pose.txt`` (12 floats per row, row-major 3×4
    camera pose) into (N, 4, 4) float64 homogeneous **lidar** poses via the
    extrinsic conjugation (reference/KittiPointCloudSelect.cpp:248-309)."""
    mats = _read_pose_matrices(path)
    return CAM_WRT_LIDAR[None] @ mats @ np.linalg.inv(CAM_WRT_LIDAR)[None]


def read_raw_gt_poses(path: str) -> np.ndarray:
    """The raw-variant's pose read: the 12-field rows are used DIRECTLY as
    homogeneous matrices — no camera→lidar extrinsic conjugation
    (reference/KittiRawPointCloudSelect.cpp:222-262; the axis shuffle
    into Pose6f happens at the selector layer, :252-259)."""
    return _read_pose_matrices(path)


def read_timestamps(path: str) -> list[int]:
    """KITTI ``times.txt`` read as int64 per the reference's std::stoll
    (reference/KittiPointCloudSelect.cpp:326-330).  stoll parses only
    the leading integer prefix of the decimal timestamps; the values are
    never used by the selector, only the entry count is (:427-430)."""
    import re

    out = []
    with open(path) as f:
        for tok in f.read().split():
            m = re.match(r"[+-]?\d+", tok)
            if m is None:
                raise ValueError(f"unparseable timestamp token: {tok!r}")
            out.append(int(m.group(0)))
    return out
