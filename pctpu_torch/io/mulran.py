"""MulRan dataset ingest: Ouster ``.bin`` reader and ``global_pose.csv`` (the
port of ``pctpu/io/mulran.py``).

Reproduces reference/MulranPointCloudSelect.cpp:
  * ``.bin`` is N×4 float32 rows, capped at 64*1024 points (:113).
  * row = k mod 64 (:121); col = round(semi_positive(az)/360 * 1024) with
    C round (:122-125) — note the reference does **not** wrap col 1024, so a
    point at az≈360° keeps col=1024 and is later dropped by the ordered-cloud
    bounds check (reference/BatchMultiBevGen.cpp:109).
  * label = -2, real intensity preserved (:120,126) — so ground marking is
    effective on MulRan clouds, unlike KITTI.
  * ``global_pose.csv``: 13 comma-separated fields per row — int64 timestamp
    then a row-major 3×4 pose (:148-171); rows sorted by timestamp (:195-198).
"""

from __future__ import annotations

import numpy as np

from pctpu_torch.ops.rounding import c_round_np

N_SCAN = 64
HORIZON_SCAN = 1024
MAX_NUM_POINTS = N_SCAN * HORIZON_SCAN


def read_bin(path: str, max_points: int = MAX_NUM_POINTS) -> dict[str, np.ndarray]:
    """Read a MulRan Ouster .bin into XYZIRCT field arrays (unstructured —
    the selector stores the raw point sequence with row/col annotations).

    Documented divergence: the reference's ``while (!file.eof())`` loop
    (reference/MulranPointCloudSelect.cpp:114-128) pushes one final
    point after the last read FAILS, so its keyframe PCDs declare POINTS =
    N+1 with uninitialized coordinates (but a valid row/col from the stale
    loop counter) in the extra slot.  The garbage bytes are unreproducible;
    this reader returns exactly N points (see README Fidelity notes)."""
    raw = np.fromfile(path, np.float32)
    pts = raw[: (len(raw) // 4) * 4].reshape(-1, 4)[:max_points]
    n = len(pts)

    # all-f32 chain like the C++ (azimuth stored in a float,
    # reference/MulranPointCloudSelect.cpp:122-125); the intermediate
    # /M_PI*180 promotion to double then back to float is emulated via f64
    az = (
        (np.arctan2(pts[:, 1], pts[:, 0]).astype(np.float64) / np.pi * 180.0)
        .astype(np.float32)
    )
    az = np.where(az > 360.0, az - np.float32(360.0), az)
    az = np.where(az < 0.0, az + np.float32(360.0), az)

    ratio = (az / np.float32(360.0) * np.float32(HORIZON_SCAN)).astype(np.float32)
    col = c_round_np(ratio.astype(np.float64)).astype(np.int32)

    return {
        "x": pts[:, 0].copy(),
        "y": pts[:, 1].copy(),
        "z": pts[:, 2].copy(),
        "intensity": pts[:, 3].copy(),
        "row": (np.arange(n, dtype=np.int64) % N_SCAN).astype(np.uint16),
        "col": col.astype(np.uint16),
        "t": np.zeros(n, np.uint32),
        "label": np.full(n, -2, np.int16),
    }


def read_global_poses(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse MulRan global_pose.csv → (timestamps int64 (N,), poses (N,4,4)),
    sorted by timestamp."""
    stamps = []
    mats = []
    with open(path) as f:
        for tok in f.read().split():
            fields = tok.split(",")
            if len(fields) != 13:
                break
            stamps.append(int(fields[0]))
            m = np.zeros((4, 4), np.float64)
            m[3, 3] = 1.0
            m[:3, :4] = np.asarray([float(v) for v in fields[1:13]]).reshape(3, 4)
            mats.append(m)
    stamps_arr = np.asarray(stamps, np.int64)
    order = np.argsort(stamps_arr, kind="stable")
    return stamps_arr[order], np.asarray(mats, np.float64)[order]


def read_timestamps(path: str) -> np.ndarray:
    """Cloud timestamps (ouster_front_stamp.csv), sorted ascending
    (reference/MulranPointCloudSelect.cpp:216-228)."""
    out = []
    with open(path) as f:
        for tok in f.read().split():
            out.append(int(tok.split(",")[0]))
    return np.sort(np.asarray(out, np.int64), kind="stable")
