"""Oxford Radar RobotCar ingest: velodyne_left ``.bin`` (transposed layout)
and INS ``.csv`` poses (the port of ``pctpu/io/oxford.py``).

Reproduces reference/OxfordPointCloudSelect.cpp:
  * ``.bin`` stores N points **columnwise**: all x, then all y, z, intensity
    (:162-198); N = filesize / 16.
  * The lidar is mounted upside-down: x = -x, z = -z (:203-204).
  * row from elevation: round((-elev + 10.67) / 1.3335) clamped to [0, 31]
    (:208-211); col = round(semi_positive(az)/360 * 1056), wrapped (:213-218).
  * label = -2, intensity preserved (:206).
  * INS csv: header line skipped; x = easting (field 6), y = northing (5),
    z = altitude (4), rpy from fields 14/13/12, R = Rz(yaw)Ry(pitch)Rx(roll)
    (:245-267); sorted by timestamp.
"""

from __future__ import annotations

import numpy as np

from pctpu_torch.geom.se3 import euler_zyx_to_matrix
from pctpu_torch.ops.rounding import c_round_np

N_SCAN = 32
HORIZON_SCAN = 1056


def read_bin(path: str) -> dict[str, np.ndarray]:
    """Read an Oxford velodyne .bin into XYZIRCT field arrays."""
    raw = np.fromfile(path, np.float32)
    n = len(raw) // 4
    # upside-down lidar fix x = -x, z = -z (:203-204); f32 negation is exact,
    # no need for a double detour
    x32 = -raw[0:n]
    y32 = raw[n : 2 * n].copy()
    z32 = -raw[2 * n : 3 * n]
    intensity = raw[3 * n : 4 * n]

    # float members → f32 products; atan2 promoted to double by /M_PI*180.0f
    # then stored in a float (:208); row expression is double (10.67/1.3335
    # literals) on the f32 elevation
    elev = (
        np.arctan2(z32, np.sqrt(x32 * x32 + y32 * y32)).astype(np.float64)
        / np.pi
        * 180.0
    ).astype(np.float32)
    row_f = (-elev.astype(np.float64) + 10.67) / 1.3335
    row = np.clip(c_round_np(row_f).astype(np.int32), 0, 31)

    az = (np.arctan2(y32, x32).astype(np.float64) / np.pi * 180.0).astype(np.float32)
    az = np.where(az > 360.0, az - np.float32(360.0), az)
    az = np.where(az < 0.0, az + np.float32(360.0), az)
    ratio = (az / np.float32(360.0) * np.float32(HORIZON_SCAN)).astype(np.float32)
    col = c_round_np(ratio.astype(np.float64)).astype(np.int32)
    col = np.where(col >= HORIZON_SCAN, col - HORIZON_SCAN, col)
    col = np.where(col < 0, col + HORIZON_SCAN, col)

    return {
        "x": x32,
        "y": y32,
        "z": z32,
        "intensity": intensity.copy(),
        "row": row.astype(np.uint16),
        "col": col.astype(np.uint16),
        "t": np.zeros(n, np.uint32),
        "label": np.full(n, -2, np.int16),
    }


def read_ins_poses(path: str):
    """Parse the INS csv → (timestamps (N,), list of (R, t)) sorted by stamp.

    Returns rotation matrices and translations plus the raw rpy used to build
    them (the reference keeps rpy floats directly, :249-264)."""
    stamps, rots, trans, rpys = [], [], [], []
    with open(path) as f:
        first = True
        for tok in f.read().split():
            if first:
                first = False  # header line (:243)
                continue
            fields = tok.split(",")
            stamp = int(fields[0])
            roll = np.float32(fields[14])
            pitch = np.float32(fields[13])
            yaw = np.float32(fields[12])
            r = euler_zyx_to_matrix(float(roll), float(pitch), float(yaw))
            stamps.append(stamp)
            rots.append(r)
            trans.append(
                np.array(
                    [np.float32(fields[6]), np.float32(fields[5]), np.float32(fields[4])],
                    np.float64,
                )
            )
            rpys.append((float(roll), float(pitch), float(yaw)))
    order = np.argsort(np.asarray(stamps, np.int64), kind="stable")
    stamps_arr = np.asarray(stamps, np.int64)[order]
    rots = [rots[i] for i in order]
    trans = [trans[i] for i in order]
    rpys = [rpys[i] for i in order]
    return stamps_arr, rots, trans, rpys
