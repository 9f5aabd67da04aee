"""Oxford Radar RobotCar keyframes for the ray caster of ``harness.scene``:
the HDL-32E's sweep as its ``.bin`` stores it, and the Oxford selector's
rule that turns those bytes into a keyframe.

- The sensor: 32 rings at the data sheet's -30.67 to +10.67 degrees in 31
  equal steps, fired together once every 46.08 us; at Oxford's 20 Hz a
  revolution holds 1,085 firings (50 ms / 46.08 us), which fall into the
  selector's 1,056 columns, so in every ring 29 columns get two firings and
  the later return must win.
- The ``.bin`` (``oxford_bin``): the returns only, firing by firing, 32
  rings a firing, in the upside-down sensor frame (x and z negated), stored
  columnwise: all x, then all y, z and intensity
  (reference/OxfordPointCloudSelect.cpp:162-204).
- The selector's rule (``oxford_points``): a frozen copy of
  ``pctpu_torch/io/oxford.py``'s ``read_bin`` at commit e8eb508, on the
  file's float32 contents: the flip back, row from the f32 elevation
  (``round((-elev + 10.67) / 1.3335)`` clamped to [0, 31]), column from the
  semi-positive azimuth over 360/1056, wrapped; label -2, real intensity
  (reference/OxfordPointCloudSelect.cpp:203-218).

Everything here is numpy and imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from harness import scene

N_SCAN, HORIZON_SCAN = 32, 1056
FIRINGS = 1085  # a revolution at 20 Hz, one firing every 46.08 us


def hdl32e_elevations() -> np.ndarray:
    """The 32 rings, lowest first, as one firing stores them."""
    return np.linspace(-30.67, 10.67, N_SCAN)


def oxford_bin(pts: np.ndarray, hit: np.ndarray, inten: np.ndarray) -> np.ndarray:
    """The float32 contents of a velodyne_left ``.bin`` of one sweep
    ((rings, firings) arrays of ``scene._scan``): the hits firing by firing,
    x and z negated, written columnwise."""
    p = pts.transpose(1, 0, 2)[hit.T]
    i = inten.T[hit.T]
    return np.concatenate([-p[:, 0], p[:, 1], -p[:, 2], i]).astype(np.float32)


def oxford_points(raw: np.ndarray) -> dict[str, np.ndarray]:
    """The Oxford selector's keyframe of a ``.bin``'s float32 contents
    (pctpu_torch/io/oxford.py ``read_bin`` @ e8eb508)."""
    raw = np.asarray(raw, np.float32)
    n = len(raw) // 4
    x32 = -raw[0:n]
    y32 = raw[n:2 * n].copy()
    z32 = -raw[2 * n:3 * n]
    intensity = raw[3 * n:4 * n]
    elev = (np.arctan2(z32, np.sqrt(x32 * x32 + y32 * y32)).astype(np.float64)
            / np.pi * 180.0).astype(np.float32)
    row_f = (-elev.astype(np.float64) + 10.67) / 1.3335
    row = np.clip(scene.c_round_np(row_f).astype(np.int32), 0, N_SCAN - 1)
    az = (np.arctan2(y32, x32).astype(np.float64) / np.pi * 180.0).astype(np.float32)
    az = np.where(az > 360.0, az - np.float32(360.0), az)
    az = np.where(az < 0.0, az + np.float32(360.0), az)
    ratio = (az / np.float32(360.0) * np.float32(HORIZON_SCAN)).astype(np.float32)
    col = scene.c_round_np(ratio.astype(np.float64)).astype(np.int32)
    col = np.where(col >= HORIZON_SCAN, col - HORIZON_SCAN, col)
    col = np.where(col < 0, col + HORIZON_SCAN, col)
    return {"x": x32, "y": y32, "z": z32, "intensity": intensity.copy(),
            "row": row.astype(np.uint16), "col": col.astype(np.uint16),
            "t": np.zeros(n, np.uint32), "label": np.full(n, -2, np.int16)}


def keyframe(boxes: np.ndarray, x: float, y: float, yaw: float,
             rng: np.random.Generator) -> dict[str, np.ndarray]:
    """One Oxford keyframe (the selector's XYZIRCT field dict, on-disk
    dtypes) of a sweep taken at (x, y) facing ``yaw`` radians in the world
    of ``boxes``, at the ray caster's sensor height."""
    pts, hit, inten = scene._scan(boxes, np.array([x, y]), yaw, hdl32e_elevations(),
                                  FIRINGS, rng)
    return oxford_points(oxford_bin(pts, hit, inten))
