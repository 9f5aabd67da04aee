"""Keyframe pose CSV format, reader and label writer, bit-compatible with the
reference (the port of ``pctpu/io/poses.py``).

One row per keyframe (reference/KittiPointCloudSelect.cpp:456-461):

  {cloud_idx:06d},{x:.6f},{y:.6f},{z:.6f},{roll:.6f},{pitch:.6f},{yaw:.6f},
  {R00:.6f},{R01:.6f},{R02:.6f},{R10:.6f},...,{R22:.6f}\\n

The reader mirrors reference/BatchMultiBevGen.cpp:381-460: the translation
and rotation matrix are re-parsed; roll/pitch/yaw are *not* taken from the
file but re-derived through the custom euler extraction.
"""

from __future__ import annotations

import sys

import numpy as np

from pctpu_torch.geom.se3 import Pose6f

# the C++ multi-line literal is line-spliced, so the continuation lines'
# 13-space indentation is part of the output (KittiPointCloudSelect.cpp:417-422)
POSE_FORMAT_HEADER = (
    "cloud_idx, x, y, z, roll, pitch, yaw, "
    "             rotation_matrix(0 0), rotation_matrix(0 1), rotation_matrix(0 2), "
    "             rotation_matrix(1 0), rotation_matrix(1 1), rotation_matrix(1 2), "
    "             rotation_matrix(2 0), rotation_matrix(2 1), rotation_matrix(2 2)"
)


def format_pose_entry(cloud_idx: int, pose: Pose6f) -> str:
    r = pose.rotation_matrix
    vals = [
        pose.x, pose.y, pose.z, pose.roll, pose.pitch, pose.yaw,
        r[0, 0], r[0, 1], r[0, 2], r[1, 0], r[1, 1], r[1, 2], r[2, 0], r[2, 1], r[2, 2],
    ]
    return f"{cloud_idx:06d}," + ",".join(f"{float(v):.6f}" for v in vals) + "\n"


def write_pose_format_file(path: str) -> None:
    """The keyframe_pose_format.csv description file
    (reference/KittiPointCloudSelect.cpp:417-422), including the literal
    whitespace from the multi-line C++ string."""
    with open(path, "w") as f:
        f.write(POSE_FORMAT_HEADER + "\n")


def read_keyframe_poses(path: str) -> list[tuple[int, Pose6f]]:
    """Read keyframe_pose.csv → [(cloud_idx, Pose6f)].

    Matches readKeyframePose (reference/BatchMultiBevGen.cpp:381-460):
    16 comma-separated tokens; whitespace-delimited entry scan; euler angles
    re-derived from the rotation matrix."""
    entries: list[tuple[int, Pose6f]] = []
    with open(path) as f:
        for tok in f.read().split():
            fields = tok.split(",")
            if len(fields) != 16:
                # reference prints this to stderr then stops the scan (:415-419)
                print(
                    f"Size of entry_token is: {len(fields)}, while expecting 16. ",
                    file=sys.stderr,
                )
                break
            cloud_idx = int(fields[0])
            t = np.array([float(fields[1]), float(fields[2]), float(fields[3])], np.float64)
            r = np.array([float(v) for v in fields[7:16]], np.float64).reshape(3, 3)
            entries.append((cloud_idx, Pose6f.from_matrix(r, t)))
    return entries


def save_labels(path: str, labels: np.ndarray) -> None:
    """Write keyframe_label.csv: comma-joined floats with a trailing comma
    per row (std::ostream_iterator with ',' delimiter,
    reference/BatchMultiBevGen.cpp:645-661).  Values print like
    std::ostream << float (shortest %g-style, 6 significant digits)."""
    with open(path, "w") as f:
        for row in np.asarray(labels):
            f.write("".join(_ostream_float(v) + "," for v in row))
            f.write("\n")


def _ostream_float(v: float) -> str:
    """Format like C++ ``std::ostream << float``: %g with 6 significant
    digits."""
    return "%.6g" % float(v)
