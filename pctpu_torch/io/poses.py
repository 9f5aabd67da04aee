"""Keyframe pose CSV reader and label writer, bit-compatible with the
reference (the port of ``pctpu/io/poses.py``).

One row per keyframe (reference/KittiPointCloudSelect.cpp:456-461): the
cloud index, x, y, z, roll, pitch, yaw and the rotation matrix, comma
separated.  The reader mirrors reference/BatchMultiBevGen.cpp:381-460.
"""

from __future__ import annotations

import sys

import numpy as np

from pctpu_torch.geom.se3 import Pose6f


def read_keyframe_poses(path: str) -> list[tuple[int, Pose6f]]:
    """Read keyframe_pose.csv → [(cloud_idx, Pose6f)].

    Matches readKeyframePose (reference/BatchMultiBevGen.cpp:381-460):
    16 comma-separated tokens; whitespace-delimited entry scan."""
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
