"""OpenCV ``cv::Formatter FMT_CSV``-compatible uint8 matrix → CSV bytes
(the port of ``pctpu/io/csvfmt.py``'s uint8 path, the single-BEV CSV of
batch_multi_bev_gen; byte-identical to pctpu's formatters and the native
writer).

The reference exports the single BEV through ``cv::format(mat, FMT_CSV)``
(reference/BatchMultiBevGen.cpp:371).  The byte format, verified against
libopencv_core by pctpu's tests: ``%3d`` per value, values joined by
``", "``, every row terminated by ``"\\n"`` except in a single-row matrix.
"""

from __future__ import annotations

import numpy as np

_U8_LUT = np.array([("%3d" % i).encode() for i in range(256)], "S3")


def format_csv_bytes(mat: np.ndarray) -> bytes:
    """Render a 2-D uint8 matrix exactly like OpenCV FMT_CSV (a numpy
    assembly: a per-value Python formatter costs ~15 ms a 224² BEV)."""
    mat = np.asarray(mat)
    if mat.ndim != 2 or mat.dtype != np.uint8:
        raise ValueError(f"expected a 2-D uint8 matrix, got {mat.dtype} {mat.shape}")
    h, w = mat.shape
    cells = _U8_LUT[mat].view("S1").reshape(h, w, 3)
    buf = np.empty((h, w, 5), "S1")
    buf[:, :, :3] = cells
    buf[:, :, 3] = b","
    buf[:, :, 4] = b" "
    rows = np.empty((h, w * 5 - 1), "S1")
    rows[:, :-1] = buf.reshape(h, w * 5)[:, :-2]  # drop the trailing ", "
    rows[:, -1] = b"\n"
    out = rows.tobytes()
    return out[:-1] if h == 1 else out


def write_csv(path: str, mat: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(format_csv_bytes(mat))
