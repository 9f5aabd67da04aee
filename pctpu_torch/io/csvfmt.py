"""OpenCV ``cv::Formatter FMT_CSV``-compatible matrix → CSV bytes (the port
of ``pctpu/io/csvfmt.py``, byte-identical to pctpu's formatters and the
native writer).

The reference exports BEVs through ``cv::format(mat, FMT_CSV)`` with 4-digit
float precision (reference/BatchCloudManip.cpp:227-229,
BatchMultiBevGen.cpp:371).  The byte format, verified against
libopencv_core by pctpu's tests:

  * float32/float64: ``%.4g`` per value (precision = set32fPrecision), a
    NaN with its sign bit set printed ``-nan`` as glibc does;
  * uint8:           ``%3d`` per value (width-3, right aligned);
  * int16/int32:     ``%d``;
  * values joined by ``", "``; every row terminated by ``"\\n"`` —
    except single-row matrices, which get no trailing newline.
"""

from __future__ import annotations

import numpy as np

from pctpu_torch.runtime import native_io

_U8_LUT = np.array([("%3d" % i).encode() for i in range(256)], "S3")


def _value_formatter(dtype: np.dtype, float_precision: int):
    if dtype == np.uint8 or dtype == np.int8:
        return lambda v: "%3d" % int(v)
    if dtype in (np.dtype(np.uint16), np.dtype(np.int16), np.dtype(np.int32)):
        return lambda v: "%d" % int(v)
    if dtype in (np.dtype(np.float32), np.dtype(np.float64)):
        fmt = f"%.{float_precision}g"

        def _fmt_float(v):
            # glibc %g (what OpenCV used, and what the native path emits)
            # prints sign-set NaNs as "-nan"; Python's % always says "nan"
            if np.isnan(v) and np.signbit(v):
                return "-nan"
            return fmt % float(v)

        return _fmt_float
    raise TypeError(f"unsupported dtype for FMT_CSV: {dtype}")


def _format_u8(mat: np.ndarray) -> bytes:
    """The ``%3d`` path as a numpy assembly (a per-value Python formatter
    costs ~15 ms a 224² BEV)."""
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


def format_csv_python(mat: np.ndarray, float_precision: int = 4) -> bytes:
    """The per-value formatter of every supported dtype (the float route
    where the native library is missing; tens of ms a 201² float BEV)."""
    value = _value_formatter(mat.dtype, float_precision)
    rows = (", ".join(value(v) for v in row) for row in mat)
    if mat.shape[0] == 1:
        return next(rows).encode()
    return "".join(r + "\n" for r in rows).encode()


def csv_route(mat: np.ndarray) -> str:
    """Which formatter :func:`format_csv_bytes` takes for ``mat``: ``numpy``
    (uint8), ``native`` (float32 with the library built) or ``python``."""
    mat = np.asarray(mat)
    if mat.dtype == np.uint8 and mat.size:
        return "numpy"
    if mat.dtype == np.float32 and mat.size and native_io.native_available():
        return "native"
    return "python"


def format_csv_bytes(mat: np.ndarray, float_precision: int = 4) -> bytes:
    """Render a 2-D matrix exactly like OpenCV FMT_CSV (bytes).

    uint8 goes through a numpy lookup-table assembly and float32 through the
    native snprintf formatter when it is built (printf %g is literally what
    libopencv used); both are byte-identical to :func:`format_csv_python`."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {mat.shape}")
    route = csv_route(mat)
    if route == "numpy":
        return _format_u8(mat)
    if route == "native":
        out = native_io.format_csv_f32(mat, float_precision)
        if out is not None:
            return out
    return format_csv_python(mat, float_precision)


def format_csv(mat: np.ndarray, float_precision: int = 4) -> str:
    """Render a 2-D matrix exactly like OpenCV FMT_CSV."""
    return format_csv_bytes(mat, float_precision).decode()


def write_csv(path: str, mat: np.ndarray, float_precision: int = 4) -> None:
    with open(path, "wb") as f:
        f.write(format_csv_bytes(mat, float_precision))
