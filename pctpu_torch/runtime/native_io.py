"""ctypes bindings of the native IO library ``native/pctpu_io.cpp``: the BEV
artifact writers, the CSV formatters and the PCD LZF decoder (the port of
``pctpu/runtime/native_io.py``).

The library is built at first use with ``g++ -O2 -shared -fPIC … -lz`` into
``build/pctpu_torch/`` (never into ``native/``), under a name carrying a hash
of the source.  Where that build fails, the Python writers
(``pctpu_torch.io.png``, ``pctpu_torch.io.csvfmt``) write the same bytes.
This is host file output, not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "pctpu_io.cpp"
BUILD_DIR = _REPO / "build" / "pctpu_torch"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
build_error: str | None = None


def library_path() -> Path:
    return BUILD_DIR / f"libpctpu_io_{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # build to a temp name and rename: a concurrent process must
                # never dlopen a half-written library
                tmp = out.with_suffix(f".build{os.getpid()}.so")
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC), "-lz"],
                    check=True, capture_output=True, text=True, timeout=300,
                )
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pctpu_write_cloud_artifacts.argtypes = [
                p, p, i, i, i, p, i, i, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_char_p, i, i,
            ]
            lib.pctpu_write_cloud_artifacts.restype = i
            lib.pctpu_format_csv_f32.argtypes = [p, i, i, i, p, ctypes.c_long]
            lib.pctpu_format_csv_f32.restype = ctypes.c_long
            lib.pctpu_write_png.argtypes = [p, i, i, i, ctypes.c_char_p]
            lib.pctpu_write_png.restype = i
            lib.pctpu_write_multi_bev.argtypes = [p, i, i, i, ctypes.c_char_p, ctypes.c_char_p,
                                                  i, i]
            lib.pctpu_write_multi_bev.restype = i
            lib.pctpu_lzf_decompress.argtypes = [p, ctypes.c_long, p, ctypes.c_long]
            lib.pctpu_lzf_decompress.restype = ctypes.c_long
            lib.pctpu_format_csv_u8.argtypes = [p, i, i, p, ctypes.c_long]
            lib.pctpu_format_csv_u8.restype = ctypes.c_long
            _lib = lib
        except (OSError, subprocess.SubprocessError) as exc:
            build_error = getattr(exc, "stderr", None) or str(exc)
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def writer_name() -> str:
    """Which writer writes the BEV artifacts: the native library (and its
    path) or the Python fallback."""
    lib = _load()
    if lib is None:
        return "python (native build failed)"
    return f"native ({os.path.relpath(library_path(), _REPO)})"


def write_cloud_artifacts(
    bin_path: str,
    img_dir: str,
    single_png_path: str,
    single_csv_path: str,
    single: np.ndarray,
    multi: np.ndarray,
    write_pngs: bool = True,
) -> None:
    """Write one cloud's in-[TIME] artifact set
    (reference/BatchMultiBevGen.cpp:295-320, 352-372): the layer-major
    ``.bin``, the per-layer PNGs ``<img_dir>/%02d.png``, the single-BEV PNG
    and its FMT_CSV.  ``multi`` is (L, H, W) u8 of 0/255.  PNGs take the
    encoder's level 1 (the RLE form), as pctpu's writer does."""
    single = np.ascontiguousarray(single, np.uint8)
    multi = np.ascontiguousarray(multi, np.uint8)
    lib = _load()
    if lib is not None:
        nl, h, w = multi.shape
        rc = lib.pctpu_write_cloud_artifacts(
            None, multi.ctypes.data, nl, h, w,
            single.ctypes.data, single.shape[0], single.shape[1],
            bin_path.encode(), img_dir.rstrip("/").encode(),
            single_png_path.encode() if write_pngs else None,
            single_csv_path.encode(), 1, 1 if write_pngs else 0,
        )
        if rc != 0:
            raise OSError(f"native BEV writer failed with code {rc} for {bin_path}")
        return
    write_cloud_artifacts_python(bin_path, img_dir, single_png_path, single_csv_path,
                                 single, multi, write_pngs)


def write_cloud_artifacts_python(
    bin_path: str, img_dir: str, single_png_path: str, single_csv_path: str,
    single: np.ndarray, multi: np.ndarray, write_pngs: bool = True,
) -> None:
    """The Python writers: the same bytes as the native library."""
    from pctpu_torch.io.csvfmt import write_csv
    from pctpu_torch.io.png import write_gray_png

    with open(bin_path, "wb") as f:
        f.write(np.ascontiguousarray(multi, np.uint8).tobytes())
    if write_pngs:
        os.makedirs(img_dir, exist_ok=True)
        for layer in range(multi.shape[0]):
            write_gray_png(os.path.join(img_dir, f"{layer:02d}.png"), multi[layer], 1)
        write_gray_png(single_png_path, single, 1)
    write_csv(single_csv_path, single)


def format_csv_f32(mat: np.ndarray, precision: int) -> bytes | None:
    """Native OpenCV-FMT_CSV float formatting ("%.<p>g", ", ", row "\\n").
    Returns None when the library is unavailable (the caller falls back to
    the byte-identical Python formatter)."""
    lib = _load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.float32)
    h, w = mat.shape
    # worst case per value: sign + 8 significant + dot + e+XX + sep ≈ 24
    cap = h * w * (precision + 20) + h + 16
    out = np.empty(cap, np.uint8)
    n = lib.pctpu_format_csv_f32(mat.ctypes.data, h, w, precision, out.ctypes.data, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write an 8-bit grayscale PNG (native if possible, else Python); a
    non-uint8 image is saturated to uint8 first, as OpenCV's imwrite does."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        from pctpu_torch.ops.rounding import cv_saturate_u8

        img = cv_saturate_u8(img)
    lib = _load()
    if lib is not None:
        if lib.pctpu_write_png(img.ctypes.data, img.shape[0], img.shape[1], level,
                               path.encode()) == 0:
            return
    from pctpu_torch.io.png import write_gray_png

    write_gray_png(path, img, compress_level=level)


def write_multi_bev(bin_path: str, img_dir: str, multi: np.ndarray, level: int = 1,
                    write_pngs: bool = True) -> None:
    """Write one cloud's multi-BEV: the layer-major ``.bin`` and the
    per-layer PNGs ``<img_dir>/%02d.png`` (native if possible, else
    Python)."""
    multi = np.ascontiguousarray(multi, np.uint8)
    layers, h, w = multi.shape
    lib = _load()
    if lib is not None:
        if lib.pctpu_write_multi_bev(multi.ctypes.data, layers, h, w, bin_path.encode(),
                                     img_dir.rstrip("/").encode(), level,
                                     1 if write_pngs else 0) == 0:
            return
    from pctpu_torch.io.png import write_gray_png

    with open(bin_path, "wb") as f:
        f.write(multi.tobytes())
    if write_pngs:
        os.makedirs(img_dir, exist_ok=True)
        for layer in range(layers):
            write_gray_png(os.path.join(img_dir, f"{layer:02d}.png"), multi[layer], level)


def format_csv_u8(mat: np.ndarray) -> bytes | None:
    """Native OpenCV-FMT_CSV uint8 formatting ("%3d", ", ", row "\\n").
    Returns None when the library is unavailable (the caller falls back to
    the byte-identical Python formatter)."""
    lib = _load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.uint8)
    h, w = mat.shape
    cap = h * w * 5
    out = np.empty(cap, np.uint8)
    n = lib.pctpu_format_csv_u8(mat.ctypes.data, h, w, out.ctypes.data, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def lzf_decompress(data: bytes, expected_size: int) -> bytes | None:
    """Native liblzf decompression; None when the library is unavailable or
    the stream does not decode to exactly ``expected_size`` bytes (the
    caller falls back to the Python decoder)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(expected_size, np.uint8)
    src = np.frombuffer(data, np.uint8)
    n = lib.pctpu_lzf_decompress(src.ctypes.data, len(data), out.ctypes.data, expected_size)
    if n != expected_size:
        return None
    return out.tobytes()
