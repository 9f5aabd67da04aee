"""ctypes binding of the native BEV artifact writer (``native/pctpu_io.cpp``'s
``pctpu_write_cloud_artifacts``; the port of the part of
``pctpu/runtime/native_io.py`` that batch_multi_bev_gen runs).

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
            _lib = lib
        except (OSError, subprocess.SubprocessError) as exc:
            build_error = getattr(exc, "stderr", None) or str(exc)
            _lib = None
        return _lib


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
    native encoder's level 1, the one form the Python fallback writes."""
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
            write_gray_png(os.path.join(img_dir, f"{layer:02d}.png"), multi[layer])
        write_gray_png(single_png_path, single)
    write_csv(single_csv_path, single)
