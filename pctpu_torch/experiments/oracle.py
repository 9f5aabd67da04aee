"""The reference's BEV chain as an independent native oracle, for checks on
the card: ``native/ref_oracle.cpp``'s ``pctpu_ref_preprocess`` (ordering,
ground marking with the C++'s f64 slope, both BEV rasters), built with
``g++ -O2 -std=c++14 -ffp-contract=off`` into ``build/pctpu_torch/`` and
bound with ctypes; and the D2 analysis that attributes a difference from it
to the slope test's f32/f64 knife edge."""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from pctpu_torch.ops import ground

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "ref_oracle.cpp"
BUILD_DIR = _REPO / "build" / "pctpu_torch"
BEV_LAYERS, BEV_SIZE = 24, 224


def load() -> ctypes.CDLL:
    """Build (once per source) and load the oracle library."""
    out = BUILD_DIR / f"libref_oracle_{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".build{os.getpid()}.so")
        subprocess.run(["g++", "-O2", "-std=c++14", "-ffp-contract=off", "-shared", "-fPIC",
                        "-o", str(tmp), str(_SRC)], check=True, capture_output=True,
                       text=True, timeout=300)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.pctpu_ref_preprocess.argtypes = [p, p, p, p, p, ctypes.c_int64, i32, i32, i32,
                                         ctypes.c_float, p, p, p, p]
    lib.pctpu_ref_preprocess.restype = ctypes.c_int
    return lib


def preprocess(lib: ctypes.CDLL, data: dict, params) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One raw cloud (a PCD field dict, in file order) through the oracle:
    (labels (G,) i32, multi (24, 224, 224) u8, single (224, 224) u8)."""
    n = len(data["x"])
    xyz = np.ascontiguousarray(np.stack([data["x"], data["y"], data["z"]], 1), np.float32)
    inten = np.ascontiguousarray(data["intensity"], np.float32)
    row = np.ascontiguousarray(data["row"], np.int32)
    col = np.ascontiguousarray(data["col"], np.int32)
    label = np.ascontiguousarray(data["label"], np.int32)
    labels = np.empty(params.grid_size, np.int32)
    multi = np.empty((BEV_LAYERS, BEV_SIZE, BEV_SIZE), np.uint8)
    single = np.empty((BEV_SIZE, BEV_SIZE), np.uint8)
    rc = lib.pctpu_ref_preprocess(
        xyz.ctypes.data, inten.ctypes.data, row.ctypes.data, col.ctypes.data,
        label.ctypes.data, n, params.n_scan, params.horizon_scan, params.ground_upper_scan,
        params.height_res, labels.ctypes.data, multi.ctypes.data, single.ctypes.data, None)
    if rc != 0:
        raise RuntimeError(f"pctpu_ref_preprocess failed: {rc}")
    return labels, multi, single


def slope_disagreements(xyz: torch.Tensor, intensity: torch.Tensor, params,
                        slope_deg: float = 10.0, window_deg: float = 1e-5) -> tuple[int, int]:
    """Swept cells of one dense ordered cloud where the port's slope test
    (f32 atan2 of the fma-form length, on the tensors' device) and the
    C++'s (f64 atan2 of the plain f32 sum of squares, stored to float)
    decide differently.  Returns (cells that differ, cells among them whose
    f64 angle lies farther than ``window_deg`` from the limit) — a
    difference inside the window is D2, one outside it is a fault."""
    dx, dy, dz, invalid = ground.slope_pairs(xyz[None], intensity[None], params)
    port = torch.rad2deg(torch.atan2(dz, ground._horizontal_length(dx, dy)))
    ss = dx * dx + dy * dy
    ref64 = torch.atan2(dz.double(), torch.sqrt(ss.double())) * (180.0 / math.pi)
    ref = ref64.float().double()
    differ = ~invalid & ((port.abs() <= slope_deg) != (ref.abs() <= slope_deg))
    far = differ & ((ref64.abs() - slope_deg).abs() > window_deg)
    return int(differ.sum()), int(far.sum())
