"""The reference's BEV chain as an independent native oracle, for checks on
the card: ``native/ref_oracle.cpp``'s ``pctpu_ref_preprocess`` (ordering,
ground marking with the C++'s f64 slope, both BEV rasters),
``pctpu_ref_float_bev`` (saveAsMat's 201² float BEV) and
``pctpu_ref_top_flatten`` (extractTopAndFlatten in the reference's order),
built with ``g++ -O2 -std=c++14 -ffp-contract=off`` into
``build/pctpu_torch/`` and bound with ctypes; the D2 analysis that
attributes a difference from it to the slope test's f32/f64 knife edge;
and the plain-loop oracle ``tests/ref_impl.py`` (numpy only), loaded from
the checkout by path, like the C++ source."""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import math
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from pctpu_torch.ops import ground

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "ref_oracle.cpp"
_NN_SRC = Path(__file__).resolve().parent / "ref_nn.c"
_REF_IMPL = _REPO / "tests" / "ref_impl.py"
BUILD_DIR = _REPO / "build" / "pctpu_torch"
BEV_LAYERS, BEV_SIZE = 24, 224


def _build(src: Path, name: str, flags: list[str]) -> ctypes.CDLL:
    """Compile ``src`` once per source hash into ``BUILD_DIR`` and load it."""
    out = BUILD_DIR / f"lib{name}_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".build{os.getpid()}.so")
        subprocess.run([*flags, "-shared", "-fPIC", "-o", str(tmp), str(src), "-lm"],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def load() -> ctypes.CDLL:
    """Build (once per source) and load the oracle library."""
    lib = _build(_SRC, "ref_oracle", ["g++", "-O2", "-std=c++14", "-ffp-contract=off"])
    p, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.pctpu_ref_preprocess.argtypes = [p, p, p, p, p, ctypes.c_int64, i32, i32, i32,
                                         ctypes.c_float, p, p, p, p]
    lib.pctpu_ref_preprocess.restype = ctypes.c_int
    lib.pctpu_ref_float_bev.argtypes = [p, p, ctypes.c_int64, i32, p]
    lib.pctpu_ref_float_bev.restype = ctypes.c_int
    lib.pctpu_ref_top_flatten.argtypes = [p, p, ctypes.c_int64, p, ctypes.c_int64]
    lib.pctpu_ref_top_flatten.restype = ctypes.c_int64
    return lib


def preprocess(lib: ctypes.CDLL, data: dict, params, ordered: bool = False) -> tuple:
    """One raw cloud (a PCD field dict, in file order) through the oracle:
    (labels (G,) i32, multi (24, 224, 224) u8, single (224, 224) u8), and
    with ``ordered`` the dense grid's xyz (G, 3) f32 after them."""
    n = len(data["x"])
    xyz = np.ascontiguousarray(np.stack([data["x"], data["y"], data["z"]], 1), np.float32)
    inten = np.ascontiguousarray(data["intensity"], np.float32)
    row = np.ascontiguousarray(data["row"], np.int32)
    col = np.ascontiguousarray(data["col"], np.int32)
    label = np.ascontiguousarray(data["label"], np.int32)
    labels = np.empty(params.grid_size, np.int32)
    multi = np.empty((BEV_LAYERS, BEV_SIZE, BEV_SIZE), np.uint8)
    single = np.empty((BEV_SIZE, BEV_SIZE), np.uint8)
    grid_xyz = np.empty((params.grid_size, 3), np.float32) if ordered else None
    rc = lib.pctpu_ref_preprocess(
        xyz.ctypes.data, inten.ctypes.data, row.ctypes.data, col.ctypes.data,
        label.ctypes.data, n, params.n_scan, params.horizon_scan, params.ground_upper_scan,
        params.height_res, labels.ctypes.data, multi.ctypes.data, single.ctypes.data,
        None if grid_xyz is None else grid_xyz.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"pctpu_ref_preprocess failed: {rc}")
    return (labels, multi, single) if grid_xyz is None else (labels, multi, single, grid_xyz)


def float_bev(lib: ctypes.CDLL, xyz: np.ndarray, label: np.ndarray,
              filter_ground: bool) -> np.ndarray:
    """One cloud's saveAsMat float BEV (reference/BatchCloudManip.cpp:201-239)
    by the oracle: (201, 201) f32, max of z + 2 from 0, ground skipped with
    ``filter_ground``.  Its ``v > out`` never stores a NaN."""
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    label = np.ascontiguousarray(label, np.int32)
    out = np.empty(201 * 201, np.float32)
    rc = lib.pctpu_ref_float_bev(xyz.ctypes.data, label.ctypes.data, len(xyz),
                                 1 if filter_ground else 0, out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"pctpu_ref_float_bev failed: {rc}")
    return out.reshape(201, 201)


def top_flatten(lib: ctypes.CDLL, xyz: np.ndarray, label: np.ndarray) -> np.ndarray:
    """extractTopAndFlatten by the oracle: the kept points (k, 3) f32, z = 0,
    in the reference's order (cells in turn, each by z descending, ties in
    input order)."""
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    label = np.ascontiguousarray(label, np.int32)
    cap = max(len(xyz), 1)
    out = np.empty((cap, 3), np.float32)
    k = lib.pctpu_ref_top_flatten(xyz.ctypes.data, label.ctypes.data, len(xyz),
                                  out.ctypes.data, cap)
    if k < 0:
        raise RuntimeError("pctpu_ref_top_flatten overflowed its output")
    return out[:k]


_nn_lib: ctypes.CDLL | None = None


def _nn_library() -> ctypes.CDLL:
    global _nn_lib
    if _nn_lib is None:
        lib = _build(_NN_SRC, "ref_nn", ["gcc", "-O2", "-fno-builtin", "-ffp-contract=off"])
        p = ctypes.c_void_p
        lib.pctpu_ref_nn_1.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_float, p]
        lib.pctpu_ref_nn_1.restype = ctypes.c_int64
        _nn_lib = lib
    return _nn_lib


class NnLoop:
    """``ref_impl._nn_1_ref`` by its C transcription (``ref_nn.c``, built
    with ``gcc -O2 -fno-builtin -ffp-contract=off``): the same f32 terms
    (libm's ``powf`` squares, as numpy's f32 scalar power), the same sums
    and the first strict minimum, ``(0, inf)`` when none wins.  It keeps the
    last mask object's bytes: ``icp_ref`` passes one list for every query of
    a pass and never changes it, and converting it is half the cost — a
    mask object passed again must not have changed in between."""

    def __init__(self) -> None:
        self._mask: tuple = (None, None)  # replaced whole: threads never mix two masks

    def __call__(self, q, target, target_ok) -> tuple[int, float]:
        lib = _nn_library()
        q = np.ascontiguousarray(q, np.float32)
        t = np.ascontiguousarray(target, np.float32).reshape(-1, 3)
        seen, ok = self._mask
        if target_ok is not seen:
            ok = np.ascontiguousarray(np.asarray(target_ok, bool).view(np.uint8))
            self._mask = (target_ok, ok)
        if len(ok) != len(t):
            raise ValueError(f"{len(ok)} mask entries for {len(t)} targets")
        d = ctypes.c_double()
        j = lib.pctpu_ref_nn_1(q.ctypes.data, t.ctypes.data, ok.ctypes.data, len(t), 2.0,
                               ctypes.byref(d))
        return int(j), d.value


_ref_modules: dict[bool, object] = {}


def ref_impl(c_nn: bool = True):
    """The plain-loop oracle ``tests/ref_impl.py`` (numpy only), loaded by
    path from the checkout.  With ``c_nn`` (a module copy of its own) its
    1-NN loop ``_nn_1_ref`` — 99% of the ICP oracles' time — is an
    :class:`NnLoop`, its C transcription, which returns the same index and
    the same d² (``tests/test_torch_fuzz_campaign.py`` holds the two equal,
    and the campaign checks it again where it runs); every other function
    is the file's own."""
    if c_nn not in _ref_modules:
        spec = importlib.util.spec_from_file_location(
            f"pctpu_torch_ref_impl{'_c_nn' if c_nn else ''}", _REF_IMPL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if c_nn:
            mod._nn_1_ref = NnLoop()
        _ref_modules[c_nn] = mod
    return _ref_modules[c_nn]


def slope_decisions(xyz: torch.Tensor, intensity: torch.Tensor, params,
                    slope_deg: float = 10.0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The port's slope test on the tensors' device for every swept cell of
    one dense ordered cloud: (passes (R, H) bool, the C++'s f64 angle in
    degrees, invalid pair)."""
    dx, dy, dz, invalid = ground.slope_pairs(xyz[None], intensity[None], params)
    port = torch.rad2deg(torch.atan2(dz, ground._horizontal_length(dx, dy)))
    ss = dx * dx + dy * dy
    ref64 = torch.atan2(dz.double(), torch.sqrt(ss.double())) * (180.0 / math.pi)
    return (port.abs() <= slope_deg)[0], ref64[0], invalid[0]


def slope_flips(card: tuple, cpu: tuple, params, slope_deg: float = 10.0,
                window_deg: float = 1e-5) -> tuple[int, int]:
    """Swept cells where the port's slope test decides differently on two
    devices, for one dense ordered cloud given on each as (xyz, intensity).
    Returns (cells that differ, cells among them whose f64 angle lies
    farther than ``window_deg`` from the limit): D2 explains the first only
    when the second is 0."""
    ok_a, ref64, invalid = slope_decisions(*card, params, slope_deg)
    ok_b = slope_decisions(*cpu, params, slope_deg)[0].to(ok_a.device)
    differ = ~invalid & (ok_a != ok_b)
    far = differ & ((ref64.abs() - slope_deg).abs() > window_deg)
    return int(differ.sum()), int(far.sum())


def slope_disagreements(xyz: torch.Tensor, intensity: torch.Tensor, params,
                        slope_deg: float = 10.0, window_deg: float = 1e-5) -> tuple[int, int]:
    """Swept cells of one dense ordered cloud where the port's slope test
    (f32 atan2 of the fma-form length, on the tensors' device) and the
    C++'s (f64 atan2 of the plain f32 sum of squares, stored to float)
    decide differently.  Returns (cells that differ, cells among them whose
    f64 angle lies farther than ``window_deg`` from the limit) — a
    difference inside the window is D2, one outside it is a fault."""
    port_ok, ref64, invalid = slope_decisions(xyz, intensity, params, slope_deg)
    ref = ref64.float().double()
    differ = ~invalid & (port_ok != (ref.abs() <= slope_deg))
    far = differ & ((ref64.abs() - slope_deg).abs() > window_deg)
    return int(differ.sum()), int(far.sum())
