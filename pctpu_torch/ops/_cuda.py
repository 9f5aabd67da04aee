"""Build, load and count the hand-written CUDA kernels (``pctpu_torch/csrc``).

The kernels are compiled at first use by ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  The library lands in ``build/pctpu_torch/`` of the
checkout under a name carrying a hash of the sources and flags, so it is
rebuilt only when they change.  Nothing here runs at import: a CPU-only
machine never calls ``nvcc``.

``launch_counts`` counts kernel launches by name; each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / f for f in (
    "nn_pruned_warp.cu", "nn_variant.cu", "nn_pruned.cu", "segment_sum.cu", "nn_fused.cu",
    "bev_raster.cu", "pca_moments.cu"))
BUILD_DIR = _PKG.parent / "build" / "pctpu_torch"

# the (TQ, TT, MODE) instances of the argmin and tile-shape variants
# (MODE: 0 prod, 1 explicit2, 2 64-bit key, 3 bf16): every tile shape in
# prod, and each other argmin body at (256, 1024).  The build instantiates
# exactly these in both designs — csrc/nn_variant.cu (pctpu_nn_variant) and
# the first, csrc/nn_pruned.cu (pctpu_nn_variant_v1) — through the
# NN_INSTANCES macro of a generated header, so this is the only list.
NN_INSTANCES = (
    (128, 1024, 0), (256, 1024, 0), (256, 2048, 0), (256, 4096, 0), (512, 1024, 0),
    (512, 2048, 0), (1024, 1024, 0), (1024, 2048, 0), (512, 4096, 0),
    (256, 1024, 1), (256, 1024, 2), (256, 1024, 3),
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launch_counts: dict[str, int] = {
    "nn_prep": 0, "nn_pruned": 0, "nn_pruned_count": 0, "nn_prep_batched": 0,
    "nn_pruned_batched": 0, "nn_pruned_batched_v1": 0, "segment_sum4": 0, "nn_fused": 0,
    "nn_variant": 0, "nn_variant_prep": 0, "nn_variant_v1": 0, "ground_sums": 0, "bev_raster": 0, "segment_sum_walk": 0,
    "nn_fused_v1": 0, "bev_raster_v1": 0, "pca_moments": 0,
}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _instances_header() -> str:
    # a header, not -D: nvcc splits a -D value at its commas
    entries = " ".join(f"X({tq}, {tt}, {mode})" for tq, tt, mode in NN_INSTANCES)
    return f"#define NN_INSTANCES {entries}\n"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_instances_header().encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpctpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise on the first that fails.  Returns
    their joined output (ptxas's register and spill report)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}")
    return "".join(outs)


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists:
    one nvcc per source, all started together, then one link.  ptxas's
    report lands beside the library as ``<library>.ptxas.txt``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    header = BUILD_DIR / f"nn_instances.{tag}.h"
    header.write_text(_instances_header())
    report = _run_all([[_nvcc(), *NVCC_FLAGS, "-include", str(header), "-c", "-o", str(o),
                        str(src)] for o, src in zip(objs, SOURCES)])
    tmp = out.with_suffix(f".{tag}.so")
    _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in (*objs, header):
        o.unlink()
    out.with_suffix(".ptxas.txt").write_text(report)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.pctpu_nn_prep.argtypes = [p, p, i64, p, p, p, p]
        lib.pctpu_nn_prep.restype = ctypes.c_int
        lib.pctpu_nn_pruned.argtypes = [
            p, p, i64, p, p, p, i64, ctypes.c_float, p, p, p, p, p,
        ]
        lib.pctpu_nn_pruned.restype = ctypes.c_int
        lib.pctpu_nn_prep_batched.argtypes = [p, p, i64, i64, p, p, p, p]
        lib.pctpu_nn_prep_batched.restype = ctypes.c_int
        lib.pctpu_nn_pruned_batched.argtypes = [
            p, p, i64, i64, p, p, p, i64, i64, ctypes.c_float, p, p, p, p, p,
        ]
        lib.pctpu_nn_pruned_batched.restype = ctypes.c_int
        lib.pctpu_nn_pruned_batched_v1.argtypes = [
            p, p, i64, i64, p, p, p, i64, i64, ctypes.c_float, p, p, p, p,
        ]
        lib.pctpu_nn_pruned_batched_v1.restype = ctypes.c_int
        lib.pctpu_nn_variant_prep.argtypes = [p, p, i64, i64, ctypes.c_int, p, p, p, p]
        lib.pctpu_nn_variant_prep.restype = ctypes.c_int
        lib.pctpu_nn_variant.argtypes = [
            p, p, i64, p, p, p, i64, i64, i64, ctypes.c_int, ctypes.c_float, p, p, p, p, p,
        ]
        lib.pctpu_nn_variant.restype = ctypes.c_int
        lib.pctpu_nn_variant_v1.argtypes = [
            p, p, i64, p, p, i64, p, i64, p, i64, ctypes.c_int, ctypes.c_float,
            p, p, p,
        ]
        lib.pctpu_nn_variant_v1.restype = ctypes.c_int
        lib.pctpu_nn_fused.argtypes = [p, i64, p, p, i64, p, p, p, ctypes.c_int, p]
        lib.pctpu_nn_fused.restype = ctypes.c_int
        lib.pctpu_nn_fused_splits.argtypes = [i64, i64, ctypes.c_int]
        lib.pctpu_nn_fused_splits.restype = ctypes.c_int
        lib.pctpu_nn_fused_v1.argtypes = [p, i64, p, p, i64, p, p, p]
        lib.pctpu_nn_fused_v1.restype = ctypes.c_int
        f, i32 = ctypes.c_float, ctypes.c_int
        for fn in (lib.pctpu_segment_sum, lib.pctpu_segment_sum_walk):
            fn.argtypes = [p, p, p, i64, i32, f, f, f, f, p, i64, i32, p]
            fn.restype = ctypes.c_int
        lib.pctpu_bev_raster.argtypes = [
            p, p, p, i64, i64, i32, i32, f, f, f, f, f, f, p, p, p, p, p,
        ]
        lib.pctpu_bev_raster.restype = ctypes.c_int
        lib.pctpu_bev_raster_v1.argtypes = [
            p, p, p, i64, i64, i32, i32, f, f, f, f, f, f, p, p, p, p, p, p,
        ]
        lib.pctpu_bev_raster_v1.restype = ctypes.c_int
        lib.pctpu_pca_moments.argtypes = [p, p, i64, p, p, p]
        lib.pctpu_pca_moments.restype = ctypes.c_int
        lib.pctpu_pca_moments_scratch_words.argtypes = [i64]
        lib.pctpu_pca_moments_scratch_words.restype = i64
        _lib = lib
    return _lib


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw pointer.  The raw
    getter skips building a ``Stream`` object, some microseconds a launch;
    a torch without it takes the public way."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    launch_counts[name] += 1


def require_card(device: torch.device, what: str) -> None:
    """Raise unless ``device`` is a CUDA card: ``what`` launches kernels and
    has no CPU mode."""
    if device.type != "cuda":
        raise ValueError(f"{what} need CUDA tensors, got {device}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Validate a tensor before its pointer goes to a kernel (-1 in
    ``shape`` matches any size)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
        s != -1 and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
