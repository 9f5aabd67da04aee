"""Build, load and count the hand-written CUDA kernels (``pctpu_torch/csrc``).

The kernels are compiled at first use by ``nvcc`` into one shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds.  The library lands in ``build/pctpu_torch/`` of the
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
SOURCES = (_PKG / "csrc" / "nn_pruned.cu", _PKG / "csrc" / "segment_sum.cu")
BUILD_DIR = _PKG.parent / "build" / "pctpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

launch_counts: dict[str, int] = {"nn_pruned": 0, "segment_sum4": 0}

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


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpctpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.pctpu_nn_pruned.argtypes = [
            p, p, i64, p, p, i64, p, i64, p, i64, ctypes.c_float, p, p, p,
        ]
        lib.pctpu_nn_pruned.restype = ctypes.c_int
        lib.pctpu_segment_sum4.argtypes = [p, p, i64, p, p]
        lib.pctpu_segment_sum4.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    launch_counts[name] += 1


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
