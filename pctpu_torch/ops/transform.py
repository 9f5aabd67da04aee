"""Rigid transforms of points (the port of ``pctpu/ops/transform.py``).

Replaces ``pcl::transformPointCloud`` (reference/CloudManip.cpp:128): one
(N, 3) @ (3, 3) product plus the translation.  Its rounding depends on how
pctpu reaches it.  Inside a jit (the registration steps) XLA's CPU backend
compiles the product into torch's CPU fma chain, which ``transform_xyz``
computes.  Called eagerly (cloud_manip), the dot rounds each product and
each sum in the first two output columns, and the yaw matrix's third row
makes the third column the same: ``transform_cloud`` computes that form
with separate elementwise products and sums, which round the same way on
any device.  ``make_rigid_transform``
takes its cosine and sine from the C library's ``cosf`` / ``sinf``, which
is what XLA's CPU backend calls for pctpu's scalar ``jnp.cos`` /
``jnp.sin``: torch's f32 ``cos``, an f64 cosine rounded to f32 and numpy's
f32 ``cos`` each differ from it in the last bit for some angles."""

from __future__ import annotations

import ctypes
import ctypes.util

import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.ops.rounding import x86_nan

_libm: ctypes.CDLL | None = None


def transform_xyz(xyz: torch.Tensor, matrix4: torch.Tensor) -> torch.Tensor:
    """Apply a homogeneous 4x4 to (..., 3) points in full f32 (TF32 is off
    package-wide, see ``pctpu_torch/__init__.py``); a batch of matrices
    (B, 4, 4) moves a batch of clouds (B, N, 3), cloud b by matrix b."""
    matrix4 = matrix4.to(torch.float32)
    rot_t = matrix4[..., :3, :3].transpose(-1, -2)
    # bmm is the kernel matmul reaches for a batch, minus its reshapes: the
    # ICP loop calls this every iteration and pays for each op on the host
    rotated = torch.bmm(xyz, rot_t) if matrix4.dim() == 3 else torch.matmul(xyz, rot_t)
    return rotated + matrix4[..., None, :3, 3]


def transform_xyz_rounded(xyz: torch.Tensor, matrix4: torch.Tensor) -> torch.Tensor:
    """(..., 3) points moved by a 4x4 with every product and sum rounded
    to f32 in turn: ((x·m[i,0] + y·m[i,1]) + z·m[i,2]) + m[i,3], each NaN
    with the bits x86 gives it at that step (``rounding.x86_nan``).  Bit-equal to pctpu's eager
    ``transform_xyz`` for a matrix whose third row is (0, 0, 1, tz)
    (``make_rigid_transform``'s; README D20 for others, D21 for points with
    differently signed NaN coordinates)."""
    m = matrix4.to(device=xyz.device, dtype=torch.float32)
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]

    def mul(a, b):
        return x86_nan(a * b, a, b)

    def add(a, b):
        return x86_nan(a + b, a, b)

    return add(add(add(mul(x, m[:3, 0]), mul(y, m[:3, 1])), mul(z, m[:3, 2])), m[:3, 3])


def transform_cloud(cloud: Cloud, matrix4: torch.Tensor) -> Cloud:
    """The cloud with every slot's xyz moved by ``matrix4`` (taken to the
    cloud's device), rounded as pctpu's eager call rounds it."""
    return cloud.replace(xyz=transform_xyz_rounded(cloud.xyz, matrix4))


def _cos_sin_f32(angle: float) -> tuple[float, float]:
    """``cosf`` and ``sinf`` of ``angle`` rounded to f32, from the C
    library."""
    global _libm
    if _libm is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        for name in ("cosf", "sinf"):
            getattr(lib, name).argtypes = [ctypes.c_float]
            getattr(lib, name).restype = ctypes.c_float
        _libm = lib
    return _libm.cosf(angle), _libm.sinf(angle)


def make_rigid_transform(tx: float, ty: float, tz: float, yaw_rad: float) -> torch.Tensor:
    """Translation + yaw, the cloud_manip argv transform
    (reference/CloudManip.cpp:119-128): a (4, 4) f32 tensor on the CPU,
    bit-equal to pctpu's."""
    c, s = _cos_sin_f32(yaw_rad)
    return torch.tensor(
        [[c, -s, 0, tx], [s, c, 0, ty], [0, 0, 1, tz], [0, 0, 0, 1]], dtype=torch.float32
    )
