"""Rigid transforms of points (the port of ``pctpu/ops/transform.py``)."""

from __future__ import annotations

import torch


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
