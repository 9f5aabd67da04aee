"""Rigid transforms of points (the port of ``pctpu/ops/transform.py``)."""

from __future__ import annotations

import torch


def transform_xyz(xyz: torch.Tensor, matrix4: torch.Tensor) -> torch.Tensor:
    """Apply a homogeneous 4x4 to (..., 3) points in full f32 (TF32 is off
    package-wide, see ``pctpu_torch/__init__.py``)."""
    matrix4 = matrix4.to(torch.float32)
    return torch.matmul(xyz, matrix4[:3, :3].T) + matrix4[:3, 3]
