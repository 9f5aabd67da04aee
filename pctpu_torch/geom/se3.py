"""Host-side SE(3) helpers the registration and BEV pipelines need, with
the reference's exact arithmetic — copied from ``pctpu/geom/se3.py``."""

from __future__ import annotations

import dataclasses

import numpy as np


def yaw_rotation_4x4(yaw_rad: float) -> np.ndarray:
    """Homogeneous pure-yaw rotation, the ICP initial guess construction
    (reference/BatchTopPartRegistration.cpp:416-422)."""
    t = np.eye(4, dtype=np.float64)
    c, s = np.cos(yaw_rad), np.sin(yaw_rad)
    t[0, 0], t[0, 1] = c, -s
    t[1, 0], t[1, 1] = s, c
    return t


def eigen_inverse3_f32(m: np.ndarray) -> np.ndarray:
    """3×3 float inverse with Eigen's exact arithmetic
    (``Eigen::Matrix3f::inverse()``, the cofactor expansion of
    Inverse_size3 — used by the precision-report relative rotation,
    reference/BatchTopPartRegistration.cpp:516).

    Eigen computes the first adjugate column, the determinant as the
    left-to-right f32 sum of its product with column 0, ``invdet = 1/det``,
    then every entry as ``cofactor(i, j) * invdet``.  numpy's
    ``linalg.inv`` (LAPACK LU) rounds differently at the ulp level, which is
    visible in the report's 6 significant digits on boundary values."""
    m = np.asarray(m, np.float32)

    def cof(i: int, j: int) -> np.float32:
        i1, i2, j1, j2 = (i + 1) % 3, (i + 2) % 3, (j + 1) % 3, (j + 2) % 3
        return np.float32(m[i1, j1] * m[i2, j2] - m[i1, j2] * m[i2, j1])

    c0, c1, c2 = cof(0, 0), cof(1, 0), cof(2, 0)
    det = np.float32(np.float32(c0 * m[0, 0] + c1 * m[1, 0]) + c2 * m[2, 0])
    invdet = np.float32(np.float32(1.0) / det)
    out = np.empty((3, 3), np.float32)
    for i in range(3):
        for j in range(3):
            out[j, i] = np.float32(cof(i, j) * invdet)
    return out


def matmul3_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """3×3 float product with Eigen's coefficient order: each entry is the
    left-to-right f32 sum ``((a_i0·b_0j + a_i1·b_1j) + a_i2·b_2j)``."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    out = np.empty((3, 3), np.float32)
    for i in range(3):
        for j in range(3):
            out[i, j] = np.float32(
                np.float32(a[i, 0] * b[0, j] + a[i, 1] * b[1, j])
                + a[i, 2] * b[2, j]
            )
    return out


@dataclasses.dataclass
class Pose6f:
    """The part of the 6-DoF pose record (reference/include/Utility.h:38-77)
    that batch_multi_bev_gen reads: the position, float32 like the reference
    struct, and the rotation matrix as the Eigen doubles.  pctpu's euler
    angles and quaternion are read by no ported tool yet."""

    x: float
    y: float
    z: float
    rotation_matrix: np.ndarray

    @classmethod
    def from_matrix(cls, rotation: np.ndarray, translation: np.ndarray) -> "Pose6f":
        return cls(
            x=np.float32(translation[0]),
            y=np.float32(translation[1]),
            z=np.float32(translation[2]),
            rotation_matrix=np.asarray(rotation, np.float64),
        )
