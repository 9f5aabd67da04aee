"""SE(3) helpers with the reference's exact conventions (host-side numpy;
the port of ``pctpu/geom/se3.py``).

The reference deliberately avoids ``Eigen::eulerAngles`` and uses a custom
ZYX extraction (reference/src/Utility.cpp:21-41, and the float copy at
reference/BatchTopPartRegistration.cpp:290-309).  Pose interpolation is
linear position + quaternion slerp with euler re-derived through that same
extraction (reference/include/Utility.h:51-71).  These run on the host
(pose tables are tiny); device-side rigid transforms live in
``pctpu_torch.ops.transform``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def is_rotation_matrix(r: np.ndarray, err: float = 1e-4) -> bool:
    """||R Rᵀ − I||_F < err (reference/src/Utility.cpp:11-19)."""
    r = np.asarray(r, np.float64)
    return bool(np.linalg.norm(r @ r.T - np.eye(3)) < err)


def rotation_matrix_to_euler_angles(r: np.ndarray) -> np.ndarray:
    """Custom euler extraction returning (roll, pitch, yaw).

    Matches reference/src/Utility.cpp:21-41: sy = hypot(R00, R10); in the
    non-singular branch roll = atan2(R21, R22), pitch = atan2(-R20, sy),
    yaw = atan2(R10, R00); singular branch (sy < 1e-6) uses
    roll = atan2(-R12, R11), yaw = 0.
    """
    r = np.asarray(r, np.float64)
    sy = np.sqrt(r[0, 0] * r[0, 0] + r[1, 0] * r[1, 0])
    if sy >= 1e-6:
        x = np.arctan2(r[2, 1], r[2, 2])
        y = np.arctan2(-r[2, 0], sy)
        z = np.arctan2(r[1, 0], r[0, 0])
    else:
        x = np.arctan2(-r[1, 2], r[1, 1])
        y = np.arctan2(-r[2, 0], sy)
        z = 0.0
    return np.array([x, y, z], np.float64)


def eigen_euler_angles_xyz(r: np.ndarray) -> np.ndarray:
    """Emulate ``Eigen::Matrix3d::eulerAngles(0, 1, 2)`` (Graphics Gems IV
    style), used only by the KITTI selector
    (reference/KittiPointCloudSelect.cpp:292) to fill the decorative
    roll/pitch/yaw CSV columns.  Returns (a0, a1, a2) with
    R = Rx(a0) @ Ry(a1) @ Rz(a2) and a0 in [0, pi]."""
    r = np.asarray(r, np.float64)
    # even permutation (0,1,2): odd=0, i=0, j=1, k=2
    res0 = np.arctan2(r[1, 2], r[2, 2])
    c2 = np.hypot(r[0, 0], r[0, 1])
    if res0 > 0:
        res0 -= np.pi
        res1 = np.arctan2(-r[0, 2], -c2)
    else:
        res1 = np.arctan2(-r[0, 2], c2)
    s1, c1 = np.sin(res0), np.cos(res0)
    res2 = np.arctan2(s1 * r[2, 0] - c1 * r[1, 0], c1 * r[1, 1] - s1 * r[2, 1])
    return -np.array([res0, res1, res2], np.float64)


def eigen_euler_angles_zyx(r: np.ndarray) -> np.ndarray:
    """Emulate ``Eigen::Matrix3d::eulerAngles(2, 1, 0)`` — the Oxford
    selector's LOCAL ``Pose6f::interpolate`` uses this Eigen call
    (reference/OxfordPointCloudSelect.cpp:84-99) where the shared
    Utility.h version deliberately avoids it, so interpolated Oxford
    keyframe poses carry Eigen's euler convention in the CSV.  Returns
    (yaw, pitch, roll) with R = Rz(yaw) @ Ry(pitch) @ Rx(roll) and
    yaw in [0, pi] — for headings with conventional yaw < 0 this is the
    ALTERNATE euler triple (all three angles differ from the custom
    extraction's), which still reconstructs the same rotation."""
    r = np.asarray(r, np.float64)
    # Eigen's generic Graphics-Gems path for the odd permutation (2,1,0):
    # odd=1, i=2, j=1, k=0 (see eigen_euler_angles_xyz for the even twin)
    res0 = np.arctan2(r[1, 0], r[0, 0])
    c2 = np.hypot(r[2, 2], r[2, 1])
    if res0 < 0:
        res0 += np.pi
        res1 = np.arctan2(-r[2, 0], -c2)
    else:
        res1 = np.arctan2(-r[2, 0], c2)
    s1, c1 = np.sin(res0), np.cos(res0)
    res2 = np.arctan2(s1 * r[0, 2] - c1 * r[1, 2], c1 * r[1, 1] - s1 * r[0, 1])
    return np.array([res0, res1, res2], np.float64)


def euler_zyx_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), the composition used by the Oxford
    selector (reference/OxfordPointCloudSelect.cpp:253-256)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], np.float64)
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], np.float64)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float64)
    return rz @ ry @ rx


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
    then every entry as ``cofactor(i, j) * invdet`` — each cofactor a 2×2
    f32 cross-difference.  numpy's ``linalg.inv`` (LAPACK LU) rounds
    differently at the ulp level, which is visible in the report's 6
    significant digits on boundary values.  (Assumes Eigen's scalar/SSE
    path — two-op mul+add, no FMA contraction — the reference's default
    build.)"""
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
    left-to-right f32 sum ``((a_i0·b_0j + a_i1·b_1j) + a_i2·b_2j)`` (lazy
    product of small fixed-size matrices).  numpy routes even 3×3 through
    BLAS, whose accumulation order/FMA use is unspecified."""
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


def quat_from_matrix(r: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion (w, x, y, z), Shepperd's method.

    Matches Eigen's ``Quaterniond(Matrix3d)`` up to the global sign, which is
    irrelevant because slerp below takes the shortest path.
    """
    r = np.asarray(r, np.float64)
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2.0
        w = (r[2, 1] - r[1, 2]) / s
        x = 0.25 * s
        y = (r[0, 1] + r[1, 0]) / s
        z = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2.0
        w = (r[0, 2] - r[2, 0]) / s
        x = (r[0, 1] + r[1, 0]) / s
        y = 0.25 * s
        z = (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2.0
        w = (r[1, 0] - r[0, 1]) / s
        x = (r[0, 2] + r[2, 0]) / s
        y = (r[1, 2] + r[2, 1]) / s
        z = 0.25 * s
    # Eigen's Quaterniond(Matrix3d) conversion does NOT renormalize; for
    # CSV-roundtripped (only ~1e-6-orthonormal) matrices an extra normalize
    # would shift components by several f32 ulps vs the reference
    return np.array([w, x, y, z], np.float64)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) → rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def quat_slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Shortest-path slerp, matching ``Eigen::Quaternion::slerp`` semantics
    (used by Pose6f::interpolate, reference/include/Utility.h:59)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    d = float(np.dot(q0, q1))
    abs_d = abs(d)
    one_minus_eps = 1.0 - np.finfo(np.float64).eps
    if abs_d >= one_minus_eps:
        scale0, scale1 = 1.0 - t, t
    else:
        theta = np.arccos(abs_d)
        sin_theta = np.sin(theta)
        scale0 = np.sin((1.0 - t) * theta) / sin_theta
        scale1 = np.sin(t * theta) / sin_theta
    if d < 0:
        scale1 = -scale1
    # like Eigen, no renormalization of the result
    return scale0 * q0 + scale1 * q1


@dataclasses.dataclass
class Pose6f:
    """6-DoF pose record (reference/include/Utility.h:38-77).

    Positions/angles are kept as float32 to match the reference struct; the
    rotation matrix and quaternion stay float64 like the Eigen doubles.
    """

    x: float
    y: float
    z: float
    roll: float
    pitch: float
    yaw: float
    rotation_matrix: np.ndarray
    rotation_quat: np.ndarray  # (w, x, y, z)

    @classmethod
    def from_matrix(cls, rotation: np.ndarray, translation: np.ndarray) -> "Pose6f":
        euler = rotation_matrix_to_euler_angles(rotation)
        return cls(
            x=np.float32(translation[0]),
            y=np.float32(translation[1]),
            z=np.float32(translation[2]),
            roll=np.float32(euler[0]),
            pitch=np.float32(euler[1]),
            yaw=np.float32(euler[2]),
            rotation_matrix=np.asarray(rotation, np.float64),
            rotation_quat=quat_from_matrix(rotation),
        )

    def position(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z], np.float32)


def interpolate_pose(
    pose_a: Pose6f, pose_b: Pose6f, ratio: float, euler: str = "utility"
) -> Pose6f:
    """Linear position + quaternion slerp, euler re-derived per ``euler``:

    - ``"utility"`` — the custom extraction (Utility.h:51-71, the MulRan
      path; the reference comments out the Eigen call there);
    - ``"eigen_zyx"`` — ``rotation_matrix.eulerAngles(2,1,0)`` with
      (yaw, pitch, roll) = the returned triple, the Oxford selector's LOCAL
      ``Pose6f::interpolate`` (reference/OxfordPointCloudSelect.cpp:
      84-99).  For interpolated headings with conventional yaw < 0 the two
      conventions give entirely different roll/pitch/yaw CSV columns (the
      rotation matrix columns agree).

    The position mix promotes to double like the C++ (`x` is a float but
    `ratio` is a double, so ``x*(1-ratio) + pose_2.x*ratio`` is f64 math
    with ONE final rounding into the float field, Utility.h:55-57) — an
    all-f32 mix diverges on ~44% of random inputs, enough to flip keyframes
    near the distance gate.
    """
    ratio = float(ratio)
    x = np.float32(np.float64(pose_a.x) * (1.0 - ratio) + np.float64(pose_b.x) * ratio)
    y = np.float32(np.float64(pose_a.y) * (1.0 - ratio) + np.float64(pose_b.y) * ratio)
    z = np.float32(np.float64(pose_a.z) * (1.0 - ratio) + np.float64(pose_b.z) * ratio)
    quat = quat_slerp(pose_a.rotation_quat, pose_b.rotation_quat, ratio)
    rotation = quat_to_matrix(quat)
    if euler == "utility":
        e = rotation_matrix_to_euler_angles(rotation)
        roll, pitch, yaw = e[0], e[1], e[2]
    elif euler == "eigen_zyx":
        e = eigen_euler_angles_zyx(rotation)
        yaw, pitch, roll = e[0], e[1], e[2]
    else:
        raise ValueError(f"euler must be 'utility' or 'eigen_zyx', got {euler!r}")
    return Pose6f(
        x=x,
        y=y,
        z=z,
        roll=np.float32(roll),
        pitch=np.float32(pitch),
        yaw=np.float32(yaw),
        rotation_matrix=rotation,
        rotation_quat=quat,
    )


def pose_distance(pose_a: Pose6f, pose_b: Pose6f) -> float:
    """Euclidean 3-D pose distance in float32
    (reference/src/Utility.cpp:43-49)."""
    dx = np.float32(pose_a.x) - np.float32(pose_b.x)
    dy = np.float32(pose_a.y) - np.float32(pose_b.y)
    dz = np.float32(pose_a.z) - np.float32(pose_b.z)
    return float(np.sqrt(dx * dx + dy * dy + dz * dz, dtype=np.float32))
