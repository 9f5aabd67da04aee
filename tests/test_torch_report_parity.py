"""The registration report arithmetic and the guess-angle chain of
pctpu_torch against pctpu's, on the CPU: the port's copies of the nine
cases of ``tests/test_report_parity.py``
(reference/BatchTopPartRegistration.cpp:290-309, 416-425, 512-527).

Each case runs pctpu's function and the port's on the same inputs: the
results are bit-equal wherever pctpu's test asserts equality, and each is
held to pctpu's own assertions."""

import math

import numpy as np
import pytest

from pctpu.geom import se3 as jse3
from pctpu.pipelines import registration as jreg
from pctpu_torch.geom import se3 as tse3
from pctpu_torch.pipelines import registration as treg


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def test_guess_angle_reference_f32_chain():
    """angle/180.0f in f32 before the double ·M_PI promotion, and the +180°
    guess added in f32 first."""
    a = 123.456
    expected = float(np.float32(np.float32(a) / np.float32(180.0))) * math.pi
    expected2 = (float(np.float32((np.float32(a) + np.float32(180.0)) / np.float32(180.0)))
                 * math.pi)
    for mod in (jreg, treg):
        assert mod._guess_angle_rad(a) == expected
        assert mod._guess_angle_rad(a) != a / 180.0 * math.pi
        assert mod._guess_angle_rad(a, 180.0) == expected2
        assert mod._guess_angle_rad(90.0) == 90.0 / 180.0 * math.pi
    g, jg = treg._guess_pair_np(a), jreg._guess_pair_np(a)
    assert g.dtype == np.float32 and g.shape == (2, 4, 4)
    np.testing.assert_array_equal(_bits(g), _bits(jg))
    np.testing.assert_array_equal(g[0], tse3.yaw_rotation_4x4(expected).astype(np.float32))
    np.testing.assert_array_equal(g[1], tse3.yaw_rotation_4x4(expected2).astype(np.float32))
    for angle in (0.0, 17.0, -45.5, 179.999, 359.0, 1e-3):
        np.testing.assert_array_equal(_bits(treg._guess_pair_np(angle)),
                                      _bits(jreg._guess_pair_np(angle)))


def test_match_results_parse_to_f32(tmp_path):
    path = tmp_path / "match.txt"
    path.write_text("0 1 123.456\n2 3 -45.0\n")
    got, want = treg.load_match_results(str(path)), jreg.load_match_results(str(path))
    # the reference stores a C float (ss >> float); 123.456 is not f32-exact
    assert got[0].angle_guess == float(np.float32("123.456")) != 123.456
    assert got[1].angle_guess == -45.0
    assert [(m.query_idx, m.match_idx, m.angle_guess) for m in got] == \
        [(m.query_idx, m.match_idx, m.angle_guess) for m in want]


def test_eigen_inverse3_f32_inverts():
    rng = np.random.default_rng(0)
    for _ in range(50):
        m = rng.standard_normal((3, 3)).astype(np.float32)
        if abs(np.linalg.det(m.astype(np.float64))) < 1e-2:
            continue
        inv = tse3.eigen_inverse3_f32(m)
        assert inv.dtype == np.float32
        np.testing.assert_array_equal(_bits(inv), _bits(jse3.eigen_inverse3_f32(m)))
        np.testing.assert_allclose(tse3.matmul3_f32(inv, m), np.eye(3, dtype=np.float32),
                                   atol=5e-5)
        np.testing.assert_allclose(inv, np.linalg.inv(m.astype(np.float64)), rtol=1e-4,
                                   atol=1e-5)


def test_matmul3_f32_matches_reference_order():
    a = np.float32([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    b = np.float32([[9, 8, 7], [6, 5, 4], [3, 2, 1]])
    out = tse3.matmul3_f32(a, b)
    np.testing.assert_array_equal(out, (a.astype(np.float64) @ b).astype(np.float32))
    expected00 = np.float32(np.float32(np.float32(1) * np.float32(9)
                                       + np.float32(2) * np.float32(6))
                            + np.float32(3) * np.float32(3))
    assert out[0, 0] == expected00
    # inexact operands: the left-to-right f32 order, bit for bit
    rng = np.random.default_rng(1)
    for _ in range(200):
        x = rng.standard_normal((3, 3)).astype(np.float32)
        y = rng.standard_normal((3, 3)).astype(np.float32)
        np.testing.assert_array_equal(_bits(tse3.matmul3_f32(x, y)),
                                      _bits(jse3.matmul3_f32(x, y)))


def test_pair_precision_reference_arithmetic():
    t_coarse = tse3.yaw_rotation_4x4(math.radians(30.0)).astype(np.float32)
    t_coarse[0, 3], t_coarse[1, 3] = 1.25, -0.5
    t_fine = tse3.yaw_rotation_4x4(math.radians(30.25)).astype(np.float32)
    t_fine[0, 3], t_fine[1, 3] = 1.5, -0.25
    diff_xy, diff_yaw = treg._pair_precision(t_coarse, t_fine)
    assert (diff_xy, diff_yaw) == jreg._pair_precision(t_coarse, t_fine)
    assert diff_xy == float(np.float32(diff_xy))
    assert diff_yaw == float(np.float32(diff_yaw))
    assert abs(diff_xy - math.hypot(0.25, 0.25)) < 1e-6
    assert abs(diff_yaw - (-0.25)) < 1e-4
    assert treg._pair_precision(t_fine, t_fine) == (0.0, 0.0)
    rng = np.random.default_rng(2)
    for _ in range(200):
        a = tse3.yaw_rotation_4x4(rng.uniform(-math.pi, math.pi)).astype(np.float32)
        b = tse3.yaw_rotation_4x4(rng.uniform(-math.pi, math.pi)).astype(np.float32)
        a[:2, 3], b[:2, 3] = rng.normal(0, 5, 2), rng.normal(0, 5, 2)
        assert treg._pair_precision(a, b) == jreg._pair_precision(a, b)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_pair_precision_yaw_boundary_is_exact_180(sign):
    """f32(atan2) tops out at f32(π), so the ±180° boundary prints as
    exactly ±180 (the ±360° guard is dead in both stacks)."""
    eps = np.float32(sign * 1e-9)
    t_coarse = np.eye(4, dtype=np.float32)
    t_coarse[0, 0] = t_coarse[1, 1] = -1.0
    t_coarse[1, 0], t_coarse[0, 1] = eps, -eps
    t_fine = np.eye(4, dtype=np.float32)
    got = treg._pair_precision(t_coarse, t_fine)
    assert got == jreg._pair_precision(t_coarse, t_fine)
    assert got[1] == sign * 180.0


def test_warn_flat_cap_prints_only_on_truncation(capsys):
    for mod in (jreg, treg):
        mod._warn_flat_cap(100, 128)
        assert "WARNING" not in capsys.readouterr().out
        mod._warn_flat_cap(200, 128)
        assert "truncated" in capsys.readouterr().out
    treg._warn_flat_cap(200, 128)
    ours = capsys.readouterr().out
    jreg._warn_flat_cap(200, 128)
    assert ours == capsys.readouterr().out


def test_rotmat_to_euler_f32_singular_branch():
    """Gimbal lock (sy < 1e-6): yaw 0, pitch ±90°
    (reference/BatchTopPartRegistration.cpp:290-309's else branch)."""
    r = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]], np.float32)
    e = treg._rotmat_to_euler_f32(r)
    assert e.dtype == np.float32
    assert e[2] == 0.0 and e[1] == np.float32(math.pi / 2)
    np.testing.assert_array_equal(_bits(e), _bits(jreg._rotmat_to_euler_f32(r)))
    ry = tse3.yaw_rotation_4x4(math.radians(40.0)).astype(np.float32)[:3, :3]
    assert abs(treg._rotmat_to_euler_f32(ry)[2] - math.radians(40.0)) < 1e-6
    rng = np.random.default_rng(3)
    for _ in range(100):
        m = tse3.yaw_rotation_4x4(rng.uniform(-math.pi, math.pi)).astype(np.float32)[:3, :3]
        np.testing.assert_array_equal(_bits(treg._rotmat_to_euler_f32(m)),
                                      _bits(jreg._rotmat_to_euler_f32(m)))


def test_pow2_bucket_growth_and_cap():
    assert treg._BUCKET_FLOOR == jreg._BUCKET_FLOOR
    assert treg._pow2_bucket(1, 1 << 20) == treg._BUCKET_FLOOR
    assert treg._pow2_bucket(treg._BUCKET_FLOOR + 1, 1 << 20) == treg._BUCKET_FLOOR * 2
    assert treg._pow2_bucket(5000, 1 << 20) == 8192
    assert treg._pow2_bucket(5000, 4096) == 4096
    for n in (0, 1, 1023, 1024, 1025, 4095, 4096, 4097, 32768, 32769, 65536, 100_000):
        for cap in (2048, 4096, 32768, 1 << 20):
            assert treg._pow2_bucket(n, cap) == jreg._pow2_bucket(n, cap)
