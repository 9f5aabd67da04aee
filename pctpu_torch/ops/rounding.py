"""C ``round()`` and the BEV cell index of f32 values, bit-exact (the port
of ``pctpu/ops/rounding.py``; ``c_round_np`` and ``bev_cell_np`` are their
numpy forms, which the dataset readers use), and OpenCV's ``saturate_cast<uchar>`` of a
float image for the float BEV PNGs.

``x86_nan`` gives a NaN result the bits pctpu's CPU arithmetic gives it, so
that a NaN written to a file (a PCD coordinate, a CSV ``-nan``) is the same
from the card: the card's float units return one canonical NaN
(0x7FFFFFFF) whatever the operands, where x86 passes the NaN operand on.

``c_round`` is half away from zero, via floor + an exact fraction compare
(``a - floor(a)`` is exact in f32 for our magnitudes).  ``torch.round`` is
half-to-even and must not be used here.

``to_i32`` is the f32 → int32 conversion pctpu's ``astype(jnp.int32)``
performs: XLA saturates and maps NaN to 0, as CUDA's ``cvt.rzi`` does,
whereas torch's CPU ``.to(torch.int32)`` turns NaN, ±inf and everything out
of range into INT_MIN.  Every f32 index in the port goes through it, so a
corrupt coordinate lands in the same cell on both packages and devices."""

from __future__ import annotations

import numpy as np
import torch

_I32_MAX_F = 2147483520.0  # the largest f32 below 2**31


def x86_nan(result: torch.Tensor, *operands: torch.Tensor) -> torch.Tensor:
    """``result`` (computed from ``operands`` by adds and multiplies) with
    each NaN given the bits x86's SSE/AVX units give it: the first NaN
    operand, quieted, or the default NaN 0xFFC00000 where the arithmetic
    made one (inf·0, inf − inf).  The identity on an x86 CPU wherever the
    NaN operands of an element share one bit pattern; on the card it undoes
    the canonical NaN.  With differently signed NaN operands the first one
    wins (README D21)."""
    nan = torch.isnan(result)
    # built on the device (a fill, not a copy from the host): 0xFFC00000
    default = torch.full((), -0x400000, dtype=torch.int32, device=result.device)
    out = torch.where(nan, default.view(torch.float32), result)
    for op in reversed(operands):
        quiet = (op.view(torch.int32) | 0x400000).view(torch.float32)
        out = torch.where(nan & torch.isnan(op), quiet, out)
    return out


def c_round(v: torch.Tensor) -> torch.Tensor:
    """C ``round()`` of an f32 tensor: half away from zero, bit-exact."""
    a = torch.abs(v)
    k = torch.floor(a)
    r = k + (a - k >= 0.5).to(v.dtype)
    return torch.where(v < 0, -r, r)


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """XLA's saturating f32 → int32 of an integral-valued tensor: NaN → 0,
    values past the int32 range clamp to INT_MIN / INT_MAX."""
    out = torch.where(torch.isnan(v), 0.0, v).clamp(-2147483648.0, _I32_MAX_F)
    out = out.to(torch.int32)
    return torch.where(v > _I32_MAX_F, torch.iinfo(torch.int32).max, out)


def bev_cell(coord: torch.Tensor, max_range: float, interval: float) -> torch.Tensor:
    """The reference BEV cell index ``round((coord + MAX_RANGE)/interval +
    0.5)`` (reference/BatchMultiBevGen.cpp:279-280) with its f32-then-f64
    semantics: the 0.5 literal promotes the f32 quotient t to double, and
    round64(t + 0.5) = floor(t) + 1 for t >= -0.5, ceil(t) below.  int32."""
    t = (coord + max_range) / interval
    return torch.where(t >= -0.5, to_i32(torch.floor(t)) + 1, to_i32(torch.ceil(t)))


def c_round_np(v) -> np.ndarray:
    """C ``round()`` in numpy (float64 inputs): the dataset readers' ring
    and column indices."""
    v = np.asarray(v)
    a = np.abs(v)
    k = np.floor(a)
    r = k + (a - k >= 0.5)
    return np.where(v < 0, -r, r)


def bev_cell_np(coord, max_range: float, interval: float) -> np.ndarray:
    """numpy twin of :func:`bev_cell` (f32 expression, f64 + 0.5, C round)."""
    t = (np.float32(coord) + np.float32(max_range)) / np.float32(interval)
    t = t.astype(np.float64)
    return c_round_np(t + 0.5).astype(np.int32)


def cv_saturate_u8(v: np.ndarray) -> np.ndarray:
    """OpenCV ``saturate_cast<uchar>(float)``: rint (half-to-even) + clamp,
    as numpy computes it (a NaN stays NaN through ``rint`` and ``clip`` and
    becomes whatever numpy's cast to uint8 makes of it).

    Used when emulating cv::imwrite's CV_32F→CV_8U fallback for float BEV
    PNGs (reference/BatchCloudManip.cpp:238 writes a CV_32F mat)."""
    return np.clip(np.rint(np.asarray(v)), 0, 255).astype(np.uint8)
