"""C ``round()`` and the BEV cell index of f32 values, bit-exact (the port
of ``pctpu/ops/rounding.py``).

``c_round`` is half away from zero, via floor + an exact fraction compare
(``a - floor(a)`` is exact in f32 for our magnitudes).  ``torch.round`` is
half-to-even and must not be used here.

``to_i32`` is the f32 → int32 conversion pctpu's ``astype(jnp.int32)``
performs: XLA saturates and maps NaN to 0, as CUDA's ``cvt.rzi`` does,
whereas torch's CPU ``.to(torch.int32)`` turns NaN, ±inf and everything out
of range into INT_MIN.  Every f32 index in the port goes through it, so a
corrupt coordinate lands in the same cell on both packages and devices."""

from __future__ import annotations

import torch

_I32_MAX_F = 2147483520.0  # the largest f32 below 2**31


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

