"""C ``round()`` of f32 values, bit-exact (the port of
``pctpu/ops/rounding.py::c_round``).

Half away from zero, via floor + an exact fraction compare (``a - floor(a)``
is exact in f32 for our magnitudes).  ``torch.round`` is half-to-even and
must not be used here."""

from __future__ import annotations

import torch


def c_round(v: torch.Tensor) -> torch.Tensor:
    """C ``round()`` of an f32 tensor: half away from zero, bit-exact."""
    a = torch.abs(v)
    k = torch.floor(a)
    r = k + (a - k >= 0.5).to(v.dtype)
    return torch.where(v < 0, -r, r)
