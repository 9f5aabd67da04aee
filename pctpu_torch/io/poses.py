"""C++ float printing for the precision report (from ``pctpu/io/poses.py``)."""

from __future__ import annotations


def _ostream_float(v: float) -> str:
    """Format like C++ ``std::ostream << float``: %g with 6 significant
    digits."""
    return "%.6g" % float(v)
