"""Shared argv handling for the CLI entry points: positional args like the
reference binaries, plus optional --key=value extensions."""

from __future__ import annotations

import sys


def split_args(argv: list[str]) -> tuple[list[str], dict[str, str]]:
    pos: list[str] = []
    kw: dict[str, str] = {}
    for a in argv:
        if a.startswith("--"):
            key, _, val = a[2:].partition("=")
            kw[key.replace("-", "_")] = val if val else "true"
        else:
            pos.append(a)
    return pos, kw


def usage_exit(msg: str) -> None:
    print(msg)
    sys.exit(1)


def int_kw(kw: dict[str, str], key: str, default: int | None) -> int | None:
    """Parse an integer --key=N extension flag with a clear error for a bare
    or malformed flag."""
    if key not in kw:
        return default
    val = kw[key]
    try:
        return int(val)
    except ValueError:
        usage_exit(f"--{key.replace('_', '-')} requires an integer value "
                   f"(got {val!r}); use --{key.replace('_', '-')}=N")
