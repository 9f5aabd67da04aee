"""Shared argv handling for the CLI entry points: positional args like the
reference binaries, plus optional --key=value extensions."""

from __future__ import annotations

import sys

import torch


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


def pick_device(kw: dict[str, str], file=None) -> str:
    """The ``--device=cuda|cpu`` extension (default ``cuda``), printed as
    ``device: ...`` to ``file`` (standard output unless given).  Without a
    CUDA card the run stops unless the CPU was asked for: nothing falls back
    silently."""
    device = kw.get("device", "cuda")
    if device not in ("cuda", "cpu"):
        usage_exit(f"--device must be cuda or cpu (got {device!r})")
    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card found (torch.cuda.is_available() is false); "
                  "pass --device=cpu to run on the CPU", file=sys.stderr)
            sys.exit(2)
        print(f"device: cuda ({torch.cuda.get_device_name()})", file=file or sys.stdout)
    else:
        print("device: cpu", file=file or sys.stdout)
    return device


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


def path_kw(kw: dict[str, str], key: str, default: str | None = None) -> str | None:
    """Parse a path-valued --key=PATH flag; a bare flag returns ``default``
    (or errors when no default makes sense)."""
    if key not in kw:
        return None
    val = kw[key]
    if val in ("", "true"):
        if default is not None:
            return default
        usage_exit(f"--{key.replace('_', '-')} requires a value: "
                   f"--{key.replace('_', '-')}=PATH")
    return val
