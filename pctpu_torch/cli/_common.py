"""Shared argv handling for the CLI entry points: positional args like the
reference binaries, plus optional --key=value extensions."""

from __future__ import annotations

import contextlib
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


def devices_kw(kw: dict[str, str], device: str) -> int | None:
    """The ``--devices=N`` extension (a data mesh of N devices).  On the
    card it needs N cards: with fewer the run stops with exit code 2, as
    ``--device=cuda`` does without a card, and never runs on fewer devices
    than asked.  With ``--device=cpu`` the mesh is N logical CPU devices."""
    devices = int_kw(kw, "devices", None)
    if devices is not None and devices < 1:
        usage_exit(f"--devices must be at least 1 (got {devices})")
    if device == "cuda" and devices is not None and devices > torch.cuda.device_count():
        print(f"--devices={devices} needs {devices} CUDA cards, this process sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(2)
    return devices


@contextlib.contextmanager
def process_group(kw: dict[str, str], device: str, devices: int | None):
    """``--num-processes=N --process-id=K --coordinator=host:port``:
    (N, K) for the pipeline, as given (None where absent).  With N > 1 and a
    coordinator the process joins the group for the block and leaves it
    after, so a run never hangs at teardown.  With N > 1 on the card the
    process runs on cards of its own: the first of its ``devices`` (default
    1) cards in ``parallel.distributed.process_cards`` becomes its current
    card, printed as ``process K on cuda:C``."""
    from pctpu_torch.parallel.distributed import (initialize, process_cards, process_index,
                                                  shutdown)

    nproc = int_kw(kw, "num_processes", None)
    pid = int_kw(kw, "process_id", None)
    joined = nproc is not None and nproc > 1 and "coordinator" in kw
    if joined:
        initialize(kw["coordinator"], nproc, pid)
    try:
        if device == "cuda" and (joined or (nproc or 1) > 1):
            card = process_cards(devices or 1, pid)[0]
            torch.cuda.set_device(card)
            print(f"process {process_index() if pid is None else pid} on {card}")
        yield nproc, pid
    finally:
        if joined:
            shutdown()
