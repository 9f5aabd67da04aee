"""What every measurement on the card prints beside its numbers, the
CUDA-event timer, and the kernel-against-twin comparison."""

from __future__ import annotations

import subprocess

import torch


def nvidia_smi_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, timed with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def mismatches(got, want) -> tuple[int, float]:
    """Entries where two results differ — integer entries by value, f32
    entries by bit pattern — and the largest |Δ| over the finite f32 values
    (0.0 when bit-equal)."""
    n, err = 0, 0.0
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            n += int((a.view(torch.int32) != b.view(torch.int32)).sum())
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                err = max(err, float((a[fin] - b[fin]).abs().max()))
        else:
            n += int((a != b).sum())
    return n, err
