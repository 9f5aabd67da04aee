"""What every measurement on the card prints beside its numbers, the
CUDA-event timer, the kernel-against-twin comparison, and the least time
the card could take for a kernel's work (its bound)."""

from __future__ import annotations

import subprocess

import torch

# NVIDIA's data sheet for one H100 SXM at its full 700 W: HBM3 bytes/s and
# dense float32 operations/s outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
# flops a (query, target) pair costs in the exact 1-NN: 3 sub, 1 mul,
# 2 fma (2 flops each), 1 compare
NN_FLOP_PER_PAIR = 9


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oracle_pairs(query: torch.Tensor, query_mask: torch.Tensor, d2: torch.Tensor,
                 group_box: torch.Tensor, thr2: float, chunk: int = 4096) -> int:
    """The pairs an oracle over 32-point target groups scans: for each valid
    query, 32 for every group whose box lies within min(thr², its final
    d²) of it (``d2`` is +inf where nothing was found).  Torch ops on the
    card, from the pass's outputs."""
    lo, hi = group_box[0:3].T, group_box[3:6].T
    total = 0
    for s in range(0, query.shape[0], chunk):
        q = query[s:s + chunk, None, :]
        gap = torch.clamp_min(torch.maximum(lo[None] - q, q - hi[None]), 0.0)
        g2 = (gap * gap).sum(dim=2)
        lim = torch.clamp_max(d2[s:s + chunk], thr2)[:, None]
        total += int(((g2 <= lim) & query_mask[s:s + chunk, None]).sum())
    return 32 * total


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
