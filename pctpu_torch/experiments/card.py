"""What every measurement on the card prints beside its numbers, the
CUDA-event timer, the profiler's per-kernel times, the kernel-against-twin
comparison, and the least time the card could take for a kernel's work (its
bound)."""

from __future__ import annotations

import re
import subprocess

import torch

# NVIDIA's data sheet for one H100 SXM at its full 700 W: HBM3 bytes/s and
# dense float32 operations/s outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
# flops a (query, target) pair costs in the exact 1-NN: 3 sub, 1 mul,
# 2 fma (2 flops each), 1 compare
NN_FLOP_PER_PAIR = 9
# cycles from one f32 add (or fma) to a dependent one on Hopper's SMs
F32_ADD_LATENCY_CYCLES = 4


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segment_sums_bound(seg: torch.Tensor, lanes: int, n_out: int,
                       clock_mhz: float) -> dict:
    """The least time the card could take for the in-order segment sums of
    these ids, reckoned from the work: the larger of its bytes over the
    memory rate — each row that joins a segment read once (its lanes and a
    4-byte id), one output row a segment written — and the one cost the
    order itself imposes: the longest segment's chain of dependent f32 adds
    at ``clock_mhz``, the SM clock the card reports.  Returns ms, by
    ("bytes" or "chain"), bytes, chain_ms, rows, segments and longest."""
    ids = seg[(seg >= 0) & (seg < n_out)]
    runs = torch.unique_consecutive(ids, return_counts=True)[1]
    rows, segments = int(ids.numel()), int(runs.numel())
    longest = int(runs.max()) if segments else 0
    n_bytes = rows * (4 * lanes + 4) + segments * 4 * lanes
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_chain = longest * F32_ADD_LATENCY_CYCLES / (clock_mhz * 1e6) * 1e3
    return {"ms": max(t_bytes, t_chain), "by": "bytes" if t_bytes >= t_chain else "chain",
            "bytes": n_bytes, "chain_ms": t_chain, "rows": rows, "segments": segments,
            "longest": longest}


def pca_moments_bound(n: int, live: int, clock_mhz: float) -> dict:
    """The least time the card could take for ``pca.pca_moments`` over n
    rows of which ``live`` are ``pca.live_rows``, reckoned from the work: the
    larger of its bytes over the memory rate — each row's 12 B of xyz and 1
    B of mask read once, the 12 output floats written once — and the one
    cost the order itself imposes: the longest chain of dependent f32
    operations at ``clock_mhz``, 4 cycles each.  That chain is the mean's
    tree (32 adds a level on its critical path, then the last ≤ 32 in
    order) followed by one covariance chain of an fma a live row (the other
    rows leave every chain as it was).  Returns ms, by ("bytes" or
    "chain"), bytes, chain_ms and the chain's length."""
    depth, size = 0, n
    while size > 32:
        depth += 32
        size = -(-size // 32)
    chain = depth + size + live
    n_bytes = n * 13 + 12 * 4
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_chain = chain * F32_ADD_LATENCY_CYCLES / (clock_mhz * 1e6) * 1e3
    return {"ms": max(t_bytes, t_chain), "by": "bytes" if t_bytes >= t_chain else "chain",
            "bytes": n_bytes, "chain_ms": t_chain, "chain": chain}


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


def sm_clock_mhz() -> float:
    """The first card's highest SM clock in MHz
    (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0])


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


def profile_calls(fn, reps: int = 50) -> tuple[int, int, dict[str, float]]:
    """What one call of ``fn`` puts on the card, by torch.profiler over
    ``reps`` calls after a warm-up: (kernels, copies and memsets, {kernel,
    copy or memset name: device ms}), per call.  Only the device events that
    start inside the span of the calls (a ``record_function`` around them,
    ended after a synchronize) are the calls' own: an event of an earlier
    window that the profiler hands over late is not counted.  The profiler
    can also miss events of a window, and come back with none at all, so a
    window whose events are not a whole number a call is taken again, up to
    four times, and the fullest one is kept; the counts are rounded."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    events: list = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("profile_calls"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        listed = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        span = next(e.time_range for e in listed
                    if e.name == "profile_calls" and e.device_type != cuda)
        # the span's own mark on the card's timeline is no event of the calls
        window = [e for e in listed if e.device_type == cuda and e.name != "profile_calls"
                  and span.start <= e.time_range.start <= span.end]
        if len(window) > len(events):
            events = window
        if window and len(window) % reps == 0:
            break
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    ms: dict[str, float] = {}
    for e in events:
        name = m.group(0) if (m := re.search(r"\w+_kernel", e.name)) else e.name
        ms[name] = ms.get(name, 0.0) + e.device_time_total / 1e3 / reps
    return round((len(events) - len(copies)) / reps), round(len(copies) / reps), ms


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
