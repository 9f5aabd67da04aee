"""One run of one cell:

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the process's start: imports, the card, the kernels' build on
a checkout's first run, the seeded inputs, the warm-up batches) is
``setup_s``.  The window then runs whole batches for ``--seconds``; its
rate counts every cloud or pair whose results reached the host, over the
window's seconds.  With ``--trace 1`` the window runs under torch.profiler
and torch's sync debug mode, and the line carries the cell's per-layer
metrics, the busy and window seconds and the breakdown.  After the window
``memory_peak_bytes`` is read, the program's state is freed and the sampled
answers are judged against the plain reference (``harness.checks``); the
numbers compared and their limits end standard error and the result line.

The last line of standard output is the result.  Without a CUDA card,
without the program beside the benchmark, or with JAX or the JAX package
loaded once the window has closed, the run prints no result and exits
non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import sys
import time

from harness.cells import ROOT, metric_reader, resolve
from harness.trace import SPAN_PREFIX, WINDOW_MARK, SyncCounter, breakdown, busy_s, from_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "pctpu")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 benchmarks/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``pctpu_torch`` is neither)."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout; the
    port's own kernels build into ``build/pctpu_torch/`` there."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def make_window(cell, seed: int, device, span):
    """The window driver that the cell's traffic file names (``window``, a
    module of ``benchmarks/`` whose ``Window`` takes the configuration, the
    traffic, the seed, the device and the span maker)."""
    module = importlib.import_module(cell.traffic["window"])
    return module.Window(cell.config, cell.traffic, seed, device, span)


def traced_window(win, seconds: float, syncs: SyncCounter):
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = win.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    counting = syncs.counting() if on_card else contextlib.nullcontext()
    with profile(activities=activities) as prof:
        with counting, record_function(WINDOW_MARK):
            items, batches, secs = win.window(seconds)
            win.sync()
    return prof, items, batches, secs


def run(args, t_start: float, device=None) -> tuple[int, dict | None]:
    """The run; returns (exit code, result or None).  A ``device`` other
    than the card is for the harness's own tests."""
    import torch

    cell = resolve(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload}: needs {cell.chips} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
            return 3, None
        device = torch.device("cuda", 0)
    import pctpu_torch  # noqa: F401  (TF32 off, as the configuration states)

    tracing = bool(args.trace)
    span = (lambda name: torch.profiler.record_function(SPAN_PREFIX + name)) if tracing else (
        lambda name: contextlib.nullcontext())
    win = make_window(cell, args.seed, device, span)
    on_card = device.type == "cuda"
    setup_s = time.perf_counter() - t_start

    syncs = SyncCounter()
    trace = None
    if tracing:
        prof, items, batches, secs = traced_window(win, args.seconds, syncs)
    else:
        items, batches, secs = win.window(args.seconds)
        win.sync()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if tracing:
        trace = from_profiler(prof, items, batches)
        del prof
        trace.extra.update(host_syncs=syncs.count, **win.stats)
    stats = dict(win.stats)
    win.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    from harness.checks import rules, verdict

    cell_rules = rules(cell.name)
    check = win.check(cell_rules)
    ok, compared = verdict(check["numbers"], cell_rules["limits"])
    bad = forbidden_modules()
    if bad:
        print(f"{args.workload}: loaded {', '.join(bad)}, which the port must not load",
              file=sys.stderr)
        return 4, None

    if tracing:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(trace, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {f"{win.unit}_per_s": {"value": items / secs, "unit": f"{win.unit}/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else str(device),
           "count": 1, "memory_peak_bytes": int(peak)}
    if tracing:
        dev.update(busy_s=busy_s(trace), window_s=trace.window_s)
    result = {"correct": ok, "attempted": items, "failed": 0, "metrics": metrics,
              "device": dev}
    if tracing:
        result["breakdown"] = breakdown(trace)
    diag = {k: v for k, v in check.items() if k != "numbers"}
    print(json.dumps({"window_s": secs, "batches": batches, "setup_s": setup_s, **stats,
                      **diag}), file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    result["checks"] = compared
    return (0 if on_card else 5), result


def main(argv: list[str] | None, t_start: float) -> int:
    args = parser().parse_args(argv)
    if not (ROOT / "pctpu_torch").is_dir():
        print("the program (pctpu_torch) is not beside the benchmark", file=sys.stderr)
        return 2
    cache_dirs()
    code, result = run(args, t_start)
    if result is None or code != 0:
        return code or 1
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
