"""What the in-order segment sums cost apart from the paths' two shapes, on
one CUDA card.

    python3 -m pctpu_torch.experiments.segment_sums_probe

Three parts, each printed with the card's name and power limit:

1. synthetic shapes of 2-lane rows, with and without an order to gather
   through: one lone segment of 1,750 and of 17,500 rows (what the carry of
   ``csrc/segment_sum.cu`` costs a row when nothing else runs), many segments
   of 120 and of 20 rows (its throughput), and no segment at all (the scan);
   the tile kernel's device time by torch.profiler;
2. the lone 17,500-row segment again with the carry's adds replaced by XORs
   in a copy of the source built under ``build/``: if the time does not move,
   the add chain is not what bounds the carry;
3. the host's cost of the wrapper's pieces at the voxel shape, microseconds
   a call on the host clock: the output's allocation, the argument checks,
   the stream lookup, the C call with and without the fill, the whole
   wrapper, and ``torch.index_add`` beside it.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time

import numpy as np
import torch

_ADDS = """      acc.v[0] = __fadd_rn(acc.v[0], r.x);
      acc.v[1] = __fadd_rn(acc.v[1], r.y);
      acc.v[2 % L] = __fadd_rn(acc.v[2 % L], r.z);
      acc.v[3 % L] = __fadd_rn(acc.v[3 % L], r.w);
"""
_XORS = """      acc.v[0] = __int_as_float(__float_as_int(acc.v[0]) ^ __float_as_int(r.x) ^
                                __float_as_int(r.z));
      acc.v[1] = __int_as_float(__float_as_int(acc.v[1]) ^ __float_as_int(r.y) ^
                                __float_as_int(r.w));
"""


def _rows(lengths, n, gather, dev):
    seg = np.full(n, -1, np.int32)
    pos = 0
    for k, length in enumerate(lengths):
        seg[pos:pos + length] = k
        pos += length
    order = torch.randperm(n, device=dev) if gather else None
    return (torch.randn(n, 2, device=dev), torch.from_numpy(seg).to(dev), None,
            max(len(lengths), 1), order)


def _kernel_us(launch, name, reps=50):
    from pctpu_torch.experiments.card import profile_calls

    return profile_calls(launch, reps=reps)[2].get(name, float("nan")) * 1e3


def main() -> int:
    from pctpu_torch.experiments.card import nvidia_smi_line, sm_clock_mhz
    from pctpu_torch.ops import _cuda, voxel

    if not torch.cuda.is_available():
        raise SystemExit("segment_sums_probe needs a CUDA card")
    dev = torch.device("cuda", 0)
    card, mhz = nvidia_smi_line(), sm_clock_mhz()

    shapes = [("one segment of 1,750 rows", [1750], 2048),
              ("one segment of 17,500 rows", [17500], 17504),
              ("one segment of 1,750 rows among 849,864", [1750], 849864),
              ("4,200 segments of 120 rows among 849,864", [120] * 4200, 849864),
              ("25,200 segments of 20 rows among 849,864", [20] * 25200, 849864),
              ("no segment among 849,864 rows", [], 849864)]
    for gather in (False, True):
        for name, lengths, n in shapes:
            args = _rows(lengths, n, gather, dev)
            tile = voxel._segment_launcher(*args, "segment_sum4", fill=False)[0]
            t = _kernel_us(tile, "segment_sum_tile_kernel")
            rows = sum(lengths)
            per_row = f", {t * 1e-6 * mhz * 1e6 / rows:.1f} cycles a row" if len(lengths) == 1 else ""
            print(f"{name}, {'through an order' if gather else 'in place'}: tile {t:.3f} us"
                  f"{per_row}; card {card}", flush=True)

    # 2. the carry without its add chain, from a copy of the source
    src = next(s for s in _cuda.SOURCES if s.name == "segment_sum.cu").read_text()
    if src.count(_ADDS) != 1:
        raise SystemExit("segment_sums_probe: the carry's adds are not where this probe looks")
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    args = _rows([17500], 17504, False, dev)
    values, seg, _, n_out, _ = args
    out = torch.empty((n_out, 2), device=dev)
    for name, text in (("as built", src), ("XORs for the adds", src.replace(_ADDS, _XORS))):
        cu = _cuda.BUILD_DIR / "segment_sum_probe.cu"
        so = _cuda.BUILD_DIR / f"segment_sum_probe_{len(name)}.so"
        cu.write_text(text)
        flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_cuda._nvcc(), *flags, "-shared", "-o", str(so), str(cu)], check=True)
        fn = ctypes.CDLL(str(so)).pctpu_segment_sum
        p, f = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_int, f, f, f, f, p, ctypes.c_int64,
                       ctypes.c_int, p]

        def launch():
            rc = fn(values.data_ptr(), None, seg.data_ptr(), seg.shape[0], 2, 0, 0, 0, 0,
                    out.data_ptr(), n_out, 0, _cuda.stream_ptr(dev))
            assert rc == 0, rc

        t = _kernel_us(launch, "segment_sum_tile_kernel")
        print(f"one segment of 17,500 rows, {name}: {t:.3f} us = "
              f"{t * 1e-6 * mhz * 1e6 / (17504 // 32):.0f} cycles a tile; card {card}", flush=True)

    # 3. the host's share at the voxel shape
    xyz = torch.randn(65536, 3, device=dev) * 20
    mask = torch.rand(65536, device=dev) > 0.2
    values, seg, _ = voxel.voxel_segments(xyz, mask, 0.2)
    out = torch.empty((65536, 4), device=dev)
    zeros, idx = torch.zeros_like(values), seg.clamp_min(0).long()

    def host_us(fn, n=3000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    def launcher(**kw):
        return voxel._segment_launcher(values, seg, None, None, None, "segment_sum4", **kw)[0]

    pieces = [
        ("torch.empty of the output",
         lambda: torch.empty((65536, 4), dtype=torch.float32, device=dev)),
        ("the argument checks", lambda: (
            _cuda.require(values, "values", torch.float32, (-1, 4), dev),
            _cuda.require(seg, "seg", torch.int32, (65536,), dev))),
        ("_cuda.stream_ptr", lambda: _cuda.stream_ptr(dev)),
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("the C call, fill + tile kernel", launcher()),
        ("the C call, tile kernel alone", launcher(fill=False)),
        ("segment_sum_sorted", lambda: voxel.segment_sum_sorted(values, seg)),
        ("segment_sum_sorted(fill=False)",
         lambda: voxel.segment_sum_sorted(values, seg, fill=False)),
        ("torch.index_add", lambda: torch.index_add(zeros, 0, idx, values)),
    ]
    for name, fn in pieces:
        print(f"host, 65,536 voxel rows: {name} {host_us(fn):.3f} us a call; card {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
