"""Sort-based last-wins ordering against the port's scatter-max + gather —
the port of ``scripts/exp_sort_ordering.py`` (a closed experiment of
pctpu's).

    python -m pctpu_torch.experiments.sort_ordering [--small] [--device=cuda|cpu]

``get_ordered_cloud`` (``ops/ordering.py``) picks each grid cell's last
point with one ``scatter_reduce(amax)`` of point indices and gathers every
field's bits in one packed (P, 8) row gather.  The candidate,
:func:`get_ordered_cloud_sort`, replaces the scatter with two stable sorts
(``torch.sort(stable=True)``):

1. one sentinel entry a cell (index -1) goes in front of the points, and
   (cell, index) is sorted by cell: inside a cell's run the last entry is
   the reference's last-wins winner (reference/BatchMultiBevGen.cpp:94-117
   overwrites in input order, which a stable sort keeps);
2. a compaction sort: each run's last entry keeps its cell as its key,
   every other entry takes ``grid_size``, so the first ``grid_size``
   entries are the winners in cell order (a sentinel wins only an empty
   cell).

The packed row gather is the incumbent's.  Every key is an integer cell id,
so no float ordering (the card's radix sort puts -0.0 before +0.0) enters.

On 16 distinct batches of 8 HDL-64E clouds (the port's copy of
``bench.synth_batch``, general layout, 119,980 points a cloud; ``--small``:
one batch of 2, for a short CPU run) both are held bit for bit, then timed
in turns, 8 passes (1 with ``--small``) over the batches a turn (CUDA
events on the card).  Prints one JSON line: ms a cloud of each, the bit-equality verdict
and the card's name and power limit.  Exit 1 when they differ, 2 for
``--device=cuda`` without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import SensorParams


def get_ordered_cloud_sort(cloud: Cloud, params: SensorParams) -> Cloud:
    """The sort-based ordering (module docstring) of a cloud or a batch:
    bit-equal to ``ordering.get_ordered_cloud`` by construction."""
    batched = cloud.xyz.dim() == 3
    g = params.grid_size
    fields = (cloud.xyz, cloud.intensity, cloud.row, cloud.col, cloud.t, cloud.label,
              cloud.valid_mask())
    xyz, inten, row, col, t, label, valid = (f if batched else f[None] for f in fields)
    b, p = valid.shape
    dev = xyz.device
    in_bounds = ((row >= 0) & (row < params.n_scan) & (col >= 0) & (col < params.horizon_scan)
                 & valid)
    cell = torch.where(in_bounds, row * params.horizon_scan + col, g).to(torch.int32)
    # sentinels first: the stable sort keeps each cell's sentinel ahead of
    # its points, so a sentinel wins only an empty cell
    keys = torch.cat([torch.arange(g, dtype=torch.int32, device=dev).expand(b, g), cell], 1)
    idxs = torch.cat([torch.full((b, g), -1, dtype=torch.int32, device=dev),
                      torch.arange(p, dtype=torch.int32, device=dev).expand(b, p)], 1)
    sk, perm = torch.sort(keys, dim=1, stable=True)
    si = idxs.gather(1, perm)
    is_last = torch.cat([sk[:, :-1] != sk[:, 1:], torch.ones((b, 1), dtype=torch.bool,
                                                             device=dev)], 1)
    ck = torch.where(is_last & (sk < g), sk, g)
    _, perm2 = torch.sort(ck, dim=1, stable=True)
    winner = si.gather(1, perm2[:, :g])
    occupied = winner >= 0
    src = torch.where(occupied, winner, 0).long()

    packed = torch.cat([xyz.view(torch.int32), inten.view(torch.int32)[..., None],
                        row.to(torch.int32)[..., None], col.to(torch.int32)[..., None],
                        t.to(torch.int32)[..., None], label.to(torch.int32)[..., None]], -1)
    taken = packed.gather(1, src[..., None].expand(-1, -1, 8))
    taken = torch.where(occupied[..., None], taken, 0)
    if not batched:
        taken = taken[0]
    return Cloud(
        xyz=taken[..., 0:3].contiguous().view(torch.float32),
        intensity=taken[..., 3].contiguous().view(torch.float32),
        row=taken[..., 4],
        col=taken[..., 5],
        t=taken[..., 6].to(torch.int64) & 0xFFFFFFFF,
        label=taken[..., 7],
        count=torch.full((b,), g, dtype=torch.int64, device=dev) if batched else g,
    )


def same_bits(a: Cloud, b: Cloud) -> bool:
    """Every field of two ordered clouds equal, floats bit for bit."""
    for f in ("xyz", "intensity", "row", "col", "t", "label"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            return False
    return True


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pctpu_torch.experiments.sort_ordering")
    ap.add_argument("--small", action="store_true",
                    help="one batch of 2 clouds, one pass a turn (short CPU runs)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where both run (default: the card)")
    return ap


def run(argv: list[str] | None = None, dev: torch.device | None = None) -> dict:
    """The experiment with ``argv``'s flags; returns the JSON line's dict."""
    from pctpu_torch.config import get_sensor_params
    from pctpu_torch.experiments import card, scene
    from pctpu_torch.ops.ordering import get_ordered_cloud

    args = parser().parse_args(argv)
    dev = dev or card.tool_device(args.device, "sort_ordering")
    batch, n_stack, reps = (2, 1, 1) if args.small else (scene.BENCH_BATCH, 16, 8)
    params = get_sensor_params("HDL_64E")
    n_points = min(scene.BENCH_N_POINTS, int(params.grid_size * 0.9))
    stack = [scene.synth_batch(params, batch, n_points, seed, ordered=False, device=dev)
             for seed in range(n_stack)]
    bit_equal = all(same_bits(get_ordered_cloud(c, params), get_ordered_cloud_sort(c, params))
                    for c in stack)

    def per_cloud_ms(fn) -> float:
        def once():
            for c in stack:
                fn(c, params)
        if dev.type == "cuda":
            return card.cuda_ms(once, reps=reps) / (len(stack) * batch)
        once()
        t0 = time.perf_counter()
        for _ in range(reps):
            once()
        return (time.perf_counter() - t0) * 1e3 / (reps * len(stack) * batch)

    ms = {"incumbent": [], "sort": []}
    for name in ("incumbent", "sort", "sort", "incumbent"):  # in turns
        ms[name].append(per_cloud_ms(get_ordered_cloud if name == "incumbent"
                                     else get_ordered_cloud_sort))
    ms_inc, ms_sort = min(ms["incumbent"]), min(ms["sort"])
    out = {"experiment": "sort_ordering", "bit_equal": bit_equal,
           "ms_per_cloud_segment_max_gather": ms_inc, "ms_per_cloud_sort_based": ms_sort,
           "winner": "sort" if ms_sort < ms_inc else "incumbent",
           "clouds": len(stack) * batch, "batch": batch,
           "n_points": n_points, "device": card.device_record(dev)}
    if dev.type == "cuda":
        for key, fn in (("incumbent", get_ordered_cloud), ("sort", get_ordered_cloud_sort)):
            kernels, copies, _ = card.profile_calls(lambda fn=fn: fn(stack[0], params), reps=5)
            out[f"kernels_per_batch_{key}"] = kernels
            out[f"copies_per_batch_{key}"] = copies
    return out


def main(argv: list[str] | None = None) -> int:
    from pctpu_torch.experiments import card

    argv = sys.argv[1:] if argv is None else argv
    dev = card.tool_device(parser().parse_args(argv).device, "sort_ordering")
    if dev is None:
        return 2
    out = run(argv, dev)
    print(json.dumps(out))
    return 0 if out["bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
