"""Cylindrical ordering: scatter points into the dense (N_SCAN, Horizon_SCAN)
range-image grid (the port of ``pctpu/ops/ordering.py``).

Reproduces ``getOrderedCloud`` (reference/BatchMultiBevGen.cpp:94-117):
points with out-of-bounds row/col are dropped; cells never hit stay all-zero;
when several points map to one cell the **last** one in input order wins.

The "last wins" rule is one ``scatter_reduce(amax)`` of point indices per
cell — max does not depend on the order of the updates, so it is
deterministic on CUDA too — followed by one gather of every field bit-cast
to int32, so -0.0 and NaN payloads come through unchanged.  Clouds may carry
a leading batch axis (one launch per op for the whole batch).

The host checks (``is_grid_ordered``, ``arrays_grid_ordered``,
``compact_last_wins``) are pctpu's numpy code, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import SensorParams


def _grid_ordered_core(
    xyz: np.ndarray, intensity: np.ndarray, row: np.ndarray, col: np.ndarray,
    t: np.ndarray, label: np.ndarray, count: int, params: SensorParams,
) -> bool:
    """Shared predicate behind is_grid_ordered / arrays_grid_ordered.

    A slot counts as *empty* only when its float fields are **bit**-zero
    (+0.0): a -0.0 coordinate is a real point the reference's last-wins
    scatter would store byte-for-byte (0x80000000), so such clouds must take
    the general ordering path to keep bit parity.
    """
    g = params.grid_size
    if xyz.shape[0] != g or count != g:
        return False
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    xyz_bits = np.ascontiguousarray(np.asarray(xyz, np.float32)).view(np.uint32)
    inten_bits = np.ascontiguousarray(
        np.asarray(intensity, np.float32)
    ).view(np.uint32)
    is_zero = (
        (row == 0) & (col == 0) & (np.asarray(label) == 0)
        & (np.asarray(t) == 0)
        & (inten_bits == 0) & (xyz_bits == 0).all(axis=1)
    )
    in_place = (
        (row >= 0) & (row < params.n_scan)
        & (col >= 0) & (col < params.horizon_scan)
        & (row * params.horizon_scan + col == np.arange(g))
    )
    return bool(np.all(is_zero | in_place))


def is_grid_ordered(cloud: Cloud, params: SensorParams) -> bool:
    """Host-side check: is this (unbatched) cloud already in dense
    sensor-grid layout?  True when it has exactly ``grid_size`` points and
    every slot ``i`` holds either an all-(bit-)zero point or an in-bounds
    point with ``row*H + col == i`` — the layout the selector binaries write
    (reference/KittiPointCloudSelect.cpp:240).  ``getOrderedCloud`` then
    reduces to the slot-0 fix-up of ``preprocess._reorder_preordered``."""

    def host(a: torch.Tensor) -> np.ndarray:
        return a.cpu().numpy()

    return _grid_ordered_core(
        host(cloud.xyz), host(cloud.intensity), host(cloud.row), host(cloud.col),
        host(cloud.t), host(cloud.label), int(cloud.count), params,
    )


def arrays_grid_ordered(arrays: dict, params: SensorParams) -> bool:
    """``is_grid_ordered`` for the loader's SoA dict form (narrow dtypes,
    see pctpu_torch.runtime.loader.load_xyzirct_arrays)."""
    return _grid_ordered_core(
        arrays["xyz"], arrays["intensity"], arrays["row"], arrays["col"],
        arrays["t"], arrays["label"], int(arrays["count"]), params,
    )


def compact_last_wins(data: dict, n: int, params: SensorParams) -> tuple[dict, int]:
    """Host-side pre-reduction for clouds LARGER than the pipeline's fixed
    grid capacity: keep only each grid cell's last-wins winner, in input
    order.  ``getOrderedCloud`` retains at most one point per cell — the
    last in input order — and drops out-of-bounds points, so
    ordering(winners) == ordering(raw) exactly.  ``data`` is a pcd field dict
    (1-D arrays, ≥ n long); returns (compacted field dict, winner count)."""
    rows = np.asarray(data["row"][:n], np.int64)
    cols = np.asarray(data["col"][:n], np.int64)
    ib = (
        (rows >= 0) & (rows < params.n_scan)
        & (cols >= 0) & (cols < params.horizon_scan)
    )
    cell = rows[ib] * params.horizon_scan + cols[ib]
    winner = np.full(params.grid_size, -1, np.int64)
    # ufunc.at is defined for repeated indices: per-cell max input index ==
    # the reference's last-wins overwrite order
    np.maximum.at(winner, cell, np.flatnonzero(ib))
    keep = np.sort(winner[winner >= 0])
    return {k: np.asarray(v)[:n][keep] for k, v in data.items()}, len(keep)


def get_ordered_cloud(cloud: Cloud, params: SensorParams) -> Cloud:
    """Order a padded cloud (or a batch of them) into the dense sensor grid.

    Returns a Cloud of capacity ``params.grid_size`` whose slot ``r*H + c``
    holds the last input point with (row, col) == (r, c), or zeros.
    """
    batched = cloud.xyz.dim() == 3
    g = params.grid_size
    fields = (cloud.xyz, cloud.intensity, cloud.row, cloud.col, cloud.t, cloud.label,
              cloud.valid_mask())
    xyz, inten, row, col, t, label, valid = (f if batched else f[None] for f in fields)
    b, p = valid.shape
    dev = xyz.device
    in_bounds = (
        (row >= 0) & (row < params.n_scan)
        & (col >= 0) & (col < params.horizon_scan)
        & valid
    )
    cell = torch.where(in_bounds, row.long() * params.horizon_scan + col, g)

    point_idx = torch.arange(p, device=dev).expand(b, p)
    winner = torch.full((b, g + 1), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(1, cell, point_idx, "amax", include_self=True)[:, :g]
    occupied = winner >= 0
    src = torch.where(occupied, winner, 0)

    # one packed row gather of every field's bits instead of one per field
    packed = torch.cat(
        [
            xyz.view(torch.int32),
            inten.view(torch.int32)[..., None],
            row.to(torch.int32)[..., None],
            col.to(torch.int32)[..., None],
            t.to(torch.int32)[..., None],  # the low 32 bits: t is a uint32
            label.to(torch.int32)[..., None],
        ],
        dim=-1,
    )  # (B, P, 8)
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
