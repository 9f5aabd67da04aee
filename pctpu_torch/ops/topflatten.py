"""Top-part extraction: keep the top 20% (by z) of each 20 m grid cell,
project to z = 0 (the port of ``pctpu/ops/topflatten.py``).

Reproduces ``extractTopAndFlatten``
(reference/BatchTopPartRegistration.cpp:90-147): 10×10 grid over
±100 m with C-round cell indexing; ground (label==0) skipped; cells with
< 20 points skipped; per cell keep round(0.2*n) points sorted by z
descending; output in (gx, gy) row-major cell order, z-descending inside a
cell, ties in input order (D14).

The per-cell sort is one global stable sort by (cell, -z), done as two
stable passes (least significant key first); a point's rank inside its cell
is its sorted position minus the cell's start.  A batch of clouds (fields
with a leading B, as pctpu's under ``jax.vmap``) is sorted row by row along
its point axis."""

from __future__ import annotations

import numpy as np
import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import TopFlattenConfig
from pctpu_torch.ops.rounding import c_round


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, dim=-1, stable=True).indices


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(x, order, dim=-1)


def extract_top_and_flatten(
    cloud: Cloud, cfg: TopFlattenConfig = TopFlattenConfig()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (xyz (N,3) with z=0, valid mask (N,), count as a 0-d int64
    tensor) — compacted to the front in reference order, zero-padded; for a
    batched cloud the same with a leading B (count (B,))."""
    dev = cloud.device
    ncell = cfg.num_grid_x * cfg.num_grid_y
    gx = c_round((cloud.x + cfg.max_radius_x) / cfg.grid_res_x).to(torch.int64)
    gy = c_round((cloud.y + cfg.max_radius_y) / cfg.grid_res_y).to(torch.int64)
    ok = (
        (cloud.label != 0)
        & (gx >= 0) & (gx < cfg.num_grid_x)
        & (gy >= 0) & (gy < cfg.num_grid_y)
        & cloud.valid_mask()
    )
    cell = torch.where(ok, gx * cfg.num_grid_y + gy, ncell)
    p = cloud.capacity

    # stable sort on (cell ascending, z descending).  "+ 0.0" maps -0.0 to
    # +0.0: a CUDA radix sort orders the two zeros by their bits, where the
    # reference comparison (and pctpu's) treats them as equal
    by_z = _stable_argsort(-cloud.z + 0.0)
    perm = _take(by_z, _stable_argsort(_take(cell, by_z)))
    cell_s, x_s, y_s = _take(cell, perm), _take(cloud.x, perm), _take(cloud.y, perm)

    # per-point run geometry from boundary scans: rank inside the cell and
    # the cell's total count
    i = torch.arange(p, device=dev).expand_as(cell_s)
    change = cell_s[..., 1:] != cell_s[..., :-1]
    one = torch.ones_like(cell_s[..., :1], dtype=torch.bool)
    is_start = torch.cat([one, change], dim=-1)
    is_end = torch.cat([change, one], dim=-1)
    run_start = torch.cummax(torch.where(is_start, i, 0), dim=-1).values
    run_end = torch.flip(
        torch.cummin(torch.flip(torch.where(is_end, i, p), [-1]), dim=-1).values, [-1]
    )
    rank = i - run_start
    count_pt = (run_end - run_start + 1).to(torch.float32)
    # C++: round(0.2f * n) — the f32 literal product
    k_pt = c_round(float(np.float32(cfg.top_fraction)) * count_pt).to(torch.int64)
    k_pt = torch.where(count_pt >= cfg.min_grid_points, k_pt, 0)
    keep = (rank < k_pt) & (cell_s < ncell)

    # compact kept points to the front, preserving sorted (reference) order
    nkept = keep.sum(dim=-1)
    order = _stable_argsort((~keep).to(torch.int32))
    keep_c = i < nkept[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    xyz = torch.stack(
        [
            torch.where(keep_c, _take(x_s, order), zero),
            torch.where(keep_c, _take(y_s, order), zero),
            torch.zeros(keep_c.shape, dtype=torch.float32, device=dev),  # flatten
        ],
        dim=-1,
    )
    return xyz, keep_c, nkept
