"""Fused per-cloud preprocessing: ordering + ground marking + BEV rasters (the
port of ``pctpu/ops/preprocess.py``).

This is the hot loop of the flagship pipeline
(reference/BatchMultiBevGen.cpp:727-757).  ``preprocess_batch`` keeps the
leading batch axis through every op, so one batch costs a fixed number of
kernel launches however many clouds it holds.
"""

from __future__ import annotations

import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import GroundConfig, MultiBevConfig, SensorParams, SingleBevConfig
from pctpu_torch.ops.bev import (
    fused_bev_compatible,
    fused_multi_single_bev,
    multi_bev,
    single_bev,
)
from pctpu_torch.ops.ground import mark_ground
from pctpu_torch.ops.ordering import get_ordered_cloud


def preprocess_batch(
    clouds: Cloud,
    params: SensorParams,
    ground_cfg: GroundConfig = GroundConfig(),
    multi_cfg: MultiBevConfig = MultiBevConfig(),
    single_cfg: SingleBevConfig = SingleBevConfig(),
    assume_ordered: bool = False,
    compat: str = "bitexact",
) -> tuple[Cloud, torch.Tensor, torch.Tensor]:
    """Clouds (every field with a leading batch axis, or one cloud) →
    (labeled ordered clouds, multi-BEV u8 (…, L, S, S), single-BEV u8
    (…, S, S)).

    ``assume_ordered=True`` is the production fast path: the selector tools
    emit clouds already scattered onto the dense sensor grid
    (reference/KittiPointCloudSelect.cpp:240), so re-running
    ``getOrderedCloud`` is the identity except at slot 0.  The caller must
    have verified the layout host-side (``ordering.arrays_grid_ordered``)."""
    if assume_ordered:
        ordered = _reorder_preordered(clouds, params)
    else:
        ordered = get_ordered_cloud(clouds, params)
    labeled, _ = mark_ground(ordered, params, ground_cfg, compat=compat)
    if fused_bev_compatible(multi_cfg, single_cfg):
        multi_img, single_img = fused_multi_single_bev(
            labeled, params.height_res, multi_cfg, single_cfg
        )
    else:
        multi_img = multi_bev(labeled, params.height_res, multi_cfg)
        single_img = single_bev(labeled, single_cfg)
    return labeled, multi_img, single_img


def preprocess_cloud(
    cloud: Cloud,
    params: SensorParams,
    ground_cfg: GroundConfig = GroundConfig(),
    multi_cfg: MultiBevConfig = MultiBevConfig(),
    single_cfg: SingleBevConfig = SingleBevConfig(),
    assume_ordered: bool = False,
    compat: str = "bitexact",
) -> tuple[Cloud, torch.Tensor, torch.Tensor]:
    """One cloud → (labeled ordered cloud, multi-BEV u8, single-BEV u8)."""
    if cloud.xyz.dim() != 2:
        raise ValueError("preprocess_cloud takes one cloud; use preprocess_batch")
    return preprocess_batch(cloud, params, ground_cfg, multi_cfg, single_cfg,
                            assume_ordered=assume_ordered, compat=compat)


def _reorder_preordered(cloud: Cloud, params: SensorParams) -> Cloud:
    """getOrderedCloud on an already-grid-ordered cloud (or batch).

    Equals the input except slot 0: all-zero slots carry (row, col) = (0, 0),
    so under the reference's last-wins scatter the last all-zero slot — if
    any exists — overwrites cell 0.  An all-zero overwrite is itself
    all-zero, so the update is "zero slot 0 iff any slot beyond 0 is
    all-zero"."""
    batched = cloud.xyz.dim() == 3
    fields = [cloud.xyz, cloud.intensity, cloud.row, cloud.col, cloud.t, cloud.label]
    xyz, inten, row, col, t, label = (f if batched else f[None] for f in fields)
    zero_slot = (
        (row == 0) & (col == 0) & torch.all(xyz == 0.0, dim=-1)
        & (inten == 0.0) & (t == 0) & (label == 0)
    )
    keep0 = ~torch.any(zero_slot[:, 1:], dim=1)  # (B,)

    def zero_first(arr):
        # select, not multiply: ×0 would turn negatives into -0.0 and leave
        # NaN/Inf in place, diverging byte-wise from the scatter path
        out = arr.clone()
        k = keep0.view(-1, *([1] * (arr.dim() - 2)))
        out[:, 0] = torch.where(k, arr[:, 0], torch.zeros_like(arr[:, 0]))
        return out if batched else out[0]

    g = params.grid_size
    return Cloud(
        xyz=zero_first(xyz),
        intensity=zero_first(inten),
        row=zero_first(row),
        col=zero_first(col),
        t=zero_first(t),
        label=zero_first(label),
        count=(torch.full((xyz.shape[0],), g, dtype=torch.int64, device=xyz.device)
               if batched else g),
    )
