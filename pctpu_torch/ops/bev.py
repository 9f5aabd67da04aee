"""BEV rasters: multi-layer occupancy, uint8 height and float max-height (the
port of ``pctpu/ops/bev.py``).

Reference semantics (reference/BatchMultiBevGen.cpp:261-373):
  * multi-layer: 24 layers of 224×224 uint8; x = round((px+112)/res + 0.5);
    layer = round(z/HEIGHT_RES + 2.0); ground (label==0) and out-of-range
    skipped; occupied = 255.
  * single-layer: per-cell max of clamp(int((z+2)*4), 0, 255), ground
    skipped.
  * float BEV (reference/BatchCloudManip.cpp:201-239, CloudManip.cpp:79-109):
    201×201 float max of z+2 (init 0); ground skipped only in the batch
    variant.

``multi_bev``, ``single_bev`` and ``float_bev`` are ``scatter_reduce(amax)``
torch ops: max does not depend on the order of the updates, so they are
deterministic on any device (for ``float_bev`` a NaN height carries into its
cell with the bits pctpu's CPU gives it, ``rounding.x86_nan``; only which of
several differently signed NaNs a cell keeps may differ, README D21).  ``fused_multi_single_bev`` computes both in one pass; on CUDA it
is the hand-written kernel ``csrc/bev_raster.cu`` (pctpu's counterpart is a
TPU-shaped double sort with a Hillis-Steele OR scan): one memset and two
kernels a call.  The two torch ops are its plain twin.  Every op takes one
cloud or a batch (leading axis).
"""

from __future__ import annotations

import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import FloatBevConfig, MultiBevConfig, SingleBevConfig
from pctpu_torch.ops import _cuda
from pctpu_torch.ops.rounding import bev_cell, c_round, to_i32, x86_nan


def _layer(z: torch.Tensor, height_res: float, cfg: MultiBevConfig) -> torch.Tensor:
    return to_i32(c_round(z / height_res + cfg.lidar_to_ground_height))


def _height(z: torch.Tensor, cfg: SingleBevConfig) -> torch.Tensor:
    # the C++ computes int((z + 2.0f) * 4.0): z+2 rounds to f32 first, and
    # the ×4.0 double multiply is exact for the power-of-two scale
    # (reference/BatchMultiBevGen.cpp:345-346)
    return to_i32(torch.trunc((z + cfg.lidar_to_ground_height) * cfg.height_scale)).clamp(0, 255)


def _batched(cloud: Cloud):
    if cloud.xyz.dim() == 3:
        return cloud.xyz, cloud.label, cloud.valid_mask(), lambda a: a
    return cloud.xyz[None], cloud.label[None], cloud.valid_mask()[None], lambda a: a[0]


def multi_bev(
    cloud: Cloud, height_res: float, cfg: MultiBevConfig = MultiBevConfig()
) -> torch.Tensor:
    """(…, num_layers, mat, mat) uint8 occupancy BEV.  ``height_res`` is the
    sensor's HEIGHT_RES (metres per layer)."""
    xyz, label, valid, out = _batched(cloud)
    s, nl = cfg.mat_size, cfg.num_layers
    cx = bev_cell(xyz[..., 0], cfg.max_range, cfg.interval).long()
    cy = bev_cell(xyz[..., 1], cfg.max_range, cfg.interval).long()
    layer = _layer(xyz[..., 2], height_res, cfg).long()
    ok = (
        (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s)
        & (layer >= 0) & (layer < nl) & (label != 0) & valid
    )
    flat = torch.where(ok, layer * s * s + cx * s + cy, nl * s * s)
    img = torch.zeros((xyz.shape[0], nl * s * s + 1), dtype=torch.int32, device=xyz.device)
    img = img.scatter_reduce(1, flat, torch.full_like(flat, 255, dtype=torch.int32), "amax")
    return out(img[:, :-1].to(torch.uint8).reshape(-1, nl, s, s))


def single_bev(cloud: Cloud, cfg: SingleBevConfig = SingleBevConfig()) -> torch.Tensor:
    """(…, mat, mat) uint8 max-height BEV."""
    xyz, label, valid, out = _batched(cloud)
    s = cfg.mat_size
    cx = bev_cell(xyz[..., 0], cfg.max_range, cfg.interval).long()
    cy = bev_cell(xyz[..., 1], cfg.max_range, cfg.interval).long()
    height = _height(xyz[..., 2], cfg)
    ok = (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s) & (label != 0) & valid
    flat = torch.where(ok, cx * s + cy, s * s)
    img = torch.zeros((xyz.shape[0], s * s + 1), dtype=torch.int32, device=xyz.device)
    img = img.scatter_reduce(1, flat, torch.where(ok, height, 0), "amax")
    return out(img[:, :-1].to(torch.uint8).reshape(-1, s, s))


def float_bev(cloud: Cloud, cfg: FloatBevConfig = FloatBevConfig()) -> torch.Tensor:
    """(…, mat, mat) float32 max(z + 2) BEV (zero-initialised): one
    ``scatter_reduce_`` for the whole batch, cloud b's cells offset by
    b·(S² + 1), the last cell of each taking the points that fall outside."""
    xyz, label, valid, out = _batched(cloud)
    b, s = xyz.shape[0], cfg.mat_size
    cx = bev_cell(xyz[..., 0], cfg.max_range, cfg.interval).long()
    cy = bev_cell(xyz[..., 1], cfg.max_range, cfg.interval).long()
    ok = (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s) & valid
    if cfg.filter_ground:
        ok &= label != 0
    val = x86_nan(xyz[..., 2] + cfg.lidar_to_ground_height, xyz[..., 2])
    base = torch.arange(b, device=xyz.device)[:, None] * (s * s + 1)
    flat = torch.where(ok, cx * s + cy, s * s) + base
    img = torch.zeros(b * (s * s + 1), dtype=torch.float32, device=xyz.device)
    img.scatter_reduce_(0, flat.reshape(-1), torch.where(ok, val, 0.0).reshape(-1), "amax")
    return out(img.view(b, s * s + 1)[:, :-1].reshape(b, s, s))


def fused_bev_compatible(multi_cfg: MultiBevConfig, single_cfg: SingleBevConfig) -> bool:
    """Whether the two BEV configs share one (cell, grid) geometry (pctpu's
    routing rule: otherwise the two rasters run as separate ops)."""
    return (
        multi_cfg.max_range == single_cfg.max_range
        and multi_cfg.interval == single_cfg.interval
        and multi_cfg.mat_size == single_cfg.mat_size
        and multi_cfg.mat_size <= 2047
        and multi_cfg.num_layers <= 24
    )


def fused_multi_single_bev_reference(
    cloud: Cloud, height_res: float,
    multi_cfg: MultiBevConfig = MultiBevConfig(),
    single_cfg: SingleBevConfig = SingleBevConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the ``bev_raster`` kernel."""
    return multi_bev(cloud, height_res, multi_cfg), single_bev(cloud, single_cfg)


def _raster_inputs(cloud: Cloud, multi_cfg: MultiBevConfig, single_cfg: SingleBevConfig):
    """Validate a CUDA cloud for the raster kernels.  Returns (xyz, label,
    count (B,) int64 on the card, out) with ``out`` undoing the batch axis."""
    dev = cloud.device
    if dev.type != "cuda":
        raise ValueError(f"the bev_raster kernels need CUDA tensors, got {dev}")
    # not _batched: the kernels test a point against its cloud's count
    # themselves, so no valid mask is built
    batched = cloud.xyz.dim() == 3
    xyz, label = (cloud.xyz, cloud.label) if batched else (cloud.xyz[None], cloud.label[None])
    b, p = label.shape
    count = cloud.count
    if isinstance(count, torch.Tensor):
        count = count.to(device=dev, dtype=torch.int64).reshape(b)
    else:
        count = torch.full((b,), int(count), dtype=torch.int64, device=dev)
    _cuda.require(xyz, "xyz", torch.float32, (b, p, 3), dev)
    _cuda.require(label, "label", torch.int32, (b, p), dev)
    return xyz, label, count, (lambda a: a) if batched else (lambda a: a[0])


def _raster_launcher(cloud: Cloud, height_res: float,
                     multi_cfg: MultiBevConfig = MultiBevConfig(),
                     single_cfg: SingleBevConfig = SingleBevConfig(),
                     counter: torch.Tensor | None = None):
    """Validate a CUDA cloud for ``csrc/bev_raster.cu`` and allocate its
    outputs and scratch.  Returns (launch, multi, single): each ``launch()``
    puts one call's work on the stream — the memset and the two kernels — and
    counts one ``bev_raster``.  ``counter`` (a zeroed int64 CUDA
    tensor) receives the atomics the raster kernel sends."""
    if not fused_bev_compatible(multi_cfg, single_cfg):
        raise ValueError("fused raster needs matching multi/single BEV grid geometry")
    xyz, label, count, out = _raster_inputs(cloud, multi_cfg, single_cfg)
    dev = xyz.device
    b, p = label.shape
    s, nl = multi_cfg.mat_size, multi_cfg.num_layers
    scratch = torch.empty((b, 2, s * s), dtype=torch.int32, device=dev)
    multi = torch.empty((b, nl, s, s), dtype=torch.uint8, device=dev)
    single = torch.empty((b, s, s), dtype=torch.uint8, device=dev)
    fn = _cuda.library().pctpu_bev_raster
    counter_ptr = None if counter is None else counter.data_ptr()

    def launch():
        rc = fn(xyz.data_ptr(), label.data_ptr(), count.data_ptr(), b, p, s, nl,
                multi_cfg.max_range, multi_cfg.interval, height_res,
                multi_cfg.lidar_to_ground_height, single_cfg.lidar_to_ground_height,
                single_cfg.height_scale, scratch.data_ptr(), multi.data_ptr(),
                single.data_ptr(), counter_ptr, _cuda.stream_ptr(dev))
        _cuda.check(rc, "bev_raster")

    return launch, out(multi), out(single)


def fused_multi_single_bev(
    cloud: Cloud, height_res: float,
    multi_cfg: MultiBevConfig = MultiBevConfig(),
    single_cfg: SingleBevConfig = SingleBevConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both flagship rasters in one pass: exactly ``(multi_bev(...),
    single_bev(...))``.  CUDA tensors launch ``csrc/bev_raster.cu`` (or
    raise); CPU tensors run the twin."""
    if cloud.device.type == "cpu":
        if not fused_bev_compatible(multi_cfg, single_cfg):
            raise ValueError("fused raster needs matching multi/single BEV grid geometry")
        return fused_multi_single_bev_reference(cloud, height_res, multi_cfg, single_cfg)
    launch, multi, single = _raster_launcher(cloud, height_res, multi_cfg, single_cfg)
    launch()
    return multi, single


def atomics_sent(cloud: Cloud, height_res: float,
                   multi_cfg: MultiBevConfig = MultiBevConfig(),
                   single_cfg: SingleBevConfig = SingleBevConfig()) -> int:
    """The global atomics one call's raster kernel sends for this cloud,
    from the kernel's own count (synchronises)."""
    counter = torch.zeros((1,), dtype=torch.int64, device=cloud.device)
    _raster_launcher(cloud, height_res, multi_cfg, single_cfg, counter)[0]()
    return int(counter.item())
