"""Point-cloud data model: a structure-of-arrays dataclass of tensors.

The port of ``pctpu/cloud.py``: the same fields, a fixed point capacity, and
``count`` leading real points.  Differences: ``t`` (uint32 on disk and in
pctpu) is carried as int64 because torch's uint32 support is thin — it is
bit-cast only at I/O — and ``count`` is a Python int, so building a valid
mask needs no device round trip.  A batch of clouds carries a leading batch
axis on every field and a ``(B,)`` int tensor as ``count``.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from pctpu_torch.runtime import profiler

# label conventions of the reference: not yet segmented
# (KittiPointCloudSelect.cpp:237) and ground (BatchMultiBevGen.cpp:245)
LABEL_UNSEGMENTED = -2
LABEL_GROUND = 0


@dataclasses.dataclass(frozen=True)
class Cloud:
    """A fixed-capacity point cloud.

    Attributes:
      xyz:       (N, 3) float32 positions.
      intensity: (N,)   float32.
      row:       (N,)   int32 ring index.
      col:       (N,)   int32 azimuth bin index.
      t:         (N,)   int64 per-point time (uint32 on disk).
      label:     (N,)   int32 segmentation label.
      count:     number of real points (leading slots); a (B,) tensor
                 when the fields carry a leading batch axis.
      ordering_counts: (B, 2) int64 on the device, or None: the in-bounds
                 points of each input cloud (B = 1 without a batch axis) and
                 those that lost their slot to a later point, set by
                 ``ops.ordering.get_ordered_cloud`` while tracing
                 (``multi_bev._to_host`` records them).
    """

    xyz: torch.Tensor
    intensity: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    t: torch.Tensor
    label: torch.Tensor
    count: int | torch.Tensor
    ordering_counts: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def x(self) -> torch.Tensor:
        return self.xyz[..., 0]

    @property
    def y(self) -> torch.Tensor:
        return self.xyz[..., 1]

    @property
    def z(self) -> torch.Tensor:
        return self.xyz[..., 2]

    def valid_mask(self) -> torch.Tensor:
        """Boolean mask of real (non-padding) points."""
        idx = torch.arange(self.capacity, device=self.device)
        if isinstance(self.count, torch.Tensor):
            return idx < self.count.to(self.device)[..., None]
        return idx < self.count

    def replace(self, **changes) -> "Cloud":
        return dataclasses.replace(self, **changes)


def make_cloud(
    xyz,
    intensity=None,
    row=None,
    col=None,
    t=None,
    label=None,
    count: int | None = None,
    capacity: int | None = None,
    device: torch.device | str = "cuda",
) -> Cloud:
    """Build a Cloud on ``device`` (the card unless asked otherwise), zero-padding every field up to
    ``capacity`` (padding slots are all-zero, like default-constructed PCL
    points)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")

    def _field(v, np_dtype, torch_dtype):
        if v is None:
            v = np.zeros((n,), np_dtype)
        v = np.asarray(v).astype(np_dtype)
        if v.shape[0] != n:
            raise ValueError(f"field length {v.shape[0]} != xyz length {n}")
        out = torch.zeros((capacity,), dtype=torch_dtype, device=device)
        out[:n] = torch.from_numpy(v).to(device=device, dtype=torch_dtype)
        return out

    xyz_t = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
    xyz_t[:n] = torch.from_numpy(xyz).to(device)
    return Cloud(
        xyz=xyz_t,
        intensity=_field(intensity, np.float32, torch.float32),
        row=_field(row, np.int32, torch.int32),
        col=_field(col, np.int32, torch.int32),
        t=_field(t, np.int64, torch.int64),
        label=_field(label, np.int32, torch.int32),
        count=int(n if count is None else count),
    )


def empty_cloud(capacity: int, device: torch.device | str = "cuda") -> Cloud:
    """An all-zero cloud of ``capacity`` points on ``device``, every slot
    real (count = capacity), like the reference's
    ``output_cloud->resize(N_SCAN * Horizon_SCAN)``
    (BatchMultiBevGen.cpp:98)."""

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Cloud(xyz=zeros(capacity, 3), intensity=zeros(capacity),
                 row=zeros(capacity, dtype=torch.int32), col=zeros(capacity, dtype=torch.int32),
                 t=zeros(capacity, dtype=torch.int64), label=zeros(capacity, dtype=torch.int32),
                 count=capacity)


def stack_clouds(clouds: list[Cloud]) -> Cloud:
    """Stack equally sized clouds of one device along a new leading batch
    axis: one ``torch.stack`` a field, ``count`` a (B,) int64 tensor on
    their device."""
    fields = {f: torch.stack([getattr(c, f) for c in clouds])
              for f in ("xyz", "intensity", "row", "col", "t", "label")}
    counts = torch.tensor([int(c.count) for c in clouds], dtype=torch.int64,
                          device=fields["xyz"].device)
    return Cloud(**fields, count=counts)


def to_numpy(cloud: Cloud) -> dict[str, np.ndarray]:
    """All fields as host numpy arrays, in ``pctpu.cloud.to_numpy``'s dict
    (``t`` as uint32, ``count`` an int) — the inverse of :func:`from_numpy`."""
    return {
        "xyz": cloud.xyz.cpu().numpy(),
        "intensity": cloud.intensity.cpu().numpy(),
        "row": cloud.row.cpu().numpy(),
        "col": cloud.col.cpu().numpy(),
        "t": cloud.t.cpu().numpy().astype(np.uint32),
        "label": cloud.label.cpu().numpy(),
        "count": int(cloud.count),
    }


def from_numpy(d: dict, device: torch.device | str = "cuda") -> Cloud:
    """Build a Cloud on ``device`` (the card unless asked otherwise) from the
    dict that ``pctpu.cloud.to_numpy`` returns (full capacity, padding
    included) — how tests feed pctpu and the port identical inputs.  Traced
    as ``cloud.upload``, on whichever thread calls it."""

    def _t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    with profiler.span("cloud.upload"):
        return Cloud(
            xyz=_t(np.asarray(d["xyz"], np.float32), torch.float32),
            intensity=_t(np.asarray(d["intensity"], np.float32), torch.float32),
            row=_t(np.asarray(d["row"], np.int32), torch.int32),
            col=_t(np.asarray(d["col"], np.int32), torch.int32),
            t=_t(np.asarray(d["t"]).astype(np.int64), torch.int64),
            label=_t(np.asarray(d["label"], np.int32), torch.int32),
            count=int(d["count"]),
        )
