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
    """

    xyz: torch.Tensor
    intensity: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    t: torch.Tensor
    label: torch.Tensor
    count: int | torch.Tensor

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


def from_numpy(d: dict, device: torch.device | str = "cuda") -> Cloud:
    """Build a Cloud on ``device`` (the card unless asked otherwise) from the
    dict that ``pctpu.cloud.to_numpy`` returns (full capacity, padding
    included) — how tests feed pctpu and the port identical inputs."""

    def _t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return Cloud(
        xyz=_t(np.asarray(d["xyz"], np.float32), torch.float32),
        intensity=_t(np.asarray(d["intensity"], np.float32), torch.float32),
        row=_t(np.asarray(d["row"], np.int32), torch.int32),
        col=_t(np.asarray(d["col"], np.int32), torch.int32),
        t=_t(np.asarray(d["t"]).astype(np.int64), torch.int64),
        label=_t(np.asarray(d["label"], np.int32), torch.int32),
        count=int(d["count"]),
    )
