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
import math

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
    points).  On a card the fields cross in one staged copy
    (:func:`_staged_fields`)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    given = {"xyz": xyz, "intensity": intensity, "row": row, "col": col, "t": t,
             "label": label}
    for v in given.values():
        if v is not None and np.shape(v)[0] != n:
            raise ValueError(f"field length {np.shape(v)[0]} != xyz length {n}")
    count = int(n if count is None else count)
    if _staged(device):
        shapes = {k: (capacity, 3) if k == "xyz" else (capacity,) for k, *_ in _FIELDS}
        return Cloud(**_staged_fields(shapes, lambda dst: _fill_padded(dst, given, n),
                                      device), count=count)

    def _field(v, np_dtype, torch_dtype):
        if v is None:
            v = np.zeros((n,), np_dtype)
        v = np.asarray(v).astype(np_dtype)
        out = torch.zeros((capacity,), dtype=torch_dtype, device=device)
        out[:n] = torch.from_numpy(v).to(device=device, dtype=torch_dtype)
        return out

    xyz_t = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
    xyz_t[:n] = torch.from_numpy(xyz).to(device)
    profiler.count("cloud.upload.direct")
    return Cloud(
        xyz=xyz_t,
        intensity=_field(intensity, np.float32, torch.float32),
        row=_field(row, np.int32, torch.int32),
        col=_field(col, np.int32, torch.int32),
        t=_field(t, np.int64, torch.int64),
        label=_field(label, np.int32, torch.int32),
        count=count,
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
    included) — how tests feed pctpu and the port identical inputs.  On a
    card the fields cross in one staged copy (:func:`_staged_fields`).
    Traced as ``cloud.upload``, on whichever thread calls it."""
    with profiler.span("cloud.upload"):
        if _staged(device):
            shapes = {k: np.shape(d[k]) for k, *_ in _FIELDS}
            return Cloud(**_staged_fields(shapes, lambda dst: _fill(dst, d), device),
                         count=int(d["count"]))

        def _t(a, dtype):
            return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

        profiler.count("cloud.upload.direct")
        return Cloud(
            xyz=_t(np.asarray(d["xyz"], np.float32), torch.float32),
            intensity=_t(np.asarray(d["intensity"], np.float32), torch.float32),
            row=_t(np.asarray(d["row"], np.int32), torch.int32),
            col=_t(np.asarray(d["col"], np.int32), torch.int32),
            t=_t(np.asarray(d["t"]).astype(np.int64), torch.int64),
            label=_t(np.asarray(d["label"], np.int32), torch.int32),
            count=int(d["count"]),
        )


# -- the staged upload: a Cloud's fields in one block, one copy to the card --

# the fields in their Cloud dtypes, in the order they sit in a staged block
_FIELDS = (("xyz", torch.float32, np.float32), ("intensity", torch.float32, np.float32),
           ("row", torch.int32, np.int32), ("col", torch.int32, np.int32),
           ("t", torch.int64, np.int64), ("label", torch.int32, np.int32))
# each field's offset in a block is a multiple of this, so every field is as
# aligned as if the card's allocator had handed it out alone
_ALIGN = 256


def _staged(device) -> bool:
    """Whether a Cloud for ``device`` crosses by :func:`_staged_fields`: on
    a card."""
    return torch.device(device).type == "cuda"


def _layout(shapes: dict) -> tuple[dict, int]:
    """Each field's (byte offset, shape, torch dtype, numpy dtype) in one
    block, given each field's shape, and the block's size in bytes."""
    out, off = {}, 0
    for name, dtype, np_dtype in _FIELDS:
        shape = tuple(shapes[name])
        out[name] = (off, shape, dtype, np_dtype)
        off += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return out, off


def _views(block: torch.Tensor, fields: dict) -> dict[str, torch.Tensor]:
    """The fields of :func:`_layout` as contiguous typed views of a uint8
    ``block``: one view of the block a dtype, one ``as_strided`` a field."""
    typed, out = {}, {}
    for name, (off, shape, dtype, _) in fields.items():
        if dtype not in typed:
            typed[dtype] = block.view(dtype)
        strides = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        out[name] = typed[dtype].as_strided(shape, strides, off // dtype.itemsize)
    return out


def _host_views(block: torch.Tensor, fields: dict) -> dict[str, np.ndarray]:
    """The fields of :func:`_layout` as numpy views of a uint8 host
    ``block``."""
    raw = block.numpy()
    return {name: np.ndarray(shape, np_dtype, raw, off)
            for name, (off, shape, _, np_dtype) in fields.items()}


def _fill_one(view: np.ndarray, src) -> None:
    """One host pass of ``src`` into ``view``: torch's copy, on its
    intra-op threads with the interpreter lock released, where the dtypes
    match; else numpy's cast, the one the direct path makes (``t`` as
    uint32), which numpy also makes where torch cannot read the array
    (read-only or reversed)."""
    src = np.asarray(src)
    if src.dtype == view.dtype and src.flags.writeable and min(src.strides, default=0) >= 0:
        torch.from_numpy(view).copy_(torch.from_numpy(src))
    else:
        np.copyto(view, src, casting="unsafe")


def _fill(dst: dict, d: dict) -> None:
    """Every view of ``dst`` from the same key of ``d``."""
    for name, view in dst.items():
        _fill_one(view, d[name])


def _fill_padded(dst: dict, given: dict, n: int) -> None:
    """The first ``n`` points of every view of ``dst`` from ``given`` (a
    None field all zero), and every slot after them zero."""
    for name, view in dst.items():
        if given[name] is not None:
            _fill_one(view[:n], given[name])
        torch.from_numpy(view[0 if given[name] is None else n:]).zero_()


def _host_block(nbytes: int) -> torch.Tensor:
    """A pinned uint8 host block from torch's caching host allocator."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def _send(host: torch.Tensor, device) -> torch.Tensor:
    """``host`` copied to a block of the same size on the card: one
    non-blocking copy on the caller's current stream, so the kernels that
    read the block queue behind it and nothing waits on the host.  The
    caching host allocator hands ``host``'s block out again only once the
    copy has finished."""
    block = torch.empty(host.shape, dtype=host.dtype, device=device)
    return block.copy_(host, non_blocking=True)


def _staged_fields(shapes: dict, fill, device) -> dict[str, torch.Tensor]:
    """A Cloud's six fields on a card through one staged copy: ``fill``
    writes the numpy views of a pinned host block from torch's caching host
    allocator (traced as ``cloud.upload.fill``), :func:`_send` copies the
    block to the card, and the fields are views of the device block."""
    fields, nbytes = _layout(shapes)
    host = _host_block(nbytes)
    with profiler.span("cloud.upload.fill"):
        fill(_host_views(host, fields))
    block = _send(host, device)
    profiler.count("cloud.upload.staged")
    return _views(block, fields)
