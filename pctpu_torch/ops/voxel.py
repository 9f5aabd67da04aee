"""Deterministic voxel-grid centroid downsampling (PCL VoxelGrid semantics) —
the port of ``pctpu/ops/voxel.py``.

Reproduces ``pcl::VoxelGrid`` with leaf 0.2
(reference/BatchTopPartRegistration.cpp:342-346): voxel index
ijk = floor(coord / leaf) offset by the cloud min; one output point per
occupied voxel = the centroid of its points; outputs ordered by ascending
flat voxel index.

Points are stably sorted by voxel key, so each voxel's points form one run
in input order.  The per-voxel sums are taken by ``segment_sum_sorted``:
one sequential in-order sum per run, as pctpu's scatter-add takes them (D14).
On CUDA that is the kernel ``csrc/segment_sum.cu``, because ``index_add_``
sums with atomics in an order that changes from run to run.
"""

from __future__ import annotations

import torch

from pctpu_torch.ops import _cuda


def segment_sum_sorted_reference(values: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the segment-sum kernel.

    ``values`` (n, 4) f32; ``seg`` (n,) int64 segment ids, equal ids
    contiguous, -1 for rows that join no segment.  Returns (n, 4): row s holds
    the sum of segment s's rows, added one by one in row order starting from
    0.0; rows past the last segment are zero.  Step k adds the k-th row of
    every segment at once (one update per segment per step, so the order
    inside each segment is the row order)."""
    n = values.shape[0]
    out = torch.zeros((n, 4), dtype=torch.float32, device=values.device)
    valid = seg >= 0
    i = torch.arange(n, device=values.device)
    prev = torch.cat([seg.new_full((1,), -1), seg[:-1]])
    head = valid & (seg != prev)
    pos = i - torch.cummax(torch.where(head, i, 0), dim=0).values
    pos = torch.where(valid, pos, -1)
    for k in range(int(pos.max()) + 1 if n else 0):
        rows = torch.nonzero(pos == k).squeeze(1)
        out[seg[rows]] = out[seg[rows]] + values[rows]
    return out


def segment_sum_sorted(values: torch.Tensor, seg: torch.Tensor,
                       count_as: str = "segment_sum4") -> torch.Tensor:
    """In-order per-segment sums (see :func:`segment_sum_sorted_reference`).
    CUDA tensors launch the kernel (or raise); CPU tensors run the twin.
    ``count_as`` names the launch count the launch adds to (the ground
    marking's sector sums count as ``ground_sums``)."""
    dev = values.device
    if dev.type == "cpu":
        return segment_sum_sorted_reference(values, seg)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_sorted: unsupported device {dev}")
    n = values.shape[0]
    _cuda.require(values, "values", torch.float32, (n, 4), dev)
    _cuda.require(seg, "seg", torch.int64, (n,), dev)
    if n == 0:
        raise ValueError("segment_sum_sorted: empty input")
    if values.data_ptr() % 16:
        raise ValueError("segment_sum_sorted: values must be 16-byte aligned")
    out = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rc = _cuda.library().pctpu_segment_sum4(
        values.data_ptr(), seg.data_ptr(), n, out.data_ptr(), _cuda.stream_ptr(dev)
    )
    _cuda.check(rc, count_as)
    return out


def voxel_segments(
    xyz: torch.Tensor, mask: torch.Tensor, leaf: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The voxel grid's sort: rows (x, y, z, 1) of the valid points in
    ascending-voxel order (stable, so input order inside a voxel), their
    voxel ids (-1 past the valid rows) and the voxel count (0-d int64) — the
    inputs of :func:`segment_sum_sorted`."""
    dev = xyz.device
    inv = 1.0 / leaf
    big = torch.tensor(1e30, dtype=torch.float32, device=dev)
    mins = torch.where(mask[:, None], xyz, big).amin(dim=0)
    maxs = torch.where(mask[:, None], xyz, -big).amax(dim=0)
    ijk = torch.floor(xyz * inv).to(torch.int64)
    min_b = torch.floor(mins * inv).to(torch.int64)
    max_b = torch.floor(maxs * inv).to(torch.int64)
    div = max_b - min_b + 1
    # extent clamp (D13): x/y cap at 4096 cells each, z gets what remains of
    # a 2³⁰-key budget
    dx = torch.clamp_max(div[0], 4096)
    dy = torch.clamp_max(div[1], 4096)
    dz = torch.minimum(div[2], torch.clamp_min((1 << 30) // (dx * dy), 1))
    div = torch.stack([dx, dy, dz])
    rel = torch.minimum(torch.clamp_min(ijk - min_b, 0), div - 1)
    key = rel[:, 0] + rel[:, 1] * div[0] + rel[:, 2] * div[0] * div[1]
    key = torch.where(mask, key, div[0] * div[1] * div[2])

    order = torch.sort(key, stable=True).indices
    key_s, xyz_s, mask_s = key[order], xyz[order], mask[order]
    prev = torch.cat([key_s.new_full((1,), -1), key_s[:-1]])
    head = (key_s != prev) & mask_s
    seg = torch.where(mask_s, torch.cumsum(head, dim=0) - 1, -1)
    values = torch.cat(
        [
            torch.where(mask_s[:, None], xyz_s, 0.0),
            mask_s.to(torch.float32)[:, None],
        ],
        dim=1,
    )
    return values, seg, head.sum()


def voxel_downsample(
    xyz: torch.Tensor, mask: torch.Tensor, leaf: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xyz (N,3), valid (N,), leaf) → (centroids (N,3), valid (N,), count as
    a 0-d int64 tensor).  Centroids are compacted to the front in
    ascending-voxel order."""
    values, seg, nvox = voxel_segments(xyz, mask, leaf)
    acc = segment_sum_sorted(values, seg)
    valid = torch.arange(xyz.shape[0], device=xyz.device) < nvox
    centroids = torch.where(
        valid[:, None], acc[:, :3] / torch.clamp_min(acc[:, 3], 1.0)[:, None], 0.0
    )
    return centroids, valid, nvox
