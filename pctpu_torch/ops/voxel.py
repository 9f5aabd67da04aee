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
On CUDA that is the kernel ``csrc/segment_sum.cu`` (a warp per tile of 32
rows, heads adding side by side, long runs carried on with their rows in
flight), because ``index_add_`` sums with atomics in an order that changes
from run to run.

A batch of B clouds (B, N, 3) is one stable sort of B·N rows on a
cloud-major key (b << 31 | voxel key) and one segment-sum call whose ids
are offset by b·N: each voxel's rows are still added in input order, so each
cloud's centroids are bit-equal to its own unbatched grid.
"""

from __future__ import annotations

import torch

from pctpu_torch.ops import _cuda


def segment_sum_sorted_reference(
    values: torch.Tensor, seg: torch.Tensor, init=None, n_out: int | None = None,
    order: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch twin of the segment-sum kernel.

    ``values`` (·, L) f32; ``seg`` (n,) integer segment ids, one per row:
    row i is ``values[order[i]]`` (``values[i]`` without an ``order``).
    Equal ids are contiguous; an id outside [0, ``n_out``) marks a row that
    joins no segment.  Returns (``n_out``, L), ``n_out`` = n unless given:
    row s holds ``init`` (L floats, zeros unless given) plus segment s's
    rows, added one by one in row order; a row that no segment names holds
    ``init``.  Step k adds the k-th row of every segment at once (one update
    per segment per step, so the order inside each segment is the row
    order); once fewer than ``_TAIL_SEGMENTS`` segments are still running,
    each of them adds its remaining rows one at a time, so a cloud whose
    empty cells all fall in one segment costs its length, not length × n."""
    n, lanes = seg.shape[0], values.shape[1]
    dev = values.device
    n_out = n if n_out is None else n_out
    rows = values if order is None else values[order]
    start = torch.zeros(lanes) if init is None else torch.tensor(init, dtype=torch.float32)
    out = start.to(dev).repeat(n_out, 1)
    seg = seg.long()
    valid = (seg >= 0) & (seg < n_out)
    if n == 0 or not bool(valid.any()):
        return out
    seg = torch.where(valid, seg, -1)
    i = torch.arange(n, device=dev)
    prev = torch.cat([seg.new_full((1,), -1), seg[:-1]])
    head = valid & (seg != prev)
    pos = i - torch.cummax(torch.where(head, i, 0), dim=0).values
    longest = int(pos[valid].max()) + 1
    # the rows grouped by their place in their segment (row order inside a
    # group); rows that join no segment sort last
    by_pos = torch.argsort(torch.where(valid, pos, longest), stable=True)
    counts = torch.bincount(pos[valid], minlength=longest).tolist()
    done, k = 0, 0
    while k < longest and counts[k] >= _TAIL_SEGMENTS:
        at = by_pos[done:done + counts[k]]
        out[seg[at]] = out[seg[at]] + rows[at]
        done += counts[k]
        k += 1
    rest = by_pos[done:done + sum(counts[k:])].sort().values
    if rest.numel():
        ids, lens = torch.unique_consecutive(seg[rest], return_counts=True)
        for s, piece in zip(ids.tolist(), rows[rest].split(lens.tolist())):
            acc = out[s]
            for row in piece.unbind(0):
                acc = acc + row
            out[s] = acc
    return out


# segments still running below which the twin adds row by row
_TAIL_SEGMENTS = 8


def _segment_launcher(values, seg, init, n_out, order, count_as, fill=True):
    """Validate CUDA inputs of the segment-sum kernels and allocate the
    output.  Returns (launch, out): each ``launch()`` makes the one C call
    (the fill of ``out`` with ``init``, then the sums) and counts it under
    ``count_as``.  Without ``fill`` rows that no segment names are left
    unwritten."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"the segment-sum kernel needs CUDA tensors, got {dev}")
    n, lanes = seg.shape[0], values.shape[-1]
    if lanes not in (2, 4):
        raise ValueError(f"segment sums take rows of 2 or 4 lanes, got {lanes}")
    _cuda.require(values, "values", torch.float32, (-1, lanes), dev)
    _cuda.require(seg, "seg", torch.int32, (n,), dev)
    if order is None:
        if values.shape[0] != n:
            raise ValueError(f"{values.shape[0]} rows for {n} segment ids")
    else:
        _cuda.require(order, "order", torch.int64, (n,), dev)
    n_out = n if n_out is None else n_out
    if n == 0 or n_out <= 0 or max(n, n_out, values.shape[0]) >= 2**31:
        raise ValueError(f"segment sums: unsupported sizes n={n}, n_out={n_out}")
    if values.data_ptr() % (4 * lanes):
        raise ValueError("segment sums: values must be aligned to a row")
    if init is not None and len(init) != lanes:
        raise ValueError(f"init has {len(init)} values for {lanes} lanes")
    start = (*(float(v) for v in init or ()), 0.0, 0.0, 0.0, 0.0)[:4]
    out = torch.empty((n_out, lanes), dtype=torch.float32, device=dev)
    fn = _cuda.library().pctpu_segment_sum
    order_ptr = None if order is None else order.data_ptr()

    def launch():
        rc = fn(values.data_ptr(), order_ptr, seg.data_ptr(), n, lanes, *start,
                out.data_ptr(), n_out, int(fill), _cuda.stream_ptr(dev))
        _cuda.check(rc, count_as)

    return launch, out


def segment_sum_sorted(
    values: torch.Tensor, seg: torch.Tensor, init=None, n_out: int | None = None,
    order: torch.Tensor | None = None, count_as: str = "segment_sum4", fill: bool = True,
) -> torch.Tensor:
    """In-order per-segment sums (see :func:`segment_sum_sorted_reference`).
    CUDA tensors launch the kernel (or raise) and need int32 ids, and an
    ``order`` whose entries index rows of ``values`` (the kernel does not
    check them); CPU tensors run the twin.  ``count_as`` names the launch count the launch adds to
    (the ground marking's sector sums count as ``ground_sums``).  A caller
    that reads no row but those its segments name passes ``fill=False``: on
    the card such rows are then left unwritten, one launch less."""
    dev = values.device
    if dev.type == "cpu":
        return segment_sum_sorted_reference(values, seg, init, n_out, order)
    launch, out = _segment_launcher(values, seg, init, n_out, order, count_as, fill=fill)
    launch()
    return out


def voxel_segments(
    xyz: torch.Tensor, mask: torch.Tensor, leaf: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The voxel grid's sort: rows (x, y, z, 1) of the valid points in
    ascending-voxel order (stable, so input order inside a voxel), their
    voxel ids (int32, -1 past the valid rows) and the voxel count (int64) —
    the inputs of :func:`segment_sum_sorted`.  For one cloud (N, 3): N rows,
    ids from 0, a 0-d count.  For a batch (B, N, 3): B·N rows, cloud b's
    rows and ids from b·N, a (B,) count."""
    single = xyz.dim() == 2
    if single:
        xyz, mask = xyz[None], mask[None]
    dev = xyz.device
    b, n = mask.shape
    inv = 1.0 / leaf
    mins = torch.where(mask[..., None], xyz, 1e30).amin(dim=1, keepdim=True)
    maxs = torch.where(mask[..., None], xyz, -1e30).amax(dim=1, keepdim=True)
    ijk = torch.floor(xyz * inv).to(torch.int64)
    min_b = torch.floor(mins * inv).to(torch.int64)
    max_b = torch.floor(maxs * inv).to(torch.int64)
    div = max_b - min_b + 1
    # extent clamp (D13): x/y cap at 4096 cells each, z gets what remains of
    # a 2³⁰-key budget
    dx = torch.clamp_max(div[..., 0], 4096)
    dy = torch.clamp_max(div[..., 1], 4096)
    dz = torch.minimum(div[..., 2], torch.clamp_min((1 << 30) // (dx * dy), 1))
    div = torch.stack([dx, dy, dz], dim=-1)
    rel = torch.minimum(torch.clamp_min(ijk - min_b, 0), div - 1)
    key = rel[..., 0] + rel[..., 1] * dx + rel[..., 2] * dx * dy
    # keys stay below 2³¹ (masked points: dx·dy·dz ≤ 2³⁰), so the cloud's
    # index above them keeps each cloud's rows together
    key = torch.where(mask, key, dx * dy * dz)
    key = key + (torch.arange(b, device=dev) << 31)[:, None]

    order = torch.sort(key.reshape(-1), stable=True).indices
    key_s, xyz_s, mask_s = key.reshape(-1)[order], xyz.reshape(-1, 3)[order], mask.reshape(-1)[order]
    prev = torch.cat([key_s.new_full((1,), -1), key_s[:-1]])
    head = ((key_s != prev) & mask_s).reshape(b, n)
    local = torch.cumsum(head, dim=1, dtype=torch.int32) - 1
    offset = (torch.arange(b, device=dev, dtype=torch.int32) * n)[:, None]
    seg = torch.where(mask_s, (local + offset).reshape(-1), -1)
    values = torch.cat(
        [
            torch.where(mask_s[:, None], xyz_s, 0.0),
            mask_s.to(torch.float32)[:, None],
        ],
        dim=1,
    )
    nvox = head.sum(dim=1)
    return values, seg, nvox[0] if single else nvox


def voxel_downsample(
    xyz: torch.Tensor, mask: torch.Tensor, leaf: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xyz (N,3), valid (N,), leaf) → (centroids (N,3), valid (N,), count as
    a 0-d int64 tensor).  Centroids are compacted to the front in
    ascending-voxel order.  A batch (B, N, 3) gives the same with a leading
    B (count (B,)), in one sort and one segment-sum call."""
    values, seg, nvox = voxel_segments(xyz, mask, leaf)
    # rows at and past each cloud's nvox are masked below: no fill
    acc = segment_sum_sorted(values, seg, fill=False).reshape(*xyz.shape[:-1], 4)
    valid = torch.arange(xyz.shape[-2], device=xyz.device) < nvox[..., None]
    centroids = torch.where(
        valid[..., None], acc[..., :3] / torch.clamp_min(acc[..., 3], 1.0)[..., None], 0.0
    )
    return centroids, valid, nvox
