"""Exact bbox-pruned 1-NN over spatially sorted clouds — the counterpart of
``pctpu/ops/pallas_knn.py``.

``nn_1_pruned`` launches the CUDA kernel ``csrc/nn_pruned.cu`` (which replaces
the TPU kernels ``_make_nn_pruned_loop_kernel`` and ``_make_nn_pruned_kernel``)
for CUDA tensors, and runs its plain torch twin ``nn_1_pruned_reference`` for
CPU tensors.  The Morton sort key, the payload sort and the tile bounding
boxes are torch ops, as in pctpu they are XLA ops around the kernel.

Contract (both paths, identical results): for every query, the index of the
nearest valid target by the squared distance fma(dz, dz, fma(dy, dy, dx·dx))
(``knn.sq_dist``, correctly rounded at each step), ties to the lowest index,
and that distance; +inf and index 0 for masked queries
and for queries with no target within ``max_distance``.  pctpu's kernel
instead compares |t|² − 2q·t scores, so its winner can differ inside the
score-tie window ~4·|p|²·2⁻²³ (pallas_knn.py:355-365), and beyond the
threshold it returns +inf or a finite d² > thr²; ICP rejects both alike.
"""

from __future__ import annotations

import numpy as np
import torch

from pctpu_torch.ops import _cuda
from pctpu_torch.ops.knn import sq_dist

# tile shapes compiled into the kernel (NN_TQ, NN_TT in csrc/nn_pruned.cu)
TQ = 128
TT = 1024
_BIG = 3e38


def morton_sort_key(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """16-bit 2-D Morton code over (x, y) — a cheap locality-preserving sort
    key (int32).  Masked points get the maximum key so they sort to the end."""
    inf = torch.tensor(float("inf"), device=xyz.device)
    lo = torch.where(mask[:, None], xyz, inf).amin(dim=0)
    hi = torch.where(mask[:, None], xyz, -inf).amax(dim=0)
    span = torch.clamp_min(hi - lo, 1e-6)
    q = torch.clamp(((xyz - lo) / span * 255.0).to(torch.int32), 0, 255)

    def spread(v):  # interleave 8 bits with zeros
        v = (v | (v << 4)) & 0x0F0F
        v = (v | (v << 2)) & 0x3333
        v = (v | (v << 1)) & 0x5555
        return v

    key = spread(q[:, 0]) | (spread(q[:, 1]) << 1)
    return torch.where(mask, key, torch.full_like(key, 0x7FFFFFFF))


def spatial_sort_payload(xyz: torch.Tensor, mask: torch.Tensor, *extras):
    """Stable Morton sort carrying payload tensors (indexed on dim 0) along.
    Returns (xyz_s, mask_s, *extras_s)."""
    order = torch.sort(morton_sort_key(xyz, mask), stable=True).indices
    return (xyz[order], mask[order], *(e[order] for e in extras))


def _tile_bboxes(xyz: torch.Tensor, mask: torch.Tensor, tile: int) -> torch.Tensor:
    """(8, n_tiles) f32: rows [minx miny minz maxx maxy maxz 0 0]; fully
    masked tiles get an impossible box (min=+big, max=-big) so every gap test
    skips them.  ``xyz.shape[0]`` must be a multiple of ``tile``."""
    n = xyz.shape[0]
    nt = n // tile
    x = xyz.reshape(nt, tile, 3)
    m = mask.reshape(nt, tile, 1)
    big = torch.tensor(_BIG, dtype=torch.float32, device=xyz.device)
    mins = torch.where(m, x, big).amin(dim=1)
    maxs = torch.where(m, x, -big).amax(dim=1)
    out = torch.zeros((8, nt), dtype=torch.float32, device=xyz.device)
    out[0:3] = mins.T
    out[3:6] = maxs.T
    return out


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    rem = (-x.shape[0]) % multiple
    if not rem:
        return x
    return torch.cat([x, x.new_zeros((rem, *x.shape[1:]))])


def _thr2(max_distance: float | None) -> float:
    # the f32 square, as pctpu's jnp.float32(max_distance) ** 2
    return _BIG if max_distance is None else float(np.float32(max_distance) ** 2)


def _finish(query, query_mask, target, target_mask, idx, found, thr2):
    """Shared epilogue: re-derive the winner's d² elementwise (the kernel's
    own formula, so it matches bit for bit), then map masked, not found and
    beyond-threshold queries to (index 0, +inf)."""
    idx = idx.to(torch.int64).clamp(0, target.shape[0] - 1)
    d2 = sq_dist(query - target[idx])
    ok = query_mask & target_mask[idx] & found & (d2 <= thr2)
    inf = torch.tensor(float("inf"), device=query.device)
    return torch.where(ok, idx, 0).to(torch.int32), torch.where(ok, d2, inf)


def nn_1_pruned_reference(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    max_distance: float | None = None,
    block: int = 1 << 23,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the kernel: blocked exact brute force over all
    targets, the same contract as :func:`nn_1_pruned`.  ``block`` bounds the
    (queries × targets) elements held at once."""
    nq, nt = query.shape[0], target.shape[0]
    rows = max(1, block // max(nt, 1))
    inf = torch.tensor(float("inf"), device=query.device)
    idx = torch.zeros((nq,), dtype=torch.int64, device=query.device)
    best = torch.full((nq,), float("inf"), device=query.device)
    for s in range(0, nq, rows):
        d = sq_dist(query[s : s + rows, None, :] - target[None, :, :])
        d = torch.where(target_mask[None, :], d, inf)
        # argmin returns the first minimum: ties go to the lowest index
        best[s : s + rows], idx[s : s + rows] = torch.min(d, dim=1)
    return _finish(query, query_mask, target, target_mask, idx,
                   torch.isfinite(best), _thr2(max_distance))


def nn_1_pruned(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    max_distance: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN with bounding-box pruning: (index (Q,) int32, d² (Q,) f32).

    Both clouds should be spatially sorted (:func:`spatial_sort_payload`)
    for the pruning to bite; the result is exact either way.  CUDA tensors
    launch the kernel (or raise); CPU tensors run the plain twin."""
    dev = query.device
    if dev.type == "cpu":
        return nn_1_pruned_reference(query, query_mask, target, target_mask,
                                     max_distance)
    if dev.type != "cuda":
        raise ValueError(f"nn_1_pruned: unsupported device {dev}")
    nq, nt = query.shape[0], target.shape[0]
    _cuda.require(query, "query", torch.float32, (-1, 3), dev)
    _cuda.require(query_mask, "query_mask", torch.bool, (nq,), dev)
    _cuda.require(target, "target", torch.float32, (-1, 3), dev)
    _cuda.require(target_mask, "target_mask", torch.bool, (nt,), dev)
    if nq == 0 or nt == 0 or nt >= 2**31:
        raise ValueError(f"nn_1_pruned: unsupported sizes Q={nq}, T={nt}")
    thr2 = _thr2(max_distance)
    q_box = _tile_bboxes(_pad_rows(query, TQ), _pad_rows(query_mask, TQ), TQ)
    t_box = _tile_bboxes(_pad_rows(target, TT), _pad_rows(target_mask, TT), TT)
    val = torch.empty((nq,), dtype=torch.float32, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    rc = lib.pctpu_nn_pruned(
        query.data_ptr(), query_mask.data_ptr(), nq,
        target.data_ptr(), target_mask.data_ptr(), nt,
        q_box.data_ptr(), TQ, t_box.data_ptr(), TT, thr2,
        val.data_ptr(), idx.data_ptr(), _cuda.stream_ptr(dev),
    )
    _cuda.check(rc, "nn_pruned")
    return _finish(query, query_mask, target, target_mask, idx,
                   val < _BIG / 2, thr2)
