"""1-NN kernels and their plain torch twins — the counterpart of
``pctpu/ops/pallas_knn.py`` and of the argmin experiment
``scripts/exp_nn_argmin.py``.

``nn_1_pruned`` launches the CUDA kernel ``csrc/nn_pruned.cu`` at
(TQ, TT) = (128, 1024) (it replaces the TPU kernels
``_make_nn_pruned_loop_kernel`` and ``_make_nn_pruned_kernel``) for CUDA
tensors, and runs its plain torch twin ``nn_1_pruned_reference`` for CPU
tensors.  The Morton sort key, the payload sort and the tile bounding boxes
are torch ops, as in pctpu they are XLA ops around the kernel.

Contract (both paths, identical results): for every query, the index of the
nearest valid target by the squared distance fma(dz, dz, fma(dy, dy, dx·dx))
(``knn.sq_dist``, correctly rounded at each step), ties to the lowest index,
and that distance; +inf and index 0 for masked queries
and for queries with no target within ``max_distance``.  pctpu's kernel
instead compares |t|² − 2q·t scores, so its winner can differ inside the
score-tie window ~4·|p|²·2⁻²³ (pallas_knn.py:355-365), and beyond the
threshold it returns +inf or a finite d² > thr²; ICP rejects both alike.

``nn_1_pruned_variant`` launches the other instances of the same template
(the port of ``exp_nn_argmin.py``'s ``nn_variant``): a tile shape from
``VARIANT_TILES`` and an argmin body, named as the script names its modes:

  ==============  ==========================================  ==================
  script mode     Hopper form (``csrc/nn_pruned.cu``)         twin
  ==============  ==========================================  ==================
  prod            K1's body: running (d², index) pair         nn_1_pruned_reference
  explicit2       per tile min d², then the lowest index      nn_1_pruned_reference
                  reaching it
  onehot_exact    min of the 64-bit key (d² bits << 32 |      nn_1_pruned_reference
                  index)
  onehot_mxu      the TPU's speed probe of the same idea:     nn_1_pruned_reference
                  runs the onehot_exact body
  bf16            tiles staged as bf16 coordinates, widened   nn_1_pruned_bf16_reference
                  to f32 for the same fma chain
  ==============  ==========================================  ==================

The exact modes keep the contract above at every tile shape.  ``bf16``
picks winners on the coordinates rounded to bf16 (queries and targets;
boxes from the rounded points, so the pruning stays exact for them) and
returns the winner's d² re-derived from the f32 coordinates.

``nn_1_fused`` launches ``csrc/nn_fused.cu`` (it replaces the TPU kernel
``_nn_kernel`` of ``pallas_nn_1``): the unpruned 1-NN on the score
|t|² − 2q·t with pctpu's semantics — first minimum, masked targets at
|t|² = 3e38, d² re-derived, +inf where the query or its winner is masked
(the index is kept).  Its twin is ``nn_1_fused_reference``.
"""

from __future__ import annotations

import numpy as np
import torch

from pctpu_torch.ops import _cuda
from pctpu_torch.ops.knn import _fma_f32, sq_dist

# the tile shape of nn_1_pruned (the <128, 1024, kProd> instance of
# csrc/nn_pruned.cu)
TQ = 128
TT = 1024
_BIG = 3e38

# nn_1_pruned_variant: the script's mode names and the kernel's MODE
MODES = {"prod": 0, "explicit2": 1, "onehot_exact": 2, "onehot_mxu": 2, "bf16": 3}
# the compiled (tq, tt, mode) instances, read from _cuda.NN_INSTANCES; the
# tile shapes compiled in "prod" are the script's sweep
# (exp_nn_argmin.py:437-438) plus (128, 1024) and (256, 1024)
VARIANTS = frozenset((tq, tt, name) for tq, tt, code in _cuda.NN_INSTANCES
                     for name, c in MODES.items() if c == code)
VARIANT_TILES = tuple((tq, tt) for tq, tt, code in _cuda.NN_INSTANCES
                      if code == MODES["prod"])


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


def _pruned_launcher(query, query_mask, target, target_mask, thr2, tq, tt, mode):
    """Validate CUDA inputs for one instance of ``csrc/nn_pruned.cu`` (``mode``
    None: K1's ``pctpu_nn_pruned``), build the tile boxes and the outputs.
    Returns (launch, val, idx): each ``launch()`` runs the kernel into the
    raw outputs (best d², index) and counts the launch."""
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"the nn_pruned kernel needs CUDA tensors, got {dev}")
    nq, nt = query.shape[0], target.shape[0]
    _cuda.require(query, "query", torch.float32, (-1, 3), dev)
    _cuda.require(query_mask, "query_mask", torch.bool, (nq,), dev)
    _cuda.require(target, "target", torch.float32, (-1, 3), dev)
    _cuda.require(target_mask, "target_mask", torch.bool, (nt,), dev)
    if nq == 0 or nt == 0 or nt >= 2**31:
        raise ValueError(f"nn_pruned: unsupported sizes Q={nq}, T={nt}")
    q_box = _tile_bboxes(_pad_rows(query, tq), _pad_rows(query_mask, tq), tq)
    t_box = _tile_bboxes(_pad_rows(target, tt), _pad_rows(target_mask, tt), tt)
    val = torch.empty((nq,), dtype=torch.float32, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    fn, name, extra = ((lib.pctpu_nn_pruned, "nn_pruned", ()) if mode is None else
                       (lib.pctpu_nn_variant, "nn_variant", (MODES[mode],)))

    def launch():
        rc = fn(query.data_ptr(), query_mask.data_ptr(), nq,
                target.data_ptr(), target_mask.data_ptr(), nt,
                q_box.data_ptr(), tq, t_box.data_ptr(), tt, *extra, thr2,
                val.data_ptr(), idx.data_ptr(), _cuda.stream_ptr(dev))
        _cuda.check(rc, name)

    return launch, val, idx


def _pruned(query, query_mask, target, target_mask, max_distance, tq, tt, mode):
    """The CUDA path of :func:`nn_1_pruned` (``mode`` None) and of
    :func:`nn_1_pruned_variant`: launch, then the shared epilogue.  For
    ``bf16`` the kernel gets the rounded points, so its boxes and the
    threshold test use what it compares, and the winners' d² come from the
    f32 points."""
    thr2 = _thr2(max_distance)
    q, t = (_bf16(query), _bf16(target)) if mode == "bf16" else (query, target)
    launch, val, idx = _pruned_launcher(q, query_mask, t, target_mask, thr2, tq, tt, mode)
    launch()
    idx, d2 = _finish(q, query_mask, t, target_mask, idx, val < _BIG / 2, thr2)
    return _rescore(query, target, idx, d2) if mode == "bf16" else (idx, d2)


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
    return _pruned(query, query_mask, target, target_mask, max_distance, TQ, TT, None)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _rescore(query, target, idx, d2_rounded):
    """bf16 epilogue: keep the winners found on the rounded coordinates and
    re-derive their d² from the f32 ones."""
    d2 = sq_dist(query - target[idx.to(torch.int64)])
    inf = torch.tensor(float("inf"), device=query.device)
    return idx, torch.where(torch.isfinite(d2_rounded), d2, inf)


def nn_1_pruned_bf16_reference(query, query_mask, target, target_mask,
                               max_distance=None):
    """Plain twin of the ``bf16`` variant: the exact 1-NN
    (:func:`nn_1_pruned_reference`) of the bf16-rounded queries in the
    bf16-rounded target, then each winner's d² from the f32 coordinates."""
    idx, d2r = nn_1_pruned_reference(_bf16(query), query_mask, _bf16(target),
                                     target_mask, max_distance)
    return _rescore(query, target, idx, d2r)


def nn_1_pruned_variant(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    max_distance: float | None,
    tq: int,
    tt: int,
    mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One variant of the pruned 1-NN (see the module docstring): a
    compiled (tq, tt, mode) from ``VARIANTS``, or ValueError.  CUDA tensors
    launch that kernel instance (or raise); CPU tensors run the mode's twin,
    which does not depend on the tile shape."""
    if (tq, tt, mode) not in VARIANTS:
        raise ValueError(f"nn_1_pruned_variant: ({tq}, {tt}, {mode!r}) is not "
                         "compiled (see cuda_knn.VARIANTS)")
    if query.device.type == "cpu":
        twin = nn_1_pruned_bf16_reference if mode == "bf16" else nn_1_pruned_reference
        return twin(query, query_mask, target, target_mask, max_distance)
    return _pruned(query, query_mask, target, target_mask, max_distance, tq, tt, mode)


def _finish_fused(query, query_mask, target, target_mask, idx):
    """pallas_nn_1's epilogue (pallas_knn.py:120-125): clamp the index,
    re-derive d², +inf where the query or its winner is masked; the index
    is kept either way."""
    idx = idx.to(torch.int64).clamp(0, target.shape[0] - 1)
    d2 = sq_dist(query - target[idx])
    inf = torch.tensor(float("inf"), device=query.device)
    ok = query_mask & target_mask[idx]
    return idx.to(torch.int32), torch.where(ok, d2, inf)


def nn_1_fused_reference(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    block: int = 1 << 23,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the fused kernel, blocked over queries
    (``block`` bounds the (queries × targets) elements held at once).  The
    score is the kernel's: cross = fma(qz, tz, fma(qy, ty, qx·tx)),
    |t|² = fma(tz, tz, fma(ty, ty, tx·tx)) (3e38 where masked) and
    |t|² − 2·cross, whose f32 subtraction is the correctly rounded
    fma(−2, cross, |t|²) because 2·cross is exact.  ``torch.min`` returns
    the first minimum; a minimum not below 3e38 keeps index 0."""
    nq, nt = query.shape[0], target.shape[0]
    big = torch.tensor(_BIG, dtype=torch.float32, device=query.device)
    tx, ty, tz = target.unbind(1)
    t_sq = torch.where(target_mask, _fma_f32(tz, tz, _fma_f32(ty, ty, tx * tx)), big)
    rows = max(1, block // max(nt, 1))
    idx = torch.zeros((nq,), dtype=torch.int64, device=query.device)
    for s in range(0, nq, rows):
        qx, qy, qz = (c[:, None] for c in query[s : s + rows].unbind(1))
        cross = _fma_f32(qz, tz, _fma_f32(qy, ty, qx * tx))
        best, arg = torch.min(t_sq - 2.0 * cross, dim=1)
        idx[s : s + rows] = torch.where(best < big, arg, 0)
    return _finish_fused(query, query_mask, target, target_mask, idx)


def nn_1_fused(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpruned fused 1-NN, the port of ``pallas_nn_1``: (index (Q,) int32,
    d² (Q,) f32).  CUDA tensors launch ``csrc/nn_fused.cu`` (or raise); CPU
    tensors run :func:`nn_1_fused_reference`."""
    dev = query.device
    if dev.type == "cpu":
        return nn_1_fused_reference(query, query_mask, target, target_mask)
    if dev.type != "cuda":
        raise ValueError(f"nn_1_fused: unsupported device {dev}")
    nq, nt = query.shape[0], target.shape[0]
    _cuda.require(query, "query", torch.float32, (-1, 3), dev)
    _cuda.require(query_mask, "query_mask", torch.bool, (nq,), dev)
    _cuda.require(target, "target", torch.float32, (-1, 3), dev)
    _cuda.require(target_mask, "target_mask", torch.bool, (nt,), dev)
    if nq == 0 or nt == 0 or nt >= 2**31:
        raise ValueError(f"nn_1_fused: unsupported sizes Q={nq}, T={nt}")
    val = torch.empty((nq,), dtype=torch.float32, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    rc = _cuda.library().pctpu_nn_fused(
        query.data_ptr(), nq, target.data_ptr(), target_mask.data_ptr(), nt,
        val.data_ptr(), idx.data_ptr(), _cuda.stream_ptr(dev),
    )
    _cuda.check(rc, "nn_fused")
    return _finish_fused(query, query_mask, target, target_mask, idx)
