"""1-NN kernels and their plain torch twins — the counterpart of
``pctpu/ops/pallas_knn.py`` and of the argmin experiment
``scripts/exp_nn_argmin.py``.

``nn_1_pruned`` launches the CUDA kernels of ``csrc/nn_pruned_warp.cu``
(they replace the TPU kernels ``_make_nn_pruned_loop_kernel`` and
``_make_nn_pruned_kernel``) for CUDA tensors, and runs its plain torch twin
``nn_1_pruned_reference`` for CPU tensors.  ``prepare_target`` packs a
target and its mask once — float4 points with masked ones at +inf, and the
boxes of each 32-point group and 1,024-point tile — so that a caller
searching one target many times (``icp``) pays for it once; a pass on a
prepared target is three launches (seed, main, finish) and creates no
tensor on the card but its outputs and scratch.  ``prepare_targets`` and
``nn_1_pruned_batched`` are the same kernels over a problem axis (pctpu's
kernel under ``jax.vmap`` in the pair-batched registration stages): one prep
launch packs Bt targets of one length, and one pass of three launches
searches P problems, problem p in target p // (P / Bt), bit-equal problem by
problem to P single passes; their twins run the single twins per target and
problem.  A pass (one problem is the P = 1 case) is a memset and three
launches: the seed also writes a work list of the (problem, query warp,
target tile) items that its bound cannot rule out, and a persistent main
grid works through that list on the card; its scratch holds the list, room
for every item (``_pass_scratch_words``).  The Morton sort key and the
payload sort are torch ops, as in pctpu they are XLA ops around the kernel.

Contract (both paths, identical results): for every query, the index of the
nearest valid target by the squared distance fma(dz, dz, fma(dy, dy, dx·dx))
(``knn.sq_dist``, correctly rounded at each step), ties to the lowest index,
and that distance; +inf and index 0 for masked queries
and for queries with no target within ``max_distance``.  pctpu's kernel
instead compares |t|² − 2q·t scores, so its winner can differ inside the
score-tie window ~4·|p|²·2⁻²³ (pallas_knn.py:355-365), and beyond the
threshold it returns +inf or a finite d² > thr²; ICP rejects both alike.
A target with a NaN coordinate is never found and costs no other target
anything (the answer is the one without it); pctpu's kernel loses the whole
target tile (``tt``) that holds one, masked or not, so its answer there
depends on its tile size (README D23).

``nn_1_pruned_variant`` launches the instances of ``csrc/nn_variant.cu``
(the port of ``exp_nn_argmin.py``'s ``nn_variant``): K1's warp design
(prep, seed, main grid, finish) with a query block of ``tq`` (tq / 32 warps,
each with its own box and bound), work items of ``tt`` target points (tt /
32 groups) and an argmin body for the scanned group, named as the script
names its modes; its (128, 1024, "prod") instance is K1's own shape:

  ==============  ==========================================  ==================
  script mode     argmin body of a staged 32-point group      twin
  ==============  ==========================================  ==================
  prod            K1's body: running (d², index) pair         nn_1_pruned_reference
  explicit2       min d² first, then the lowest index         nn_1_pruned_reference
                  reaching it
  onehot_exact    min of the 64-bit key (d² bits << 32 |      nn_1_pruned_reference
                  index)
  onehot_mxu      the TPU's speed probe of the same idea:     nn_1_pruned_reference
                  runs the onehot_exact body
  bf16            target packed as bf16 coordinates, widened  nn_1_pruned_bf16_reference
                  to f32 for the same fma chain
  ==============  ==========================================  ==================

The exact modes keep the contract above at every tile shape.  ``bf16``
picks winners on the coordinates rounded to bf16 (queries and targets;
boxes from the rounded points, so the pruning stays exact for them) and
returns the winner's d² re-derived from the f32 coordinates.  A call on the
card is the prep (``prepare_variant_target``, counted ``nn_variant_prep``)
and one pass of three launches (counted ``nn_variant``), with no torch op
between them but the outputs' and scratch's allocation.

``nn_1_fused`` launches ``csrc/nn_fused.cu`` (it replaces the TPU kernel
``_nn_kernel`` of ``pallas_nn_1``): the unpruned 1-NN on the score
|t|² − 2q·t with pctpu's semantics — first minimum, masked targets at
|t|² = 3e38, d² re-derived, +inf where the query or its winner is masked
(the index is kept).  One call is three launches: a prep that packs the
target as float4 (twin ``prepare_fused_target_reference``), the main grid of
query tiles × target splits, and a finish.  Its twin is
``nn_1_fused_reference``.  Where a coordinate is NaN or infinite a score is NaN, and a
NaN score never wins; pctpu's kernel instead loses every target of the
tile (``tt``) that holds one, so its answer there depends on its tile size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pctpu_torch.ops import _cuda
from pctpu_torch.ops.knn import _fma_f32, sq_dist

# nn_1_pruned's target group and tile (csrc/nn_pruned_warp.cu's kGroup,
# kTile); (TQ, TT, "prod") is the variant of K1's own shape
GROUP = 32
TT = 1024
TQ = 128
_BIG = 3e38
# a work item keeps its target tile and its problem in 16 bits each
_MAX_TARGETS = 65535 * TT
_MAX_PROBLEMS = 65535
# nn_1_fused's target tile and the queries of a block (csrc/nn_fused.cu's
# kTile, kQueries)
FUSED_TILE = 512
FUSED_QUERIES = 512

# nn_1_pruned_variant: the script's mode names and the kernel's MODE
MODES = {"prod": 0, "explicit2": 1, "onehot_exact": 2, "onehot_mxu": 2, "bf16": 3}
# the compiled (tq, tt, mode) instances, read from _cuda.NN_INSTANCES; the
# tile shapes compiled in "prod" are the script's sweep
# (exp_nn_argmin.py:437-438) plus (128, 1024) and (256, 1024)
VARIANTS = frozenset((tq, tt, name) for tq, tt, code in _cuda.NN_INSTANCES
                     for name, c in MODES.items() if c == code)
VARIANT_TILES = tuple((tq, tt) for tq, tt, code in _cuda.NN_INSTANCES
                      if code == MODES["prod"])
# the (tt, bf16) of the compiled preps: one for each tile of the instances,
# bf16 where a bf16 instance has that tile
VARIANT_PREPS = frozenset((tt, code == MODES["bf16"]) for _, tt, code in _cuda.NN_INSTANCES)


def morton_sort_key(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """16-bit 2-D Morton code over (x, y) — a cheap locality-preserving sort
    key (int32), of (N, 3) points or of each row of (P, N, 3).  Masked points
    get the maximum key so they sort to the end."""
    lo = torch.where(mask[..., None], xyz, float("inf")).amin(dim=-2, keepdim=True)
    hi = torch.where(mask[..., None], xyz, -float("inf")).amax(dim=-2, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-6)
    q = torch.clamp(((xyz - lo) / span * 255.0).to(torch.int32), 0, 255)

    def spread(v):  # interleave 8 bits with zeros
        v = (v | (v << 4)) & 0x0F0F
        v = (v | (v << 2)) & 0x3333
        v = (v | (v << 1)) & 0x5555
        return v

    key = spread(q[..., 0]) | (spread(q[..., 1]) << 1)
    return torch.where(mask, key, torch.full_like(key, 0x7FFFFFFF))


def gather_points(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``x`` (..., N) or (..., N, C) reordered along its point axis by
    ``order`` (..., N): ``x[order]`` for one cloud, row by row for a batch."""
    axis = order.dim() - 1
    return torch.take_along_dim(x, order if x.dim() == order.dim() else order[..., None], axis)


def _morton_order(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sort(morton_sort_key(xyz, mask), dim=-1, stable=True).indices


def spatial_sort(xyz: torch.Tensor, mask: torch.Tensor):
    """Stable sort of points by Morton code (pctpu's ``spatial_sort``):
    (xyz_sorted, mask_sorted, order int32), ``xyz_sorted = xyz[order]``."""
    order = _morton_order(xyz, mask)
    return gather_points(xyz, order), gather_points(mask, order), order.to(torch.int32)


def spatial_sort_payload(xyz: torch.Tensor, mask: torch.Tensor, *extras):
    """Stable Morton sort carrying payload tensors (indexed on the point
    axis) along, of one cloud (N, 3) or each cloud of a batch (P, N, 3).
    Returns (xyz_s, mask_s, *extras_s)."""
    order = _morton_order(xyz, mask)
    return tuple(gather_points(x, order) for x in (xyz, mask, *extras))


def _tile_bboxes(xyz: torch.Tensor, mask: torch.Tensor, tile: int) -> torch.Tensor:
    """(8, n_tiles) f32: rows [minx miny minz maxx maxy maxz 0 0]; fully
    masked tiles get an impossible box (min=+big, max=-big) so every gap test
    skips them.  A NaN coordinate is left out of its box, as the kernels'
    ``fminf`` / ``fmaxf`` leave it out (such a point never wins).
    ``xyz.shape[0]`` must be a multiple of ``tile``."""
    n = xyz.shape[0]
    nt = n // tile
    x = xyz.reshape(nt, tile, 3)
    m = mask.reshape(nt, tile, 1) & ~x.isnan()
    mins = torch.where(m, x, _BIG).amin(dim=1)
    maxs = torch.where(m, x, -_BIG).amax(dim=1)
    out = torch.zeros((8, nt), dtype=torch.float32, device=xyz.device)
    out[0:3] = mins.T
    out[3:6] = maxs.T
    return out


@dataclasses.dataclass(frozen=True)
class PreparedTarget:
    """A target and its mask as :func:`nn_1_pruned`'s kernels read them:
    ``packed`` (⌈n / 1024⌉·1024, 4) f32 — x, y, z, 0 in the target's order,
    +inf coordinates for masked and padding points; ``group_box`` and
    ``tile_box``, (8, groups) and (8, tiles) f32 in ``_tile_bboxes``' layout
    over 32- and 1,024-point runs, with −0 stored as +0; ``n`` the target's
    length.  :func:`prepare_variant_target` makes the same for the variants,
    with tiles of tt points, and for ``bf16`` a bfloat16 ``packed`` of the
    rounded coordinates."""

    packed: torch.Tensor
    group_box: torch.Tensor
    tile_box: torch.Tensor
    n: int


def prepare_target_reference(target: torch.Tensor, target_mask: torch.Tensor,
                             tile: int = TT, bf16: bool = False) -> PreparedTarget:
    """Plain torch twin of the prep kernels (``nn_prep_kernel``; with
    ``tile`` and ``bf16``, ``nn_variant_prep_kernel``): tiles of ``tile``
    points; ``bf16`` packs the coordinates rounded to bf16 as a bfloat16
    (n, 4) tensor and builds the boxes from the rounded points."""
    xyz, m = _pad_rows(target, tile), _pad_rows(target_mask, tile)
    if bf16:
        xyz = _bf16(xyz)
    pts = torch.where(m[:, None], xyz, float("inf"))
    packed = torch.cat([pts, torch.zeros_like(pts[:, :1])], dim=1)
    # + 0.0 turns a −0 into +0, as the kernels do
    return PreparedTarget(packed.to(torch.bfloat16) if bf16 else packed,
                          _tile_bboxes(xyz, m, GROUP) + 0.0,
                          _tile_bboxes(xyz, m, tile) + 0.0, target.shape[0])


def prepare_target(target: torch.Tensor, target_mask: torch.Tensor) -> PreparedTarget:
    """Pack ``target`` (T, 3) f32 and ``target_mask`` (T,) bool for
    :func:`nn_1_pruned`: CUDA tensors launch the prep kernel (or raise), CPU
    tensors run :func:`prepare_target_reference`."""
    dev = target.device
    if dev.type == "cpu":
        return prepare_target_reference(target, target_mask)
    if dev.type != "cuda":
        raise ValueError(f"prepare_target: unsupported device {dev}")
    n = target.shape[0]
    _cuda.require(target, "target", torch.float32, (-1, 3), dev)
    _cuda.require(target_mask, "target_mask", torch.bool, (n,), dev)
    if not 0 < n <= _MAX_TARGETS:
        raise ValueError(f"prepare_target: unsupported size T={n}")
    tiles = -(-n // TT)
    packed = torch.empty((tiles * TT, 4), dtype=torch.float32, device=dev)
    group_box = torch.empty((8, tiles * TT // GROUP), dtype=torch.float32, device=dev)
    tile_box = torch.empty((8, tiles), dtype=torch.float32, device=dev)
    rc = _cuda.library().pctpu_nn_prep(
        target.data_ptr(), target_mask.data_ptr(), n, packed.data_ptr(),
        group_box.data_ptr(), tile_box.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(rc, "nn_prep")
    return PreparedTarget(packed, group_box, tile_box, n)



@dataclasses.dataclass(frozen=True)
class PreparedTargets:
    """Bt targets of one length as :func:`nn_1_pruned_batched`'s kernels read
    them: :class:`PreparedTarget`'s fields with a leading target axis
    (``packed`` (Bt, ⌈n / 1024⌉·1024, 4), ``group_box`` (Bt, 8, groups),
    ``tile_box`` (Bt, 8, tiles)); ``n`` the targets' length."""

    packed: torch.Tensor
    group_box: torch.Tensor
    tile_box: torch.Tensor
    n: int


def prepare_targets_reference(target: torch.Tensor,
                              target_mask: torch.Tensor) -> PreparedTargets:
    """Plain torch twin of the batched prep: :func:`prepare_target_reference`
    per target, stacked."""
    preps = [prepare_target_reference(t, m) for t, m in zip(target, target_mask)]
    return PreparedTargets(*(torch.stack([getattr(p, f) for p in preps])
                             for f in ("packed", "group_box", "tile_box")), target.shape[1])


def prepare_targets(target: torch.Tensor, target_mask: torch.Tensor) -> PreparedTargets:
    """Pack Bt targets ``target`` (Bt, T, 3) f32 and ``target_mask`` (Bt, T)
    bool for :func:`nn_1_pruned_batched` in one launch of the prep kernel
    (grid tiles × Bt): CUDA tensors launch it (or raise), CPU tensors run
    :func:`prepare_targets_reference`."""
    dev = target.device
    if dev.type == "cpu":
        return prepare_targets_reference(target, target_mask)
    if dev.type != "cuda":
        raise ValueError(f"prepare_targets: unsupported device {dev}")
    if target.dim() != 3:
        raise ValueError(f"prepare_targets: target must be (Bt, T, 3), got {tuple(target.shape)}")
    bt, n = target.shape[:2]
    _cuda.require(target, "target", torch.float32, (bt, n, 3), dev)
    _cuda.require(target_mask, "target_mask", torch.bool, (bt, n), dev)
    if not 0 < n <= _MAX_TARGETS or not 0 < bt <= _MAX_PROBLEMS:
        raise ValueError(f"prepare_targets: unsupported sizes Bt={bt}, T={n}")
    tiles = -(-n // TT)
    packed = torch.empty((bt, tiles * TT, 4), dtype=torch.float32, device=dev)
    group_box = torch.empty((bt, 8, tiles * TT // GROUP), dtype=torch.float32, device=dev)
    tile_box = torch.empty((bt, 8, tiles), dtype=torch.float32, device=dev)
    rc = _cuda.library().pctpu_nn_prep_batched(
        target.data_ptr(), target_mask.data_ptr(), bt, n, packed.data_ptr(),
        group_box.data_ptr(), tile_box.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(rc, "nn_prep_batched")
    return PreparedTargets(packed, group_box, tile_box, n)


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    rem = (-x.shape[0]) % multiple
    if not rem:
        return x
    return torch.cat([x, x.new_zeros((rem, *x.shape[1:]))])


def _thr2(max_distance: float | None) -> float:
    # the f32 square, as pctpu's jnp.float32(max_distance) ** 2
    return _BIG if max_distance is None else float(np.float32(max_distance) ** 2)


def _finish(query, query_mask, target, target_mask, idx, found, thr2):
    """The twin's epilogue: re-derive the winner's d² elementwise (the kernel's
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
    targets, the same contract as :func:`nn_1_pruned`.  A NaN d² (a NaN
    coordinate) counts as +inf, as it never wins the kernels' strict <: a
    valid target with a NaN coordinate is never found and costs no other
    target anything.  ``block`` bounds the (queries × targets) elements held
    at once."""
    nq, nt = query.shape[0], target.shape[0]
    rows = max(1, block // max(nt, 1))
    inf = torch.tensor(float("inf"), device=query.device)
    idx = torch.zeros((nq,), dtype=torch.int64, device=query.device)
    best = torch.full((nq,), float("inf"), device=query.device)
    for s in range(0, nq, rows):
        d = sq_dist(query[s : s + rows, None, :] - target[None, :, :])
        d = torch.where(target_mask[None, :] & ~d.isnan(), d, inf)
        # argmin returns the first minimum: ties go to the lowest index
        best[s : s + rows], idx[s : s + rows] = torch.min(d, dim=1)
    return _finish(query, query_mask, target, target_mask, idx,
                   torch.isfinite(best), _thr2(max_distance))


def nn_1_pruned_batched_reference(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    max_distance: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the batched pass: :func:`nn_1_pruned_reference`
    for each problem p of ``query`` (P, Q, 3) in target p // (P / Bt) of
    ``target`` (Bt, T, 3); (index (P, Q) int32, d² (P, Q) f32)."""
    per = _per_target(query.shape[0], target.shape[0])
    outs = [nn_1_pruned_reference(query[p], query_mask[p], target[p // per],
                                  target_mask[p // per], max_distance)
            for p in range(query.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _per_target(n_problems: int, n_targets: int) -> int:
    if not 0 < n_problems <= _MAX_PROBLEMS:
        raise ValueError(f"nn_1_pruned_batched: P={n_problems} problems, the grid takes "
                         f"1 to {_MAX_PROBLEMS}")
    if n_targets <= 0 or n_problems % n_targets:
        raise ValueError(f"nn_1_pruned_batched: P={n_problems} problems is no multiple of "
                         f"Bt={n_targets} targets")
    return n_problems // n_targets


def _pass_scratch_words(n_problems: int, nq: int, tiles: int) -> int:
    """The 64-bit words of a pass's scratch: the work list's count and a
    spare word, each problem's query warps' boxes (four words each), one key
    a query, and the list itself, room for every (problem, query warp, tile)
    item."""
    warps = -(-nq // 32)
    return 2 + n_problems * (4 * warps + nq + warps * tiles)


def _pass_launcher(query, query_mask, prepared, thr2, counter=None):
    """Validate CUDA queries for a pass of ``csrc/nn_pruned_warp.cu`` and
    allocate its outputs and scratch: ``query`` (Q, 3) on a
    :class:`PreparedTarget`, or (P, Q, 3) on :class:`PreparedTargets`.
    Returns (launch, idx, d2): each ``launch()`` runs the pass (the list's
    memset, seed, main and finish) into the outputs and counts it once, as
    ``nn_pruned`` or ``nn_pruned_batched``.  With ``counter`` (two int64
    words on the card) the counting instance runs, counted as
    ``nn_pruned_count``, and adds the pairs it visited and the list's items."""
    dev = query.device
    _cuda.require_card(dev, "the nn_pruned kernels")
    batched = isinstance(prepared, PreparedTargets)
    lead = query.shape[:1] if batched else ()
    if query.dim() != len(lead) + 2:
        raise ValueError(f"query has shape {tuple(query.shape)}")
    nq = query.shape[-2]
    n_problems = query.shape[0] if batched else 1
    n_targets = prepared.packed.shape[0] if batched else 1
    _per_target(n_problems, n_targets)
    _cuda.require(query, "query", torch.float32, (*lead, nq, 3), dev)
    _cuda.require(query_mask, "query_mask", torch.bool, (*lead, nq), dev)
    tiles = prepared.tile_box.shape[-1]
    tl = (n_targets,) if batched else ()
    _cuda.require(prepared.packed, "prepared.packed", torch.float32, (*tl, tiles * TT, 4), dev)
    _cuda.require(prepared.group_box, "prepared.group_box", torch.float32,
                  (*tl, 8, tiles * TT // GROUP), dev)
    _cuda.require(prepared.tile_box, "prepared.tile_box", torch.float32, (*tl, 8, tiles), dev)
    if not 0 < nq < 2**31 - 256:
        raise ValueError(f"nn_pruned: unsupported size Q={nq}")
    idx = torch.empty((*lead, nq), dtype=torch.int32, device=dev)
    d2 = torch.empty((*lead, nq), dtype=torch.float32, device=dev)
    scratch = torch.empty((_pass_scratch_words(n_problems, nq, tiles),), dtype=torch.int64,
                          device=dev)
    lib = _cuda.library()
    name = ("nn_pruned_count" if counter is not None
            else "nn_pruned_batched" if batched else "nn_pruned")
    count_ptr = None if counter is None else counter.data_ptr()
    ptrs = (prepared.packed.data_ptr(), prepared.group_box.data_ptr(),
            prepared.tile_box.data_ptr())

    def launch():
        if batched:
            rc = lib.pctpu_nn_pruned_batched(
                query.data_ptr(), query_mask.data_ptr(), n_problems, nq, *ptrs, n_targets,
                tiles, thr2, scratch.data_ptr(), idx.data_ptr(), d2.data_ptr(), count_ptr,
                _cuda.stream_ptr(dev))
        else:
            rc = lib.pctpu_nn_pruned(
                query.data_ptr(), query_mask.data_ptr(), nq, *ptrs, tiles, thr2,
                scratch.data_ptr(), idx.data_ptr(), d2.data_ptr(), count_ptr,
                _cuda.stream_ptr(dev))
        _cuda.check(rc, name)

    return launch, idx, d2


def nn_1_pruned(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
    max_distance: float | None = None,
    prepared: PreparedTarget | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN with bounding-box pruning: (index (Q,) int32, d² (Q,) f32).

    Both clouds should be spatially sorted (:func:`spatial_sort_payload`)
    for the pruning to bite; the result is exact either way.  The target is
    ``target`` and ``target_mask``, or ``prepared`` alone:
    ``prepare_target(target, target_mask)``, made once for many passes, so
    that the mask the pass uses is the one it was prepared with.  CUDA
    tensors launch the kernels (or raise); CPU tensors run the plain twin,
    on a prepared target over its packed points (a masked point is +inf)."""
    if prepared is None:
        if target is None or target_mask is None:
            raise ValueError("nn_1_pruned: give target and target_mask, or prepared")
        if query.device.type == "cpu":
            return nn_1_pruned_reference(query, query_mask, target, target_mask,
                                         max_distance)
        prepared = prepare_target(target, target_mask)
    elif target is not None or target_mask is not None:
        raise ValueError("nn_1_pruned: a prepared target takes the place of target and "
                         "target_mask; give one or the other")
    if prepared.packed.device != query.device:
        raise ValueError(f"nn_1_pruned: prepared target on {prepared.packed.device}, "
                         f"queries on {query.device}")
    if query.device.type == "cpu":
        pts = prepared.packed[:prepared.n, :3]
        return nn_1_pruned_reference(query, query_mask, pts, torch.isfinite(pts).all(dim=1),
                                     max_distance)
    launch, idx, d2 = _pass_launcher(query, query_mask, prepared, _thr2(max_distance))
    launch()
    return idx, d2


def nn_1_pruned_batched(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    prepared: PreparedTargets,
    max_distance: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`nn_1_pruned` for P problems at once: ``query`` (P, Q, 3) f32 and
    ``query_mask`` (P, Q) bool on ``prepared`` = ``prepare_targets(target
    (Bt, T, 3), mask (Bt, T))``, P a multiple of Bt (at most 65,535), problem
    p searching target p // (P / Bt).  Returns (index (P, Q) int32, d² (P, Q)
    f32), problem by problem what :func:`nn_1_pruned` returns.  CUDA tensors
    launch the three kernels once for all problems (or raise); CPU tensors
    run :func:`nn_1_pruned_batched_reference` over the packed points."""
    if prepared.packed.device != query.device:
        raise ValueError(f"nn_1_pruned_batched: prepared targets on "
                         f"{prepared.packed.device}, queries on {query.device}")
    if query.device.type == "cpu":
        pts = prepared.packed[:, :prepared.n, :3]
        return nn_1_pruned_batched_reference(query, query_mask, pts,
                                             torch.isfinite(pts).all(dim=2), max_distance)
    launch, idx, d2 = _pass_launcher(query, query_mask, prepared, _thr2(max_distance))
    launch()
    return idx, d2


def pass_counts(query, query_mask, prepared, max_distance=None) -> tuple[int, int]:
    """What one pass of :func:`nn_1_pruned` (or, on :class:`PreparedTargets`,
    of :func:`nn_1_pruned_batched`) does on the card, from the kernels'
    counting instance (synchronises): (the (query, target) pairs it scans —
    1,024 for every (32-query warp, 32-point group) it visits — and the
    items of its work list)."""
    counter = torch.zeros((2,), dtype=torch.int64, device=query.device)
    _pass_launcher(query, query_mask, prepared, _thr2(max_distance), counter)[0]()
    pairs, items = counter.tolist()
    return pairs, items


def pairs_visited(query, query_mask, prepared, max_distance=None) -> int:
    """The (query, target) pairs of :func:`pass_counts`."""
    return pass_counts(query, query_mask, prepared, max_distance)[0]


def _check_variant(name: str, tq: int, tt: int, mode: str) -> None:
    if (tq, tt, mode) not in VARIANTS:
        raise ValueError(f"{name}: ({tq}, {tt}, {mode!r}) is not compiled (see "
                         "cuda_knn.VARIANTS)")


def _variant_twin(query, query_mask, target, target_mask, max_distance, mode):
    twin = nn_1_pruned_bf16_reference if mode == "bf16" else nn_1_pruned_reference
    return twin(query, query_mask, target, target_mask, max_distance)


def prepare_variant_target(target: torch.Tensor, target_mask: torch.Tensor, tt: int,
                           bf16: bool = False) -> PreparedTarget:
    """Pack ``target`` (T, 3) f32 and ``target_mask`` (T,) bool for the
    variants of tile ``tt`` (``bf16`` for the ``bf16`` mode): ``packed``
    (⌈T / tt⌉·tt, 4) f32, or bfloat16 for ``bf16``, and the boxes of each
    32-point group and tt-point tile.  CUDA tensors launch the prep kernel of
    ``csrc/nn_variant.cu`` (or raise), counted ``nn_variant_prep``; CPU
    tensors run :func:`prepare_target_reference`.  A (tt, bf16) that no
    compiled instance has (``VARIANT_PREPS``) raises ValueError."""
    if (tt, bool(bf16)) not in VARIANT_PREPS:
        raise ValueError(f"prepare_variant_target: no compiled instance has tt={tt}"
                         f"{' in bf16' if bf16 else ''} (see cuda_knn.VARIANTS)")
    dev = target.device
    if dev.type == "cpu":
        return prepare_target_reference(target, target_mask, tt, bf16)
    if dev.type != "cuda":
        raise ValueError(f"prepare_variant_target: unsupported device {dev}")
    n = target.shape[0]
    _cuda.require(target, "target", torch.float32, (-1, 3), dev)
    _cuda.require(target_mask, "target_mask", torch.bool, (n,), dev)
    tiles = -(-n // tt)
    if not 0 < tiles <= 65535:
        raise ValueError(f"prepare_variant_target: unsupported size T={n} at tt={tt}")
    dtype = torch.bfloat16 if bf16 else torch.float32
    packed = torch.empty((tiles * tt, 4), dtype=dtype, device=dev)
    group_box = torch.empty((8, tiles * tt // GROUP), dtype=torch.float32, device=dev)
    tile_box = torch.empty((8, tiles), dtype=torch.float32, device=dev)
    rc = _cuda.library().pctpu_nn_variant_prep(
        target.data_ptr(), target_mask.data_ptr(), n, tt, int(bf16), packed.data_ptr(),
        group_box.data_ptr(), tile_box.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(rc, "nn_variant_prep")
    return PreparedTarget(packed, group_box, tile_box, n)


def _variant_launcher(query, query_mask, prepared, target, thr2, tq, tt, mode):
    """Validate CUDA queries for a pass of instance (tq, tt, mode) of
    ``csrc/nn_variant.cu`` on ``prepared`` (:func:`prepare_variant_target`
    at ``tt``, bf16 for ``bf16``) and allocate its outputs and scratch;
    ``target`` is the f32 target, read for ``bf16``'s d² (else ignored).
    Returns (launch, idx, d2): each ``launch()`` runs the pass (seed, main
    and finish) into the outputs and counts one ``nn_variant``."""
    _check_variant("nn_variant", tq, tt, mode)
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"the nn_variant kernels need CUDA tensors, got {dev}")
    nq = query.shape[0]
    _cuda.require(query, "query", torch.float32, (-1, 3), dev)
    _cuda.require(query_mask, "query_mask", torch.bool, (nq,), dev)
    tiles = prepared.tile_box.shape[-1]
    bf16 = mode == "bf16"
    _cuda.require(prepared.packed, "prepared.packed", torch.bfloat16 if bf16 else torch.float32,
                  (tiles * tt, 4), dev)
    _cuda.require(prepared.group_box, "prepared.group_box", torch.float32,
                  (8, tiles * tt // GROUP), dev)
    _cuda.require(prepared.tile_box, "prepared.tile_box", torch.float32, (8, tiles), dev)
    if bf16:
        _cuda.require(target, "target", torch.float32, (prepared.n, 3), dev)
    if not 0 < nq < 2**31 - 256:
        raise ValueError(f"nn_variant: unsupported size Q={nq}")
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    d2 = torch.empty((nq,), dtype=torch.float32, device=dev)
    # the query warps' boxes (four words each), then one 64-bit key a query
    scratch = torch.empty((4 * -(-nq // 32) + nq,), dtype=torch.int64, device=dev)
    lib = _cuda.library()
    ptrs = (prepared.packed.data_ptr(), prepared.group_box.data_ptr(),
            prepared.tile_box.data_ptr())
    t32 = target.data_ptr() if bf16 else None

    def launch():
        rc = lib.pctpu_nn_variant(
            query.data_ptr(), query_mask.data_ptr(), nq, *ptrs, tiles, tq, tt, MODES[mode],
            thr2, t32, scratch.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            _cuda.stream_ptr(dev))
        _cuda.check(rc, "nn_variant")

    return launch, idx, d2


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
    launch that instance of ``csrc/nn_variant.cu`` — its prep, then one pass
    — (or raise); CPU tensors run the mode's twin, which does not depend on
    the tile shape."""
    _check_variant("nn_1_pruned_variant", tq, tt, mode)
    if query.device.type == "cpu":
        return _variant_twin(query, query_mask, target, target_mask, max_distance, mode)
    prepared = prepare_variant_target(target, target_mask, tt, mode == "bf16")
    launch, idx, d2 = _variant_launcher(query, query_mask, prepared, target,
                                        _thr2(max_distance), tq, tt, mode)
    launch()
    return idx, d2


def _finish_fused(query, query_mask, target, target_mask, idx):
    """pallas_nn_1's epilogue (pallas_knn.py:120-125): clamp the index,
    re-derive d², +inf where the query or its winner is masked; the index
    is kept either way."""
    idx = idx.to(torch.int64).clamp(0, target.shape[0] - 1)
    d2 = sq_dist(query - target[idx])
    inf = torch.tensor(float("inf"), device=query.device)
    ok = query_mask & target_mask[idx]
    return idx.to(torch.int32), torch.where(ok, d2, inf)


def prepare_fused_target_reference(target: torch.Tensor,
                                   target_mask: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the fused kernel's prep (``nn_fused_prep_kernel``):
    the target as (⌈T / 512⌉·512, 4) f32 rows x, y, z, |t|² with
    |t|² = fma(tz, tz, fma(ty, ty, tx·tx)), 3e38 where masked, and padding
    rows (0, 0, 0, 3e38) — pctpu's ``_plane_layout`` planes, a point a row."""
    tx, ty, tz = target.unbind(1)
    t_sq = torch.where(target_mask, _fma_f32(tz, tz, _fma_f32(ty, ty, tx * tx)), _BIG)
    packed = _pad_rows(torch.cat([target, t_sq[:, None]], dim=1), FUSED_TILE)
    packed[target.shape[0]:, 3] = _BIG
    return packed


def nn_1_fused_reference(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    block: int = 1 << 23,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the fused kernels, blocked over queries
    (``block`` bounds the (queries × targets) elements held at once).  The
    score is the kernels': cross = fma(qz, tz, fma(qy, ty, qx·tx)),
    |t|² = fma(tz, tz, fma(ty, ty, tx·tx)) (3e38 where masked) and
    |t|² − 2·cross, whose f32 subtraction is the correctly rounded
    fma(−2, cross, |t|²) because 2·cross is exact.  A NaN score (a NaN or
    infinite coordinate) never wins, as under the kernels' strict ``<``;
    ``torch.min`` returns the first minimum; a minimum not below 3e38 keeps
    index 0."""
    nq, nt = query.shape[0], target.shape[0]
    big = torch.tensor(_BIG, dtype=torch.float32, device=query.device)
    tx, ty, tz, t_sq = prepare_fused_target_reference(target, target_mask)[:nt].unbind(1)
    rows = max(1, block // max(nt, 1))
    idx = torch.zeros((nq,), dtype=torch.int64, device=query.device)
    for s in range(0, nq, rows):
        qx, qy, qz = (c[:, None] for c in query[s : s + rows].unbind(1))
        cross = _fma_f32(qz, tz, _fma_f32(qy, ty, qx * tx))
        score = t_sq - 2.0 * cross
        best, arg = torch.min(torch.where(score.isnan(), float("inf"), score), dim=1)
        idx[s : s + rows] = torch.where(best < big, arg, 0)
    return _finish_fused(query, query_mask, target, target_mask, idx)


def _fused_launcher(query, query_mask, target, target_mask, splits: int = 0):
    """Validate CUDA inputs for ``csrc/nn_fused.cu`` and allocate its output
    and scratch.  Returns (launch, idx, packed): each ``launch()`` runs the
    prep, main and finish kernels and counts one ``nn_fused``; ``packed`` is
    the prep kernel's output.  ``splits`` > 0 fixes the main grid's target
    splits (0: the C side picks them, :func:`fused_grid`)."""
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"nn_1_fused: the kernel needs CUDA tensors, got {dev}")
    nq, nt = query.shape[0], target.shape[0]
    _cuda.require(query, "query", torch.float32, (-1, 3), dev)
    _cuda.require(query_mask, "query_mask", torch.bool, (nq,), dev)
    _cuda.require(target, "target", torch.float32, (-1, 3), dev)
    _cuda.require(target_mask, "target_mask", torch.bool, (nt,), dev)
    if nq == 0 or nt == 0 or nt >= 2**31 - FUSED_TILE:
        raise ValueError(f"nn_1_fused: unsupported sizes Q={nq}, T={nt}")
    packed = torch.empty((-(-nt // FUSED_TILE) * FUSED_TILE, 4), dtype=torch.float32, device=dev)
    keys = torch.empty((nq,), dtype=torch.int64, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    fn = _cuda.library().pctpu_nn_fused

    def launch():
        rc = fn(query.data_ptr(), nq, target.data_ptr(), target_mask.data_ptr(), nt,
                packed.data_ptr(), keys.data_ptr(), idx.data_ptr(), splits,
                _cuda.stream_ptr(dev))
        _cuda.check(rc, "nn_fused")

    return launch, idx, packed


def fused_grid(nq: int, nt: int, splits: int = 0) -> tuple[int, int]:
    """The main kernel's grid for Q queries and T targets on the current
    card: (query tiles, target splits)."""
    got = _cuda.library().pctpu_nn_fused_splits(nq, nt, splits)
    if got <= 0:
        raise ValueError(f"nn_1_fused: unsupported sizes Q={nq}, T={nt}")
    return -(-nq // FUSED_QUERIES), got


def nn_1_fused(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpruned fused 1-NN, the port of ``pallas_nn_1``: (index (Q,) int32,
    d² (Q,) f32).  CUDA tensors launch ``csrc/nn_fused.cu`` (or raise); CPU
    tensors run :func:`nn_1_fused_reference`."""
    if query.device.type == "cpu":
        return nn_1_fused_reference(query, query_mask, target, target_mask)
    launch, idx, _ = _fused_launcher(query, query_mask, target, target_mask)
    launch()
    return _finish_fused(query, query_mask, target, target_mask, idx)
