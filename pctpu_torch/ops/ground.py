"""Ground marking: slope test per column + sector-average heights + rooftop
veto (the port of ``pctpu/ops/ground.py``).

Reproduces ``markGroundPoints`` (reference/BatchMultiBevGen.cpp:119-252) as
pctpu does, on clouds with a leading batch axis:

1. **Slope sweep.** Each swept cell is compared with the cell one ring up,
   falling back to col+2, col-2 (a *flat* shift, so col < 2 walks into the
   previous row like the C++'s negative ``%``), then two rings up when the
   upper reading is missing (``intensity == -1``).  All four candidates are
   static offsets of the range image: slices, rolls and ``torch.where``.
   The horizontal length is ``sqrt(fma(dx, dx, dy·dy))``, the form XLA's
   CPU backend gives pctpu's ``sqrt(dx*dx + dy*dy)`` (checked bit by bit
   on random inputs); ``atan2`` is the device's own, whose last-ulp
   differences from XLA's can flip a label only within D2's window
   (|angle| within ~1e-6° of the 10° limit).
2. **Sector averages** of (z, count) over the 75×50 grid of 2 m sectors,
   for ground cells of the swept band.  ``compat="bitexact"`` sums each
   sector sequentially in point order, the count starting at the 0.01
   epsilon — on CUDA the in-order segment-sum kernel (``index_add_`` adds
   with atomics, in an order that changes from run to run).
   ``compat="tolerance"`` is one full-f32 one-hot matmul, as pctpu's
   ``dot_general`` (sector averages within ~1e-5 relative).
3. **Rooftop veto.** A cell more than 0.30 m above the average of any valid
   4-neighbour sector is un-marked: above the *minimum* neighbour average,
   a (75, 50) shifted-min table and one gather ``nbr_min[srow, scol]``
   (exact; pctpu's one-hot MXU lookup is a TPU shape).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import GroundConfig, SensorParams
from pctpu_torch.ops.knn import _fma_f32
from pctpu_torch.ops.rounding import to_i32
from pctpu_torch.ops.voxel import segment_sum_sorted


def _strict_gt_f32_threshold(margin: float) -> np.float32:
    """Smallest f32 strictly greater than the f64 ``margin``: for f32-valued
    d, the C++'s ``(double)d > margin`` ⟺ ``d >= d0``
    (reference/BatchMultiBevGen.cpp:227-241)."""
    m64 = float(margin)
    m32 = np.float32(m64)
    # compare in f64 explicitly: NumPy 2 weak promotion would otherwise
    # round m64 down to f32 and make the comparison trivially false
    if float(m32) > m64:
        return m32
    return np.nextafter(m32, np.float32(np.inf))


def _horizontal_length(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """pctpu's ``jnp.sqrt(dx*dx + dy*dy)`` bit for bit: XLA's CPU backend
    computes it as sqrt(fma(dx, dx, dy·dy)), correctly rounded.  torch's CPU
    f32 ``sqrt`` is not correctly rounded (≈ 0.6% of values 1 ulp off), so
    the root is taken in f64 and rounded once more to f32, which is exact
    for a square root."""
    return torch.sqrt(_fma_f32(dx, dx, dy * dy).double()).float()


def _belonging_grid(x: torch.Tensor, y: torch.Tensor, cfg: GroundConfig):
    """Point → ground-grid sector (reference/BatchMultiBevGen.h:73-99): the
    f32 add + f32 divide equal the C++'s float store + double quotient for a
    power-of-two cell."""
    row = to_i32(torch.floor((x + cfg.offset_x) / cfg.cell_size))
    col = to_i32(torch.floor((y + cfg.offset_y) / cfg.cell_size))
    return row.clamp(0, cfg.grid_rows - 1), col.clamp(0, cfg.grid_cols - 1)


def sector_sums_rows(
    sector: torch.Tensor, z: torch.Tensor, ground: torch.Tensor, cfg: GroundConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The in-order sector sums as segment-sum rows: (values (n, 2) f32,
    seg (n,) int32, order (n,) int64) for
    :func:`pctpu_torch.ops.voxel.segment_sum_sorted`, n = B·P.

    ``values`` holds (z, 1) per point in point order; ``order`` is the
    stable sort of the points by segment, so row i of the sums is
    ``values[order[i]]`` and ``seg[i]`` its segment: ``b·S + s`` for a ground
    point of cloud b in sector s, in point order inside a segment, and B·S
    (past the last segment, so in none) for the others, which sort last.
    Started at (0, epsilon), a sequential sum gives ``((0 + z₁) + z₂) + …``
    and ``((ε + 1) + 1) + …`` — the C++'s rounding sequence
    (BatchMultiBevGen.cpp:135-136, 187-210); a sector without ground points
    keeps (0, ε).  pctpu adds exact zeros for non-ground points, which
    change no bit."""
    b, p = sector.shape
    nseg = b * cfg.grid_rows * cfg.grid_cols
    if nseg >= 2**31:
        raise ValueError(f"{nseg} sectors do not fit int32 segment ids")
    dev = sector.device
    first = torch.arange(b, dtype=torch.int32, device=dev)[:, None] * (nseg // b)
    key = torch.where(ground, sector.to(torch.int32) + first, nseg).reshape(-1)
    seg, order = torch.sort(key, stable=True)
    values = torch.ones((b, p, 2), dtype=torch.float32, device=dev)
    values[..., 0] = z
    return values.reshape(-1, 2), seg, order


def _grid_sums_bitexact(
    sector: torch.Tensor, z: torch.Tensor, ground: torch.Tensor, cfg: GroundConfig
) -> torch.Tensor:
    """(B, S, 2) sequential-rounding (z sum, count) per sector."""
    b = sector.shape[0]
    nsec = cfg.grid_rows * cfg.grid_cols
    values, seg, order = sector_sums_rows(sector, z, ground, cfg)
    sums = segment_sum_sorted(values, seg, init=(0.0, cfg.count_epsilon), n_out=b * nsec,
                              order=order, count_as="ground_sums")
    return sums.reshape(b, nsec, 2)


def _grid_sums_tolerance(
    srow: torch.Tensor, scol: torch.Tensor, z: torch.Tensor,
    ground: torch.Tensor, cfg: GroundConfig,
) -> torch.Tensor:
    """(B, S, 2) sector sums as one factorized one-hot contraction
    ``(2R, P) @ (P, C)`` per cloud (pctpu's ``_grid_sums_tolerance``): the z
    sums in the matmul's order instead of point order, the epsilon added
    once at the end.  Deterministic from run to run (no atomics), full f32
    (TF32 is off, see ``pctpu_torch/__init__.py``)."""
    r, c = cfg.grid_rows, cfg.grid_cols
    dev = srow.device
    oh_row = (srow[..., None] == torch.arange(r, device=dev)).to(torch.float32)
    oh_col = (scol[..., None] == torch.arange(c, device=dev)).to(torch.float32)
    gmask = ground.to(torch.float32)
    zg = torch.where(ground, z, 0.0)
    lhs = torch.cat([oh_row * zg[..., None], oh_row * gmask[..., None]], dim=-1)
    both = torch.matmul(lhs.transpose(1, 2), oh_col)  # (B, 2R, C)
    b = srow.shape[0]
    zsum = both[:, :r].reshape(b, r * c)
    count = both[:, r:].reshape(b, r * c) + cfg.count_epsilon
    return torch.stack([zsum, count], dim=-1)


def slope_pairs(
    xyz: torch.Tensor, intensity: torch.Tensor, params: SensorParams
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slope sweep's point pairs of a batch of dense ordered clouds
    ((B, G, 3) xyz, (B, G) intensity): (dx, dy, dz, invalid), each (B, R, H)
    over the swept rows [n - ground_upper_scan, n), from each cell to its
    upper reading (reference/BatchMultiBevGen.cpp:146-171)."""
    n, h = params.n_scan, params.horizon_scan
    b = xyz.shape[0]
    r_min = n - params.ground_upper_scan  # lowest swept row index
    flat = {"x": xyz[..., 0], "y": xyz[..., 1], "z": xyz[..., 2], "i": intensity}

    def cands(arr):
        a2 = arr.reshape(b, n, h)
        u0 = a2[:, r_min - 1 : n - 1]  # row above
        u1 = torch.roll(u0, -2, dims=2)  # (col+2) % H on the row above
        u2 = torch.roll(arr, 2, dims=1).reshape(b, n, h)[:, r_min - 1 : n - 1]
        u3 = a2[:, r_min - 2 : n - 2]  # two rows above
        return u0, u1, u2, u3

    cand = {k: cands(v) for k, v in flat.items()}
    rr = torch.arange(r_min, n, device=xyz.device)[:, None]
    i_up = cand["i"][0]
    sel1 = i_up == -1
    i_up = torch.where(sel1, cand["i"][1], i_up)
    sel2 = i_up == -1
    i_up = torch.where(sel2, cand["i"][2], i_up)
    sel3 = (i_up == -1) & (rr >= 2)
    i_up = torch.where(sel3, cand["i"][3], i_up)

    def select(k):
        v = cand[k][0]
        v = torch.where(sel1, cand[k][1], v)
        v = torch.where(sel2, cand[k][2], v)
        return torch.where(sel3, cand[k][3], v)

    lo = {k: flat[k].reshape(b, n, h)[:, r_min:] for k in flat}
    invalid = (lo["i"] == -1) | (i_up == -1)
    return (select("x") - lo["x"], select("y") - lo["y"], select("z") - lo["z"], invalid)


def mark_ground(
    ordered: Cloud,
    params: SensorParams,
    cfg: GroundConfig = GroundConfig(),
    compat: str = "bitexact",
) -> tuple[Cloud, torch.Tensor]:
    """Label ground points 0 in a dense ordered cloud (or a batch of them).

    Returns (cloud with updated labels, ground_mat int8 (…, n_scan,
    horizon_scan)) with the reference encoding {-1 invalid, 0 no,
    1 ground}.  ``compat`` selects the sector-sum accumulation (module
    docstring)."""
    if compat not in ("bitexact", "tolerance"):
        raise ValueError(f"compat must be 'bitexact' or 'tolerance', got {compat!r}")
    n, h = params.n_scan, params.horizon_scan
    g = n * h
    if params.ground_upper_scan >= n - 1:
        raise ValueError("ground_upper_scan must leave at least two rows above")
    batched = ordered.xyz.dim() == 3
    xyz = ordered.xyz if batched else ordered.xyz[None]
    inten = ordered.intensity if batched else ordered.intensity[None]
    b = xyz.shape[0]
    dev = xyz.device
    r_min = n - params.ground_upper_scan  # lowest swept row index

    # --- pass 1: slope test via static shifts (all (B, R, H)) -------------
    dx, dy, dz, invalid = slope_pairs(xyz, inten, params)
    angle = torch.rad2deg(torch.atan2(dz, _horizontal_length(dx, dy)))
    slope_ok = (~invalid) & (torch.abs(angle) <= cfg.slope_deg)

    # closed form of the sequential bottom-up writes: a swept cell is -1 if
    # its own pair is invalid, else 1 if its own test or the one of the cell
    # below passed; the row above the sweep is written by the sweep's top row
    from_below = torch.cat([slope_ok[:, 1:], torch.zeros_like(slope_ok[:, :1])], dim=1)
    mark = torch.zeros((b, n, h), dtype=torch.int8, device=dev)
    mark[:, r_min - 1] = slope_ok[:, 0].to(torch.int8)
    mark[:, r_min:] = torch.where(
        invalid, torch.tensor(-1, dtype=torch.int8, device=dev),
        (slope_ok | from_below).to(torch.int8),
    )
    mark = mark.reshape(b, g)

    # --- pass 2: sector averages over the swept band ----------------------
    # only rows >= r_min-1 can carry mark==1
    lo0 = (r_min - 1) * h
    x_sw, y_sw, z_sw = (xyz[:, lo0:, k] for k in range(3))
    ground_sw = mark[:, lo0:] == 1
    srow, scol = _belonging_grid(x_sw, y_sw, cfg)
    if compat == "bitexact":
        sums = _grid_sums_bitexact(srow * cfg.grid_cols + scol, z_sw, ground_sw, cfg)
    else:
        sums = _grid_sums_tolerance(srow, scol, z_sw, ground_sw, cfg)
    avg = (sums[..., 0] / sums[..., 1]).reshape(b, cfg.grid_rows, cfg.grid_cols)

    # --- pass 3: rooftop veto (min valid-neighbour average) + labels ------
    big = float(np.finfo(np.float32).max)
    # a ±inf average (overflowed sum) saturates and NaN never vetoes, like
    # the C++'s per-neighbour `NaN > 0.3` = false
    avg = torch.nan_to_num(avg, nan=big, posinf=big, neginf=-big)
    padded = F.pad(avg, (1, 1, 1, 1), value=big)
    nbr_min = torch.minimum(
        torch.minimum(padded[:, :-2, 1:-1], padded[:, 2:, 1:-1]),
        torch.minimum(padded[:, 1:-1, :-2], padded[:, 1:-1, 2:]),
    ).reshape(b, -1)
    m_per_point = nbr_min.gather(1, (srow * cfg.grid_cols + scol).long())
    veto_sw = (z_sw - m_per_point) >= float(_strict_gt_f32_threshold(cfg.rooftop_margin))
    mark[:, lo0:] = torch.where(veto_sw, torch.zeros_like(mark[:, lo0:]), mark[:, lo0:])

    is_ground = mark == 1
    label = ordered.label if batched else ordered.label[None]
    label = torch.where(is_ground, 0, label)
    mark = mark.reshape(b, n, h)
    if not batched:
        label, mark = label[0], mark[0]
    return ordered.replace(label=label), mark
