"""Plain numpy reference of what one batch_multi_bev_gen loop body makes of a
keyframe: getOrderedCloud, markGroundPoints and the two uint8 BEVs
(reference/BatchMultiBevGen.cpp:94-373), with the C++'s f32/f64 arithmetic,
and the labeled cloud in the wire's widths.

It takes the keyframe as the loader hands it over (on-disk widths padded to
the grid, ``count``) and works everything out itself; it imports nothing of
the program.  One cell at a time in point order, as the C++ does.

The only transcendental on the path is the slope test's ``atan2``.  The
card's ``atan2f`` and numpy's may differ in the last bits, so a pair whose
f32 angle lies within ``EDGE_DEG`` of the 10 degree limit is an edge: the
reference answers for each way such pairs can fall (up to
``MAX_EDGE_VARIANTS`` ways), and a cloud is right when it equals one of
them bit for bit.
"""

from __future__ import annotations

import itertools

import numpy as np

EDGE_DEG = 1e-4  # about 100 f32 ulps of 10 degrees
MAX_EDGE_CELLS = 4
F32_MAX = np.float32(np.finfo(np.float32).max)


def _to_i32(v: np.ndarray) -> np.ndarray:
    """Saturating f32 -> int32 of integral values, NaN -> 0."""
    v = np.asarray(v, np.float64)
    out = np.where(np.isnan(v), 0.0, v)
    out = np.clip(out, -2147483648.0, 2147483647.0)
    return out.astype(np.int64)


def _c_round_f32(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    k = np.floor(a)
    r = k + (a - k >= np.float32(0.5)).astype(np.float32)
    return np.where(v < 0, -r, r).astype(np.float32)


def _bev_cell(coord: np.ndarray, max_range: float, interval: float) -> np.ndarray:
    """round((coord + MAX_RANGE) / interval + 0.5): f32 quotient, the 0.5
    promotes to double, C round."""
    t = (coord + np.float32(max_range)) / np.float32(interval)
    return np.where(t >= -0.5, _to_i32(np.floor(t)) + 1, _to_i32(np.ceil(t)))


def smallest_f32_above(margin: float) -> np.float32:
    m32 = np.float32(margin)
    return m32 if float(m32) > margin else np.nextafter(m32, np.float32(np.inf))


def ordered_cloud(a: dict, n_scan: int, horizon: int) -> dict:
    """getOrderedCloud: each in-bounds point of the first ``count`` written
    to slot row*H + col, the last one winning; other slots all-zero."""
    g = n_scan * horizon
    n = int(a["count"])
    row = a["row"][:n].astype(np.int64)
    col = a["col"][:n].astype(np.int64)
    ok = (row >= 0) & (row < n_scan) & (col >= 0) & (col < horizon)
    src = np.flatnonzero(ok)
    cell = row[src] * horizon + col[src]
    winner = np.full(g, -1, np.int64)
    winner[cell] = src  # fancy assignment applies in order: the last wins
    occ = winner >= 0
    w = winner[occ]
    out = {"xyz": np.zeros((g, 3), np.float32), "intensity": np.zeros(g, np.float32),
           "row": np.zeros(g, np.int64), "col": np.zeros(g, np.int64),
           "t": np.zeros(g, np.int64), "label": np.zeros(g, np.int64)}
    out["xyz"][occ] = a["xyz"][w]
    out["intensity"][occ] = a["intensity"][w]
    out["row"][occ] = row[w]
    out["col"][occ] = col[w]
    out["t"][occ] = a["t"][w].astype(np.int64)
    out["label"][occ] = a["label"][w].astype(np.int64)
    return out


def _slope(xyz, inten, n, h, gus):
    """(angle f32 (R, H), invalid (R, H)) of the swept rows' pairs with their
    upper readings: one ring up, else col + 2 on that ring, else the flat
    slot two before, else two rings up (BatchMultiBevGen.cpp:146-171)."""
    g = n * h
    r_min = n - gus
    flat_idx = np.arange(g).reshape(n, h)
    lo = flat_idx[r_min:]
    c0 = flat_idx[r_min - 1:n - 1]
    c1 = np.roll(c0, -2, axis=1)
    c2 = (c0 - 2) % g
    c3 = flat_idx[r_min - 2:n - 2]
    up = c0.copy()
    i_up = inten[c0]
    sel = i_up == -1
    up = np.where(sel, c1, up)
    i_up = inten[up]
    sel = i_up == -1
    up = np.where(sel, c2, up)
    i_up = inten[up]
    rr = np.arange(r_min, n)[:, None]
    sel = (i_up == -1) & (rr >= 2)
    up = np.where(sel, c3, up)
    i_up = inten[up]
    invalid = (inten[lo] == -1) | (i_up == -1)
    d = xyz[up] - xyz[lo]  # f32
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    # sqrt(fma(dx, dx, dy*dy)), the sum and the root rounded once each
    dyy = (dy * dy).astype(np.float32)
    hl = np.sqrt((dx.astype(np.float64) ** 2 + dyy).astype(np.float32).astype(np.float64))
    hl = hl.astype(np.float32)
    with np.errstate(invalid="ignore"):
        angle = np.rad2deg(np.arctan2(dz, hl)).astype(np.float32)
    return angle, invalid


def labels_from_slope(ordered: dict, slope_ok: np.ndarray, invalid: np.ndarray,
                      n: int, h: int, gus: int, ground: dict) -> np.ndarray:
    """The labels after the bottom-up marks, the in-order sector averages
    and the rooftop veto, from each swept pair's slope verdict."""
    g = n * h
    r_min = n - gus
    mark = np.zeros((n, h), np.int8)
    mark[r_min - 1] = slope_ok[0]
    from_below = np.concatenate([slope_ok[1:], np.zeros_like(slope_ok[:1])], 0)
    mark[r_min:] = np.where(invalid, -1, (slope_ok | from_below).astype(np.int8))
    mark = mark.reshape(g)
    lo0 = (r_min - 1) * h
    xyz = ordered["xyz"][lo0:]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    gnd = mark[lo0:] == 1
    rows, cols = int(ground["grid_rows"]), int(ground["grid_cols"])
    cell = np.float32(ground["cell_size"])
    srow = np.clip(_to_i32(np.floor((x + np.float32(ground["offset_x"])) / cell)), 0, rows - 1)
    scol = np.clip(_to_i32(np.floor((y + np.float32(ground["offset_y"])) / cell)), 0, cols - 1)
    sector = srow * cols + scol
    zsum = np.zeros(rows * cols, np.float32)
    cnt = np.full(rows * cols, np.float32(ground["count_epsilon"]), np.float32)
    # ufunc.at adds one index at a time, in order, in the array's f32
    np.add.at(zsum, sector[gnd], z[gnd])
    np.add.at(cnt, sector[gnd], np.float32(1.0))
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        avg = (zsum / cnt).astype(np.float32).reshape(rows, cols)
    avg = np.nan_to_num(avg, nan=F32_MAX, posinf=F32_MAX, neginf=-F32_MAX)
    pad = np.pad(avg, 1, constant_values=F32_MAX)
    nbr_min = np.minimum(np.minimum(pad[:-2, 1:-1], pad[2:, 1:-1]),
                         np.minimum(pad[1:-1, :-2], pad[1:-1, 2:])).reshape(-1)
    with np.errstate(invalid="ignore", over="ignore"):
        veto = (z - nbr_min[sector]).astype(np.float32) >= smallest_f32_above(
            ground["rooftop_margin"])
    band = mark[lo0:]
    mark[lo0:] = np.where(veto, 0, band)
    return np.where(mark == 1, 0, ordered["label"])


def bevs(xyz: np.ndarray, label: np.ndarray, height_res: float, multi: dict,
         single: dict) -> tuple[np.ndarray, np.ndarray]:
    """(multi (L, S, S) u8, single (S, S) u8) of a labeled ordered cloud
    (BatchMultiBevGen.cpp:261-373): ground and out-of-range points skipped."""
    s = int(multi["max_range"] * 2 / multi["interval"])
    nl = int(multi["num_layers"])
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cx = _bev_cell(x, multi["max_range"], multi["interval"])
    cy = _bev_cell(y, multi["max_range"], multi["interval"])
    with np.errstate(invalid="ignore", over="ignore"):
        layer = _to_i32(_c_round_f32((z / np.float32(height_res)
                                      + np.float32(multi["lidar_to_ground_height"]))
                                     .astype(np.float32)))
        height = np.clip(_to_i32(np.trunc(
            ((z + np.float32(single["lidar_to_ground_height"])).astype(np.float32)
             * np.float32(single["height_scale"])).astype(np.float32))), 0, 255)
    inside = (cx >= 0) & (cx < s) & (cy >= 0) & (cy < s) & (label != 0)
    m = np.zeros((nl, s, s), np.uint8)
    ok = inside & (layer >= 0) & (layer < nl)
    m[layer[ok], cx[ok], cy[ok]] = 255
    sb = np.zeros(s * s, np.int64)
    np.maximum.at(sb, cx[inside] * s + cy[inside], height[inside])
    return m, sb.reshape(s, s).astype(np.uint8)


def wire(ordered: dict, label: np.ndarray) -> dict:
    """The labeled cloud in the wire's on-disk widths."""
    return {"xyz": ordered["xyz"], "intensity": ordered["intensity"],
            "row": ordered["row"].astype(np.uint16), "col": ordered["col"].astype(np.uint16),
            "t": ordered["t"].astype(np.uint32), "label": label.astype(np.int16)}


def answers(a: dict, sensor: dict, ground: dict, multi: dict, single: dict):
    """Every answer the loop body owes for one keyframe ``a`` (the loader's
    dict of one cloud), once for each way its edge pairs can fall: yields
    dicts with the wire's keys and ``multi``, ``single``."""
    n, h, gus = int(sensor["n_scan"]), int(sensor["horizon_scan"]), int(sensor["ground_upper_scan"])
    ordered = ordered_cloud(a, n, h)
    angle, invalid = _slope(ordered["xyz"], ordered["intensity"], n, h, gus)
    limit = np.float32(ground["slope_deg"])
    with np.errstate(invalid="ignore"):
        slope_ok = (~invalid) & (np.abs(angle) <= limit)
        edge = (~invalid) & (np.abs(np.abs(angle.astype(np.float64)) - float(limit)) <= EDGE_DEG)
    cells = np.flatnonzero(edge.reshape(-1))
    if len(cells) > MAX_EDGE_CELLS:
        cells = cells[:0]
    for flips in itertools.product((False, True), repeat=len(cells)):
        ok = slope_ok.copy().reshape(-1)
        for c, f in zip(cells, flips):
            if f:
                ok[c] = ~ok[c]
        label = labels_from_slope(ordered, ok.reshape(slope_ok.shape), invalid, n, h, gus,
                                  ground)
        mb, sb = bevs(ordered["xyz"], label, sensor["height_res"], multi, single)
        yield {**wire(ordered, label), "multi": mb, "single": sb}


def _same(x: np.ndarray, y: np.ndarray) -> bool:
    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    if x.dtype == np.float32:
        return np.array_equal(x.view(np.uint32), y.astype(np.float32).view(np.uint32))
    return np.array_equal(x, y)


KEYS = ("xyz", "intensity", "row", "col", "t", "label", "multi", "single")


def differing(got: dict, want: dict) -> dict:
    """Elements that differ, by key (floats by bit pattern)."""
    out = {}
    for k in KEYS:
        x, y = np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k])
        if x.dtype == np.float32:
            out[k] = int(np.sum(x.view(np.uint32) != y.astype(np.float32).view(np.uint32)))
        else:
            out[k] = int(np.sum(x != y.astype(x.dtype)))
    return out


def judge(got: dict, a: dict, sensor: dict, ground: dict, multi: dict, single: dict) -> dict:
    """One cloud's verdict: ``ok`` when ``got`` (the program's answer, keys
    as :data:`KEYS`) equals one of the reference's answers bit for bit;
    ``diff`` the elements that differ from the closest answer."""
    best = None
    for want in answers(a, sensor, ground, multi, single):
        d = differing(got, want)
        if best is None or sum(d.values()) < sum(best.values()):
            best = d
        if not any(d.values()):
            break
    return {"ok": not any(best.values()), "diff": best}


def bf16_wire(a: dict) -> dict:
    """The control: the keyframe with its coordinates narrowed to bfloat16
    (round to nearest even), as a wire of half the bytes would carry them."""
    bits = np.ascontiguousarray(a["xyz"], np.float32).view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return {**a, "xyz": rounded.view(np.float32)}
