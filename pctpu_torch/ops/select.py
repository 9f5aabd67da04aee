"""Keyframe gating, major-frame selection and soft one-hot keyframe labels
(host numpy, the port of ``pctpu/ops/select.py``).  Pose tables are tiny, so the reference's nanoflann 1-NN / 2-NN
queries (reference/BatchMultiBevGen.cpp:534-550, 593-613) are exact
brute-force distances here, as in pctpu.
"""

from __future__ import annotations

import numpy as np

from pctpu_torch.config import SelectConfig


def greedy_keyframe_mask(
    positions: np.ndarray,
    interval: float,
    sentinel: tuple[float, float, float] = (-1e10, -1e10, 0.0),
) -> np.ndarray:
    """Greedy distance gate over a pose sequence — the keyframe gate used by
    every selector pipeline.

    positions: (N, 3) float32.  Keeps frame i iff its f32 distance to the
    last *kept* frame is >= interval
    (reference/KittiPointCloudSelect.cpp:442-470).  The first comparison is
    against ``sentinel``: KITTI uses (-1e10, -1e10, 0) (:440, the default —
    frame 0 always kept); MulRan/Oxford start from the origin
    (reference/MulranPointCloudSelect.cpp:318), so their frame 0 is kept
    only if it is >= interval from (0, 0, 0).
    """
    positions = np.asarray(positions, np.float32)
    keep = np.zeros(len(positions), bool)
    last = np.asarray(sentinel, np.float32)
    for i, p in enumerate(positions):
        d = np.sqrt(np.sum((p - last) ** 2, dtype=np.float32))
        if d < interval:
            continue
        keep[i] = True
        last = p
    return keep


def select_major_frames(
    positions: np.ndarray, cfg: SelectConfig = SelectConfig()
) -> list[int]:
    """Major-frame selection (reference/BatchMultiBevGen.cpp:502-566).

    A frame becomes major iff it is >= interval from the previous major AND
    its nearest previous major (1-NN, squared distance) is >= interval away.
    Frame 0 is always major.
    """
    positions = np.asarray(positions, np.float32)
    if len(positions) == 0:
        return []
    majors = [0]
    major_pos = [positions[0]]
    interval = np.float32(cfg.major_frame_interval)
    for i in range(1, len(positions)):
        p = positions[i]
        last = positions[majors[-1]]
        d_last = np.sqrt(np.sum((p - last) ** 2, dtype=np.float32))
        if d_last < interval:
            continue
        d2 = np.sum((np.stack(major_pos) - p) ** 2, axis=1, dtype=np.float32)
        if float(d2.min()) < float(interval) * float(interval):
            continue
        majors.append(i)
        major_pos.append(p)
    return majors


def keyframe_labels(
    positions: np.ndarray,
    major_indices: list[int],
    cfg: SelectConfig = SelectConfig(),
) -> np.ndarray:
    """Soft one-hot labels over major frames
    (reference/BatchMultiBevGen.cpp:575-636).

    For each keyframe: if its 1-NN major *is itself*, one-hot 1.0; otherwise
    inverse-squared-distance weights over the 2 nearest majors, normalized.
    With a single major frame the reference reads uninitialised memory for
    the second neighbor; we instead put the full weight on the only major
    (documented divergence).
    """
    positions = np.asarray(positions, np.float32)
    n = len(positions)
    m = len(major_indices)
    labels = np.zeros((n, m), np.float32)
    if m == 0:
        return labels  # no majors → (n, 0) label matrix, not an IndexError
    major_pos = positions[np.asarray(major_indices, np.int64)]
    eps = float(cfg.label_weight_epsilon)  # double literal, like the C++ 1e-5
    for i in range(n):
        d2 = np.sum((major_pos - positions[i]) ** 2, axis=1, dtype=np.float32)
        order = np.argsort(d2, kind="stable")
        c0 = int(order[0])
        if i == major_indices[c0]:
            labels[i, c0] = 1.0
            continue
        if m == 1:
            labels[i, c0] = 1.0
            continue
        c1 = int(order[1])
        # C++: 1.0f / (f32_d2 + 1e-5) promotes to double (the literal is a
        # double), then stores into a float; normalization is f32
        # (reference/BatchMultiBevGen.cpp:623-627)
        w0 = np.float32(1.0 / (np.float64(d2[c0]) + eps))
        w1 = np.float32(1.0 / (np.float64(d2[c1]) + eps))
        s = w0 + w1
        labels[i, c0] = w0 / s
        labels[i, c1] = w1 / s
    return labels
