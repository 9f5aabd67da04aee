"""The registration bench scene, in numpy — the port's copy of
``bench.py``'s ``registration_scene`` (bench.py:968-999), which builds pctpu
clouds and so cannot be imported here."""

from __future__ import annotations

import numpy as np


def registration_scene() -> tuple[np.ndarray, np.ndarray]:
    """40 vertical clusters of 150 points + 45,000 ground points, 51,000 in
    all: (xyz (51000, 3) f32, labels (51000,) int32)."""
    rng = np.random.default_rng(0)
    pts, labels = [], []
    for _ in range(40):
        cx, cy = rng.uniform(-60, 60, 2)
        n = 150
        pts.append(np.stack([cx + rng.normal(0, 2.5, n), cy + rng.normal(0, 2.5, n),
                             rng.uniform(0, 9, n)], 1))
        labels.append(np.full(n, -2))
    ng = 45000
    pts.append(np.stack([rng.uniform(-70, 70, ng), rng.uniform(-70, 70, ng),
                         rng.uniform(-2.0, -1.9, ng)], 1))
    labels.append(np.zeros(ng))
    return np.concatenate(pts).astype(np.float32), np.concatenate(labels).astype(np.int32)


def moved_copy(xyz: np.ndarray) -> np.ndarray:
    """The bench pair's second cloud (bench.py:991-994): ``xyz`` turned 17°
    about z and shifted by (1.5, −2.0, 0), in f32."""
    th = np.radians(17.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]], np.float32)
    return xyz @ rot.T + np.array([1.5, -2.0, 0], np.float32)
