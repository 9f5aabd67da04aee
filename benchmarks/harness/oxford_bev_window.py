"""The BEV window on Oxford Radar RobotCar keyframes: ``harness.bev_window``'s
loop body over a pool ray-cast in the Oxford selector's layout
(``harness.oxford_scene``).

The pool's keyframes hold the returns of one sweep in firing order, fewer
than the grid's slots, so none passes ``ops.ordering.arrays_grid_ordered``
and every batch takes the general ordering, in which about 2.6% of the
returns lose their slot to a later firing.  The producer thread, the
perturbation, the loop body and the check are ``BevWindow``'s.

A keyframe with more returns than the grid has slots is refused: the CLI
would compact it (``ops.ordering.compact_last_wins``) where the loader's
arrays here would cut it short.
"""

from __future__ import annotations

import time

import numpy as np

from harness import bev_window, oxford_scene, scene


def make_pool(config: dict, traffic: dict, seed: int) -> list[dict]:
    """``traffic["pool"]`` Oxford keyframes of a drive through a seeded
    street, ``config["spacing_m"]`` apart, in the loader's arrays (the drive
    of ``bev_window.make_pool``)."""
    rng = np.random.default_rng([int(seed), 1])
    n = int(traffic["pool"])
    if n > int(config["keyframes"]):
        raise ValueError(f"the pool ray-casts {n} keyframes; the configuration allows "
                         f"{config['keyframes']}")
    grid = bev_window.grid(config)
    spacing = float(config["spacing_m"])
    boxes = scene.world(rng, spacing * n)
    pool = []
    for k in range(n):
        x, y, yaw = spacing * k, 2.5 + 0.5 * np.sin(k / 7.0), 0.02 * k
        kf = oxford_scene.keyframe(boxes, x, y, yaw, rng)
        if len(kf["x"]) > grid:
            raise ValueError(f"keyframe {k} holds {len(kf['x'])} returns, more than the "
                             f"{grid} slots of the grid")
        pool.append(bev_window.loader_arrays(kf, grid))
    return pool


class OxfordBevWindow(bev_window.BevWindow):
    """``BevWindow`` with its pool from :func:`make_pool`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, span):
        from pctpu_torch.ops import ordering
        from pctpu_torch.runtime import loader

        self.config, self.traffic, self.device, self.span = config, traffic, device, span
        self.batch = int(traffic["batch"])
        self.params, self.ground, self.multi, self.single = bev_window.port_configs(config)
        self.compat = config["compat"]
        t0 = time.perf_counter()
        self.pool = make_pool(config, traffic, seed)
        self.stats = {"pool_s": time.perf_counter() - t0}
        rng = np.random.default_rng([int(seed), 2])
        order = rng.permutation(len(self.pool))
        params = self.params

        def load(i: int) -> dict:
            # the stand-in for the file read: the pool's keyframe, perturbed
            with span("load"):
                a = dict(self.pool[order[i % len(order)]])
                a["xyz"] = a["xyz"] * np.float32(scene.perturbation(i))
                a["_grid_ordered"] = ordering.arrays_grid_ordered(a, params)
                return a

        self.rng = np.random.default_rng([int(seed), 3])
        self._loader = loader.batched_prefetch(list(range(self.batch * 100_000)), self.batch,
                                               load, prefetch=2)
        self.sample: list[tuple[int, dict, dict]] = []
        self._seen = 0
        t0 = time.perf_counter()
        for _ in range(int(traffic["warmup_batches"])):
            self._step(keep=False)
        self.sync()
        self.stats["warmup_s"] = time.perf_counter() - t0


Window = OxfordBevWindow
