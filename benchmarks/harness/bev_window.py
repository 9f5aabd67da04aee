"""The BEV window: ``run_multi_bev``'s loop body (pipelines/multi_bev.py) over
batches of keyframes decoded before the window.

Set-up ray-casts a pool of keyframes from the seed in the configuration's
selector layout, as the loader's arrays (on-disk widths padded to the grid).
The port's own producer thread (``runtime.loader.batched_prefetch``) hands
out each batch's keyframes, every cloud perturbed by pctpu's multiplicative
factor (so no two clouds of a run are bitwise equal) and checked by
``ops.ordering.arrays_grid_ordered``, as the CLI's producer does after a
file read.  The window then runs, batch by batch, what the CLI runs between
its loader and its writers: ``stack_batch``, ``_to_device``,
``preprocess_batch`` (``assume_ordered`` when every cloud passed the check),
``_wire`` and ``_to_host``.  The writers are not called.

A batch counts when its results are on the host.  Batches drawn from the
seed are kept for the check.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from harness import scene



def loader_arrays(kf: dict, capacity: int) -> dict:
    """A keyframe's fields as ``runtime.loader.load_xyzirct_arrays`` returns
    a PCD of them: on-disk widths, zero-padded to ``capacity``, ``count``."""
    n = min(len(kf["x"]), capacity)
    out = {"xyz": np.zeros((capacity, 3), np.float32),
           "intensity": np.zeros((capacity,), np.float32),
           "row": np.zeros((capacity,), np.uint16), "col": np.zeros((capacity,), np.uint16),
           "t": np.zeros((capacity,), np.uint32), "label": np.zeros((capacity,), np.int16),
           "count": np.int32(n)}
    for i, k in enumerate("xyz"):
        out["xyz"][:n, i] = kf[k][:n]
    for k in ("intensity", "row", "col", "t", "label"):
        out[k][:n] = kf[k][:n].astype(out[k].dtype)
    return out


def grid(config: dict) -> int:
    return int(config["sensor"]["n_scan"]) * int(config["sensor"]["horizon_scan"])


def make_pool(config: dict, traffic: dict, seed: int) -> list[dict]:
    """``traffic["pool"]`` keyframes of a drive through a seeded street,
    ``config["spacing_m"]`` apart, in the loader's arrays."""
    rng = np.random.default_rng([int(seed), 1])
    n = int(traffic["pool"])
    if n > int(config["keyframes"]):
        raise ValueError(f"the pool ray-casts {n} keyframes; the configuration allows "
                         f"{config['keyframes']}")
    spacing = float(config["spacing_m"])
    boxes = scene.world(rng, spacing * n)
    pool = []
    for k in range(n):
        x, y, yaw = spacing * k, 2.5 + 0.5 * np.sin(k / 7.0), 0.02 * k
        kf = scene.keyframe(config["layout"], boxes, x, y, yaw, rng)
        pool.append(loader_arrays(kf, grid(config)))
    return pool


def port_configs(config: dict):
    from pctpu_torch.config import GroundConfig, MultiBevConfig, SensorParams, SingleBevConfig

    return (SensorParams(**config["sensor"]), GroundConfig(**config["ground"]),
            MultiBevConfig(**config["multi_bev"]), SingleBevConfig(**config["single_bev"]))


class BevWindow:
    """One run's BEV work: set-up, then ``window(seconds)``."""

    unit = "clouds"

    def __init__(self, config: dict, traffic: dict, seed: int, device, span):
        from pctpu_torch.ops import ordering
        from pctpu_torch.runtime import loader

        self.config, self.traffic, self.device, self.span = config, traffic, device, span
        self.batch = int(traffic["batch"])
        self.params, self.ground, self.multi, self.single = port_configs(config)
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
        # items for far more batches than any window runs; the producer
        # thread works two batches ahead, as in the CLI
        self._loader = loader.batched_prefetch(list(range(self.batch * 100_000)), self.batch,
                                               load, prefetch=2)
        self.sample: list[tuple[int, dict, dict]] = []
        self._seen = 0
        t0 = time.perf_counter()
        for _ in range(int(traffic["warmup_batches"])):
            self._step(keep=False)
        self.sync()
        self.stats["warmup_s"] = time.perf_counter() - t0

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, keep: bool) -> int:
        """One loop body of ``run_multi_bev``; returns the clouds done."""
        from pctpu_torch.ops import preprocess
        from pctpu_torch.pipelines import multi_bev as mb
        from pctpu_torch.runtime import loader

        with self.span("fetch_batch"):
            names, payloads = next(self._loader)
        with self.span("stack"):
            ordered = all(p["_grid_ordered"] for p in payloads)
            arrays = loader.stack_batch(
                [{k: v for k, v in p.items() if k != "_grid_ordered"} for p in payloads])
        with self.span("upload"):
            clouds = mb._to_device(arrays, self.device)
        with self.span("preprocess"):
            labeled, multi, single = preprocess.preprocess_batch(
                clouds, self.params, self.ground, self.multi, self.single,
                assume_ordered=ordered, compat=self.compat)
        with self.span("to_host"):
            host = mb._to_host([{**mb._wire(labeled), "multi": multi, "single": single}])
        if keep:
            self._keep(arrays, host, ordered)
        return len(names)

    def _keep(self, arrays: dict, host: dict, ordered: bool) -> None:
        """Reservoir sampling of ``traffic["check_batches"]`` batches."""
        k = int(self.traffic["check_batches"])
        item = (self._seen, arrays, host)
        if len(self.sample) < k:
            self.sample.append(item)
        else:
            j = int(self.rng.integers(0, self._seen + 1))
            if j < k:
                self.sample[j] = item
        self._seen += 1

    def window(self, seconds: float) -> tuple[int, int, float]:
        """Whole batches until ``seconds`` have passed: (clouds, batches,
        seconds from the first batch's start to the last one's results)."""
        t0 = time.perf_counter()
        items = batches = 0
        while True:
            items += self._step(keep=True)
            batches += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                return items, batches, t1 - t0

    def close(self) -> None:
        with contextlib.suppress(Exception):
            self._loader.close()

    def free(self) -> None:
        """Drop what the check does not need (the pool and the loader)."""
        self.close()
        self.pool = []

    def check(self, rules: dict, control: str | None = None) -> dict:
        """The sampled batches against the plain reference: numbers
        compared, each with its limit (``harness.checks``)."""
        from harness.checks import judge_bev

        return judge_bev(self, rules, control)
Window = BevWindow
