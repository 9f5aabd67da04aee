"""The registration window: the pair-batched drivers of
``pipelines/registration.py`` fed from memory.

Set-up ray-casts ``places`` places of a street, each seen twice: on a
first pass and on a revisit (``make_pool``).  Each place gives two ordered
pairs (query, match), and every pair of the window takes one of them, in
an order drawn from the seed, with the yaw guess that an estimator
resolving whole angular bins gives (the match list's ``angle_guess``).  The
keyframes are held as the PCD reader decodes them.  The traffic file names
the source of each parameter.

Inside the window each batch's pair list is built as the CLI's
``_load_pair_chunk`` builds it once the files are decoded: every cloud
crosses to the card by the port's own upload (``cloud.from_numpy``) at the
shared capacity, its xyz perturbed by pctpu's factor so that no two clouds
are bitwise equal.

- ``stage: top_part`` drives ``register_pairs_pipelined`` (``depth``) over
  thunks that build the pair lists, as ``run_batch_top_part_registration``
  does; each batch's results reach the host through its fetch.
- ``stage: whole`` calls ``register_whole_pairs`` a batch, the next batch's
  pair list built on a worker thread meanwhile, as
  ``run_batch_whole_registration`` does.

A batch counts when its results are on the host.  Pairs drawn from the
seed are kept for the check.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import time
import math

import numpy as np

from harness import scene



def _pose(x: float, y: float, yaw: float) -> np.ndarray:
    m = np.eye(4)
    c, s = math.cos(yaw), math.sin(yaw)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:2, 3] = x, y
    return m


def make_pool(config: dict, traffic: dict, seed: int):
    """(keyframes, poses, ordered pairs (query, match)): ``places`` places
    ``place_spacing_m`` apart along a street, each seen on a first pass and
    on a revisit.  The revisit's keyframe lies up to half the selector's
    keyframe gate (``gate_m``) along the track from the first pass's, as the
    nearest keyframe of an earlier pass does; each pass drives up to
    ``lateral_m`` off the lane's centre and ``heading_deg`` off the road's
    heading (uniform ranges).  The street and the places come from the
    traffic's ``world_seed``, so that every ``seed`` registers the same
    pairs, in its own order and perturbation: an ICP's work hangs on the
    scene, and a scene of the seed's own would move the work a pair from
    seed to seed."""
    rng = np.random.default_rng([int(traffic["world_seed"]), 11])
    n = int(traffic["places"])
    spacing = float(traffic["place_spacing_m"])
    half_gate = 0.5 * float(traffic["gate_m"])
    lateral, heading = float(traffic["lateral_m"]), math.radians(float(traffic["heading_deg"]))
    boxes = scene.world(rng, spacing * n)
    frames, poses, pairs = [], [], []
    for p in range(n):
        for along in (0.0, rng.uniform(-half_gate, half_gate)):
            x, y = spacing * p + along, rng.uniform(-lateral, lateral)
            yaw = rng.uniform(-heading, heading)
            frames.append(scene.keyframe(config["layout"], boxes, x, y, yaw, rng))
            poses.append(_pose(x, y, yaw))
        a, b = len(frames) - 2, len(frames) - 1
        pairs += [(a, b), (b, a)]
    if len(frames) > int(config["keyframes"]):
        raise ValueError(f"the pool ray-casts {len(frames)} keyframes; the configuration "
                         f"allows {config['keyframes']}")
    return frames, poses, pairs


def true_yaw_deg(poses: list, q: int, m: int) -> float:
    """The yaw of the transform that takes query ``q``'s sensor frame to
    match ``m``'s: inv(T_m) T_q."""
    r = np.linalg.inv(poses[m]) @ poses[q]
    return math.degrees(math.atan2(r[1, 0], r[0, 0]))


def angle_guess_deg(yaw_deg: float, bin_deg: float) -> float:
    """The match list's ``angle_guess``: the true yaw as an estimator that
    resolves it to whole angular bins of ``bin_deg`` gives it (the centre
    of the nearest bin), so it misses the truth by up to half a bin."""
    return bin_deg * round(yaw_deg / bin_deg)


def capacity_of(frames: list, step: int) -> int:
    """The CLIs' ``_auto_capacity`` rule: the largest cloud's points rounded
    up to a multiple of ``step``."""
    biggest = max(len(f["x"]) for f in frames)
    return max(-(-biggest // step) * step, step)


def port_config(config: dict, stage: str):
    from pctpu_torch.config import IcpConfig, RegistrationConfig, TopFlattenConfig

    r = config["registration"]
    if TopFlattenConfig(**r["top_flatten"]) != TopFlattenConfig():
        # the drivers take no top-flatten settings: they run the defaults
        raise ValueError("the program runs top-flatten only at TopFlattenConfig()'s "
                         f"settings, not {r['top_flatten']}")

    def icp(d):
        return IcpConfig(**{k: (float(v) if k != "max_iterations" and k != "point_to_plane"
                                else v) for k, v in d.items()})

    fine = icp(r["whole"] if stage == "whole" else r["fine"])
    return RegistrationConfig(voxel_leaf=r["voxel_leaf"], normal_radius=r["normal_radius"],
                              coarse=icp(r["coarse"]), fine=fine,
                              failure_fitness=r["failure_fitness"],
                              use_refinement=r["use_refinement"])


def padded(frame: dict, capacity: int) -> dict:
    """A decoded keyframe as ``cloud.to_numpy`` gives a cloud of it: every
    field zero-padded to ``capacity`` in the Cloud's widths, and ``count``."""
    n = len(frame["x"])
    out = {"xyz": np.zeros((capacity, 3), np.float32),
           "intensity": np.zeros(capacity, np.float32), "row": np.zeros(capacity, np.int32),
           "col": np.zeros(capacity, np.int32), "t": np.zeros(capacity, np.int64),
           "label": np.zeros(capacity, np.int32), "count": n}
    for i, k in enumerate("xyz"):
        out["xyz"][:n, i] = frame[k]
    for k in ("intensity", "row", "col", "t", "label"):
        out[k][:n] = frame[k]
    return out


class PairInput:
    """What one pair of the window was: the keyframes, the scale factors
    of their xyz and the yaw guess (degrees, as the match list's f32)."""

    __slots__ = ("q", "m", "scale_q", "scale_m", "guess_deg")

    def __init__(self, q, m, scale_q, scale_m, guess_deg):
        self.q, self.m, self.scale_q, self.scale_m, self.guess_deg = (
            q, m, scale_q, scale_m, guess_deg)


class RegWindow:
    """One run's registration work: set-up, then ``window(seconds)``."""

    unit = "pairs"

    def __init__(self, config: dict, traffic: dict, seed: int, device, span):
        self.config, self.traffic, self.device, self.span = config, traffic, device, span
        self.stage = traffic["stage"]
        self.pair_batch = int(traffic["pair_batch"])
        self.flat_cap = int(config["registration"]["flat_cap"])
        self.cfg = port_config(config, self.stage)
        t0 = time.perf_counter()
        self.frames, self.poses, self.pairs = make_pool(config, traffic, seed)
        self.capacity = capacity_of(self.frames, int(config["registration"]["capacity_step"]))
        self.guess_bin = float(traffic["guess_bin_deg"])
        self.host = [padded(f, self.capacity) for f in self.frames]
        rng = np.random.default_rng([int(seed), 12])
        self.order = rng.permutation(len(self.pairs))
        self.sample_rng = np.random.default_rng([int(seed), 13])
        self.sample: list[tuple[PairInput, object, object]] = []
        self._seen = 0
        self._next = 0  # the next batch's index
        self.stats = {"pairs_failed": 0, "pool_s": time.perf_counter() - t0}
        self._stream = None
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        t0 = time.perf_counter()
        for _ in range(int(traffic["warmup_batches"])):
            self._results()
        self.sync()
        self.stats["warmup_s"] = time.perf_counter() - t0

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pair_input(self, i: int) -> PairInput:
        q, m = self.pairs[self.order[i % len(self.order)]]
        guess = float(np.float32(angle_guess_deg(true_yaw_deg(self.poses, q, m),
                                                 self.guess_bin)))
        return PairInput(q, m, scene.perturbation(2 * i), scene.perturbation(2 * i + 1), guess)

    def upload(self, frame: int, scale: float):
        """The port's upload (``cloud.from_numpy``) of a decoded keyframe,
        padded to the shared capacity, its xyz scaled."""
        from pctpu_torch.cloud import from_numpy

        d = self.host[frame]
        return from_numpy({**d, "xyz": d["xyz"] * np.float32(scale)}, device=self.device)

    def pair_list(self, k: int):
        """Batch ``k``'s (cloud_1, cloud_2, yaw guess) list and its inputs."""
        with self.span("load_pairs"):
            ins = [self.pair_input(k * self.pair_batch + j) for j in range(self.pair_batch)]
            return ins, [(self.upload(p.q, p.scale_q), self.upload(p.m, p.scale_m), p.guess_deg)
                         for p in ins]

    def _top_part_stream(self):
        from pctpu_torch.pipelines import registration as R

        inputs: dict[int, list] = {}

        def thunk(k):
            def load():
                ins, pairs = self.pair_list(k)
                inputs[k] = ins
                return pairs
            return load

        def thunks():
            while True:
                k = self._next
                self._next += 1
                yield thunk(k)

        k = self._next
        for results in R.register_pairs_pipelined(thunks(), self.cfg, flat_cap=self.flat_cap,
                                                  depth=int(self.traffic["depth"])):
            yield inputs.pop(k), results
            k += 1

    def _whole_stream(self):
        from pctpu_torch.pipelines import registration as R

        def take():
            k = self._next
            self._next += 1
            return self._pool.submit(self.pair_list, k)

        fut = take()
        while True:
            ins, pairs = fut.result()
            fut = take()
            with self.span("register_whole_pairs"):
                fine = R.register_whole_pairs(pairs, self.cfg)
            yield ins, [(None, f) for f in fine]

    def _results(self):
        if self._stream is None:
            self._stream = (self._top_part_stream() if self.stage == "top_part"
                            else self._whole_stream())
        with self.span("fetch_batch"):
            return next(self._stream)

    def _keep(self, ins, results) -> None:
        """Reservoir sampling of ``traffic["check_pairs"]`` pairs."""
        k = int(self.traffic["check_pairs"])
        for p, (best, fine) in zip(ins, results):
            item = (p, best, fine)
            if len(self.sample) < k:
                self.sample.append(item)
            else:
                j = int(self.sample_rng.integers(0, self._seen + 1))
                if j < k:
                    self.sample[j] = item
            self._seen += 1

    def window(self, seconds: float) -> tuple[int, int, float]:
        """Whole batches until ``seconds`` have passed: (pairs, batches,
        seconds from the start to the last batch's results on the host)."""
        t0 = time.perf_counter()
        items = batches = 0
        while True:
            ins, results = self._results()
            fail = self.cfg.failure_fitness
            self.stats["pairs_failed"] += sum(float(f.fitness) > fail for _, f in results)
            self._keep(ins, results)
            items += len(results)
            batches += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                return items, batches, t1 - t0

    def close(self) -> None:
        if self._stream is not None:
            with contextlib.suppress(Exception):
                self._stream.close()
            self._stream = None
        self._pool.shutdown(wait=True)

    def free(self) -> None:
        self.close()

    def check(self, rules: dict, control: str | None = None) -> dict:
        from harness.checks import judge_registration

        return judge_registration(self, rules, control)
Window = RegWindow
