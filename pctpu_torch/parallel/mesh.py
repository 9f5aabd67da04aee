"""Device meshes: a batch split over ``data``, a target split over
``points`` (the port of ``pctpu/parallel/mesh.py``).

pctpu's scaling story, kept here:

  * **data parallelism** over the cloud-batch (or pair) axis for the BEV and
    registration pipelines — each shard is independent, nothing is
    exchanged in the hot path;
  * **point-axis sharding** for the registration correspondence search: the
    target cloud is split over ``points``, each device scans its slice, and
    the per-shard winners are reduced to the global one;
  * sums of per-shard metrics over ``data`` only.

A :class:`Mesh` is a grid of ``torch.device``s.  A device may appear more
than once (the counterpart of XLA's virtual host devices): the CPU tests use
``[cpu] * 8``, and ``[cuda:0] * 2`` runs the sharded code on one card.  The
shards of a call run one after the other in the calling thread, each under
its own device; on distinct cards the kernels of one shard overlap the host
work of the next up to the first host read.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import GroundConfig, MultiBevConfig, SingleBevConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, points)`` grid of devices: ``devices[i][j]`` holds data
    shard i, point shard j."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "points": len(self.devices[0])}

    @property
    def data_devices(self) -> list[torch.device]:
        """One device a data shard (the first of its row)."""
        return [row[0] for row in self.devices]

    @property
    def point_devices(self) -> list[torch.device]:
        """One device a point shard (the first row)."""
        return list(self.devices[0])


def make_mesh(n_data: int | None = None, n_points: int = 1, devices=None) -> Mesh:
    """A (data, points) mesh.  ``devices`` defaults to every CUDA card this
    process sees, from its current card on (``torch.cuda.set_device``; the
    CLIs set it per process, ``distributed.process_cards``), all on the data
    axis; a list may name a device more than once.  Asking for more devices
    than there are raises."""
    visible = devices is None
    if visible:
        n = torch.cuda.device_count()
        first = torch.cuda.current_device() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", (first + j) % n) for j in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_points
    if n_data < 1 or n_points < 1 or n_data * n_points > len(devices):
        raise ValueError(
            f"make_mesh: a {n_data} x {n_points} mesh needs {n_data * n_points} devices, "
            f"{len(devices)} " + ("CUDA cards visible" if visible else "given"))
    return Mesh(tuple(tuple(devices[i * n_points:(i + 1) * n_points]) for i in range(n_data)))


def data_slices(n: int, mesh: Mesh, what: str) -> list[tuple[slice, torch.device]]:
    """How an axis of ``n`` items splits over the mesh's ``data`` axis: one
    contiguous block of n / data items a data device, in device order, as
    (rows, device).  Raises, naming the axis ``what``, when the data axis
    does not divide ``n``."""
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(f"{what}={n} must be a multiple of the mesh data axis ({d}): it "
                         f"does not split over {d} data devices")
    per = n // d
    return [(slice(k * per, (k + 1) * per), dev) for k, dev in enumerate(mesh.data_devices)]


def device_guard(device: torch.device):
    """Make ``device`` current for the launches of a block: a hand kernel
    launches on the thread's current card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _cloud_fields(cloud: Cloud, fn) -> Cloud:
    """``fn`` of every field that is set (``ordering_counts`` may be None)."""
    return Cloud(**{f.name: None if (v := getattr(cloud, f.name)) is None else fn(v)
                    for f in dataclasses.fields(Cloud)})


def cloud_to(cloud: Cloud, device: torch.device) -> Cloud:
    """The cloud with every tensor field on ``device``."""
    return _cloud_fields(cloud, lambda x: x.to(device) if isinstance(x, torch.Tensor) else x)


def shard_cloud_batch(clouds: Cloud, mesh: Mesh) -> list[Cloud]:
    """A batched Cloud's leading axis split over ``data`` (:func:`data_slices`):
    one shard a data device, on that device."""
    return [cloud_to(_cloud_fields(clouds, lambda x, rows=rows: x[rows]), dev)
            for rows, dev in data_slices(clouds.xyz.shape[0], mesh, "len(clouds)")]


def preprocess_shards(shards: list[Cloud], params, ground_cfg=GroundConfig(),
                      multi_cfg=MultiBevConfig(), single_cfg=SingleBevConfig(),
                      assume_ordered: bool = False, compat: str = "bitexact") -> list[tuple]:
    """``preprocess_batch`` of each shard on its own device: a list of
    (labeled, multi BEV, single BEV), one a shard."""
    from pctpu_torch.ops.preprocess import preprocess_batch

    outs = []
    for shard in shards:
        with device_guard(shard.device):
            outs.append(preprocess_batch(shard, params, ground_cfg, multi_cfg, single_cfg,
                                         assume_ordered=assume_ordered, compat=compat))
    return outs


def sharded_preprocess(mesh: Mesh, params, ground_cfg=GroundConfig(),
                       multi_cfg=MultiBevConfig(), single_cfg=SingleBevConfig()):
    """A batched preprocess whose batch axis is split over ``data``.

    Returns a callable: the shards of :func:`shard_cloud_batch` → (labeled,
    multi_bev, single_bev) joined on the first data device, bit-equal to
    ``preprocess_batch`` of the whole batch (each cloud's work is its own)."""
    dev0 = mesh.data_devices[0]

    def run(shards: list[Cloud], assume_ordered: bool = False, compat: str = "bitexact"):
        outs = preprocess_shards(shards, params, ground_cfg, multi_cfg, single_cfg,
                                 assume_ordered, compat)
        parts = {f.name: [getattr(o[0], f.name) for o in outs] for f in dataclasses.fields(Cloud)}
        labeled = Cloud(**{k: None if any(x is None for x in v) else
                           torch.cat([x.to(dev0) for x in v]) for k, v in parts.items()})
        return (labeled, torch.cat([o[1].to(dev0) for o in outs]),
                torch.cat([o[2].to(dev0) for o in outs]))

    return run


def sharded_nn_1(mesh: Mesh, tile: int = 512):
    """1-NN with the *target* cloud split over the ``points`` axis.

    Each point device scans its slice of the target with ``knn.nn_1``; the
    per-shard winners come back to the query's device and the global one is
    the argmin over (n_shards, Q) of their scores, the values ``nn_1`` ranks
    (pctpu reduces by the winners' exact distances, which can rank two
    near-equal winners of different shards otherwise than one device's
    argmin does).  A tie goes to the lowest shard, whose indices come first,
    so the result is ``nn_1``'s over the whole target, bit for bit."""
    from pctpu_torch.ops.knn import nn_1_scored

    devs = mesh.point_devices
    n_shards = len(devs)

    def run(query, qmask, target, tmask):
        if target.shape[0] % n_shards:
            raise ValueError(
                f"the 'points' axis ({n_shards}) must divide the target "
                f"length ({target.shape[0]}) — pad the cloud to a multiple"
            )
        t_per = target.shape[0] // n_shards
        home = query.device
        found = []
        for k, dev in enumerate(devs):
            part = slice(k * t_per, (k + 1) * t_per)
            with device_guard(dev):
                idx, d2, score = nn_1_scored(query.to(dev), qmask.to(dev), target[part].to(dev),
                                             tmask[part].to(dev), tile=tile)
            found.append((idx + k * t_per, d2, score))
        idx, d2, score = (torch.stack([f[i].to(home) for f in found]) for i in range(3))
        best = torch.argmin(score, dim=0, keepdim=True)
        return idx.gather(0, best)[0], d2.gather(0, best)[0]

    return run


def psum_metrics(mesh: Mesh):
    """Sum per-shard metrics over the mesh's ``data`` axis: each data device
    sums its shard, and the shard sums add up in shard order.  The input is
    split over ``data`` only, so the ``points`` devices of a row would each
    hold a copy; summing over them too would multiply the total by
    n_points.  Returns the scalar grand total on the first data device."""
    devs = mesh.data_devices

    def run(x):
        x = torch.as_tensor(x)
        if x.shape[0] % len(devs):
            raise ValueError(f"{x.shape[0]} values do not split over {len(devs)} data devices")
        parts = x.split(x.shape[0] // len(devs))
        return torch.stack([p.to(dev).sum().to(devs[0]) for p, dev in zip(parts, devs)]).sum()

    return run
