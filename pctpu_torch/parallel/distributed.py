"""Process groups and work partitioning (the port of
``pctpu/parallel/distributed.py``).

Every process runs the same pipeline over its strided slice of the work
list; process 0 alone resets shared output directories and runs the global
phases.  The group is ``torch.distributed``'s on the ``gloo`` backend
whatever the device: no tensor of these pipelines crosses processes, the
group only carries each process's rank and a barrier, and NCCL refuses two
ranks on one card, which is a run this package supports.

Each process runs on cards of its own: :func:`process_cards` gives the
processes of a host consecutive blocks of its cards, and the CLIs make the
first of them the process's current card.  A caller of the pipelines in
several processes does the same with ``torch.cuda.set_device``; without it
every process runs on the first card.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the process group (nothing to do for one process).

    With ``coordinator_address`` (``host:port``) the group meets there;
    without it, in the environment torchrun sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).  A process that joined
    leaves with :func:`shutdown`."""
    if num_processes is not None and num_processes <= 1:
        return
    dist.init_process_group(
        backend="gloo",
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every process of the group; nothing without a group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def process_index() -> int:
    """This process's rank in the group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_shard(items: list, process_id: int | None = None,
                  num_processes: int | None = None) -> list:
    """Deterministic strided partition of a work list across processes.

    Strided (not blocked) so each process's load stays balanced when
    consecutive clouds have similar point counts."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return items[pid::n]


def process_cards(n: int = 1, process_id: int | None = None) -> list[torch.device]:
    """The ``n`` CUDA cards of this process: its local rank (torchrun's
    ``LOCAL_RANK``, else ``process_id``, else its rank in the group) takes
    the block of n cards from card ``local_rank * n`` on, counted modulo the
    cards visible.  With fewer cards than processes times n, processes share
    cards, as two processes on one card do."""
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(f"{n} cards a process, this process sees {visible}")
    if "LOCAL_RANK" in os.environ:
        rank = int(os.environ["LOCAL_RANK"])
    else:
        rank = process_index() if process_id is None else process_id
    return [torch.device("cuda", (rank * n + j) % visible) for j in range(n)]


def global_mesh(n_points: int = 1):
    """A (data, points) mesh over every card this process sees."""
    from pctpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_points=n_points)
