"""Host-side streaming loader: directory scan + threaded batch prefetch (the
port of ``pctpu/runtime/loader.py``).

The reference loads each pcd synchronously inside its hot loop
(reference/BatchMultiBevGen.cpp:730).  Here host IO is overlapped with
device compute: a producer thread reads and pads clouds into fixed-size
numpy batches while the device chews on the previous batch.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator

import numpy as np

from pctpu_torch.config import SensorParams
from pctpu_torch.io.pcd import read_pcd
from pctpu_torch.ops.ordering import compact_last_wins


def list_pcd_files(path: str) -> list[str]:
    """Sorted .pcd paths in a directory
    (reference/BatchMultiBevGen.cpp:469-494)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"Folder doesn't Exist: {path}")
    names = [
        os.path.join(path, n)
        for n in os.listdir(path)
        if n.endswith(".pcd")
    ]
    return sorted(names)


def load_xyzirct_arrays(path: str, params: SensorParams) -> dict[str, np.ndarray]:
    """Load one pcd into SoA numpy arrays zero-padded to the sensor grid's
    size, in their on-disk widths.  A cloud larger than the grid is
    host-compacted to its per-cell last-wins winners
    (``ordering.compact_last_wins``) instead of truncated, so the device
    ordering reproduces the reference's getOrderedCloud of the FULL cloud."""
    capacity = params.grid_size
    data, meta = read_pcd(path)
    n_raw = meta["points"]
    if n_raw > capacity:
        data, n_raw = compact_last_wins(data, n_raw, params)
    n = min(n_raw, capacity)
    # narrow on-disk widths: the device widens after transfer
    out = {
        "xyz": np.zeros((capacity, 3), np.float32),
        "intensity": np.zeros((capacity,), np.float32),
        "row": np.zeros((capacity,), np.uint16),
        "col": np.zeros((capacity,), np.uint16),
        "t": np.zeros((capacity,), np.uint32),
        "label": np.zeros((capacity,), np.int16),
        "count": np.int32(n),
    }
    out["xyz"][:n, 0] = data["x"][:n]
    out["xyz"][:n, 1] = data["y"][:n]
    out["xyz"][:n, 2] = data["z"][:n]
    for k in ("intensity", "row", "col", "t", "label"):
        if k in data:
            out[k][:n] = data[k][:n].astype(out[k].dtype)
    return out


def batched_prefetch(
    items: list,
    batch_size: int,
    load_fn: Callable,
    prefetch: int = 2,
) -> Iterator[tuple[list, list]]:
    """Yield (batch_items, batch_payloads) with a producer thread.

    The last batch is padded by repeating its final item so every batch has
    the same shape; the padded entries carry item=None so writers skip them.
    """
    batches: list[list] = [
        items[i : i + batch_size] for i in range(0, len(items), batch_size)
    ]
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that keeps checking the stop flag: a consumer that
        exits early (error/break) must not leave the producer blocked
        forever in q.put holding batches of padded arrays."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batches:
                if stop.is_set():
                    return
                names = list(batch) + [None] * (batch_size - len(batch))
                payload = [load_fn(b) for b in batch]
                payload += [payload[-1]] * (batch_size - len(batch))
                if not _put((names, payload)):
                    return
        except Exception as exc:  # surface loader errors on the consumer side
            _put(exc)
        finally:
            _put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is None:
                break
            if isinstance(got, Exception):
                raise got
            yield got
    finally:
        stop.set()
        thread.join(timeout=5)


def stack_batch(payloads: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack per-cloud field dicts into batched arrays."""
    keys = payloads[0].keys()
    return {k: np.stack([p[k] for p in payloads]) for k in keys}
