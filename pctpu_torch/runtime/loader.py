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
import torch

from pctpu_torch.config import SensorParams
from pctpu_torch.io.pcd import read_pcd
from pctpu_torch.ops.ordering import compact_last_wins
from pctpu_torch.runtime import profiler


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


def load_xyzirct_arrays(
    path: str, capacity: int, params: SensorParams | None = None
) -> dict[str, np.ndarray]:
    """Load one pcd into SoA numpy arrays zero-padded to ``capacity``, in
    their on-disk widths.

    With ``params``, a cloud larger than ``capacity`` is host-compacted to
    its per-grid-cell last-wins winners (``ordering.compact_last_wins``)
    instead of truncated, so the device ordering reproduces the reference's
    getOrderedCloud of the FULL cloud.  Without ``params`` (callers whose
    capacity comes from the actual point counts) an oversized cloud
    truncates to its first ``capacity`` points."""
    data, meta = read_pcd(path)
    n_raw = meta["points"]
    if params is not None and n_raw > capacity:
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
    Traced: each ``load_fn`` call is a ``loader.load`` span on the producer
    thread (with its batch index), the consumer's wait a ``loader.wait``.
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

    def load(b):
        with profiler.span("loader.load"):
            return load_fn(b)

    def producer(context):
        try:
            for k, batch in enumerate(batches):
                if stop.is_set():
                    return
                names = list(batch) + [None] * (batch_size - len(batch))
                with profiler.adopt(context), profiler.batch(k):
                    payload = [load(b) for b in batch]
                payload += [payload[-1]] * (batch_size - len(batch))
                if not _put((names, payload)):
                    return
        except Exception as exc:  # surface loader errors on the consumer side
            _put(exc)
        finally:
            _put(None)

    thread = threading.Thread(target=producer, args=(profiler.handoff(),), daemon=True)
    thread.start()
    try:
        while True:
            with profiler.span("loader.wait"):
                got = q.get()
            if got is None:
                break
            if isinstance(got, Exception):
                raise got
            yield got
    finally:
        stop.set()
        thread.join(timeout=5)


def _stack_pinned(parts: list[np.ndarray]) -> np.ndarray:
    """``np.stack(parts)`` written straight into a pinned host tensor of the
    caching host allocator; the array keeps its tensor alive."""
    dtype = np.result_type(*parts)
    shape = (len(parts), *np.shape(parts[0]))
    nbytes = int(np.prod(shape)) * dtype.itemsize
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()
    return np.stack(parts, out=buf.view(dtype).reshape(shape))


def stack_batch(payloads: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack per-cloud field dicts into batched arrays (traced as
    ``loader.stack``).  Where a card is present each field is stacked into
    a pinned host tensor, so the upload copies it to the card as it is: one
    host copy a batch where a fresh array and a pinned staging copy made
    two."""
    keys = payloads[0].keys()
    stack = _stack_pinned if torch.cuda.is_available() else np.stack
    with profiler.span("loader.stack"):
        return {k: stack([p[k] for p in payloads]) for k in keys}
