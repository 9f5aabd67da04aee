"""Asynchronous writeback: a pool of background threads drains output tasks
so the device loop never blocks on disk (the port of
``pctpu/runtime/writer.py``).

The reference writes every artifact synchronously inside its timed hot loop
(reference/BatchMultiBevGen.cpp:294-320).  Here the device produces the
next batch while this thread encodes/writes the previous one; errors are
re-raised on close so failures aren't silently dropped.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable


class AsyncWriter:
    """Pool of writer threads draining output tasks.

    A single thread cannot keep up with per-cloud encoding (24 PNG deflates
    + csv + pcd pack) at device speed; the native writers and file IO
    release the GIL, so worker threads genuinely parallelize.  Per-cloud outputs are
    disjoint files, so completion order is irrelevant.  The first failure
    wins: later tasks are skipped and the error re-raises on close/submit.
    """

    def __init__(self, max_pending: int = 8, workers: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._error: BaseException | None = None
        self._err_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(max(workers, 1))
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            if self._error is not None:
                continue  # drain without executing: stop at the FIRST failure
            try:
                task()
            except BaseException as exc:  # noqa: BLE001 — reported on close
                with self._err_lock:
                    if self._error is None:
                        self._error = exc  # first failure wins

    def submit(self, task: Callable[[], None]) -> None:
        if self._error is not None:
            raise RuntimeError("async writer failed") from self._error
        self._q.put(task)

    def close(self) -> None:
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join()
        if self._error is not None:
            raise RuntimeError("async writer failed") from self._error

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
