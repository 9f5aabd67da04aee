"""The port's runtime components (``pctpu_torch.runtime``): the BEV tools'
writer threads, prefetch loader and stage timer, under the cases of pctpu's
``tests/test_runtime.py``, copied unchanged but for the imports."""

import time

import numpy as np
import pytest

from pctpu_torch.runtime.loader import batched_prefetch, list_pcd_files, stack_batch
from pctpu_torch.runtime.profiler import StageTimer
from pctpu_torch.runtime.writer import AsyncWriter


def test_async_writer_executes_in_order(tmp_path):
    results = []
    with AsyncWriter() as writer:
        for i in range(10):
            writer.submit(lambda i=i: results.append(i))
    assert results == list(range(10))


def test_async_writer_propagates_errors():
    writer = AsyncWriter()

    def boom():
        raise ValueError("disk full")

    writer.submit(boom)
    with pytest.raises(RuntimeError):
        for _ in range(100):
            writer.submit(lambda: None)
            time.sleep(0.01)
    # close after failure also reports
    with pytest.raises(RuntimeError):
        AsyncWriter.__exit__(writer, None, None, None)


def test_batched_prefetch_pads_last_batch():
    seen = []
    for names, payloads in batched_prefetch([1, 2, 3], 2, lambda x: x * 10):
        seen.append((names, payloads))
    assert seen[0] == ([1, 2], [10, 20])
    assert seen[1] == ([3, None], [30, 30])


def test_batched_prefetch_propagates_loader_errors():
    def load(x):
        if x == 2:
            raise OSError("corrupt pcd")
        return x

    with pytest.raises(OSError):
        list(batched_prefetch([1, 2, 3], 1, load))


def test_batched_prefetch_slow_consumer_hits_queue_full():
    """With prefetch=1 and a stalled consumer the producer's bounded put
    loops on queue.Full; every batch must still arrive, in order."""
    seen = []
    gen = batched_prefetch(list(range(6)), 1, lambda x: x * 10, prefetch=1)
    first = next(gen)
    time.sleep(0.6)  # producer fills the 1-slot queue and spins on Full
    seen.append(first)
    seen.extend(gen)
    assert [n for names, _ in seen for n in names] == list(range(6))
    assert [p for _, payloads in seen for p in payloads] == \
        [10 * i for i in range(6)]


def test_batched_prefetch_early_exit_unblocks_producer(monkeypatch):
    """A consumer that stops mid-stream must not leave the producer thread
    blocked in q.put holding padded batches (loader.py _put stop-flag)."""
    import threading

    created = []
    orig = threading.Thread

    def capture(*args, **kwargs):
        t = orig(*args, **kwargs)
        created.append(t)
        return t

    monkeypatch.setattr(threading, "Thread", capture)
    gen = batched_prefetch(list(range(16)), 1, lambda x: x, prefetch=1)
    next(gen)
    time.sleep(0.5)  # producer is now blocked on the full queue
    t0 = time.monotonic()
    gen.close()  # finally: stop.set() + join
    assert time.monotonic() - t0 < 5.0
    (thread,) = created
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_list_pcd_files_sorted(tmp_path):
    for name in ("b.pcd", "a.pcd", "c.txt", "noext"):
        (tmp_path / name).write_bytes(b"")
    files = list_pcd_files(str(tmp_path))
    assert [f.rsplit("/", 1)[1] for f in files] == ["a.pcd", "b.pcd"]
    with pytest.raises(FileNotFoundError):
        list_pcd_files(str(tmp_path / "missing"))


def test_stage_timer_averages():
    t = StageTimer()
    with t.stage("s", items=4):
        time.sleep(0.01)
    assert t.average_ms("s") >= 2.5  # 10ms over 4 items
    assert "[TIME] label:" in t.report_average("s", "label")


def test_stack_batch():
    a = {"x": np.ones(3), "count": np.int32(3)}
    b = {"x": np.zeros(3), "count": np.int32(2)}
    out = stack_batch([a, b])
    assert out["x"].shape == (2, 3)
    assert out["count"].tolist() == [3, 2]


@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.uint32, np.int16])
def test_stack_batch_unpinned_is_np_stack(dtype):
    """Without a card the batch is ``np.stack`` of the fields, dtype and
    bits kept (on a card: ``test_stack_batch_pinned``)."""
    rng = np.random.default_rng(3)
    parts = [{"v": rng.integers(0, 60_000, (5, 3)).astype(dtype), "count": np.int32(k)}
             for k in range(4)]
    out = stack_batch(parts)
    assert out["v"].dtype == dtype and out["count"].dtype == np.int32
    assert out["v"].tobytes() == np.stack([p["v"] for p in parts]).tobytes()
    assert out["count"].tolist() == [0, 1, 2, 3]
