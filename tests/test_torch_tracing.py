"""The port's tracer (``pctpu_torch.runtime.profiler``): spans and counters
on every thread, on while a torch.profiler runs or a ``recording()`` block
is open, on the profiler's clock; and the registration drivers' spans,
counters and timer-free path."""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from pctpu_torch import cloud as tcloud
from pctpu_torch.config import SensorParams
from pctpu_torch.ops import ordering
from pctpu_torch.pipelines import registration as reg
from pctpu_torch.runtime import profiler
from pctpu_torch.runtime.profiler import StageTimer

from .test_torch_registration_batched import CFG, _batches, tree  # noqa: F401


def _in_thread(fn):
    """``fn()`` on a fresh thread; returns (its result, its native id)."""
    out = {}

    def run():
        out["id"] = threading.get_native_id()
        out["value"] = fn()

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    return out.get("value"), out["id"]


def _loop(make, n):
    t = time.perf_counter()
    for _ in range(n):
        with make("off"):
            pass
    return time.perf_counter() - t


def test_off_costs_nothing():
    assert not profiler.enabled()
    a, b = profiler.span("a"), profiler.span("b")
    assert a is b is profiler._NULL
    before = tuple(len(x) for x in profiler.records())
    with profiler.span("off"):
        profiler.count("off.count", 3)
    assert tuple(len(x) for x in profiler.records()) == before
    assert profiler.handoff(4) is None and profiler.adopt(None) is profiler._NULL
    assert profiler.batch(4) is profiler._NULL
    # a million spans: the span call over a bare null context, best of three
    n = 1_000_000
    extra = min(_loop(profiler.span, n) - _loop(lambda name: profiler._NULL, n)
                for _ in range(3))
    assert extra / n < 1e-6, f"{extra / n * 1e9:.0f} ns a span with tracing off"


def test_nesting_parents_batches_and_self_time():
    with profiler.recording() as rec:
        with profiler.span("outer") as outer:
            time.sleep(0.002)
            with profiler.span("inner.wait") as w:
                time.sleep(0.004)
            with profiler.batch(7):
                with profiler.span("inner") as inner:
                    with profiler.span("leaf"):
                        time.sleep(0.002)
                profiler.count("things", 2)
            profiler.count("things")
    assert [s.name for s in rec.spans] == ["inner.wait", "leaf", "inner", "outer"]
    leaf = rec.named("leaf")[0]
    assert outer.parent is None and w.parent == inner.parent == outer.id
    assert leaf.parent == inner.id
    assert (outer.batch, inner.batch, leaf.batch, w.batch) == (None, 7, 7, None)
    assert {s.thread for s in rec.spans} == {threading.get_native_id()}
    assert rec.total("things") == 3 and rec.totals() == {"things": 3}
    assert [c.batch for c in rec.counts] == [7, None]
    # self time: the duration less the direct children on the same thread,
    # which the parent links find
    def self_ns(s):
        return s.end_ns - s.start_ns - sum(c.end_ns - c.start_ns for c in rec.spans
                                           if c.parent == s.id and c.thread == s.thread)
    assert {c.name for c in rec.spans if c.parent == outer.id} == {"inner.wait", "inner"}
    assert 1_500_000 <= self_ns(outer) < outer.end_ns - outer.start_ns - 6_000_000
    assert self_ns(leaf) == leaf.end_ns - leaf.start_ns >= 2_000_000
    assert w.start_ns >= outer.start_ns and w.end_ns <= inner.start_ns <= leaf.start_ns


def test_handoff_carries_parent_and_batch_to_a_worker():
    with profiler.recording() as rec:
        with profiler.span("submit") as submit:
            context = profiler.handoff(3)

            def work():
                with profiler.adopt(context), profiler.span("work"):
                    profiler.count("work.done")
            _, tid = _in_thread(work)
    (work,) = rec.named("work")
    assert (work.parent, work.batch, work.thread) == (submit.id, 3, tid)
    assert rec.counts[0].batch == 3 and rec.counts[0].thread == tid


def test_is_profiler_enabled_pin():
    """The tracer reads ``torch.autograd.profiler._is_profiler_enabled``, a
    private flag: a torch that renames it must fail here, not leave tracing
    silently off."""
    assert hasattr(torch_profiler, "_is_profiler_enabled")
    assert torch_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch_profiler._is_profiler_enabled is True
        assert _in_thread(lambda: torch_profiler._is_profiler_enabled)[0] is True
        assert profiler.enabled()
    assert torch_profiler._is_profiler_enabled is False and not profiler.enabled()


def test_other_threads_record_while_a_profiler_runs():
    def work():
        with profiler.span("worker.span"):
            profiler.count("worker.count")
        # record_function on this thread does not reach the profiler
        return torch.autograd._profiler_enabled()

    first = next(profiler._ids)
    with profile(activities=[ProfilerActivity.CPU]):
        seen, tid = _in_thread(work)
    assert seen is False
    _in_thread(work)  # after the profiler stopped: nothing
    spans, counts = profiler.records()
    got = [s for s in spans if s.id > first and s.name == "worker.span"]
    assert [s.thread for s in got] == [tid]
    assert [c.thread for c in counts if c.id > first and c.name == "worker.count"] == [tid]


def test_program_spans_keep_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first record_function takes a millisecond or more to
        # open: a cost between the two stamps, not a clock apart
        with record_function("clock.warm"), profiler.span("clock.warm"):
            pass
        with record_function("clock.probe"), profiler.span("clock.probe") as s:
            time.sleep(0.003)
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock.probe"]
    assert abs(event.start_ns() - s.start_ns) < 1_000_000
    assert abs(event.start_ns() + event.duration_ns() - s.end_ns) < 1_000_000


def _uploaded(batches):
    """Thunks that upload each batch's clouds again (``cloud.from_numpy``),
    as a pair list built inside the window does."""
    def thunk(b):
        def load():
            return [(tcloud.from_numpy(tcloud.to_numpy(c1), device="cpu"),
                     tcloud.from_numpy(tcloud.to_numpy(c2), device="cpu"), g)
                    for c1, c2, g in b]
        return load
    return [thunk(b) for b in batches]


def test_pipelined_worker_spans_share_the_batch_index(tree, monkeypatch):  # noqa: F811
    specs = []

    class Spec(reg.BucketSpec):
        def __init__(self):
            super().__init__()
            specs.append(self)

    monkeypatch.setattr(reg, "BucketSpec", Spec)
    batches = _batches(tree)
    main = threading.get_native_id()
    with profiler.recording() as rec:
        out = list(reg.register_pairs_pipelined(iter(_uploaded(batches)), CFG, flat_cap=1024))
    assert len(out) == len(batches)
    worker = {s.thread for s in rec.named("registration.load")}
    assert len(worker) == 1 and main not in worker
    for k in range(len(batches)):
        on_worker = [s for s in rec.spans if s.thread in worker and s.batch == k]
        names = {s.name for s in on_worker}
        assert {"registration.load", "cloud.upload", "registration.stack", "registration.flat",
                "registration.coarse", "registration.voxel", "registration.fine",
                "registration.verify.wait", "icp.loop"} <= names, names
        assert sum(s.name == "cloud.upload" for s in on_worker) == 2 * len(batches[k])
        on_main = {s.name for s in rec.spans if s.thread == main and s.batch == k}
        assert {"registration.worker.wait", "registration.fetch.wait"} <= on_main
    assert all(s.batch is not None for s in rec.spans if s.name.startswith("icp."))
    (spec,) = specs
    t = rec.totals()
    hits = t.get("registration.bucket_hit.coarse", 0) + t.get("registration.bucket_hit.fine", 0)
    misses = (t.get("registration.bucket_miss.coarse", 0)
              + t.get("registration.bucket_miss.fine", 0))
    assert (hits, misses) == (spec.hits, spec.misses) and hits + misses == 4
    # the ICP counters: slots are iterations × problems, and hold the useful ones
    assert t["icp.problem_iterations"] <= t["icp.problem_slots"]
    assert t["icp.iterations"] == len(rec.named("icp.wait"))


def test_no_synchronize_without_a_timer(tree, monkeypatch):  # noqa: F811
    calls = []
    real = reg._synchronize
    monkeypatch.setattr(reg, "_synchronize", lambda shards: calls.append(1) or real(shards))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(2))
    batches = _batches(tree)
    plain = list(reg.register_pairs_pipelined(iter([lambda b=b: b for b in batches]), CFG,
                                              flat_cap=1024))
    reg.register_pairs(batches[0], CFG, flat_cap=1024)
    reg.register_whole_pairs(batches[0], CFG)
    assert calls == []
    # with a timer: the stage totals as the CLIs print them, one
    # synchronize a speculative batch (the first batch is a cold start)
    timer = StageTimer()
    timed = list(reg.register_pairs_pipelined(iter([lambda b=b: b for b in batches]), CFG,
                                              flat_cap=1024, timer=timer))
    assert calls == [1] * (len(batches) - 1)
    n = sum(len(b) for b in batches)
    assert timer.counts["coarse"] == timer.counts["fine"] == n
    assert timer.totals_ms["coarse"] > 0 and timer.totals_ms["fine"] > 0
    for pb, qb in zip(plain, timed):
        for (b1, f1), (b2, f2) in zip(pb, qb):
            assert (b1.transform == b2.transform).all() and (f1.transform == f2.transform).all()


def test_stage_timer_stage_is_a_span():
    timer = StageTimer()
    with profiler.recording() as rec:
        with timer.stage("work", items=2):
            time.sleep(0.001)
    (s,) = rec.named("work")
    assert timer.counts["work"] == 2
    assert timer.totals_ms["work"] >= (s.end_ns - s.start_ns) / 1e6


def test_grid_check_counts_where_it_decides():
    """The BEV loader's grid-order check records one counter event a check:
    ``ordering.grid_check.early`` where the first row of slots decides (a raw
    column-major cloud), ``.full`` where it sees every slot (a dense
    grid-ordered one); none with tracing off."""
    params = SensorParams(n_scan=4, horizon_scan=8, ground_upper_scan=2, height_res=0.5)
    g = params.grid_size
    slot = np.arange(g)

    def cloud(row, col):
        return {"xyz": np.ones((g, 3), np.float32), "intensity": np.ones(g, np.float32),
                "row": row.astype(np.uint16), "col": col.astype(np.uint16),
                "t": np.zeros(g, np.uint32), "label": np.zeros(g, np.int16), "count": g}

    raw = cloud(slot % params.n_scan, slot // params.n_scan)
    dense = cloud(slot // params.horizon_scan, slot % params.horizon_scan)
    with profiler.recording() as rec:
        assert not ordering.arrays_grid_ordered(raw, params)
    assert rec.totals() == {"ordering.grid_check.early": 1}
    with profiler.recording() as rec:
        assert ordering.arrays_grid_ordered(dense, params)
    assert rec.totals() == {"ordering.grid_check.full": 1}
    assert len(rec.named("ordering.grid_check")) == 1
    before = tuple(len(x) for x in profiler.records())
    assert not ordering.arrays_grid_ordered(raw, params)
    assert ordering.arrays_grid_ordered(dense, params)
    assert tuple(len(x) for x in profiler.records()) == before


def test_profile_trace_holds_worker_spans_rebased(tmp_path):
    def work():
        with profiler.span("trace.worker"):
            time.sleep(0.002)
            profiler.count("trace.count", 5)

    with profiler.trace("traced", enabled=True, trace_dir=str(tmp_path)):
        _, tid = _in_thread(work)
    (path,) = tmp_path.iterdir()
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    (block,) = [e for e in events if e.get("name") == "traced" and e.get("ph") == "X"
                and e.get("cat") != "pctpu_torch"]
    (span,) = [e for e in events if e.get("name") == "trace.worker"]
    (counter,) = [e for e in events if e.get("name") == "trace.count"]
    assert (span["ph"], span["tid"], span["pid"]) == ("X", tid, os.getpid())
    assert counter["ph"] == "C" and counter["args"] == {"total": 5}
    # on the file's clock: inside the block's own span, within a millisecond
    assert block["ts"] - 1e3 <= span["ts"] <= span["ts"] + span["dur"] <= \
        block["ts"] + block["dur"] + 1e3
    assert span["dur"] >= 2e3


def _events_with_a_span():
    with profiler.recording() as rec:
        with profiler.span("appended"):
            profiler.count("appended.count", 2)
    return rec.spans, rec.counts


PAD = [{"ph": "i", "name": f"pad {i}", "pid": 1, "tid": 1, "ts": float(i)} for i in range(3000)]


@pytest.mark.parametrize("layout", ["base_first", "base_last", "empty_array", "long"])
def test_append_to_chrome_trace_reads_only_the_ends(tmp_path, layout):
    """Both places kineto puts ``baseTimeNanoseconds``, an empty event
    array, and a file whose array closes past the bytes read at its head."""
    base = 1_700_000_000_000_000_000
    events = [] if layout == "empty_array" else PAD if layout == "long" else PAD[:2]
    body = json.dumps(events)
    if layout == "base_last":
        text = f'{{"traceEvents": {body}, "traceName": "x]y", "baseTimeNanoseconds": {base}}}'
    else:
        text = f'{{"schemaVersion": 1, "baseTimeNanoseconds": {base},\n"traceEvents": {body}' \
               f'\n, "traceName": "a/b.json" }}'
    path = tmp_path / "t.json"
    path.write_text(text)
    assert layout != "long" or len(text) > 2 * profiler._TRACE_END_BYTES
    spans, counts = _events_with_a_span()
    profiler.append_to_chrome_trace(str(path), spans, counts)
    doc = json.loads(path.read_text())
    assert doc["traceEvents"][:len(events)] == events
    (span,) = [e for e in doc["traceEvents"] if e["name"] == "appended"]
    (counter,) = [e for e in doc["traceEvents"] if e["name"] == "appended.count"]
    assert span["ts"] == (spans[0].start_ns - base) / 1e3
    assert counter["args"] == {"total": 2}
    assert len(doc["traceEvents"]) == len(events) + 2


def test_append_to_chrome_trace_needs_the_files_clock(tmp_path):
    path = tmp_path / "t.json"
    path.write_text('{"traceEvents": []}')
    with pytest.raises(ValueError, match="baseTimeNanoseconds"):
        profiler.append_to_chrome_trace(str(path), *_events_with_a_span())


def _general_batch(seed: int):
    """A loader batch that takes the general ordering: random rows (some out
    of bounds) and columns, ragged counts; (params, arrays, in-bounds points,
    points that lost their slot to a later one)."""
    params = SensorParams(n_scan=8, horizon_scan=64, ground_upper_scan=5, height_res=0.5)
    rng = np.random.default_rng(seed)
    b, c = 3, 600
    arrays = {"xyz": rng.uniform(-30, 30, (b, c, 3)).astype(np.float32),
              "intensity": rng.uniform(0, 1, (b, c)).astype(np.float32),
              "row": rng.integers(0, params.n_scan + 1, (b, c)).astype(np.uint16),
              "col": rng.integers(0, params.horizon_scan, (b, c)).astype(np.uint16),
              "t": np.zeros((b, c), np.uint32), "label": np.full((b, c), -2, np.int16),
              "count": np.array([600, 450, 10], np.int32)}
    points, lost = np.sum([_cloud_counts(arrays, k, params) for k in range(b)], axis=0)
    return params, arrays, int(points), int(lost)


def _cloud_counts(arrays: dict, k: int, params: SensorParams) -> tuple[int, int]:
    """Cloud ``k``'s in-bounds points and those a later point overwrote."""
    n = int(arrays["count"][k])
    row, col = arrays["row"][k, :n].astype(np.int64), arrays["col"][k, :n].astype(np.int64)
    ok = row < params.n_scan
    return int(ok.sum()), int(ok.sum()) - len(np.unique(row[ok] * params.horizon_scan + col[ok]))


class _TorchCalls(torch.overrides.TorchFunctionMode):
    """The names of the torch functions and tensor methods a block calls."""

    def __init__(self):
        super().__init__()
        self.calls: dict[str, int] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_ordering_counts_come_home_with_the_batch():
    """``preprocess_batch`` on a general-path batch, then ``_wire`` and
    ``_to_host``: the counters ``ordering.points`` and
    ``ordering.slots_lost`` hold the batch's in-bounds points and the points
    a later one overwrote, the span ``ordering.scatter`` wraps the ordering's
    launches, the answers equal those of an untraced batch, and the count adds
    only device work and the batch's own copy: no host read of a tensor."""
    from pctpu_torch.ops.preprocess import preprocess_batch
    from pctpu_torch.pipelines.multi_bev import _to_device, _to_host, _wire

    params, arrays, points, lost = _general_batch(5)
    assert 0 < lost < points

    def batch():
        with _TorchCalls() as log:
            labeled, multi, single = preprocess_batch(_to_device(arrays, torch.device("cpu")),
                                                      params)
            host = _to_host([{**_wire(labeled), "multi": multi, "single": single}])
        return host, log.calls

    off, calls_off = batch()
    with profiler.recording() as rec:
        on, calls_on = batch()
    assert rec.totals() == {"ordering.points": points, "ordering.slots_lost": lost}
    assert len(rec.named("ordering.scatter")) == 1
    (scatter,) = rec.named("ordering.scatter")
    (order_ground,) = rec.named("preprocess.order_ground")
    assert scatter.parent == order_ground.id
    assert set(on) == set(off)
    for k in off:
        np.testing.assert_array_equal(on[k].view(np.uint8), off[k].view(np.uint8), err_msg=k)
    added = {k: n - calls_off.get(k, 0) for k, n in calls_on.items() if n > calls_off.get(k, 0)}
    assert not set(calls_off) - set(calls_on)
    assert set(added) <= {"__get__", "__getitem__", "sum", "sub", "stack", "reshape", "empty",
                          "copy_", "numpy"}, added
    assert added["numpy"] == 1 and added["copy_"] == 1


def test_the_fast_path_counts_nothing():
    """Grid-ordered clouds (``assume_ordered``) skip the ordering: no span,
    no counter."""
    from pctpu_torch.ops.preprocess import preprocess_batch
    from pctpu_torch.pipelines.multi_bev import _to_device, _to_host, _wire

    params, arrays, _, _ = _general_batch(6)
    g = params.grid_size
    arrays = {**{k: v[:, :g] for k, v in arrays.items() if k != "count"},
              "count": np.full(3, g, np.int32)}
    with profiler.recording() as rec:
        labeled, multi, single = preprocess_batch(_to_device(arrays, torch.device("cpu")),
                                                  params, assume_ordered=True)
        _to_host([{**_wire(labeled), "multi": multi, "single": single}])
    assert rec.totals() == {}
    assert rec.named("ordering.scatter") == []


def test_ordering_counts_of_a_mesh_add_up():
    """Over a two-device data mesh (each shard ordered on its own device,
    then ``run_multi_bev``'s parts handed to ``_to_host``, or
    ``sharded_preprocess`` joining them) the counts are the whole batch's."""
    from pctpu_torch.parallel import mesh
    from pctpu_torch.pipelines.multi_bev import _to_device, _to_host, _wire

    params, arrays, _, _ = _general_batch(7)
    arrays = {k: v[:2] for k, v in arrays.items()}
    m = mesh.make_mesh(n_data=2, devices=[torch.device("cpu")] * 2)
    shards = [_to_device(arrays, dev, rows) for rows, dev in mesh.data_slices(2, m, "b")]
    with profiler.recording() as rec:
        outs = mesh.preprocess_shards(shards, params)
        _to_host([{**_wire(lab), "multi": mb, "single": sb} for lab, mb, sb in outs])
        joined, _, _ = mesh.sharded_preprocess(m, params)(shards)
    want = np.array([_cloud_counts(arrays, k, params) for k in range(2)])
    assert rec.totals() == {"ordering.points": int(want[:, 0].sum()),
                            "ordering.slots_lost": int(want[:, 1].sum())}
    np.testing.assert_array_equal(joined.ordering_counts.numpy(), want)
