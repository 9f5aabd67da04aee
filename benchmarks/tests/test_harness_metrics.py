"""The metric arithmetic on canned profiler events."""

from __future__ import annotations

import pytest

from conftest import BENCH  # noqa: F401  (puts the harness on the path)


def _trace(events, spans=(), window=(0.0, 1000.0), items=10, batches=2, **extra):
    from harness.trace import DeviceEvent, Trace

    return Trace([DeviceEvent(*e) for e in events], list(spans), window, items, batches,
                 dict(extra))


def _cell(name):
    from harness import cells

    return cells.resolve(name)


EVENTS = [
    ("void at::native::elementwise_kernel<128, 2>(int)", 0.0, 100.0),
    ("Memcpy HtoD (Pinned -> Device)", 50.0, 150.0),   # overlaps the first
    ("bev_raster_kernel(float const*)", 300.0, 340.0),
    ("bev_expand_kernel(int const*)", 340.0, 350.0),
    ("Memset (Device)", 400.0, 410.0),
    ("Memcpy DtoH (Device -> Pinned)", 600.0, 700.0),
    ("nn_main_kernel(int)", 800.0, 830.0),
    ("nn_seed_kernel(int)", 830.0, 840.0),
]


def test_busy_idle_and_gaps():
    from harness.trace import breakdown, busy_s, idle_gaps

    t = _trace(EVENTS, spans=[("stack", 150.0, 300.0), ("fetch_batch", 700.0, 1000.0),
                              ("upload", 160.0, 200.0)])
    # union: [0,150] [300,350] [400,410] [600,700] [800,840] = 150+50+10+100+40
    assert busy_s(t) == pytest.approx(350e-6)
    gs, ge = idle_gaps(t)
    assert list(zip(gs.tolist(), ge.tolist())) == [(150.0, 300.0), (350.0, 400.0),
                                                   (410.0, 600.0), (700.0, 800.0),
                                                   (840.0, 1000.0)]
    b = breakdown(t)
    gaps = dict(b["idle_gaps"])
    # [150,300]: midpoint 225 inside "stack" only ("upload" ends at 200)
    assert gaps["stack"] == pytest.approx(150e-6)
    assert gaps["fetch_batch"] == pytest.approx(260e-6)
    assert gaps["_no_span_"] == pytest.approx(240e-6)
    ops = dict(b["device_ops"])
    assert ops["elementwise_kernel"] == pytest.approx(100e-6)
    assert ops["bev_raster_kernel"] == pytest.approx(40e-6)


def test_bev_readers():
    from harness import cells

    cell = _cell("mulran-os1-64.bev")
    t = _trace(EVENTS, items=64, batches=2)
    read = {m["name"]: cells.metric_reader(m["name"]) for m in cell.per_layer}
    assert read["copy_ms_per_cloud.bev"](t, cell) == pytest.approx(0.2 / 64)
    assert read["kernels_per_cloud.bev"](t, cell) == pytest.approx(5 / 64)
    assert read["device_busy_ms_per_cloud.bev"](t, cell) == pytest.approx(0.35 / 64)
    assert read["device_idle_pct.bev"](t, cell) == pytest.approx(65.0)
    # 2 batches of 32 clouds: 65,536 slots x 16 B + 25 x 224² cells a cloud
    need = 2 * 32 * (65_536 * 16 + 25 * 224 * 224)
    want = 100.0 * need / 3.35e12 / 50e-6
    assert read["raster_roofline_pct.bev"](t, cell) == pytest.approx(want)


def test_registration_readers():
    from harness import cells

    cell = _cell("kitti-hdl64e.toppart64")
    t = _trace(EVENTS, items=128, batches=2, host_syncs=256)
    read = {m["name"]: cells.metric_reader(m["name"]) for m in cell.per_layer}
    assert read["kernels_per_pair.reg"](t, cell) == pytest.approx(5 / 128)
    assert read["host_syncs_per_pair.reg"](t, cell) == pytest.approx(2.0)
    assert read["nn_ms_per_pair.reg"](t, cell) == pytest.approx(0.04 / 128)
    assert read["device_busy_ms_per_pair.reg"](t, cell) == pytest.approx(0.35 / 128)
    assert read["device_idle_pct.reg"](t, cell) == pytest.approx(65.0)


@pytest.mark.parametrize("name", ["mulran-os1-64.bev", "kitti-hdl64e.toppart64"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    from harness import cells

    cell = _cell(name)
    t = _trace([], items=0, batches=0)
    for m in cell.per_layer:
        assert cells.metric_reader(m["name"])(t, cell) is None


def test_kernel_names():
    from harness.trace import kernel_name

    assert kernel_name("void at::native::vectorized_elementwise_kernel<4, F>(int, F)") == \
        "vectorized_elementwise_kernel"
    assert kernel_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH (Device -> Pinned)"
    assert kernel_name("nn_main_kernel(NnArgs)") == "nn_main_kernel"
