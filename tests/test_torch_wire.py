"""The BEV pipelines' host↔device wire (``pctpu_torch.pipelines.multi_bev``:
``_upload`` / ``_to_device`` up, ``_wire`` + ``_to_host`` back) against
pctpu's ``_preprocess_wire`` (pctpu/pipelines/multi_bev.py:53-90), on the
CPU: the clouds go up in their on-disk widths and widen on the device, and
the labeled fields come back narrowed to them, dtype and bits, at the
extremes of every integer field (row/col 0 and 65535, ``t`` 0, 2³¹ and
2³²−1, labels −1, −2 and 32767).  The card's pinned form is in
``test_torch_cuda_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.config import GroundConfig as JGroundConfig
from pctpu.config import MultiBevConfig as JMultiBevConfig
from pctpu.config import SensorParams as JSensorParams
from pctpu.config import SingleBevConfig as JSingleBevConfig
from pctpu.pipelines.multi_bev import _preprocess_wire
from pctpu_torch.config import GroundConfig, MultiBevConfig, SensorParams, SingleBevConfig
from pctpu_torch.ops.preprocess import preprocess_batch
from pctpu_torch.pipelines import batch_cloud_manip, multi_bev
from pctpu_torch.pipelines.multi_bev import _to_device, _to_host, _upload, _wire

SMALL = (16, 32, 10, 0.5)
CPU = torch.device("cpu")
FIELDS = ("xyz", "intensity", "row", "col", "t", "label")
ON_DISK = {"xyz": np.float32, "intensity": np.float32, "row": np.uint16, "col": np.uint16,
           "t": np.uint32, "label": np.int16}


@pytest.fixture(autouse=True)
def _one_thread():
    # pipelines beside other test workers: full intra-op pools contend
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def loader_batch(seed: int, b: int = 3, capacity: int = 520) -> dict:
    """A stacked loader batch (``stack_batch`` of ``load_xyzirct_arrays``'s
    on-disk widths, zero padding) of ``b`` random small-sensor clouds.  The
    last ten points of each cloud, which win their grid cells, carry the
    extreme ``t`` and labels above ground; the first four the extreme
    row/col, which the ordering drops; the padding the extremes of every
    field, which only the round trip keeps."""
    rng = np.random.default_rng(seed)
    counts = np.array([500, 470, 500][:b], np.int32)
    out = {
        "xyz": np.zeros((b, capacity, 3), np.float32),
        "intensity": np.zeros((b, capacity), np.float32),
        "row": np.zeros((b, capacity), np.uint16),
        "col": np.zeros((b, capacity), np.uint16),
        "t": np.zeros((b, capacity), np.uint32),
        "label": np.zeros((b, capacity), np.int16),
        "count": counts,
    }
    for k, n in enumerate(counts):
        r, az = rng.uniform(2, 60, n), rng.uniform(-np.pi, np.pi, n)
        z = np.where(rng.random(n) < 0.6, rng.uniform(-2.1, -1.7, n), rng.uniform(-1, 5, n))
        z[n - 10:] = 2.5
        out["xyz"][k, :n] = np.stack([r * np.cos(az), r * np.sin(az), z], 1)
        out["intensity"][k, :n] = np.where(rng.random(n) < 0.15, -1.0, rng.random(n))
        out["row"][k, :n] = rng.integers(0, SMALL[0], n)
        out["col"][k, :n] = rng.integers(0, SMALL[1], n)
        out["t"][k, :n] = rng.integers(0, 1000, n)
        out["label"][k, :n] = -2
        out["row"][k, :2] = (0, 65535)
        out["col"][k, 2:4] = (65535, 0)
        out["t"][k, n - 10:n - 7] = (0, 2**31, 2**32 - 1)
        out["label"][k, n - 7:n - 4] = (-1, -2, 32767)
        pad = slice(n, n + 3)
        out["row"][k, pad] = out["col"][k, pad] = (0, 65535, 32768)
        out["t"][k, pad] = (2**31, 2**32 - 1, 2**31 - 1)
        out["label"][k, pad] = (-1, 32767, -32768)
        out["xyz"][k, n] = (np.nan, -0.0, np.inf)
    return out


def test_upload_has_the_on_disk_widths():
    """Before widening, the uploaded tensors are the on-disk widths, the
    unsigned fields as their signed bit views: 26 B a slot + 4 B a cloud."""
    arrays = loader_batch(0)
    up = _upload(arrays, CPU)
    assert {k: x.dtype for k, x in up.items()} == {
        "xyz": torch.float32, "intensity": torch.float32, "row": torch.int16,
        "col": torch.int16, "t": torch.int32, "label": torch.int16, "count": torch.int32}
    b, c = arrays["row"].shape
    assert sum(x.numel() * x.element_size() for x in up.values()) == 26 * b * c + 4 * b
    for k in ON_DISK:
        np.testing.assert_array_equal(up[k].numpy().view(ON_DISK[k]), arrays[k], err_msg=k)


def test_widened_on_the_device_as_pctpu_widens():
    """``_to_device`` widens as pctpu's ``_preprocess_wire`` does
    (:64-72): row/col uint16 → int32 0…65535, ``t`` uint32 → int64 (pctpu
    keeps uint32), label int16 → int32 sign-extended, ``count`` → int64;
    a mesh shard's ``rows`` are the same rows of the whole batch."""
    arrays = loader_batch(1)
    cloud = _to_device(arrays, CPU)
    want = {"row": np.int32, "col": np.int32, "t": np.int64, "label": np.int32}
    for k, dtype in want.items():
        got = getattr(cloud, k).numpy()
        assert got.dtype == dtype, k
        np.testing.assert_array_equal(got, arrays[k].astype(dtype), err_msg=k)
    assert cloud.row.max() == cloud.col.max() == 65535 and cloud.t.max() == 2**32 - 1
    assert cloud.count.dtype == torch.int64 and cloud.count.tolist() == [500, 470, 500]
    np.testing.assert_array_equal(cloud.xyz.numpy().view(np.uint32),
                                  arrays["xyz"].view(np.uint32))
    shard = _to_device(arrays, CPU, slice(1, 3))
    assert torch.equal(shard.xyz.view(torch.int32), cloud.xyz[1:3].view(torch.int32))
    for k in ("intensity", "row", "col", "t", "label", "count"):
        assert torch.equal(getattr(shard, k), getattr(cloud, k)[1:3]), k


@pytest.mark.parametrize("parts", [1, 3])
def test_round_trip_keeps_every_bit(parts):
    """Up, widened, narrowed and back (as one part or as a mesh's shards in
    order): every field returns in its on-disk dtype with its bits."""
    arrays = loader_batch(2)
    shards = [slice(k, k + 1) for k in range(3)] if parts == 3 else [slice(None)]
    host = _to_host([_wire(_to_device(arrays, CPU, rows)) for rows in shards])
    assert set(host) == set(FIELDS)
    for k in FIELDS:
        assert host[k].dtype == ON_DISK[k], k
        np.testing.assert_array_equal(host[k].view(np.uint8), arrays[k].view(np.uint8),
                                      err_msg=k)


def test_bytes_back_a_batch():
    """The labeled fields come back at 26 B a slot, the upload's widths
    without ``count``."""
    arrays = loader_batch(3)
    b, c = arrays["row"].shape
    host = _to_host([_wire(_to_device(arrays, CPU))])
    assert sum(a.nbytes for a in host.values()) == 26 * b * c


@pytest.mark.parametrize("seed", [4, 5])
def test_wire_equals_pctpu_preprocess_wire(seed):
    """A loader batch through the port's wire (up, ``preprocess_batch``,
    ``_wire``, ``_to_host``) and through pctpu's ``_preprocess_wire`` on the
    CPU: every labeled field equal in dtype and bits, the single BEV equal,
    the occupancy BEV equal to pctpu's bit-packed one."""
    arrays = loader_batch(seed)
    jwire, jpacked, jsingle = jax.device_get(_preprocess_wire(
        {k: jnp.asarray(v) for k, v in arrays.items()}, JSensorParams(*SMALL),
        JGroundConfig(), JMultiBevConfig(), JSingleBevConfig()))
    labeled, multi, single = preprocess_batch(
        _to_device(arrays, CPU), SensorParams(*SMALL), GroundConfig(), MultiBevConfig(),
        SingleBevConfig())
    host = _to_host([{**_wire(labeled), "multi": multi, "single": single}])
    for k in FIELDS:
        want = np.asarray(jwire[k])
        assert host[k].dtype == want.dtype, k
        np.testing.assert_array_equal(host[k].view(np.uint8), want.view(np.uint8), err_msg=k)
    # the extremes reached the labeled clouds
    assert {0, 2**31, 2**32 - 1} <= set(host["t"].ravel().tolist())
    assert {-1, 32767} <= set(host["label"].ravel().tolist())
    np.testing.assert_array_equal(host["single"], np.asarray(jsingle))
    np.testing.assert_array_equal(
        np.packbits(host["multi"] != 0, axis=-1, bitorder="little"), np.asarray(jpacked))


def test_host_arrays_survive_the_next_batch():
    """The arrays handed out for batch k (which the writer threads may still
    be reading) are unchanged after batch k+1's copy back, and share no
    memory with it."""
    first = _to_host([_wire(_to_device(loader_batch(6), CPU))])
    kept = {k: a.copy() for k, a in first.items()}
    second = _to_host([_wire(_to_device(loader_batch(7), CPU))])
    for k in FIELDS:
        np.testing.assert_array_equal(first[k].view(np.uint8), kept[k].view(np.uint8),
                                      err_msg=k)
        assert not np.shares_memory(first[k], second[k]), k
    assert not np.array_equal(first["xyz"].view(np.uint8), second["xyz"].view(np.uint8))


@pytest.mark.parametrize("pipeline", ["multi_bev", "batch_cloud_manip"])
def test_writers_get_the_on_disk_dtypes(pipeline, tmp_path, monkeypatch):
    """Both BEV pipelines hand the labeled PCD writer row/col uint16, ``t``
    uint32 and label int16 straight from the wire."""
    from pctpu_torch.experiments.scene import multi_bev_tree

    params = SensorParams(16, 256, 10, 0.5)
    multi_bev_tree(str(tmp_path), params, n_ordered=2, n_raw=1, n_over=0, seed=3)
    module = multi_bev if pipeline == "multi_bev" else batch_cloud_manip
    real, seen = module.write_pcd, []

    def spy(path, fields, **kw):
        seen.append({k: v.dtype for k, v in fields.items()})
        return real(path, fields, **kw)

    monkeypatch.setattr(module, "write_pcd", spy)
    if pipeline == "multi_bev":
        multi_bev.run_multi_bev(str(tmp_path), params, batch_size=2, device="cpu")
    else:
        monkeypatch.setattr(batch_cloud_manip, "HDL64E", params)
        batch_cloud_manip.run_batch_cloud_manip(str(tmp_path), batch_size=2, device="cpu")
    assert len(seen) == 3
    for dtypes in seen:
        assert {k: dtypes[k] for k in ("row", "col", "t", "label")} == {
            "row": np.uint16, "col": np.uint16, "t": np.uint32, "label": np.int16}


def test_wire_ab_trees_equal_on_the_cpu(capsys):
    """``experiments.wire_ab`` on the CPU at a short drive: the two wires
    (pinned, pageable) write byte-equal trees, and the
    summary carries each variant's medians and the writers-alone times."""
    import json

    from pctpu_torch.experiments import wire_ab

    assert wire_ab.main(["--device=cpu", "--rounds=1", "--clouds=3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    runs, summary = [json.loads(x) for x in lines[:-1]], json.loads(lines[-1])
    assert [r["variant"] for r in runs] == list("PUUP")
    assert summary["trees_equal"] and summary["clouds"] == 6
    assert set(summary["medians"]) == {"P", "U"}
    assert all(m["clouds_per_s"] > 0 for m in summary["medians"].values())
    assert set(summary["writers_alone_ms_per_cloud"]) == {"pinned", "pageable"}
    assert summary["device"] == {"type": "cpu"}
