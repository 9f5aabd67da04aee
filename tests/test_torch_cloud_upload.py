"""The staged cloud upload (``cloud._staged_fields``), on the CPU.

On a card ``from_numpy`` and ``make_cloud`` write a Cloud's six fields into
one pinned host block at 256-byte offsets and send it in one copy.  Here the
same layout and fill run on an unpinned block (``_staged``, ``_host_block``
and ``_send`` patched: the block is "sent" by a CPU copy), and every field
must be bit for bit what the direct path gives.  The card's own tests are in ``test_torch_cuda_kernels.py``.
This file imports neither jax nor pctpu."""

import numpy as np
import pytest
import torch

from pctpu_torch import cloud
from pctpu_torch.runtime import profiler

FIELDS = ("xyz", "intensity", "row", "col", "t", "label")


@pytest.fixture
def staged_on_cpu(monkeypatch):
    """Route ``device="cpu"`` through the staged path, on unpinned blocks."""
    blocks = []

    def block(nbytes):
        blocks.append(torch.empty(nbytes, dtype=torch.uint8))
        return blocks[-1]

    monkeypatch.setattr(cloud, "_staged", lambda device: True)
    monkeypatch.setattr(cloud, "_host_block", block)
    monkeypatch.setattr(cloud, "_send", lambda host, device: host.clone())
    return blocks


def _dict(rng, cap, count, t_dtype):
    """A ``to_numpy``-style dict: random real points, zero padding."""
    d = {"xyz": rng.normal(0, 40, (cap, 3)).astype(np.float32),
         "intensity": rng.random(cap).astype(np.float32),
         "row": rng.integers(0, 64, cap).astype(np.int32),
         "col": rng.integers(0, 2083, cap).astype(np.int32),
         "t": rng.integers(0, 2**32, cap).astype(t_dtype),
         "label": rng.integers(-2, 9, cap).astype(np.int32), "count": count}
    for k in FIELDS:
        d[k][count:] = 0
    return d


def _bits(a: torch.Tensor) -> bytes:
    return a.contiguous().view(torch.uint8).numpy().tobytes()


def _same(got: cloud.Cloud, want: cloud.Cloud) -> None:
    for k in FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous(), k
        assert _bits(g) == _bits(w), k
    assert got.count == want.count


def _from_numpy_direct(d: dict) -> cloud.Cloud:
    """``from_numpy`` as the direct path has always written it."""
    def _t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device="cpu", dtype=dtype)

    return cloud.Cloud(xyz=_t(np.asarray(d["xyz"], np.float32), torch.float32),
                       intensity=_t(np.asarray(d["intensity"], np.float32), torch.float32),
                       row=_t(np.asarray(d["row"], np.int32), torch.int32),
                       col=_t(np.asarray(d["col"], np.int32), torch.int32),
                       t=_t(np.asarray(d["t"]).astype(np.int64), torch.int64),
                       label=_t(np.asarray(d["label"], np.int32), torch.int32),
                       count=int(d["count"]))


@pytest.mark.parametrize("xyz_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("t_dtype", [np.uint32, np.int64])
@pytest.mark.parametrize("cap,count", [(1, 1), (1023, 700), (8192, 8192)])
def test_from_numpy_staged_bit_for_bit(staged_on_cpu, xyz_dtype, t_dtype, cap, count):
    """A ``to_numpy`` dict, ``t`` as uint32 or int64 and xyz cast or not:
    the staged Cloud is the direct one, bit for bit."""
    d = _dict(np.random.default_rng(cap), cap, count, t_dtype)
    d["xyz"] = (d["xyz"].astype(np.float64) * (1 + 1e-9)).astype(xyz_dtype)
    want = _from_numpy_direct(d)
    got = cloud.from_numpy(d, device="cpu")
    assert len(staged_on_cpu) == 1
    _same(got, want)


@pytest.mark.parametrize("case", ["full", "tail", "defaults", "float64_xyz", "empty",
                                  "read_only", "reversed", "strided"])
@pytest.mark.parametrize("t_dtype", [np.uint32, np.int64])
def test_make_cloud_staged_bit_for_bit(monkeypatch, case, t_dtype):
    """``make_cloud``'s inputs, ``n < capacity`` with an all-zero tail
    included: the staged Cloud is the direct one, bit for bit."""
    rng = np.random.default_rng(7)
    n, cap = {"full": (1023, 1023), "empty": (0, 16)}.get(case, (700, 1023))
    kw = {"intensity": rng.random(n).astype(np.float32),
          "row": rng.integers(0, 64, n).astype(np.int32),
          "col": rng.integers(0, 2083, n).astype(np.int64),   # narrowed to int32
          "t": rng.integers(0, 2**32, n).astype(t_dtype),
          "label": rng.integers(-2, 9, n).astype(np.int16)}   # sign-extended
    xyz = rng.normal(0, 40, (n, 3)).astype(np.float64 if case == "float64_xyz" else np.float32)
    if case == "defaults":
        kw = {"label": kw["label"]}
    elif case == "read_only":
        for v in kw.values():
            v.flags.writeable = False
    elif case == "reversed":
        kw = {k: v[::-1] for k, v in kw.items()}
    elif case == "strided":
        kw = {k: np.repeat(v, 2)[::2] for k, v in kw.items()}
        xyz = np.asfortranarray(xyz)
    want = cloud.make_cloud(xyz, capacity=cap, device="cpu", **kw)
    blocks = []
    monkeypatch.setattr(cloud, "_staged", lambda device: True)
    monkeypatch.setattr(cloud, "_host_block",
                        lambda nbytes: blocks.append(torch.full((nbytes,), 0xAB,
                                                                dtype=torch.uint8)) or blocks[-1])
    monkeypatch.setattr(cloud, "_send", lambda host, device: host.clone())
    got = cloud.make_cloud(xyz, capacity=cap, device="cpu", **kw)
    assert len(blocks) == 1
    _same(got, want)
    for k in FIELDS:  # the tail is written, whatever the block held
        assert not getattr(got, k)[n:].any(), k


@pytest.mark.parametrize("cap", [1, 7, 1023, 139264])
def test_layout_aligned_contiguous_views(cap):
    shapes = {k: (cap, 3) if k == "xyz" else (cap,) for k in FIELDS}
    fields, nbytes = cloud._layout(shapes)
    block = torch.empty(nbytes, dtype=torch.uint8)
    views = cloud._views(block, fields)
    assert list(views) == list(FIELDS)
    dtypes = {"xyz": torch.float32, "intensity": torch.float32, "row": torch.int32,
              "col": torch.int32, "t": torch.int64, "label": torch.int32}
    end = 0
    for k, v in views.items():
        start = v.data_ptr() - block.data_ptr()
        assert start % 256 == 0 and start >= end, (k, start, end)
        assert v.shape == shapes[k] and v.dtype == dtypes[k] and v.is_contiguous()
        end = start + v.numel() * v.element_size()
    assert end <= nbytes < end + 256
    assert nbytes <= 36 * cap + 6 * 256


def test_cpu_device_keeps_the_direct_path():
    """``device="cpu"`` takes no staged block: the fields are the direct
    path's, each its own tensor, and the counters say which path ran."""
    d = _dict(np.random.default_rng(3), 2048, 1500, np.uint32)
    with profiler.recording() as rec:
        got = cloud.from_numpy(d, device="cpu")
        made = cloud.make_cloud(d["xyz"][:1500], label=d["label"][:1500], capacity=2048,
                                device="cpu")
    _same(got, _from_numpy_direct(d))
    assert made.label.untyped_storage().data_ptr() != made.xyz.untyped_storage().data_ptr()
    assert rec.totals() == {"cloud.upload.direct": 2}
    assert [s.name for s in rec.spans] == ["cloud.upload"]


def test_staged_spans_and_counters(staged_on_cpu):
    """The staged path's fill is a child of ``cloud.upload`` and each
    constructor counts ``cloud.upload.staged`` once."""
    d = _dict(np.random.default_rng(4), 512, 300, np.int64)
    with profiler.recording() as rec:
        cloud.from_numpy(d, device="cpu")
        cloud.make_cloud(d["xyz"][:300], capacity=512, device="cpu")
    assert rec.totals() == {"cloud.upload.staged": 2}
    (up,) = rec.named("cloud.upload")
    fills = rec.named("cloud.upload.fill")
    assert len(fills) == 2 and fills[0].parent == up.id
    assert up.start_ns <= fills[0].start_ns <= fills[0].end_ns <= up.end_ns


@pytest.mark.parametrize("staged", [False, True])
def test_make_cloud_length_checks_stay(monkeypatch, staged):
    monkeypatch.setattr(cloud, "_staged", lambda device: staged)
    xyz = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="exceed capacity"):
        cloud.make_cloud(xyz, capacity=3, device="cpu")
    with pytest.raises(ValueError, match="field length 5"):
        cloud.make_cloud(xyz, intensity=np.zeros(5, np.float32), device="cpu")
