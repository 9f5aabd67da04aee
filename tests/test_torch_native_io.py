"""The port's native IO bindings (``pctpu_torch.runtime.native_io``) against
pctpu's: ``write_png``, ``write_multi_bev``, ``format_csv_u8`` and
``lzf_decompress`` byte-equal on the same inputs, their Python fallbacks
equal to the native paths, and the port's ``binary_compressed`` PCD read
going through the native decoder."""

import os

import numpy as np
import pytest

import pctpu.runtime.native_io as jnio
from pctpu_torch.io import pcd as tpcd
from pctpu_torch.runtime import native_io as nio

from .test_pcd import _lzf_compress_literals


@pytest.fixture(autouse=True)
def _native():
    if not (nio.native_available() and jnio.native_available()):
        pytest.fail(f"native library did not build: {nio.build_error}")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _images(seed=0, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    sparse = np.where(rng.random(shape) < 0.05, 255, 0).astype(np.uint8)
    floats = rng.uniform(-40.0, 300.0, shape).astype(np.float32)  # saturated to u8
    return {"u8": u8, "sparse": sparse, "float": floats}


@pytest.mark.parametrize("level", [1, 6])
def test_write_png_equals_pctpu(tmp_path, level, monkeypatch):
    for name, img in _images().items():
        a, b, c = (str(tmp_path / f"{name}_{k}.png") for k in ("pctpu", "port", "fallback"))
        jnio.write_png(a, img, level=level)
        nio.write_png(b, img, level=level)
        assert _read(a) == _read(b), name
        # the Python writer where the native one is not there
        with monkeypatch.context() as m:
            m.setattr(nio, "_load", lambda: None)
            nio.write_png(c, img, level=level)
        assert _read(c) == _read(b), name


@pytest.mark.parametrize("write_pngs", [True, False])
def test_write_multi_bev_equals_pctpu(tmp_path, write_pngs, monkeypatch):
    rng = np.random.default_rng(1)
    multi = np.where(rng.random((4, 24, 32)) < 0.1, 255, 0).astype(np.uint8)
    trees = {}
    for kind in ("pctpu", "port", "fallback"):
        d = tmp_path / kind
        d.mkdir()
        args = (str(d / "cloud.bin"), str(d / "image" / "cloud") + "/", multi)
        if kind == "pctpu":
            jnio.write_multi_bev(*args, write_pngs=write_pngs)
        elif kind == "port":
            nio.write_multi_bev(*args, write_pngs=write_pngs)
        else:
            with monkeypatch.context() as m:
                m.setattr(nio, "_load", lambda: None)
                nio.write_multi_bev(*args, write_pngs=write_pngs)
        trees[kind] = {os.path.relpath(os.path.join(p, f), d): _read(os.path.join(p, f))
                       for p, _, fs in os.walk(d) for f in fs}
    assert len(trees["port"]) == (5 if write_pngs else 1)
    assert trees["port"] == trees["pctpu"] == trees["fallback"]


def test_format_csv_u8_equals_pctpu(monkeypatch):
    for img in _images(2).values():
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        got = nio.format_csv_u8(u8)
        assert got is not None and got == jnio.format_csv_u8(u8)
    monkeypatch.setattr(nio, "_load", lambda: None)
    assert nio.format_csv_u8(u8) is None


def test_lzf_decompress_equals_pctpu(monkeypatch):
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 255, 100_000, dtype=np.uint8).tobytes()
    comp = _lzf_compress_literals(payload)
    assert nio.lzf_decompress(comp, len(payload)) == payload == jnio.lzf_decompress(
        comp, len(payload))
    # a back reference that overlaps its own output
    stream = bytes([0x02]) + b"XYZ" + bytes([0xE0, 0x00, 0x02])
    assert nio.lzf_decompress(stream, 12) == b"XYZXYZXYZXYZ" == jnio.lzf_decompress(stream, 12)
    # a stream that does not decode to the expected size: None, as pctpu's
    assert nio.lzf_decompress(stream, 13) is None and jnio.lzf_decompress(stream, 13) is None
    monkeypatch.setattr(nio, "_load", lambda: None)
    assert nio.lzf_decompress(stream, 12) is None


def test_binary_compressed_pcd_reads_through_the_native_decoder(tmp_path, monkeypatch):
    """A binary_compressed PCD (literal LZF runs, as pctpu's PCD tests
    write one): the port's reader decodes it natively, to the same fields
    as its Python decoder and pctpu's reader."""
    import pctpu.io.pcd as jpcd
    from pctpu_torch import make_cloud

    rng = np.random.default_rng(7)
    n = 301
    cloud = make_cloud(rng.uniform(-60, 60, (n, 3)).astype(np.float32),
                       intensity=rng.random(n).astype(np.float32), device="cpu")
    data = tpcd.cloud_to_pcd_dict(cloud)
    path = str(tmp_path / "c.pcd")
    tpcd.write_pcd(path, data)
    blob = _read(path)
    head = blob[: blob.index(b"DATA binary\n")]
    soa = b"".join(np.ascontiguousarray(data[f.name]).astype(f.dtype).tobytes()
                   for f in jpcd.XYZIRCT_FIELDS)
    comp = _lzf_compress_literals(soa)
    with open(path, "wb") as f:
        f.write(head + b"DATA binary_compressed\n")
        f.write(np.array([len(comp), len(soa)], np.uint32).tobytes() + comp)
    calls = []
    real = nio.lzf_decompress
    monkeypatch.setattr(nio, "lzf_decompress",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    native, _ = tpcd.read_pcd(path)
    assert calls == [len(comp)]
    monkeypatch.setattr(nio, "lzf_decompress", lambda *a: None)  # the Python decoder
    python, _ = tpcd.read_pcd(path)
    ref, _ = jpcd.read_pcd(path)
    assert native.keys() == python.keys() == ref.keys()
    for k in native:
        np.testing.assert_array_equal(native[k], python[k])
        np.testing.assert_array_equal(native[k], ref[k])
