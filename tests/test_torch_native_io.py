"""The port's native IO bindings (``pctpu_torch.runtime.native_io``) against
pctpu's: ``write_png``, ``write_multi_bev``, ``format_csv_u8`` and
``lzf_decompress`` byte-equal on the same inputs, their Python fallbacks
equal to the native paths, the port's ``binary_compressed`` PCD read
going through the native decoder, and the CSV formatter's first use from
several writer threads (ROADMAP F8)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import pctpu.runtime.native_io as jnio
from pctpu_torch.io import pcd as tpcd
from pctpu_torch.runtime import native_io as nio

from .test_pcd import _lzf_compress_literals

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# Fresh instances of the native library (copies under new names, so each
# has its own statics), each formatting a 224² image of every byte value
# from THREADS threads released together; prints the instances whose CSVs
# were not the Python formatter's bytes.  LOADER: each copy is loaded
# through ``native_io._load`` (which builds the cell table under its lock),
# else bound bare, as any other caller of the library would.  A process
# holds a few hundred such copies at most (each takes a thread-local
# block), so each batch runs in a process of its own.
_RACE = """
import ctypes, pathlib, shutil, sys, tempfile, threading
import numpy as np
from pctpu_torch.io.csvfmt import format_csv_python
from pctpu_torch.runtime import native_io as nio
n_libs, threads, loader = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "1"
src = nio.library_path()
assert nio._load() is not None, nio.build_error
img = (np.arange(224 * 224) % 256).astype(np.uint8).reshape(224, 224)
want = format_csv_python(img)
bad = 0
with tempfile.TemporaryDirectory() as tmp:
    for k in range(n_libs):
        path = pathlib.Path(tmp) / f"libpctpu_io_{k}.so"
        shutil.copy(src, path)
        if loader:
            nio.library_path = lambda path=path: path
            nio._lib, nio._tried = None, False
            assert nio._load() is not None, nio.build_error
            fmt = nio.format_csv_u8
        else:
            lib = ctypes.CDLL(str(path))
            lib.pctpu_format_csv_u8.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p, ctypes.c_long]
            lib.pctpu_format_csv_u8.restype = ctypes.c_long

            def fmt(mat, lib=lib):
                out = np.empty(mat.size * 5, np.uint8)
                n = lib.pctpu_format_csv_u8(mat.ctypes.data, *mat.shape, out.ctypes.data,
                                            out.size)
                return out[:n].tobytes()
        got = [None] * threads
        start = threading.Barrier(threads)

        def run(i):
            start.wait(timeout=30)
            got[i] = fmt(img)

        workers = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers)
        bad += any(g != want for g in got)
print(bad)
"""


def _first_use_race(n_libs: int, threads: int, loader: bool, batch: int = 400) -> int:
    """Instances (of ``n_libs``, in processes of ``batch``) whose CSVs were wrong."""
    bad = 0
    for done in range(0, n_libs, batch):
        res = subprocess.run([sys.executable, "-c", _RACE, str(min(batch, n_libs - done)),
                              str(threads), "1" if loader else "0"], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        bad += int(res.stdout.split()[-1])
    return bad


def test_csv_formatter_first_use_from_writer_threads():
    """F8: the BEV pipelines' two writer threads format their first CSVs at
    once in a fresh process.  Through the port's loader no CSV differs from
    the Python formatter's bytes, with 4 threads on 400 fresh instances;
    bound bare, the library gives NUL bytes in some
    (``test_csv_formatter_first_use_race_needs_two_threads``)."""
    assert _first_use_race(400, 4, loader=True) == 0


@pytest.mark.slow
def test_csv_formatter_first_use_race_needs_two_threads():
    """The fault the loader guards against, in the library itself: bound
    bare, 1,000 fresh instances formatting from one thread never give a
    wrong CSV; from two threads at once some do (NUL bytes where a cell's
    text was being rewritten)."""
    assert _first_use_race(1000, 1, loader=False) == 0
    assert _first_use_race(1000, 2, loader=False) > 0


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
