"""PCL-compatible PCD reader/writer (ascii, binary, binary_compressed) —
the numpy code of ``pctpu/io/pcd.py``, carried over so the port needs no
pctpu import, with Cloud adapters for torch tensors.

The reference's on-disk cloud is ``pcl::io::savePCDFileBinary`` of the
custom ``pcl::PointXYZIRCT`` point (reference/BatchMultiBevGen.h:44-66):
fields packed without struct padding, 26 bytes a point:

  FIELDS x y z intensity row col t label
  SIZE   4 4 4 4 2 2 4 2
  TYPE   F F F F U U U I
"""

from __future__ import annotations

import dataclasses
import io as _io
import os

import numpy as np
import torch

from pctpu_torch.cloud import Cloud, make_cloud

_TYPE_MAP = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("U", 8): np.uint64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("I", 8): np.int64,
}
_INV_TYPE_MAP = {v: k for k, v in _TYPE_MAP.items()}


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    dtype: type
    count: int = 1


# The reference's custom point (reference/BatchMultiBevGen.h:56-66).
XYZIRCT_FIELDS = (
    FieldSpec("x", np.float32),
    FieldSpec("y", np.float32),
    FieldSpec("z", np.float32),
    FieldSpec("intensity", np.float32),
    FieldSpec("row", np.uint16),
    FieldSpec("col", np.uint16),
    FieldSpec("t", np.uint32),
    FieldSpec("label", np.int16),
)


def _structured_dtype(fields: tuple[FieldSpec, ...]) -> np.dtype:
    return np.dtype(
        [(f.name, f.dtype) if f.count == 1 else (f.name, f.dtype, (f.count,)) for f in fields],
    )


def write_pcd(
    path: str,
    data: dict[str, np.ndarray],
    fields: tuple[FieldSpec, ...] = XYZIRCT_FIELDS,
    binary: bool = True,
    width: int | None = None,
    height: int = 1,
) -> None:
    """Write a PCD file with a PCL-identical header and packed binary body."""
    n = len(next(iter(data.values())))
    if width is None:
        width = n
    if width * height != n:
        raise ValueError(f"width*height = {width * height} != {n} points")

    names = " ".join(f.name for f in fields)
    sizes = " ".join(str(np.dtype(f.dtype).itemsize) for f in fields)
    types = " ".join(_INV_TYPE_MAP[np.dtype(f.dtype).type][0] for f in fields)
    counts = " ".join(str(f.count) for f in fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {names}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {width}\n"
        f"HEIGHT {height}\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )

    rec = np.empty(n, _structured_dtype(fields))
    for f in fields:
        rec[f.name] = np.asarray(data[f.name]).astype(f.dtype, copy=False)

    # write to a temp name and rename: a killed run must never leave a
    # truncated PCD at the final path
    tmp_path = f"{path}.tmp.{os.getpid()}"
    with open(tmp_path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if binary:
            fh.write(rec.tobytes())
        else:
            out = _io.StringIO()
            for row in rec:
                out.write(
                    " ".join(_ascii_value(v) for cell in row for v in np.ravel(cell))
                )
                out.write("\n")
            fh.write(out.getvalue().encode("ascii"))
    os.replace(tmp_path, path)


def _ascii_value(v) -> str:
    if isinstance(v, np.float64):
        return repr(float(v))  # full f64 precision for ('F', 8) fields
    if isinstance(v, (np.floating, float)):
        return repr(float(np.float32(v)))
    return str(int(v))


def _lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """liblzf decompression (the PCD binary_compressed codec).

    Control byte < 32 ⇒ literal run of ctrl+1 bytes; otherwise a back
    reference: length = (ctrl >> 5) (+ext byte when 7) + 2, offset =
    ((ctrl & 0x1f) << 8 | next byte) + 1.  Decodes through the native
    library (``runtime.native_io``) when it is available; this pure-Python
    path is the fallback."""
    from pctpu_torch.runtime.native_io import lzf_decompress as _native_lzf

    native = _native_lzf(data, expected_size)
    if native is not None:
        return native
    out = bytearray(expected_size)
    i, o, nin = 0, 0, len(data)
    while i < nin:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            run = ctrl + 1
            out[o : o + run] = data[i : i + run]
            i += run
            o += run
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("corrupt LZF stream: reference before start")
            for _ in range(length + 2):  # may overlap: byte-by-byte copy
                out[o] = out[ref]
                o += 1
                ref += 1
    if o != expected_size:
        raise ValueError(
            f"corrupt LZF stream: expected {expected_size} bytes, got {o}"
        )
    return bytes(out)


def read_pcd_point_count(path: str) -> int:
    """POINTS from the PCD header only (no body parse/decompress)."""
    with open(path, "rb") as fh:
        head = fh.read(4096)
    for raw in head.split(b"\n"):
        line = raw.decode("ascii", "replace").strip()
        if line.startswith("POINTS "):
            return int(line.split()[1])
    raise ValueError(f"corrupt PCD (no POINTS line in header): {path}")


def read_pcd(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Read a PCD file (ascii, binary or binary_compressed).

    Returns (fields dict, header dict with width/height/points/fields)."""
    with open(path, "rb") as fh:
        blob = fh.read()

    header: dict[str, object] = {}
    pos = 0
    while True:
        eol = blob.find(b"\n", pos)
        if eol < 0:
            raise ValueError(f"corrupt PCD (no DATA line in header): {path}")
        line = blob[pos:eol].decode("ascii", "replace").strip()
        pos = eol + 1
        if line.startswith("#") or not line:
            continue
        key, _, rest = line.partition(" ")
        header[key] = rest
        if key == "DATA":
            break

    names = str(header["FIELDS"]).split()
    sizes = [int(s) for s in str(header["SIZE"]).split()]
    types = str(header["TYPE"]).split()
    counts = [int(c) for c in str(header.get("COUNT", " ".join("1" * len(names)))).split()]
    n = int(header["POINTS"])
    fields = tuple(
        FieldSpec(nm, _TYPE_MAP[(tp, sz)], ct)
        for nm, sz, tp, ct in zip(names, sizes, types, counts)
    )
    dtype = _structured_dtype(fields)

    mode = str(header["DATA"])
    if mode == "binary":
        if len(blob) - pos < n * dtype.itemsize:
            raise ValueError(
                f"truncated PCD: header declares {n} points "
                f"({n * dtype.itemsize} bytes) but the body holds "
                f"{len(blob) - pos}: {path}"
            )
        rec = np.frombuffer(blob, dtype, count=n, offset=pos)
    elif mode == "ascii":
        text = blob[pos:].decode("ascii")
        flat = np.loadtxt(_io.StringIO(text), dtype=np.float64, ndmin=2)
        rec = np.empty(n, dtype)
        col = 0
        for f in fields:
            w = f.count
            vals = flat[:, col : col + w]
            rec[f.name] = (vals[:, 0] if w == 1 else vals).astype(f.dtype)
            col += w
    elif mode == "binary_compressed":
        # [u32 compressed size][u32 uncompressed size][LZF data], field-major
        # (pcl::io::savePCDFileBinaryCompressed layout)
        comp_size, uncomp_size = np.frombuffer(blob, np.uint32, 2, offset=pos)
        payload = _lzf_decompress(
            blob[pos + 8 : pos + 8 + int(comp_size)], int(uncomp_size)
        )
        rec = np.empty(n, dtype)
        off = 0
        for f in fields:
            fdt = np.dtype(f.dtype)
            col = np.frombuffer(payload, fdt, n * f.count, offset=off)
            rec[f.name] = col if f.count == 1 else col.reshape(n, f.count)
            off += n * f.count * fdt.itemsize
    else:
        raise ValueError(f"unsupported PCD DATA mode: {mode}")

    out = {f.name: np.ascontiguousarray(rec[f.name]) for f in fields}
    meta = {
        "width": int(header["WIDTH"]),
        "height": int(header["HEIGHT"]),
        "points": n,
        "fields": fields,
    }
    return out, meta


# ---------------------------------------------------------------------------
# Cloud <-> PCD adapters


def cloud_to_pcd_dict(cloud: Cloud, num_points: int | None = None) -> dict[str, np.ndarray]:
    """Host XYZIRCT field arrays of the first ``num_points`` slots (default:
    the cloud's count); ``t`` is bit-cast back to uint32 here."""
    if num_points is None:
        num_points = cloud.count

    def host(a: torch.Tensor) -> np.ndarray:
        return a[:num_points].cpu().numpy()

    xyz = host(cloud.xyz)
    return {
        "x": xyz[:, 0],
        "y": xyz[:, 1],
        "z": xyz[:, 2],
        "intensity": host(cloud.intensity),
        "row": host(cloud.row).astype(np.uint16),
        "col": host(cloud.col).astype(np.uint16),
        "t": host(cloud.t).astype(np.uint32),
        "label": host(cloud.label).astype(np.int16),
    }


def save_cloud_pcd(path: str, cloud: Cloud, num_points: int | None = None) -> None:
    write_pcd(path, cloud_to_pcd_dict(cloud, num_points))


def load_cloud_pcd(
    path: str, capacity: int | None = None, device: torch.device | str = "cuda"
) -> Cloud:
    """Load a PCD into a Cloud on ``device`` (the card unless asked
    otherwise), padding to ``capacity`` if given.  Missing XYZIRCT fields
    default to zero (e.g. plain XYZ files)."""
    data, meta = read_pcd(path)
    n = meta["points"]
    xyz = np.stack([data["x"], data["y"], data["z"]], axis=1)

    def _get(name, dtype):
        if name in data:
            # int16 labels must sign-extend
            return data[name].astype(dtype)
        return np.zeros((n,), dtype)

    return make_cloud(
        xyz,
        intensity=_get("intensity", np.float32),
        row=_get("row", np.int32),
        col=_get("col", np.int32),
        t=_get("t", np.int64),
        label=_get("label", np.int32),
        capacity=capacity,
        device=device,
    )
