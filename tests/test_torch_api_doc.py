"""docs/API.md's surface in the port: every fully-qualified ``pctpu.*``
dotted path in the document, mapped to ``pctpu_torch.*``, resolves to a
real module attribute (the port of tests/test_api_doc.py's check).  One
module is renamed by the port, the Pallas 1-NN kernels' home
``ops.pallas_knn``, whose CUDA counterparts live in ``ops.cuda_knn``."""

from __future__ import annotations

import importlib
import re
from pathlib import Path

DOC = Path(__file__).resolve().parent.parent / "docs" / "API.md"

_PATH_RE = re.compile(r"\bpctpu(?:\.[A-Za-z_][A-Za-z0-9_]*)+")
RENAMED = {"pctpu_torch.ops.pallas_knn": "pctpu_torch.ops.cuda_knn"}


def port_path(path: str) -> str:
    path = "pctpu_torch" + path[len("pctpu"):]
    for old, new in RENAMED.items():
        if path == old or path.startswith(old + "."):
            path = new + path[len(old):]
    return path


def _resolve(path: str) -> bool:
    parts = path.split(".")
    for split in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            return False
        return True
    return False


def test_port_path_map():
    assert port_path("pctpu.ops.pallas_knn.spatial_sort") == "pctpu_torch.ops.cuda_knn.spatial_sort"
    assert port_path("pctpu.parallel") == "pctpu_torch.parallel"
    assert port_path("pctpu.ops.pallas_knn_x") == "pctpu_torch.ops.pallas_knn_x"


def test_every_documented_pctpu_path_resolves_in_the_port():
    paths = sorted(set(_PATH_RE.findall(DOC.read_text())))
    assert paths, "no pctpu.* paths found — regex or doc broken"
    bad = [port_path(p) for p in paths if not _resolve(port_path(p))]
    assert not bad, f"docs/API.md paths with no counterpart in pctpu_torch: {bad}"


def test_f5_surface_resolves():
    """The rest of F5: the names docs/API.md's modules lead to that the port
    lacked."""
    for path in ("pctpu.ops.pallas_knn.spatial_sort", "pctpu.runtime.native_io.write_png",
                 "pctpu.runtime.native_io.write_multi_bev",
                 "pctpu.runtime.native_io.format_csv_u8",
                 "pctpu.runtime.native_io.lzf_decompress", "pctpu.runtime.profiler.trace",
                 "pctpu.parallel.distributed.initialize", "pctpu.parallel.mesh.sharded_nn_1"):
        assert _resolve(path) and _resolve(port_path(path)), path
