"""The port's two examples run on the CPU (``--device=cpu``):
``examples/torch_end_to_end_demo.py`` (selector → BEV → registration on a
synthetic MulRan tree) and ``examples/torch_library_quickstart.py``
(docs/API.md's quickstart), each held to what ``tests/test_example_demo.py``
asks of pctpu's examples, the demo's tree to the bytes of pctpu's."""

import filecmp
import importlib.util
import os

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_end_to_end_demo_cpu(tmp_path, capsys):
    demo = _example("torch_end_to_end_demo")
    assert demo.main([str(tmp_path), "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "7 keyframes" in out
    assert "7 multi-BEV binaries" in out
    lines = (tmp_path / "icp_precision_report.txt").read_text().strip().split("\n")
    assert len(lines) == 2
    # both pairs register, within pctpu's example's window
    for line in lines:
        dxy, dyaw = (float(v) for v in line.split())
        assert abs(dxy) < 1.5 and abs(dyaw) < 5.0
    assert (tmp_path / "viewer.html").stat().st_size > 0


def test_library_quickstart_cpu(tmp_path, capsys):
    quick = _example("torch_library_quickstart")
    assert quick.main([str(tmp_path), "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "round-tripped 2700 points" in out
    assert "quickstart OK" in out


def test_demo_tree_bytes_equal_pctpu_example(tmp_path):
    """The port's demo writes the dataset of pctpu's, byte for byte."""
    _example("torch_end_to_end_demo").build_mulran_tree(str(tmp_path / "port"))
    _example("end_to_end_demo").build_mulran_tree(str(tmp_path / "pctpu"))
    for dirpath, _, files in os.walk(tmp_path / "pctpu"):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), tmp_path / "pctpu")
            assert filecmp.cmp(tmp_path / "pctpu" / rel, tmp_path / "port" / rel, shallow=False)
    assert sum(len(f) for _, _, f in os.walk(tmp_path / "port")) == 10


@pytest.mark.parametrize("name", ["torch_end_to_end_demo", "torch_library_quickstart"])
def test_examples_exit_2_without_a_card(name, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _example(name).main([str(tmp_path)]) == 2
    assert "--device=cpu" in capsys.readouterr().err
