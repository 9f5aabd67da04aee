"""top_part_registration of pctpu_torch against pctpu's CLI, on the CPU, on
the scene of ``tests/test_render.py``'s snapshot test (a 12-cluster
building scene and its copy turned 15° and moved 1 m, capacity 4096).

Both print the same two ``[TIME]`` lines and result lines; the converged
flag agrees, the fitness within 1e-4 relative or 1e-8 m² and the
transforms within 1e-4 (D5: the two stacks sum in different orders).  The flat scene the
snapshot draws is re-derived as pctpu does it: its voxel centroids are
bit-equal to pctpu's, the normals valid at the same points, the whiskers'
ends within 0.01 m (D3/D4: the 2-D normals' radius membership and
ill-conditioned neighbourhoods), so both views and the HTML viewer differ
from pctpu's in at most 0.1% of pixels and 0.01 m of a whisker's end."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from pctpu.cli import top_part_registration as jcli
from pctpu.cloud import make_cloud
from pctpu.io.pcd import save_cloud_pcd
from pctpu_torch.cli import top_part_registration as tcli
from pctpu_torch.io.html_viewer import read_back_layers
from pctpu_torch.io.png import decode_rgb_png

from .test_registration_e2e import rigid, synth_scene


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("top_part")
    xyz, labels = synth_scene(np.random.default_rng(7))
    xyz2 = rigid(xyz, 15.0, [1.0, 0.0, 0.0])
    p1, p2 = str(d / "a.pcd"), str(d / "b.pcd")
    save_cloud_pcd(p1, make_cloud(xyz, label=labels, capacity=4096))
    save_cloud_pcd(p2, make_cloud(xyz2, label=labels, capacity=4096))
    return d, p1, p2


@pytest.fixture(scope="module")
def runs(pair):
    d, p1, p2 = pair
    out = {}
    for name, main, extra in (("pctpu", jcli.main, []), ("port", tcli.main, ["--device=cpu"])):
        files = {}
        for view in ("top", "front"):
            png, html = d / f"{name}_{view}.png", d / f"{name}.html"
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                assert main([p1, p2, "15.0", "--flat-cap=4096", f"--snapshot={png}",
                             f"--snapshot-view={view}", f"--html={html}", *extra]) == 0
            files[view] = decode_rgb_png(png.read_bytes())
        out[name] = (log.getvalue(), files, read_back_layers(str(html)))
    return out


def _numbers(log: str) -> list[float]:
    body = "\n".join(line for line in log.splitlines()
                     if not line.startswith(("[TIME]", "device:")))
    return [float(v) for v in re.findall(r"-?\d+\.\d*(?:e[-+]\d+)?", body)]


def test_report_lines_match_pctpu(runs):
    want, got = runs["pctpu"][0], runs["port"][0]
    assert got.startswith("device: cpu\n")

    def shape(lines):  # each line with its numbers and spacing blanked out
        return ["".join(re.sub(r"-?\d+\.?\d*(?:e[-+]\d+)?", "#", line).split())
                for line in lines]

    assert shape(got.splitlines()[1:]) == shape(want.splitlines())
    assert "is icp converged: True" in got and "is icp converged: True" in want
    w, g = np.array(_numbers(want)), np.array(_numbers(got))
    assert w.shape == g.shape == (1 + 16 + 1 + 16,)
    np.testing.assert_allclose(g[[0, 17]], w[[0, 17]], rtol=1e-4, atol=1e-8)  # fitness, m²
    np.testing.assert_allclose(g, w, atol=1e-4)


@pytest.mark.parametrize("view", ["top", "front"])
def test_snapshots_match_pctpu(runs, view):
    want, got = runs["pctpu"][1][view], runs["port"][1][view]
    assert got.shape == want.shape
    differ = int((got != want).any(-1).sum())
    assert differ <= 0.001 * want.shape[0] * want.shape[1], differ
    for color in [(255, 0, 0), (255, 255, 255), (0, 0, 0)]:
        assert (np.all(got == color, axis=-1)).any(), color


def test_html_matches_pctpu(runs):
    want, got = runs["pctpu"][2], runs["port"][2]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=0.01, err_msg=name)
    np.testing.assert_array_equal(got["original_cloud"], want["original_cloud"])


def test_needs_a_card_unless_asked(pair, monkeypatch, capsys):
    _, p1, p2 = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tcli.main([p1, p2, "15.0"])
    assert exc.value.code == 2
    assert "--device=cpu" in capsys.readouterr().err
