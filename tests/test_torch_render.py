"""The headless snapshot renderer, the RGB PNG codec and the HTML viewer of
the port (``pctpu_torch.ops.render``, ``io.png``, ``io.html_viewer``) against
pctpu's on the CPU: the images bit-equal and the files byte-equal on the
same inputs, and the cases of pctpu's ``tests/test_render.py`` and
``tests/test_html_viewer.py`` run on the port."""

import base64
import json

import numpy as np
import pytest

from pctpu.io import html_viewer as jhtml
from pctpu.io.png import encode_rgb_png as jencode_rgb
from pctpu.ops.render import Layer as JLayer
from pctpu.ops.render import render_snapshot as jrender
from pctpu.ops.render import segment_points as jsegment_points
from pctpu_torch.io import html_viewer as html
from pctpu_torch.io.png import decode_rgb_png, encode_rgb_png, write_rgb_png
from pctpu_torch.ops.render import Layer, render_snapshot, segment_points


def render(layers, **kw):
    return render_snapshot(layers, device="cpu", **kw)


def _scene(seed: int, n: int = 3000, nan: bool = False, view: str = "top"):
    """Three layers of random points (one masked in part, one a sampled
    line run), as numpy; with ``nan``, NaN depths in the first (the depth
    range carries them) and NaN coordinates on masked points of the second."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    b = (a[: n // 2] + rng.normal(0, 0.5, (n // 2, 3))).astype(np.float32)
    m = rng.random(n // 2) > 0.2
    line = segment_points(rng.uniform(-30, 30, (5, 3)), rng.uniform(-30, 30, (5, 3)))
    if nan:
        a[::97, 2 if view == "top" else 1] = np.nan
        b[~m, 0] = np.nan
    return [(a, (255, 0, 0), None), (b, (0, 255, 0), m), (line, (250, 250, 250), None)]


@pytest.mark.parametrize("case", [
    dict(seed=0, view="top", point_size=2),
    dict(seed=1, view="front", point_size=2),
    dict(seed=2, view="top", point_size=1, img_size=257),
    dict(seed=3, view="front", point_size=3, img_size=300, background=(13, 13, 13)),
    dict(seed=4, view="top", point_size=2, extent=(-20.0, 25.5, -18.25, 30.0)),
    dict(seed=5, view="top", point_size=2, nan=True),
    dict(seed=6, view="front", point_size=2, nan=True),
    dict(seed=7, view="top", point_size=2, pad_frac=0.0, n=50),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_render_bit_equal_to_pctpu(case):
    """The whole image equals pctpu's on the same layers: projection,
    culling, depth quantisation, z-buffer and palette."""
    case = dict(case)
    scene = _scene(case.pop("seed"), case.pop("n", 3000), case.pop("nan", False), case["view"])
    want = jrender([JLayer(x, c, mask=m) for x, c, m in scene], **case)
    got = render([Layer(x, c, mask=m) for x, c, m in scene], **case)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 1


def test_segment_points_equal_to_pctpu():
    rng = np.random.default_rng(4)
    p0, p1 = rng.uniform(-300, 300, (12, 3)), rng.uniform(-300, 300, (12, 3))
    p1[3] = p0[3]  # a zero-length segment: two samples
    got, want = segment_points(p0, p1), jsegment_points(p0, p1)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert segment_points(np.zeros((0, 3)), np.zeros((0, 3))).shape == (0, 3)


def test_rgb_png_round_trip():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    assert np.array_equal(decode_rgb_png(encode_rgb_png(img)), img)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_rgb_png_bytes_equal_to_pctpu(level, tmp_path):
    rng = np.random.default_rng(level)
    img = np.where(rng.random((40, 61, 1)) < 0.3, rng.integers(0, 256, (40, 61, 3)), 13)
    img = img.astype(np.uint8)
    write_rgb_png(str(tmp_path / "a.png"), img, level)
    assert (tmp_path / "a.png").read_bytes() == jencode_rgb(img, level)
    assert np.array_equal(decode_rgb_png(jencode_rgb(img, level)), img)
    with pytest.raises(ValueError):
        encode_rgb_png(img[..., 0])


def test_rgb_png_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    data = np.frombuffer(encode_rgb_png(img), np.uint8)
    decoded = cv2.imdecode(data, cv2.IMREAD_COLOR)  # BGR
    assert np.array_equal(decoded[:, :, ::-1], img)


def test_render_single_point_position():
    # one point at the center of a known extent lands mid-image
    img = render(
        [Layer(np.array([[0.0, 0.0, 1.0]]), (255, 0, 0))],
        img_size=64, extent=(-10, 10, -10, 10), point_size=2,
        background=(0, 0, 0),
    )
    assert img.shape == (64, 64, 3)
    ys, xs = np.nonzero(img[:, :, 0])
    assert len(ys) == 4  # 2x2 splat
    assert abs(xs.mean() - 31.5) < 2 and abs(ys.mean() - 31.5) < 2


def test_render_v_axis_points_up():
    # +y in top view must appear in the UPPER half of the image (low rows)
    img = render(
        [Layer(np.array([[0.0, 8.0, 0.0]]), (0, 255, 0))],
        img_size=64, extent=(-10, 10, -10, 10), background=(0, 0, 0),
    )
    ys, _ = np.nonzero(img[:, :, 1])
    assert ys.max() < 32


def test_render_depth_order_top_view():
    # same (x, y), different z: the higher point's layer must win
    low = Layer(np.array([[1.0, 1.0, 0.0]]), (255, 0, 0))
    high = Layer(np.array([[1.0, 1.0, 5.0]]), (0, 0, 255))
    img = render([low, high], img_size=32, extent=(-5, 5, -5, 5), background=(0, 0, 0))
    assert (img[:, :, 2] > 0).any() and not (img[:, :, 0] > 0).any()
    # and symmetrically with layers swapped
    img2 = render([high, low], img_size=32, extent=(-5, 5, -5, 5), background=(0, 0, 0))
    assert (img2[:, :, 2] > 0).any() and not (img2[:, :, 0] > 0).any()


def test_render_equal_depth_later_layer_wins():
    a = Layer(np.array([[0.0, 0.0, 1.0]]), (255, 0, 0))
    b = Layer(np.array([[0.0, 0.0, 1.0]]), (0, 255, 0))
    img = render([a, b], img_size=32, extent=(-5, 5, -5, 5), background=(0, 0, 0))
    assert (img[:, :, 1] > 0).any() and not (img[:, :, 0] > 0).any()


def test_render_front_view_uses_xz():
    # front view: u=x, v=z; point with big z should be near the top
    img = render(
        [Layer(np.array([[0.0, 0.0, 9.0]]), (255, 255, 255))],
        img_size=64, view="front", extent=(-10, 10, -10, 10),
        background=(0, 0, 0),
    )
    ys, _ = np.nonzero(img[:, :, 0])
    assert ys.max() < 16


def test_render_masked_points_hidden():
    img = render(
        [Layer(np.array([[0.0, 0.0, 0.0]]), (255, 0, 0), mask=np.array([False]))],
        img_size=32, extent=(-5, 5, -5, 5), background=(7, 9, 11),
    )
    assert np.array_equal(np.unique(img.reshape(-1, 3), axis=0), [[7, 9, 11]])


def test_render_all_layers_empty_returns_background():
    img = render(
        [Layer(np.zeros((0, 3), np.float32), (255, 0, 0))],
        img_size=16, background=(5, 6, 7),
    )
    assert np.array_equal(np.unique(img.reshape(-1, 3), axis=0), [[5, 6, 7]])


def test_render_out_of_extent_points_culled():
    # a far-away point must be culled, not clamped onto the border
    inside = Layer(np.array([[4.9, 0.0, 0.0]]), (0, 255, 0))
    outside = Layer(np.array([[100.0, 100.0, 50.0]]), (255, 0, 0))
    img = render([inside, outside], img_size=32, extent=(-5, 5, -5, 5), background=(0, 0, 0))
    assert not (img[:, :, 0] > 0).any()  # red never drawn
    assert (img[:, :, 1] > 0).any()


def test_render_unknown_view_rejected():
    with pytest.raises(ValueError):
        render([Layer(np.zeros((1, 3)), (1, 2, 3))], view="side")


def test_segment_points_endpoints_and_density():
    pts = segment_points(np.array([[0.0, 0.0, 0.0]]), np.array([[10.0, 0.0, 0.0]]))
    assert pts.shape[0] >= 2
    np.testing.assert_allclose(pts[0], [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(pts[-1], [10, 0, 0], atol=1e-5)
    assert np.all(np.diff(pts[:, 0]) > 0)


# --- the HTML viewer ---------------------------------------------------------


def _read_scene(path):
    doc = open(path, encoding="utf-8").read()
    start = doc.index('<script id="scene" type="application/json">')
    start = doc.index(">", start) + 1
    end = doc.index("</script>", start)
    return json.loads(doc[start:end].replace("<\\/", "</")), doc


def _session_args(name: str):
    rng = np.random.default_rng(len(name))
    xyz = rng.normal(size=(53, 3)).astype(np.float32)
    mask = np.ones(53, bool)
    mask[::7] = False
    if name == "write_cloud_manip_html":
        return (xyz, mask, xyz + np.float32(1.5), mask)
    if name == "write_top_part_html":
        ok = np.ones(53, bool)
        ok[30] = False
        return (xyz, mask, rng.normal(size=(53, 3)).astype(np.float32), ok)
    v = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    return (xyz, mask, np.array([1.0, -2.0, 3.0], np.float32), v)


@pytest.mark.parametrize("name", ["write_cloud_manip_html", "write_top_part_html",
                                  "write_pca_test_html", "write_html_viewer"])
def test_html_bytes_equal_to_pctpu(name, tmp_path):
    """Each session builder (and the generic writer with viewports, masks,
    lines and an escaped title) writes pctpu's file byte for byte."""
    a, b = str(tmp_path / "pctpu.html"), str(tmp_path / "port.html")
    if name == "write_html_viewer":
        pts = np.random.default_rng(9).uniform(-100, 100, (64, 3)).astype(np.float32)
        mask = np.arange(64) % 5 != 0

        def layers(mod):
            return ([mod.ViewLayer("p", pts, (1, 2, 3), mask=mask, point_size=3.0),
                     mod.ViewLayer("l", pts, (4, 5, 6), lines=True, mask=mask,
                                   rect=(0.0, 0.0, 0.5, 1.0))],
                    [mod.ViewportSpec(rect=(0.0, 0.0, 0.5, 1.0), axes_size=2.5),
                     mod.ViewportSpec(rect=(0.5, 0.0, 1.0, 1.0), background=(1.0, 1.0, 1.0))])

        jhtml.write_html_viewer(a, *layers(jhtml), title="T </script> & <x>")
        html.write_html_viewer(b, *layers(html), title="T </script> & <x>")
    else:
        getattr(jhtml, name)(a, *_session_args(name))
        getattr(html, name)(b, *_session_args(name))
    assert open(a, "rb").read() == open(b, "rb").read()


def test_embedded_points_bit_exact(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-100, 100, (513, 3)).astype(np.float32)
    out = str(tmp_path / "v.html")
    html.write_html_viewer(out, [html.ViewLayer("cloud", pts, (255, 0, 0))])
    back = html.read_back_layers(out)
    assert back["cloud"].tobytes() == pts.astype("<f4").tobytes()


def test_mask_drops_points_and_line_pairs(tmp_path):
    pts = np.arange(18, dtype=np.float32).reshape(6, 3)
    mask = np.array([True, False, True, True, False, True])
    out = str(tmp_path / "v.html")
    html.write_html_viewer(out, [
        html.ViewLayer("p", pts, (1, 2, 3), mask=mask),
        # pairs (0,1) and (4,5) each have a masked endpoint -> dropped
        html.ViewLayer("l", pts, (4, 5, 6), lines=True, mask=mask),
    ])
    back = html.read_back_layers(out)
    np.testing.assert_array_equal(back["p"], pts[mask])
    np.testing.assert_array_equal(back["l"], pts[2:4])


def test_odd_line_layer_rejected(tmp_path):
    with pytest.raises(ValueError):
        html.write_html_viewer(
            str(tmp_path / "v.html"),
            [html.ViewLayer("l", np.zeros((3, 3), np.float32), (0, 0, 0), lines=True)],
        )


def test_axes_and_viewports_in_scene(tmp_path):
    out = str(tmp_path / "v.html")
    html.write_html_viewer(
        out,
        [html.ViewLayer("c", np.zeros((1, 3), np.float32), (9, 9, 9))],
        [html.ViewportSpec(background=(0.05, 0.05, 0.05), axes_size=1.0)],
        title="Mip Viewer </script> safe & <escaped>",
    )
    scene, doc = _read_scene(out)
    assert scene["viewports"] == [{"rect": [0.0, 0.0, 1.0, 1.0], "background": [0.05, 0.05, 0.05]}]
    by_name = {l["name"]: l for l in scene["layers"]}
    # addCoordinateSystem: x red, y green, z blue, length = axes_size
    assert by_name["axis_x"]["color"] == [255, 0, 0]
    assert by_name["axis_y"]["color"] == [0, 255, 0]
    assert by_name["axis_z"]["color"] == [0, 0, 255]
    ax = np.frombuffer(base64.b64decode(by_name["axis_z"]["data"]), "<f4")
    np.testing.assert_array_equal(ax, [0, 0, 0, 0, 0, 1])
    # the raw "</script>" in the title must not terminate any script block
    assert doc.count("</script>") == 2  # scene json + viewer script only
    # self-contained: no external fetches
    assert "http://" not in doc and "https://" not in doc


def test_cloud_manip_session_matches_reference_constants(tmp_path):
    # CloudManip.cpp:143-158: input red, output green, 0.05 bg, 1 m axes
    rng = np.random.default_rng(0)
    xin = rng.normal(size=(40, 3)).astype(np.float32)
    m = np.ones(40, bool)
    m[::7] = False
    out = str(tmp_path / "m.html")
    html.write_cloud_manip_html(out, xin, m, xin + np.float32(1.5), m)
    scene, _ = _read_scene(out)
    by_name = {l["name"]: l for l in scene["layers"]}
    assert by_name["cloud_input"]["color"] == [255, 0, 0]
    assert by_name["cloud_output"]["color"] == [0, 255, 0]
    assert by_name["cloud_input"]["point_size"] == 2.0
    assert scene["viewports"][0]["background"] == [0.05, 0.05, 0.05]
    assert "axis_x" in by_name  # addCoordinateSystem(1.0)
    np.testing.assert_array_equal(html.read_back_layers(out)["cloud_input"], xin[m])


def test_top_part_session_whisker_geometry(tmp_path):
    # TopPartRegistration.cpp:375: every 10th point, whisker length 2
    n = 53
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[20] = False  # masked point on an every-10th index
    n_ok = np.ones(n, bool)
    n_ok[30] = False  # failed normal on an every-10th index
    out = str(tmp_path / "t.html")
    html.write_top_part_html(out, pts, mask, normals, n_ok)
    scene, _ = _read_scene(out)
    by_name = {l["name"]: l for l in scene["layers"]}
    assert by_name["original_cloud"]["color"] == [255, 0, 0]
    assert by_name["normals"]["color"] == [255, 255, 255]
    assert by_name["normals"]["lines"] is True
    assert scene["viewports"][0]["background"] == [0.0, 0.0, 0.0]
    sel = mask & n_ok & (np.arange(n) % 10 == 0)  # indices 0, 10, 40, 50
    assert sel.sum() == 4
    seg = html.read_back_layers(out)["normals"]
    np.testing.assert_array_equal(seg[0::2], pts[sel])
    np.testing.assert_array_equal(seg[1::2], pts[sel] + np.float32(2.0) * normals[sel])


def test_pca_session_arrow_tips(tmp_path):
    # main.cpp:100-128: tips = centroid + 200 * eigvec col, colors b/g/r
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(30, 3)).astype(np.float32)
    c = np.array([1.0, -2.0, 3.0], np.float32)
    v = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    out = str(tmp_path / "p.html")
    html.write_pca_test_html(out, xyz, np.ones(30, bool), c, v)
    scene, _ = _read_scene(out)
    by_name = {l["name"]: l for l in scene["layers"]}
    assert by_name["arrow_z"]["color"] == [0, 0, 255]
    assert by_name["arrow_y"]["color"] == [0, 255, 0]
    assert by_name["arrow_x"]["color"] == [255, 0, 0]
    assert scene["viewports"][0]["background"] == [1.0, 1.0, 1.0]
    back = html.read_back_layers(out)
    for i, name in enumerate(["arrow_z", "arrow_y", "arrow_x"]):
        np.testing.assert_array_equal(back[name][0], c)
        np.testing.assert_array_equal(back[name][1], c + np.float32(200.0) * v[:, i])
    # addCoordinateSystem(100)
    np.testing.assert_array_equal(back["axis_x"][1], [100, 0, 0])


def test_axes_layers_equal_to_pctpu():
    for got, want in zip(html.axes_layers(2.5, (0.0, 0.5, 1.0, 1.0)),
                         jhtml.axes_layers(2.5, (0.0, 0.5, 1.0, 1.0))):
        assert (got.name, got.color, got.lines, got.rect) == (want.name, want.color, want.lines,
                                                               want.rect)
        assert np.array_equal(got.points, want.points)


def _strip_js_literals(src: str) -> str:
    """Remove string/template literals and comments so delimiter counting
    sees only code structure (no JS engine exists in this image)."""
    out = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in "'\"`":
            q = c
            i += 1
            while i < n and src[i] != q:
                i += 2 if src[i] == "\\" else 1
            i += 1
        elif src.startswith("//", i):
            i = src.find("\n", i)
            i = n if i < 0 else i
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            i = n if j < 0 else j + 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def test_inline_script_structurally_sound(tmp_path):
    out = str(tmp_path / "v.html")
    html.write_html_viewer(out, [html.ViewLayer("c", np.zeros((2, 3), np.float32), (1, 1, 1))])
    doc = open(out, encoding="utf-8").read()
    start = doc.index("<script>") + len("<script>")
    raw = doc[doc.index('"use strict"', start):doc.rindex("</script>")]
    js = _strip_js_literals(raw)
    for o, c in ["{}", "()", "[]"]:
        assert js.count(o) == js.count(c), f"unbalanced {o}{c}"
    for name in ["decode", "draw", "resetCam", "lookAt", "persp", "mat4mul", "frame"]:
        assert f"function {name}" in js
    for key in ['"r"', '"+"', '"-"']:
        assert key in raw
    for ev in ["mousedown", "mousemove", "mouseup", "wheel", "keydown"]:
        assert ev in raw
