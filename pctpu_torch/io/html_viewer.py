"""Standalone interactive HTML viewer — the browser-based replacement for
the reference's interactive PCLVisualizer sessions (carried over whole from
``pctpu/io/html_viewer.py``: host numpy and text, byte-equal output).

The reference opens three live spin-loop viewers (the six-viewport layout
in TopPartRegistration.cpp:391-455 is commented out):

  * cloud_manip: input cloud red, transformed cloud green, point size 2,
    1 m coordinate axes, dark-gray 0.05 background
    (reference/CloudManip.cpp:143-158);
  * top_part_registration: flat source cloud red, point size 2, black
    background, every-10th-point normal whiskers of length 2
    (reference/TopPartRegistration.cpp:367-388);
  * pointcloud_pca_test: filtered cloud red, three principal-axis arrows
    (eigvec x 200 from the centroid, colored blue/green/red), 100 m axes,
    white background (reference/main.cpp:100-135).

A VTK window cannot open on a headless machine, so the same scene goes to
ONE self-contained .html file: point/line data embedded as base64 float32,
rendered by an inline vanilla-WebGL orbit viewer (no network, no external
JS).  Controls mirror PCLVisualizer's: left-drag rotate, right-/shift-drag
pan, wheel zoom, ``r`` reset camera, ``+``/``-`` point size.
Multi-viewport scenes (PCL ``createViewPort``) are supported via per-layer
normalized rects sharing one camera, matching PCL's coupled camera default.
The title of the page stays pctpu's, so the files are byte-equal.
"""

from __future__ import annotations

import base64
import html as _html
import json
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ViewLayer:
    """One addPointCloud/addPointCloudNormals equivalent.

    ``points``: (N, 3) float32.  For ``lines=True`` the rows are consecutive
    segment endpoint pairs (2k, 3) rendered as GL_LINES (normal whiskers,
    arrows, axes).  ``mask``: optional (N,) bool — invalid rows are dropped
    host-side before embedding (for lines, a pair is dropped when either
    endpoint is masked).
    """

    name: str
    points: np.ndarray
    color: tuple[int, int, int]
    point_size: float = 2.0
    lines: bool = False
    mask: np.ndarray | None = None
    rect: tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)


@dataclass(frozen=True)
class ViewportSpec:
    """Background + optional coordinate axes for one normalized rect."""

    rect: tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    background: tuple[float, float, float] = (0.0, 0.0, 0.0)
    axes_size: float = 0.0


def _clean_points(layer: ViewLayer) -> np.ndarray:
    pts = np.asarray(layer.points, np.float32).reshape(-1, 3)
    if layer.mask is not None:
        m = np.asarray(layer.mask, bool).reshape(-1)
        if layer.lines:
            pair = m.reshape(-1, 2).all(axis=1)
            pts = pts.reshape(-1, 2, 3)[pair].reshape(-1, 3)
        else:
            pts = pts[m]
    if layer.lines and pts.shape[0] % 2:
        raise ValueError(f"lines layer {layer.name!r} needs endpoint pairs")
    return np.ascontiguousarray(pts, np.float32)


def axes_layers(
    size: float, rect: tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
) -> list[ViewLayer]:
    """PCLVisualizer::addCoordinateSystem(size): x red, y green, z blue."""
    o = np.zeros(3, np.float32)
    tips = np.eye(3, dtype=np.float32) * np.float32(size)
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]
    return [
        ViewLayer(
            name=f"axis_{ax}",
            points=np.stack([o, tips[i]]),
            color=colors[i],
            lines=True,
            rect=rect,
        )
        for i, ax in enumerate("xyz")
    ]


_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>
  html, body { margin:0; height:100%; overflow:hidden; background:#000; }
  canvas { width:100vw; height:100vh; display:block; }
  #hud { position:fixed; left:8px; bottom:8px; color:#9a9a9a;
         font:12px monospace; user-select:none; pointer-events:none; }
</style>
</head>
<body>
<canvas id="gl"></canvas>
<div id="hud">drag rotate &middot; shift/right-drag pan &middot; wheel zoom
 &middot; r reset &middot; +/- point size</div>
<script id="scene" type="application/json">__SCENE_JSON__</script>
<script>
"use strict";
const scene = JSON.parse(document.getElementById("scene").textContent);
function decode(b64) {
  const s = atob(b64), u = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) u[i] = s.charCodeAt(i);
  return new Float32Array(u.buffer);
}
const canvas = document.getElementById("gl");
const gl = canvas.getContext("webgl", {antialias: true});
if (!gl) {
  document.getElementById("hud").textContent =
    "WebGL is unavailable in this browser/context - cannot render the scene.";
  throw new Error("WebGL context creation failed");
}
const VS = `
  attribute vec3 pos;
  uniform mat4 mvp;
  uniform float psize;
  void main() { gl_Position = mvp * vec4(pos, 1.0); gl_PointSize = psize; }`;
const FS = `
  precision mediump float;
  uniform vec3 color;
  void main() { gl_FragColor = vec4(color, 1.0); }`;
function shader(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const locPos = gl.getAttribLocation(prog, "pos");
const locMvp = gl.getUniformLocation(prog, "mvp");
const locColor = gl.getUniformLocation(prog, "color");
const locPsize = gl.getUniformLocation(prog, "psize");
gl.enableVertexAttribArray(locPos);
gl.enable(gl.DEPTH_TEST);

// upload layers; scene bbox over point (non-line) layers sets the camera
// (falls back to line layers when every point layer is empty, so
// arrows-only scenes still frame correctly)
const lo = [1e30, 1e30, 1e30], hi = [-1e30, -1e30, -1e30];
const llo = [1e30, 1e30, 1e30], lhi = [-1e30, -1e30, -1e30];
const layers = scene.layers.map(l => {
  const data = decode(l.data);
  const blo = l.lines ? llo : lo, bhi = l.lines ? lhi : hi;
  for (let i = 0; i < data.length; i += 3)
    for (let k = 0; k < 3; k++) {
      if (data[i + k] < blo[k]) blo[k] = data[i + k];
      if (data[i + k] > bhi[k]) bhi[k] = data[i + k];
    }
  const buf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW);
  return {buf: buf, n: data.length / 3, color: l.color, lines: l.lines,
          psize: l.point_size, rect: l.rect};
});
if (lo[0] > hi[0])
  for (let k = 0; k < 3; k++) { lo[k] = llo[k]; hi[k] = lhi[k]; }
if (lo[0] > hi[0]) { lo.fill(-1); hi.fill(1); }
const center0 = [(lo[0]+hi[0])/2, (lo[1]+hi[1])/2, (lo[2]+hi[2])/2];
const radius = Math.max(1e-3, Math.hypot(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) / 2);

// orbit state (PCL-ish: start above and behind, looking at the centroid)
let az, el, dist, center, psizeScale;
function resetCam() {
  az = -Math.PI / 4; el = Math.PI / 5; dist = radius * 2.5;
  center = center0.slice(); psizeScale = 1.0;
}
resetCam();

function mat4mul(a, b) {
  const o = new Float32Array(16);
  for (let c = 0; c < 4; c++)
    for (let r = 0; r < 4; r++) {
      let s = 0;
      for (let k = 0; k < 4; k++) s += a[k*4+r] * b[c*4+k];
      o[c*4+r] = s;
    }
  return o;
}
function lookAt(eye, at, up) {
  const z = norm3(sub3(eye, at)), x = norm3(cross3(up, z)), y = cross3(z, x);
  return new Float32Array([
    x[0], y[0], z[0], 0,  x[1], y[1], z[1], 0,  x[2], y[2], z[2], 0,
    -dot3(x, eye), -dot3(y, eye), -dot3(z, eye), 1]);
}
function persp(fovy, aspect, near, far) {
  const f = 1 / Math.tan(fovy / 2), nf = 1 / (near - far);
  return new Float32Array([
    f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1, 0,0,2*far*near*nf,0]);
}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;return [a[0]/l,a[1]/l,a[2]/l];}

function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) { canvas.width = w; canvas.height = h; }
  const eye = [
    center[0] + dist * Math.cos(el) * Math.cos(az),
    center[1] + dist * Math.cos(el) * Math.sin(az),
    center[2] + dist * Math.sin(el)];
  const view = lookAt(eye, center, [0, 0, 1]);
  gl.enable(gl.SCISSOR_TEST);
  for (const vp of scene.viewports) {
    const x = Math.round(vp.rect[0] * w), y = Math.round(vp.rect[1] * h);
    const vw = Math.max(1, Math.round((vp.rect[2] - vp.rect[0]) * w));
    const vh = Math.max(1, Math.round((vp.rect[3] - vp.rect[1]) * h));
    gl.viewport(x, y, vw, vh); gl.scissor(x, y, vw, vh);
    gl.clearColor(vp.background[0], vp.background[1], vp.background[2], 1);
    gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
    const proj = persp(Math.PI / 6, vw / vh, radius * 1e-3, dist + radius * 8);
    const mvp = mat4mul(proj, view);
    gl.uniformMatrix4fv(locMvp, false, mvp);
    for (const l of layers) {
      if (l.rect[0] !== vp.rect[0] || l.rect[1] !== vp.rect[1] ||
          l.rect[2] !== vp.rect[2] || l.rect[3] !== vp.rect[3]) continue;
      gl.bindBuffer(gl.ARRAY_BUFFER, l.buf);
      gl.vertexAttribPointer(locPos, 3, gl.FLOAT, false, 0, 0);
      gl.uniform3f(locColor, l.color[0]/255, l.color[1]/255, l.color[2]/255);
      gl.uniform1f(locPsize, l.psize * psizeScale);
      gl.drawArrays(l.lines ? gl.LINES : gl.POINTS, 0, l.n);
    }
  }
  gl.disable(gl.SCISSOR_TEST);
}
function frame() { draw(); requestAnimationFrame(frame); }

let drag = null;
canvas.addEventListener("mousedown", e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2};
});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {
    const s = dist * 0.0015;
    const rx = [-Math.sin(az), Math.cos(az), 0];
    const upw = [-Math.sin(el)*Math.cos(az), -Math.sin(el)*Math.sin(az), Math.cos(el)];
    for (let k = 0; k < 3; k++) center[k] += (-dx * rx[k] + dy * upw[k]) * s;
  } else {
    az -= dx * 0.006;
    el = Math.min(1.55, Math.max(-1.55, el + dy * 0.006));
  }
});
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.0012);
  dist = Math.min(radius * 100, Math.max(radius * 0.01, dist));
}, {passive: false});
canvas.addEventListener("contextmenu", e => e.preventDefault());
window.addEventListener("keydown", e => {
  if (e.key === "r") resetCam();
  else if (e.key === "+" || e.key === "=") psizeScale *= 1.25;
  else if (e.key === "-") psizeScale = Math.max(0.2, psizeScale / 1.25);
});
frame();
</script>
</body>
</html>
"""


def write_html_viewer(
    path: str,
    layers: list[ViewLayer],
    viewports: list[ViewportSpec] | None = None,
    title: str = "pctpu viewer",
) -> None:
    """Write one self-contained interactive viewer .html.

    Layer float32 xyz data is embedded base64 little-endian, bit-exact
    (tests decode it back and compare bytes).  ``viewports`` defaults to a
    single full-window black viewport; per-viewport axes become line
    layers (``axes_layers``).
    """
    if viewports is None:
        viewports = [ViewportSpec()]
    all_layers = list(layers)
    for vp in viewports:
        if vp.axes_size > 0.0:
            all_layers.extend(axes_layers(vp.axes_size, vp.rect))
    scene = {
        "layers": [
            {
                "name": l.name,
                "data": base64.b64encode(
                    _clean_points(l).astype("<f4").tobytes()
                ).decode("ascii"),
                "color": list(l.color),
                "point_size": float(l.point_size),
                "lines": bool(l.lines),
                "rect": list(l.rect),
            }
            for l in all_layers
        ],
        "viewports": [
            {"rect": list(vp.rect), "background": list(vp.background)}
            for vp in viewports
        ],
    }
    # </script>-safe: JSON never contains "</" unescaped
    scene_json = json.dumps(scene, separators=(",", ":")).replace("</", "<\\/")
    doc = _HTML_TEMPLATE.replace("__TITLE__", _html.escape(title)).replace(
        "__SCENE_JSON__", scene_json
    )
    with open(path, "w", encoding="utf-8") as f:
        f.write(doc)


def read_back_layers(path: str) -> dict[str, np.ndarray]:
    """Decode the embedded layer arrays from a written viewer file (tests)."""
    with open(path, encoding="utf-8") as f:
        doc = f.read()
    start = doc.index('<script id="scene" type="application/json">')
    start = doc.index(">", start) + 1
    end = doc.index("</script>", start)
    scene = json.loads(doc[start:end].replace("<\\/", "</"))
    return {
        l["name"]: np.frombuffer(
            base64.b64decode(l["data"]), dtype="<f4"
        ).reshape(-1, 3)
        for l in scene["layers"]
    }


# --- session builders mirroring the reference's three live viewers -------


def write_cloud_manip_html(
    path: str,
    xyz_in: np.ndarray,
    mask_in: np.ndarray,
    xyz_out: np.ndarray,
    mask_out: np.ndarray,
) -> None:
    """CloudManip.cpp:143-158: input red + output green, size 2, 1 m axes,
    0.05 dark-gray background."""
    write_html_viewer(
        path,
        [
            ViewLayer("cloud_input", xyz_in, (255, 0, 0), mask=mask_in),
            ViewLayer("cloud_output", xyz_out, (0, 255, 0), mask=mask_out),
        ],
        [ViewportSpec(background=(0.05, 0.05, 0.05), axes_size=1.0)],
        title="Mip Viewer",
    )


def write_top_part_html(
    path: str,
    pts: np.ndarray,
    mask: np.ndarray,
    normals: np.ndarray,
    normals_ok: np.ndarray,
    every: int = 10,
    length: float = 2.0,
) -> None:
    """TopPartRegistration.cpp:367-388: flat cloud red on black with
    every-``every``-th normal whiskers of ``length`` (PCL level=10 scale=2),
    whiskers white (VTK default when no color property is set)."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    normals = np.asarray(normals, np.float32).reshape(-1, 3)
    sel = (
        np.asarray(mask, bool)
        & np.asarray(normals_ok, bool)
        & (np.arange(pts.shape[0]) % every == 0)
    )
    p0 = pts[sel]
    seg = np.empty((p0.shape[0] * 2, 3), np.float32)
    seg[0::2] = p0
    seg[1::2] = p0 + np.float32(length) * normals[sel]
    write_html_viewer(
        path,
        [
            ViewLayer("original_cloud", pts, (255, 0, 0), mask=mask),
            ViewLayer("normals", seg, (255, 255, 255), lines=True),
        ],
        [ViewportSpec(background=(0.0, 0.0, 0.0))],
        title="3D Viewer",
    )


def write_pca_test_html(
    path: str,
    xyz: np.ndarray,
    keep: np.ndarray,
    centroid: np.ndarray,
    eigvecs: np.ndarray,
) -> None:
    """main.cpp:100-135: filtered cloud red on white, principal-axis arrows
    eigvec x 200 from the centroid colored blue/green/red (ascending
    eigenvalue order, Eigen column convention), 100 m axes.  The reference
    viewer never sets a point-size property on this cloud (main.cpp:119-121),
    so PCL renders it at the VTK default of 1 — matched here."""
    c = np.asarray(centroid, np.float32).reshape(3)
    v = np.asarray(eigvecs, np.float32).reshape(3, 3)
    arrow_colors = [(0, 0, 255), (0, 255, 0), (255, 0, 0)]
    layers = [ViewLayer("cloud", xyz, (255, 0, 0), point_size=1.0, mask=keep)]
    for i, name in enumerate(["arrow_z", "arrow_y", "arrow_x"]):
        tip = c + np.float32(200.0) * v[:, i]
        layers.append(
            ViewLayer(name, np.stack([c, tip]), arrow_colors[i], lines=True)
        )
    write_html_viewer(
        path,
        layers,
        [ViewportSpec(background=(1.0, 1.0, 1.0), axes_size=100.0)],
        title="pointcloud_pca_test",
    )
