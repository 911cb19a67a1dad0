"""Self-contained interactive HTML viewer for registration pairs (own copy
of ``rdmnet_tpu/utils/html_viewer.py``).

The reference's cfg.test.vis pops interactive open3d windows
(reference rdmnet/utils/visualization.py:139-436) — impossible headless.
The PLY exports (utils/visualization.py) cover offline tooling; this module
covers the INTERACTIVE half: one dependency-free .html per pair embedding
the clouds + correspondence lines with a hand-rolled WebGL point renderer
(orbit/zoom/pan, layer toggles). No CDN, no network — the file works from
disk on any machine with a browser.

Point data is embedded as base64 float32 to keep files compact
(~16 bytes/point vs ~40 for JSON text).
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, Optional

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 html,body{{margin:0;height:100%;background:#111;color:#ccc;font:12px sans-serif}}
 #c{{width:100%;height:100%;display:block}}
 #hud{{position:fixed;top:8px;left:8px;background:#000a;padding:8px;border-radius:6px}}
 #hud label{{display:block;cursor:pointer}}
</style></head><body>
<canvas id="c"></canvas><div id="hud"><b>{title}</b><div id="layers"></div>
<div>drag: rotate &middot; wheel: zoom &middot; shift-drag: pan</div></div>
<script>
const LAYERS = {layers_json};
function decode(b64) {{
  const bin = atob(b64); const buf = new Float32Array(bin.length / 4);
  const dv = new DataView(new ArrayBuffer(bin.length));
  for (let i = 0; i < bin.length; i++) dv.setUint8(i, bin.charCodeAt(i));
  for (let i = 0; i < buf.length; i++) buf[i] = dv.getFloat32(i * 4, true);
  return buf;
}}
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl');
const vsSrc = `attribute vec3 p; uniform mat4 mvp; uniform float ps;
 void main() {{ gl_Position = mvp * vec4(p, 1.0); gl_PointSize = ps; }}`;
const fsSrc = `precision mediump float; uniform vec4 col;
 void main() {{ gl_FragColor = col; }}`;
function shader(type, src) {{ const s = gl.createShader(type);
 gl.shaderSource(s, src); gl.compileShader(s); return s; }}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vsSrc));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fsSrc));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog, 'p');
const locMVP = gl.getUniformLocation(prog, 'mvp');
const locCol = gl.getUniformLocation(prog, 'col');
const locPS = gl.getUniformLocation(prog, 'ps');
let center = [0, 0, 0], nSampled = 0, radius = 0;
const objects = [];
for (const L of LAYERS) {{
  const data = decode(L.data);
  const buf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW);
  objects.push({{buf, n: data.length / 3, mode: L.mode, color: L.color,
                ps: L.ps || 1.5, name: L.name, on: true, data}});
  const stride = 3 * Math.max(1, (data.length / 9000 | 0));
  for (let i = 0; i + 2 < data.length; i += stride) {{
    center[0] += data[i]; center[1] += data[i+1]; center[2] += data[i+2];
    nSampled += 1;
  }}
}}
center = center.map(v => v / Math.max(nSampled, 1));
for (const o of objects) {{
  const d = o.data;
  const stride = 3 * Math.max(1, (d.length / 9000 | 0));
  for (let i = 0; i + 2 < d.length; i += stride) {{
    const dx = d[i]-center[0], dy = d[i+1]-center[1], dz = d[i+2]-center[2];
    radius = Math.max(radius, Math.sqrt(dx*dx + dy*dy + dz*dz));
  }}
}}
radius = Math.max(radius, 1e-3);
let yaw = 0.6, pitch = 0.9, dist = radius * 2.2, panX = 0, panY = 0;
function mvp() {{
  // camera = Rx(pitch) @ Rz(yaw) about `center` (z-up LiDAR data), pulled
  // back `dist` along the view axis; column-major mat4 for WebGL
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const r0 = [cy, sy, 0], r1 = [-cp*sy, cp*cy, sp], r2 = [sp*sy, -sp*cy, cp];
  const f = 1.6, asp = canvas.width / canvas.height;
  const near = radius * 0.002, far = radius * 50, nf = 1 / (near - far);
  const t = [
    -(r0[0]*center[0] + r0[1]*center[1] + r0[2]*center[2]) + panX,
    -(r1[0]*center[0] + r1[1]*center[1] + r1[2]*center[2]) + panY,
    -(r2[0]*center[0] + r2[1]*center[1] + r2[2]*center[2]) - dist,
  ];
  const m = new Float32Array(16);
  for (let j = 0; j < 3; j++) {{
    m[j*4 + 0] = (f / asp) * r0[j];
    m[j*4 + 1] = f * r1[j];
    m[j*4 + 2] = (far + near) * nf * r2[j];
    m[j*4 + 3] = -r2[j];
  }}
  m[12] = (f / asp) * t[0];
  m[13] = f * t[1];
  m[14] = (far + near) * nf * t[2] + 2 * far * near * nf;
  m[15] = -t[2];
  return m;
}}
function draw() {{
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.07, 0.07, 0.08, 1); gl.clear(gl.COLOR_BUFFER_BIT);
  gl.uniformMatrix4fv(locMVP, false, mvp());
  for (const o of objects) {{
    if (!o.on) continue;
    gl.bindBuffer(gl.ARRAY_BUFFER, o.buf);
    gl.enableVertexAttribArray(locP);
    gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
    gl.uniform4fv(locCol, o.color); gl.uniform1f(locPS, o.ps);
    gl.drawArrays(o.mode === 'lines' ? gl.LINES : gl.POINTS, 0, o.n);
  }}
}}
const layersDiv = document.getElementById('layers');
objects.forEach((o, i) => {{
  const l = document.createElement('label');
  const cb = document.createElement('input'); cb.type = 'checkbox'; cb.checked = true;
  cb.onchange = () => {{ o.on = cb.checked; draw(); }};
  l.appendChild(cb); l.appendChild(document.createTextNode(' ' + o.name));
  layersDiv.appendChild(l);
}});
let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
window.onmouseup = () => drag = null;
window.onmousemove = e => {{ if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panX += dx * dist * 0.001; panY -= dy * dist * 0.001; }}
  else {{ yaw += dx * 0.005; pitch += dy * 0.005;
          pitch = Math.max(-1.55, Math.min(1.55, pitch)); }}
  drag = [e.clientX, e.clientY, drag[2]]; draw(); }};
canvas.onwheel = e => {{ e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001); draw(); }};
window.onresize = draw;
draw();
</script></body></html>
"""


def _b64(points: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(points, dtype=np.float32).tobytes()
    ).decode("ascii")


def export_pair_html(
    path: str,
    ref_points: np.ndarray,
    src_points_aligned: np.ndarray,
    corr_ref: Optional[np.ndarray] = None,
    corr_src_aligned: Optional[np.ndarray] = None,
    corr_correct: Optional[np.ndarray] = None,
    extra_layers: Optional[Dict[str, np.ndarray]] = None,
    title: str = "registration pair",
    max_points: int = 60000,
) -> str:
    """One self-contained interactive HTML: ref cloud, aligned src cloud,
    green/red correspondence lines (by GT residual, like the reference's
    o3d rendering), optional extra point layers (e.g. NMS survivor nodes).

    ``src_points_aligned`` / ``corr_src_aligned`` should already carry the
    estimated transform so correct matches overlap visually.
    """
    layers = []

    def sub(p):
        if len(p) > max_points:
            idx = np.linspace(0, len(p) - 1, max_points).astype(int)
            return p[idx]
        return p

    layers.append({"name": f"ref ({len(ref_points)})", "mode": "points",
                   "color": [1.0, 0.85, 0.1, 1.0], "data": _b64(sub(ref_points))})
    layers.append({"name": f"src aligned ({len(src_points_aligned)})",
                   "mode": "points", "color": [0.2, 0.55, 1.0, 1.0],
                   "data": _b64(sub(src_points_aligned))})
    if corr_ref is not None and len(corr_ref):
        corr_ref = np.asarray(corr_ref, np.float32)
        corr_src_aligned = np.asarray(corr_src_aligned, np.float32)
        ok = (np.asarray(corr_correct, bool) if corr_correct is not None
              else np.ones(len(corr_ref), bool))
        for mask, name, color in [
            (ok, "correct matches", [0.1, 0.95, 0.2, 1.0]),
            (~ok, "wrong matches", [0.95, 0.15, 0.1, 1.0]),
        ]:
            if mask.any():
                seg = np.empty((mask.sum() * 2, 3), np.float32)
                seg[0::2] = corr_src_aligned[mask]
                seg[1::2] = corr_ref[mask]
                layers.append({"name": f"{name} ({int(mask.sum())})",
                               "mode": "lines", "color": color,
                               "data": _b64(seg)})
    for name, pts in (extra_layers or {}).items():
        if len(pts):
            layers.append({"name": f"{name} ({len(pts)})", "mode": "points",
                           "color": [1.0, 1.0, 1.0, 1.0], "ps": 4.0,
                           "data": _b64(np.asarray(pts, np.float32))})

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    html = _TEMPLATE.format(title=title, layers_json=json.dumps(layers))
    with open(path, "w") as f:
        f.write(html)
    return path
