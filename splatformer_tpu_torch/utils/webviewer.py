"""Self-contained interactive point-cloud viewer, one HTML file (port of
splatformer_tpu/utils/webviewer.py; numpy only, the same HTML for the same
clouds).

Vanilla WebGL2 with orbit, zoom and pan, per-cloud visibility toggles, a
point-size slider and the point data embedded as base64: it opens in any
browser with no server and no network (the reference's pyviz3d/three.js
export needs a CDN at view time).
"""
from __future__ import annotations

import base64
import json
import os
from typing import Dict, Tuple

import numpy as np

_HTML = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{title}</title><style>
body {{ margin:0; background:#111; color:#ddd; font:13px sans-serif;
       overflow:hidden }}
#ui {{ position:fixed; top:8px; left:8px; background:rgba(20,20,20,.85);
      padding:10px 12px; border-radius:6px; max-height:92vh;
      overflow-y:auto; z-index:2 }}
#ui label {{ display:block; margin:2px 0; cursor:pointer }}
#ui input[type=range] {{ width:120px; vertical-align:middle }}
canvas {{ display:block }}
.sw {{ display:inline-block; width:10px; height:10px; margin-right:6px;
      border-radius:2px }}
</style></head><body>
<div id="ui"><b>{title}</b><br>
<label>point size <input id="psize" type="range" min="1" max="12"
 step="0.5" value="3"></label>
<div id="clouds"></div>
<small>drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</small>
</div>
<canvas id="c"></canvas>
<script>
const DATA = {data_json};
function decode(b64, T) {{
  const s = atob(b64); const u = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) u[i] = s.charCodeAt(i);
  return new T(u.buffer);
}}
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl2');
const vsrc = `#version 300 es
layout(location=0) in vec3 pos; layout(location=1) in vec3 col;
uniform mat4 mvp; uniform float psize; out vec3 vcol;
void main() {{ gl_Position = mvp * vec4(pos, 1.0);
  gl_PointSize = psize * clamp(4.0 / gl_Position.w, 0.3, 4.0);
  vcol = col; }}`;
const fsrc = `#version 300 es
precision mediump float; in vec3 vcol; out vec4 frag;
void main() {{
  vec2 d = gl_PointCoord - vec2(0.5);
  if (dot(d, d) > 0.25) discard;
  frag = vec4(vcol, 1.0); }}`;
function shader(type, src) {{
  const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s; }}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vsrc));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fsrc));
gl.linkProgram(prog); gl.useProgram(prog);
const uMvp = gl.getUniformLocation(prog, 'mvp');
const uPs = gl.getUniformLocation(prog, 'psize');

// upload clouds; compute global center/extent for the initial camera
let lo = [1e9,1e9,1e9], hi = [-1e9,-1e9,-1e9];
const clouds = DATA.map(d => {{
  const pos = decode(d.pos, Float32Array);
  const col = decode(d.col, Uint8Array);
  for (let i = 0; i < pos.length; i += 3) for (let k = 0; k < 3; k++) {{
    lo[k] = Math.min(lo[k], pos[i+k]); hi[k] = Math.max(hi[k], pos[i+k]); }}
  const vao = gl.createVertexArray(); gl.bindVertexArray(vao);
  const pb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, pb);
  gl.bufferData(gl.ARRAY_BUFFER, pos, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(0);
  gl.vertexAttribPointer(0, 3, gl.FLOAT, false, 0, 0);
  const cb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, cb);
  gl.bufferData(gl.ARRAY_BUFFER, col, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(1);
  gl.vertexAttribPointer(1, 3, gl.UNSIGNED_BYTE, true, 0, 0);
  return {{ name: d.name, n: pos.length / 3, vao, visible: d.on }}; }});
const ctr = [0,1,2].map(k => 0.5 * (lo[k] + hi[k]));
const ext = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2], 1e-6);

// UI
const cdiv = document.getElementById('clouds');
const palette = ['#7ad','#da7','#7d8','#d7c','#cc6','#6cc','#c66','#999'];
clouds.forEach((c, i) => {{
  const l = document.createElement('label');
  const sw = `<span class="sw" style="background:${{palette[i%8]}}"></span>`;
  l.innerHTML = `<input type="checkbox" ${{c.visible ? 'checked' : ''}}>` +
                sw + `${{c.name}} <small>(${{c.n.toLocaleString()}})</small>`;
  l.firstChild.onchange = e => {{ c.visible = e.target.checked; }};
  cdiv.appendChild(l); }});

// orbit camera
let az = 0.6, el = 0.35, dist = 2.2 * ext, panx = 0, pany = 0;
let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
window.onmouseup = () => drag = null;
window.onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panx -= dx * dist * 0.001; pany += dy * dist * 0.001; }}
  else {{ az += dx * 0.008;
          el = Math.max(-1.55, Math.min(1.55, el + dy * 0.008)); }}
  drag = [e.clientX, e.clientY, drag[2]]; }};
canvas.onwheel = e => {{
  e.preventDefault(); dist *= Math.exp(e.deltaY * 0.001); }};

function mat(az, el, dist) {{
  const aspect = canvas.width / canvas.height;
  const f = 1.8, n = 0.01 * ext, fpl = 100 * ext;
  const ca = Math.cos(az), sa = Math.sin(az);
  const ce = Math.cos(el), se = Math.sin(el);
  const eye = [ctr[0] + dist*ce*sa, ctr[1] + dist*se, ctr[2] + dist*ce*ca];
  const fwd = [0,1,2].map(k => ctr[k] - eye[k]);
  const fl = Math.hypot(...fwd); fwd.forEach((v,k) => fwd[k] = v/fl);
  let r = [fwd[2], 0, -fwd[0]];
  const rl = Math.hypot(...r) || 1; r = r.map(v => v/rl);
  const up = [r[1]*fwd[2]-r[2]*fwd[1], r[2]*fwd[0]-r[0]*fwd[2],
              r[0]*fwd[1]-r[1]*fwd[0]];
  const ex = eye[0] + r[0]*panx + up[0]*pany,
        ey = eye[1] + r[1]*panx + up[1]*pany,
        ez = eye[2] + r[2]*panx + up[2]*pany;
  const tx = -(r[0]*ex + r[1]*ey + r[2]*ez);
  const ty = -(up[0]*ex + up[1]*ey + up[2]*ez);
  const tz =  (fwd[0]*ex + fwd[1]*ey + fwd[2]*ez);
  // column-major view then projection
  const v = [r[0],up[0],-fwd[0],0, r[1],up[1],-fwd[1],0,
             r[2],up[2],-fwd[2],0, tx,ty,tz,1];
  const p = [f/aspect,0,0,0, 0,f,0,0,
             0,0,(fpl+n)/(n-fpl),-1, 0,0,2*fpl*n/(n-fpl),0];
  const m = new Float32Array(16);
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++) {{
    let s = 0; for (let k = 0; k < 4; k++) s += p[k*4+j] * v[i*4+k];
    m[i*4+j] = s; }}
  return m; }}

function frame() {{
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.enable(gl.DEPTH_TEST);
  gl.clearColor(0.07, 0.07, 0.08, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uMvp, false, mat(az, el, dist));
  gl.uniform1f(uPs, +document.getElementById('psize').value);
  for (const c of clouds) if (c.visible) {{
    gl.bindVertexArray(c.vao); gl.drawArrays(gl.POINTS, 0, c.n); }}
  requestAnimationFrame(frame); }}
frame();
</script></body></html>"""


def export_interactive_viewer(
    path: str,
    clouds: Dict[str, Tuple[np.ndarray, np.ndarray]],
    title: str = "splatformer_tpu viewer",
    max_points: int = 200_000,
    visible: Tuple[str, ...] = (),
) -> str:
    """Write a standalone HTML viewer. ``clouds`` maps name -> (coords
    (N, 3) float, colors (N, 3) uint8 or float in [0, 1]). Clouds larger
    than ``max_points`` are uniformly subsampled (keeps the file portable).
    ``visible`` names start enabled (default: first cloud only)."""
    items = []
    names = list(clouds)
    on_names = set(visible) if visible else {names[0]} if names else set()
    for name, (coords, colors) in clouds.items():
        coords = np.asarray(coords, np.float32).reshape(-1, 3)
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0.0, 1.0) * 255).astype(np.uint8)
        colors = colors.reshape(-1, 3)
        if len(coords) > max_points:
            idx = np.linspace(0, len(coords) - 1, max_points, dtype=int)
            coords, colors = coords[idx], colors[idx]
        items.append({
            "name": name,
            "on": name in on_names,
            "pos": base64.b64encode(coords.tobytes()).decode(),
            "col": base64.b64encode(colors.tobytes()).decode(),
        })
    html = _HTML.format(title=title, data_json=json.dumps(items))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
