"""Standalone HTML trajectory renderer — fully offline; the port of
`pobrax_tpu/io/html.py` on the port's `System` and batch-first `QP`.

Equivalent of the `brax.io.html.render(sys, [qp, ...])` surface the
reference's notebooks use for eyeball verification (SURVEY.md §4: ant_gather
nb cell 4, ant_tag nb cell 3). Produces a single self-contained HTML page:
scene geometry + per-frame body poses are embedded as JSON and animated by a
minimal vanilla-WebGL renderer embedded in the page itself — NO network
access is needed to view it (no CDN scripts; brax's html.py by contrast
pulls three.js from a CDN). For the same scene and frames the page is the
JAX renderer's, character for character (tests/test_torch_aux.py).

Frames: a sequence of QPs, one per frame. Each is one env's QP (`pos`
(n, 3)) or a batch of one (`pos` (1, n, 3)), as a rollout of one env's
states carries; to draw env k of a wider batch, pass `qp.pos[k]` and
`qp.rot[k]` in a QP of their own. A wider batch raises.

Viewer controls: drag to orbit, wheel to zoom, shift-drag to pan, space to
play/pause, scrub bar to seek.

Usage:
    from pobrax_tpu_torch.io import html
    page = html.render(env.sys, [state.qp for state in rollout])  # batch of one
    html.save("traj.html", env.sys, qps)
"""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np

from pobrax_tpu_torch.physics import config as pcfg
from pobrax_tpu_torch.physics.system import System


def _geom_json(col: pcfg.Collider) -> dict:
    g = col.geom
    base = {"pos": list(map(float, col.position)),
            "rot": list(map(float, col.rotation))}
    if isinstance(g, pcfg.Sphere):
        return {**base, "type": "sphere", "radius": g.radius}
    if isinstance(g, pcfg.Capsule):
        return {**base, "type": "capsule", "radius": g.radius, "length": g.length}
    if isinstance(g, pcfg.Box):
        return {**base, "type": "box", "halfsize": list(map(float, g.halfsize))}
    if isinstance(g, pcfg.Plane):
        return {**base, "type": "plane"}
    return {**base, "type": "unknown"}


def _scene_json(sys: System) -> dict:
    bodies = []
    for b in sys.config.bodies:
        bodies.append({
            "name": b.name,
            "frozen": bool(b.frozen),
            "colliders": [_geom_json(c) for c in b.colliders],
        })
    return {"bodies": bodies, "dt": sys.config.dt}


def _frames_json(qps: Sequence) -> List[dict]:
    frames = []
    for qp in qps:
        pos, rot = qp.pos, qp.rot
        if pos.dim() == 3:
            if pos.shape[0] != 1:
                raise ValueError(f"a frame is one env's QP or a batch of one, not a batch of "
                                 f"{pos.shape[0]}: slice the env to draw")
            pos, rot = pos[0], rot[0]
        pos = pos.detach().cpu().numpy().astype(np.float32)
        rot = rot.detach().cpu().numpy().astype(np.float32)
        frames.append({
            "pos": np.round(pos, 4).tolist(),
            "rot": np.round(rot, 4).tolist(),
        })
    return frames


_PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<style>
  html, body { margin: 0; height: 100%; overflow: hidden; background: #1a1a2e; }
  #info { position: absolute; top: 8px; left: 12px; color: #eee;
          font-family: monospace; font-size: 13px; z-index: 2; }
  #bar { position: absolute; bottom: 12px; left: 5%; width: 90%; z-index: 2; }
  canvas { display: block; }
</style>
</head>
<body>
<div id="info"></div>
<input id="bar" type="range" min="0" value="0" step="1"/>
<canvas id="gl"></canvas>
<script>
"use strict";
const SCENE = __SCENE_JSON__;
const FRAMES = __FRAMES_JSON__;

// ---------- tiny linear algebra (column-major mat4, wxyz quats) ----------
function quatMul(a, b) {
  return [a[0]*b[0]-a[1]*b[1]-a[2]*b[2]-a[3]*b[3],
          a[0]*b[1]+a[1]*b[0]+a[2]*b[3]-a[3]*b[2],
          a[0]*b[2]-a[1]*b[3]+a[2]*b[0]+a[3]*b[1],
          a[0]*b[3]+a[1]*b[2]-a[2]*b[1]+a[3]*b[0]];
}
function eulerToQuat(deg) {  // intrinsic XYZ, degrees (matches three.Euler XYZ)
  const r = deg.map(d => d*Math.PI/360);  // half angles
  const [cx,cy,cz] = r.map(Math.cos), [sx,sy,sz] = r.map(Math.sin);
  return [cx*cy*cz - sx*sy*sz, sx*cy*cz + cx*sy*sz,
          cx*sy*cz - sx*cy*sz, cx*cy*sz + sx*sy*cz];
}
function quatRotMat4(q, t) {  // rigid transform: rotate by q, translate by t
  const [w,x,y,z] = q;
  const xx=x*x, yy=y*y, zz=z*z, xy=x*y, xz=x*z, yz=y*z, wx=w*x, wy=w*y, wz=w*z;
  return new Float32Array([
    1-2*(yy+zz), 2*(xy+wz),   2*(xz-wy),   0,
    2*(xy-wz),   1-2*(xx+zz), 2*(yz+wx),   0,
    2*(xz+wy),   2*(yz-wx),   1-2*(xx+yy), 0,
    t[0], t[1], t[2], 1]);
}
function mat4Mul(a, b) {  // a*b, column-major
  const o = new Float32Array(16);
  for (let c = 0; c < 4; c++)
    for (let r = 0; r < 4; r++)
      o[c*4+r] = a[r]*b[c*4] + a[4+r]*b[c*4+1] + a[8+r]*b[c*4+2] + a[12+r]*b[c*4+3];
  return o;
}
function perspective(fovyDeg, aspect, near, far) {
  const f = 1 / Math.tan(fovyDeg*Math.PI/360), nf = 1/(near-far);
  return new Float32Array([f/aspect,0,0,0, 0,f,0,0,
    0,0,(far+near)*nf,-1, 0,0,2*far*near*nf,0]);
}
function lookAt(eye, target, up) {
  const sub=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
  const cross=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
  const norm=a=>{const l=Math.hypot(a[0],a[1],a[2])||1;return [a[0]/l,a[1]/l,a[2]/l];};
  const dot=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
  const z = norm(sub(eye, target)), x = norm(cross(up, z)), y = cross(z, x);
  return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
    x[2],y[2],z[2],0, -dot(x,eye),-dot(y,eye),-dot(z,eye),1]);
}

// ---------- geometry builders (positions + normals, indexed) ----------
function sphereGeo(radius, ws, hs, halfLen) {
  // uv sphere; with halfLen > 0 the two hemispheres are pulled apart along
  // z and joined by a cylinder wall -> capsule (poles on +z/-z)
  const pos = [], nrm = [], idx = [];
  if (halfLen > 0) {
    // two hemispheres pulled apart along z, joined by a duplicated-equator
    // cylinder wall (wall rows carry radial normals)
    const half = Math.floor(hs/2);
    const p2 = [], n2 = [];
    for (let i = 0; i <= hs + 1; i++) {
      const ii = i <= half ? i : i - 1;
      const v = ii / hs, phi = v * Math.PI;
      const sp = Math.sin(phi), cp = Math.cos(phi);
      const zoff = i <= half ? halfLen : -halfLen;
      for (let j = 0; j <= ws; j++) {
        const u = j / ws, th = u * 2 * Math.PI;
        const nx = sp*Math.cos(th), ny = sp*Math.sin(th), nz = cp;
        // wall normals: radial (nz=0) on the two duplicated equator rows
        const wall = (i === half || i === half + 1);
        p2.push(radius*nx, radius*ny, radius*nz + zoff);
        n2.push(wall ? Math.cos(th) : nx, wall ? Math.sin(th) : ny, wall ? 0 : nz);
      }
    }
    for (let i = 0; i <= hs; i++)
      for (let j = 0; j < ws; j++) {
        const a = i*(ws+1)+j, b = a+ws+1;
        idx.push(a, b, a+1, b, b+1, a+1);
      }
    return {pos: p2, nrm: n2, idx};
  }
  for (let i = 0; i <= hs; i++) {
    const phi = i / hs * Math.PI;                  // 0 at +z pole
    const sp = Math.sin(phi), cp = Math.cos(phi);
    for (let j = 0; j <= ws; j++) {
      const th = j / ws * 2 * Math.PI;
      const nx = sp*Math.cos(th), ny = sp*Math.sin(th), nz = cp;
      pos.push(radius*nx, radius*ny, radius*nz);
      nrm.push(nx, ny, nz);
    }
  }
  for (let i = 0; i < hs; i++)
    for (let j = 0; j < ws; j++) {
      const a = i*(ws+1)+j, b = a+ws+1;
      idx.push(a, b, a+1, b, b+1, a+1);
    }
  return {pos, nrm, idx};
}
function boxGeo(hx, hy, hz) {
  const faces = [  // normal, then 4 corners (CCW from outside)
    [[ 1,0,0], [[ 1,-1,-1],[ 1, 1,-1],[ 1, 1, 1],[ 1,-1, 1]]],
    [[-1,0,0], [[-1, 1,-1],[-1,-1,-1],[-1,-1, 1],[-1, 1, 1]]],
    [[0, 1,0], [[ 1, 1,-1],[-1, 1,-1],[-1, 1, 1],[ 1, 1, 1]]],
    [[0,-1,0], [[-1,-1,-1],[ 1,-1,-1],[ 1,-1, 1],[-1,-1, 1]]],
    [[0,0, 1], [[-1,-1, 1],[ 1,-1, 1],[ 1, 1, 1],[-1, 1, 1]]],
    [[0,0,-1], [[-1, 1,-1],[ 1, 1,-1],[ 1,-1,-1],[-1,-1,-1]]],
  ];
  const pos = [], nrm = [], idx = [];
  faces.forEach(([n, corners]) => {
    const base = pos.length / 3;
    corners.forEach(c => { pos.push(c[0]*hx, c[1]*hy, c[2]*hz); nrm.push(...n); });
    idx.push(base, base+1, base+2, base, base+2, base+3);
  });
  return {pos, nrm, idx};
}
function planeGeo(size) {
  const s = size / 2;
  return {pos: [-s,-s,0, s,-s,0, s,s,0, -s,s,0],
          nrm: [0,0,1, 0,0,1, 0,0,1, 0,0,1], idx: [0,1,2, 0,2,3]};
}

// ---------- WebGL setup ----------
const canvas = document.getElementById('gl');
const gl = canvas.getContext('webgl', {antialias: true});
const VS = `
attribute vec3 aPos; attribute vec3 aNrm;
uniform mat4 uModel; uniform mat4 uViewProj;
varying vec3 vN; varying vec3 vW;
void main() {
  vec4 w = uModel * vec4(aPos, 1.0);
  vW = w.xyz;
  vN = mat3(uModel[0].xyz, uModel[1].xyz, uModel[2].xyz) * aNrm;
  gl_Position = uViewProj * w;
}`;
const FS = `
precision mediump float;
varying vec3 vN; varying vec3 vW;
uniform vec3 uColor; uniform vec3 uLight; uniform vec3 uEye;
void main() {
  vec3 n = normalize(vN);
  float diff = max(dot(n, uLight), 0.0);
  vec3 h = normalize(uLight + normalize(uEye - vW));
  float spec = pow(max(dot(n, h), 0.0), 32.0) * 0.25;
  vec3 c = uColor * (0.45 + 0.75 * diff) + vec3(spec);
  float fog = clamp((length(vW - uEye) - 30.0) / 90.0, 0.0, 1.0);
  gl_FragColor = vec4(mix(c, vec3(0.102, 0.102, 0.180), fog), 1.0);
}`;
function shader(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw new Error(gl.getShaderInfoLog(s));
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const loc = {
  aPos: gl.getAttribLocation(prog, 'aPos'),
  aNrm: gl.getAttribLocation(prog, 'aNrm'),
  uModel: gl.getUniformLocation(prog, 'uModel'),
  uViewProj: gl.getUniformLocation(prog, 'uViewProj'),
  uColor: gl.getUniformLocation(prog, 'uColor'),
  uLight: gl.getUniformLocation(prog, 'uLight'),
  uEye: gl.getUniformLocation(prog, 'uEye'),
};
gl.enableVertexAttribArray(loc.aPos);
gl.enableVertexAttribArray(loc.aNrm);
gl.enable(gl.DEPTH_TEST);

function upload(geo) {
  const pb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, pb);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(geo.pos), gl.STATIC_DRAW);
  const nb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, nb);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(geo.nrm), gl.STATIC_DRAW);
  const ib = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ib);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, new Uint16Array(geo.idx), gl.STATIC_DRAW);
  return {pb, nb, ib, n: geo.idx.length};
}

// ---------- scene assembly ----------
const palette = [[0.431,0.776,1.0],[1.0,0.835,0.310],[1.0,0.541,0.396],
  [0.647,0.839,0.655],[0.808,0.576,0.847],[0.565,0.792,0.976],
  [1.0,0.671,0.569],[0.773,0.882,0.647],[0.957,0.561,0.694],[0.502,0.796,0.769]];
const meshes = [];  // {buf, color, bodyIndex, localPos, localQuat}
SCENE.bodies.forEach((body, bi) => {
  const color = body.frozen ? [0.333,0.357,0.431] : palette[bi % palette.length];
  body.colliders.forEach(col => {
    let geo = null, c = color;
    if (col.type === 'sphere')       geo = sphereGeo(col.radius, 24, 16, 0);
    else if (col.type === 'capsule') geo = sphereGeo(col.radius, 16, 12,
        Math.max(col.length/2 - col.radius, 0.0005));
    else if (col.type === 'box')     geo = boxGeo(...col.halfsize);
    else if (col.type === 'plane') { geo = planeGeo(200); c = [0.180,0.180,0.267]; }
    if (geo) meshes.push({buf: upload(geo), color: c, bodyIndex: bi,
                          localPos: col.pos, localQuat: eulerToQuat(col.rot)});
  });
});

// ---------- orbit camera (z-up) ----------
const cam = {theta: -0.9, phi: 0.45, dist: 14, target: [0, 0, 0.8]};
function eyePos() {
  const cp = Math.cos(cam.phi);
  return [cam.target[0] + cam.dist*cp*Math.cos(cam.theta),
          cam.target[1] + cam.dist*cp*Math.sin(cam.theta),
          cam.target[2] + cam.dist*Math.sin(cam.phi)];
}
let drag = null;
canvas.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY, e.shiftKey]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {  // pan in the view plane
    const s = cam.dist * 0.0015;
    cam.target[0] += s * (dx * Math.sin(cam.theta) + dy * Math.cos(cam.theta));
    cam.target[1] += s * (-dx * Math.cos(cam.theta) + dy * Math.sin(cam.theta));
  } else {
    cam.theta -= dx * 0.005;
    cam.phi = Math.min(1.45, Math.max(-0.2, cam.phi + dy * 0.005));
  }
  drag = [e.clientX, e.clientY, drag[2]];
});
canvas.addEventListener('wheel', e => {
  cam.dist = Math.min(120, Math.max(1.5, cam.dist * Math.exp(e.deltaY * 0.001)));
  e.preventDefault();
}, {passive: false});

// ---------- animation ----------
const bar = document.getElementById('bar');
bar.max = FRAMES.length - 1;
const info = document.getElementById('info');
let frame = 0, playing = true;
function setFrame(f) {
  frame = f;
  info.textContent = 'frame ' + f + ' / ' + (FRAMES.length - 1) +
      '  t=' + (f * SCENE.dt).toFixed(2) + 's  (space: play/pause)';
  bar.value = f;
}
bar.addEventListener('input', () => { playing = false; setFrame(+bar.value); });
window.addEventListener('keydown', e => {
  if (e.code === 'Space') { playing = !playing; e.preventDefault(); }
});

const lightDir = (() => { const l = [0.35,-0.35,0.87],
  n = Math.hypot(...l); return l.map(v => v/n); })();
function resize() {
  canvas.width = window.innerWidth; canvas.height = window.innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
}
window.addEventListener('resize', resize); resize();

let last = 0;
function draw(t) {
  requestAnimationFrame(draw);
  if (playing && t - last > 1000 * SCENE.dt) { last = t; setFrame((frame + 1) % FRAMES.length); }
  const eye = eyePos();
  const vp = mat4Mul(
      perspective(50, canvas.width / canvas.height, 0.05, 500),
      lookAt(eye, cam.target, [0, 0, 1]));
  gl.clearColor(0.102, 0.102, 0.180, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(loc.uViewProj, false, vp);
  gl.uniform3fv(loc.uLight, lightDir);
  gl.uniform3fv(loc.uEye, eye);
  const fr = FRAMES[frame];
  meshes.forEach(m => {
    const bq = fr.rot[m.bodyIndex], bp = fr.pos[m.bodyIndex];
    const model = mat4Mul(quatRotMat4(bq, bp),
                          quatRotMat4(m.localQuat, m.localPos));
    gl.uniformMatrix4fv(loc.uModel, false, model);
    gl.uniform3fv(loc.uColor, m.color);
    gl.bindBuffer(gl.ARRAY_BUFFER, m.buf.pb);
    gl.vertexAttribPointer(loc.aPos, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, m.buf.nb);
    gl.vertexAttribPointer(loc.aNrm, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, m.buf.ib);
    gl.drawElements(gl.TRIANGLES, m.buf.n, gl.UNSIGNED_SHORT, 0);
  });
}
setFrame(0); draw(0);
</script>
</body>
</html>
"""


def render(sys: System, qps: Sequence) -> str:
    """Render a trajectory (a sequence of one env's QPs, or of batches of
    one) to a standalone HTML string (no network needed to view)."""
    return (_PAGE
            .replace("__SCENE_JSON__", json.dumps(_scene_json(sys)))
            .replace("__FRAMES_JSON__", json.dumps(_frames_json(qps))))


def save(path: str, sys: System, qps: Sequence) -> None:
    with open(path, "w") as f:
        f.write(render(sys, qps))
