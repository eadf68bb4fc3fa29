"""Self-contained WebGL point-cloud viewer (port of
staticfusion_tpu/viz/webviewer.py; the same page for the same points).

The reference's interactive 3D view is a Pangolin GL window
(Utils/GUI.h:59-116, GlobalModel::renderPointCloud GlobalModel.cpp:259-319).
This exports the surfel map (plus estimated/GT trajectories, mirroring the
GUI's polyline draw at FrontEnd.cpp:1242-1261) into ONE dependency-free
HTML file: point data embedded as base64 binary, rendered by ~150 lines of
inline vanilla WebGL with orbit controls. Open it in any browser; nothing
is fetched from the network.

Entry points:
* `save_html(path, smap, threshold, trajectory=..., gt_trajectory=...)`
* `save_html_from_ply(path, ply_path)` — convert a `save_ply` export.
* CLI: `python -m staticfusion_tpu_torch.viz.webviewer map.ply out.html`.
"""

from __future__ import annotations

import base64
import json

import numpy as np

from staticfusion_tpu_torch.viz.offline import host_array

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;color:#ccc;
   font:12px system-ui,sans-serif}
 #c{width:100%;height:100%;display:block}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
   border-radius:6px;user-select:none}
 #hud input{vertical-align:middle}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>__TITLE__</b> &mdash; <span id="n"></span> points<br>
 drag: rotate &middot; shift-drag / right-drag: pan &middot; wheel: zoom<br>
 point size <input id="ps" type="range" min="0.2" max="8" step="0.1" value="2">
 <label><input id="tr" type="checkbox" checked> trajectories</label></div>
<script>
"use strict";
const DATA = __DATA__;
function buf(s, T){const b=atob(s);const u=new Uint8Array(b.length);
  for(let i=0;i<b.length;i++)u[i]=b.charCodeAt(i);return new T(u.buffer);}
const pos = buf(DATA.pos, Float32Array);
const col = buf(DATA.col, Uint8Array);
const N = pos.length/3;
document.getElementById("n").textContent = N.toLocaleString();
const trajs = DATA.trajs.map(t => ({pts: buf(t.pts, Float32Array),
                                    color: t.color}));

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:false});
const VS = `attribute vec3 p; attribute vec3 c; uniform mat4 mvp;
 uniform float ps; varying vec3 vc;
 void main(){ gl_Position = mvp*vec4(p,1.0);
   gl_PointSize = clamp(ps*40.0/max(gl_Position.w,0.05), 1.0, 64.0);
   vc = c; }`;
const FS = `precision mediump float; varying vec3 vc;
 void main(){ gl_FragColor = vec4(vc,1.0); }`;
function prog(vs, fs){
  const P = gl.createProgram();
  for(const [t,s] of [[gl.VERTEX_SHADER,vs],[gl.FRAGMENT_SHADER,fs]]){
    const sh = gl.createShader(t); gl.shaderSource(sh,s); gl.compileShader(sh);
    gl.attachShader(P,sh);}
  gl.linkProgram(P); return P;}
const P = prog(VS, FS);
const aP = gl.getAttribLocation(P,"p"), aC = gl.getAttribLocation(P,"c");
const uM = gl.getUniformLocation(P,"mvp"), uS = gl.getUniformLocation(P,"ps");

const bP = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER,bP); gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
const bC = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER,bC); gl.bufferData(gl.ARRAY_BUFFER,col,gl.STATIC_DRAW);
for(const t of trajs){ t.buf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,t.buf);
  gl.bufferData(gl.ARRAY_BUFFER,t.pts,gl.STATIC_DRAW);
  t.cbuf = gl.createBuffer();
  const cc = new Uint8Array(t.pts.length);
  for(let i=0;i<cc.length;i+=3){cc[i]=t.color[0];cc[i+1]=t.color[1];cc[i+2]=t.color[2];}
  gl.bindBuffer(gl.ARRAY_BUFFER,t.cbuf);
  gl.bufferData(gl.ARRAY_BUFFER,cc,gl.STATIC_DRAW);}

// center/extent for the initial orbit target
let cx=0,cy=0,cz=0;
for(let i=0;i<N;i++){cx+=pos[3*i];cy+=pos[3*i+1];cz+=pos[3*i+2];}
if(N>0){cx/=N;cy/=N;cz/=N;}
let ext=0.1;
for(let i=0;i<N;i++){const d=Math.abs(pos[3*i]-cx)+Math.abs(pos[3*i+1]-cy)
  +Math.abs(pos[3*i+2]-cz); if(d>ext)ext=d;}

// orbit state: camera-frame coordinates look down +Z with Y down (CV frame)
let yaw=0.3, pitch=-0.25, dist=ext*1.6, tx=cx, ty=cy, tz=cz;
function mat(){
  const w=canvas.width, h=canvas.height, asp=w/h;
  const f=1.0/Math.tan(0.45), zn=0.01, zf=1000.0;
  const cyw=Math.cos(yaw), syw=Math.sin(yaw);
  const cp=Math.cos(pitch), sp=Math.sin(pitch);
  // rows of the world->camera rotation (orbit about -Y up axis)
  const rx=[cyw,0,-syw], ry=[syw*sp,cp,cyw*sp], rz=[syw*cp,-sp,cyw*cp];
  const ex=tx-dist*rz[0], ey=ty-dist*rz[1], ez=tz-dist*rz[2];
  const v=[rx[0],ry[0],rz[0],0, rx[1],ry[1],rz[1],0, rx[2],ry[2],rz[2],0,
    -(rx[0]*ex+rx[1]*ey+rx[2]*ez), -(ry[0]*ex+ry[1]*ey+ry[2]*ez),
    -(rz[0]*ex+rz[1]*ey+rz[2]*ez),1];
  const p=[f/asp,0,0,0, 0,-f,0,0, 0,0,(zf+zn)/(zf-zn),1,
    0,0,-2*zf*zn/(zf-zn),0];
  const m=new Float32Array(16);
  for(let r=0;r<4;r++)for(let c2=0;c2<4;c2++){let s=0;
    for(let k=0;k<4;k++)s+=v[r*4+k]*p[k*4+c2]; m[r*4+c2]=s;}
  return m;}

let drag=0, lx=0, ly=0;
canvas.addEventListener("mousedown",e=>{drag=(e.button===2||e.shiftKey)?2:1;
  lx=e.clientX;ly=e.clientY;});
window.addEventListener("mouseup",()=>drag=0);
window.addEventListener("mousemove",e=>{
  if(!drag)return; const dx=e.clientX-lx, dy=e.clientY-ly;
  lx=e.clientX; ly=e.clientY;
  if(drag===1){yaw+=dx*0.005; pitch+=dy*0.005;
    pitch=Math.max(-1.55,Math.min(1.55,pitch));}
  else{const s=dist*0.0015, cyw=Math.cos(yaw), syw=Math.sin(yaw);
    tx-=s*(dx*cyw); tz+=s*(dx*syw); ty-=s*dy;}
  draw();});
canvas.addEventListener("wheel",e=>{e.preventDefault();
  dist*=Math.exp(e.deltaY*0.001); draw();},{passive:false});
canvas.addEventListener("contextmenu",e=>e.preventDefault());
document.getElementById("ps").addEventListener("input",draw);
document.getElementById("tr").addEventListener("input",draw);

function draw(){
  const dpr=window.devicePixelRatio||1;
  canvas.width=canvas.clientWidth*dpr; canvas.height=canvas.clientHeight*dpr;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.066,0.066,0.066,1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.useProgram(P);
  gl.uniformMatrix4fv(uM,false,mat());
  gl.uniform1f(uS,parseFloat(document.getElementById("ps").value));
  gl.enableVertexAttribArray(aP); gl.enableVertexAttribArray(aC);
  gl.bindBuffer(gl.ARRAY_BUFFER,bP);
  gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bC);
  gl.vertexAttribPointer(aC,3,gl.UNSIGNED_BYTE,true,0,0);
  gl.drawArrays(gl.POINTS,0,N);
  if(document.getElementById("tr").checked)
    for(const t of trajs){
      gl.bindBuffer(gl.ARRAY_BUFFER,t.buf);
      gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
      gl.bindBuffer(gl.ARRAY_BUFFER,t.cbuf);
      gl.vertexAttribPointer(aC,3,gl.UNSIGNED_BYTE,true,0,0);
      gl.drawArrays(gl.LINE_STRIP,0,t.pts.length/3);}
}
window.addEventListener("resize",draw);
draw();
</script></body></html>
"""


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii")


def build_html(points: np.ndarray, colors: np.ndarray,
               trajectories: list[tuple[np.ndarray, tuple[int, int, int]]]
               | None = None,
               title: str = "StaticFusion-TPU map") -> str:
    """points (N,3) float; colors (N,3) float [0,1] or uint8;
    trajectories: list of ((M,3) positions, (r,g,b) uint8 color)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = np.asarray(colors)
    if colors.dtype != np.uint8:
        colors = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
    colors = colors.reshape(-1, 3)
    assert colors.shape[0] == points.shape[0]
    trajs = [{"pts": _b64(np.asarray(p, np.float32).reshape(-1, 3)),
              "color": list(c)} for p, c in (trajectories or []) if len(p)]
    data = json.dumps({"pos": _b64(points), "col": _b64(colors),
                       "trajs": trajs})
    return (_PAGE.replace("__TITLE__", title).replace("__DATA__", data))


def save_html(path: str, smap, confidence_threshold: float,
              trajectory: np.ndarray | None = None,
              gt_trajectory: np.ndarray | None = None,
              title: str = "StaticFusion-TPU map") -> None:
    """Export the surfel map (the port's SurfelMap on any device; conf >
    threshold, as savePly's cut — Reconstruction.cpp:374) + trajectory
    polylines to one HTML file.  Trajectories are (M,3) translations or
    (M,4,4) pose arrays."""
    keep = host_array(smap.valid) & (host_array(smap.conf)
                                     > confidence_threshold)
    pts = host_array(smap.pos)[keep]
    col = host_array(smap.color)[keep]
    trajs = []
    for t, c in ((trajectory, (80, 255, 120)), (gt_trajectory, (255, 90, 90))):
        if t is None or len(t) == 0:
            continue
        t = np.asarray(host_array(t), np.float32)
        if t.ndim == 3:  # (M,4,4) poses
            t = t[:, :3, 3]
        trajs.append((t, c))
    with open(path, "w") as f:
        f.write(build_html(pts, col, trajs, title=title))


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a `save_ply` binary PLY back: returns (pos (N,3) f32,
    color (N,3) u8). Parses the generic header, so PLYs from other tools
    with leading x/y/z + red/green/blue properties also load."""
    dtypes = {"float": "<f4", "float32": "<f4", "uchar": "u1", "uint8": "u1",
              "int": "<i4", "int32": "<i4", "uint": "<u4", "double": "<f8",
              "ushort": "<u2", "short": "<i2", "char": "i1"}
    props: list[tuple[str, str]] = []
    n = 0
    in_vertex = False
    n_elements = 0
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = f.readline().strip()
        if b"binary_little_endian" not in fmt:
            raise ValueError(f"unsupported PLY format: {fmt!r}")
        while True:
            line = f.readline()
            if not line:
                raise ValueError("truncated PLY header")
            parts = line.decode("ascii").strip().split()
            if not parts:
                continue
            if parts[0] == "end_header":
                break
            if parts[0] == "element":
                if parts[1] == "vertex":
                    if n_elements:
                        raise ValueError("vertex must be the first element")
                    n = int(parts[2])
                    in_vertex = True
                else:
                    in_vertex = False
                n_elements += 1
            elif parts[0] == "property" and in_vertex:
                props.append((parts[1], parts[2]))
        dt = np.dtype([(name, dtypes[typ]) for typ, name in props])
        rec = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
    pos = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    names = {name for _, name in props}
    if {"red", "green", "blue"} <= names:
        col = np.stack([rec["red"], rec["green"], rec["blue"]], -1)
        col = col.astype(np.uint8)
    else:
        col = np.full((n, 3), 200, np.uint8)
    return pos, col


def save_html_from_ply(path: str, ply_path: str,
                       title: str | None = None) -> None:
    pos, col = load_ply(ply_path)
    with open(path, "w") as f:
        f.write(build_html(pos, col, title=title or ply_path))


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a StaticFusion-TPU PLY export to a "
                    "self-contained HTML viewer")
    ap.add_argument("ply")
    ap.add_argument("html")
    ap.add_argument("--title", default=None)
    args = ap.parse_args(argv)
    save_html_from_ply(args.html, args.ply, title=args.title)
    print(f"wrote {args.html}")


if __name__ == "__main__":
    main()
