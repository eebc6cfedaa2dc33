"""Live reconstruction viewer for a headless host (port of
:mod:`pvo_tpu.vo.live_viewer`).

The reference ships an interactive Open3D window driven by a separate
visualization process (VO_Module/droid_slam/visualization.py:55-154:
per-keyframe "dirty" updates of filtered point actors + camera
frusta). A server has no display, so the state is served over HTTP
instead: a background stdlib server exposes

  /            a self-contained WebGL point viewer (vanilla JS orbit
               controls, no external assets)
  /state.json  the current filtered cloud, trajectory and frusta

and :meth:`LiveViewer.update`, called from the tracking loop at the
reference's per-keyframe cadence, refreshes the snapshot from the
DepthVideo buffers with the same multi-view consistency filter as the
reference (:func:`pvo_tpu_torch.vo.visualization.filtered_pointcloud`,
on the video's device). While the planner is engaged ``update`` raises:
its read would force a sync into the planner's frame program; the
tracking loop calls :meth:`mark_stale` then.

Everything but the filter is plain stdlib + numpy; a refresh costs the
tracking loop one read of the masked points, and nothing when idle.
"""

from __future__ import annotations

import http.server
import json
import threading

import numpy as np

from pvo_tpu_torch.vo.visualization import (check_readable,
                                            filtered_pointcloud,
                                            keyframe_c2w)

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>pvo_tpu live</title>
<style>
 body{margin:0;background:#111;color:#ccc;font:12px monospace}
 #hud{position:fixed;top:8px;left:8px}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">pvo_tpu live viewer — drag: orbit, wheel: zoom</div>
<canvas id="c"></canvas>
<script>
const cv=document.getElementById('c');
const gl=cv.getContext('webgl');
const vs=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.0);
gl_PointSize=2.0;vc=col;}`;
const fs=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const pr=gl.createProgram();
gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(pr);gl.useProgram(pr);
const locP=gl.getAttribLocation(pr,'p');
const locC=gl.getAttribLocation(pr,'col');
const locM=gl.getUniformLocation(pr,'mvp');
const bufP=gl.createBuffer(),bufC=gl.createBuffer();
const bufLP=gl.createBuffer(),bufLC=gl.createBuffer();
let n=0,nl=0,az=0.5,el=0.3,dist=8,cx=0,cy=0,cz=0;
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 az+=(e.clientX-lx)*0.01;el+=(e.clientY-ly)*0.01;
 el=Math.max(-1.5,Math.min(1.5,el));lx=e.clientX;ly=e.clientY;};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function mat(){
 const w=cv.width=cv.clientWidth,h=cv.height=cv.clientHeight;
 gl.viewport(0,0,w,h);
 const f=1.5,a=w/h,zn=0.05,zf=500;
 const P=[f/a,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1,
          0,0,2*zf*zn/(zn-zf),0];
 const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
 const ex=cx+dist*ce*sa,ey=cy+dist*se,ez=cz+dist*ce*ca;
 const zx=(ex-cx)/dist,zy=(ey-cy)/dist,zz=(ez-cz)/dist;
 let xx=zz,xy=0,xz=-zx;const xl=Math.hypot(xx,xy,xz)||1;
 xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const V=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
  -(xx*ex+xy*ey+xz*ez),-(yx*ex+yy*ey+yz*ez),-(zx*ex+zy*ey+zz*ez),1];
 const M=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=P[k*4+j]*V[i*4+k];M[i*4+j]=s;}
 return M;}
function bind(bp,bc){
 gl.bindBuffer(gl.ARRAY_BUFFER,bp);
 gl.enableVertexAttribArray(locP);
 gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bc);
 gl.enableVertexAttribArray(locC);
 gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);}
function draw(){
 gl.clearColor(0.07,0.07,0.07,1);gl.clear(gl.COLOR_BUFFER_BIT);
 gl.uniformMatrix4fv(locM,false,mat());
 if(n){bind(bufP,bufC);gl.drawArrays(gl.POINTS,0,n);}
 if(nl){bind(bufLP,bufLC);gl.drawArrays(gl.LINES,0,nl);}
 requestAnimationFrame(draw);}
async function poll(){
 try{
  const r=await fetch('state.json');const s=await r.json();
  const pts=new Float32Array(s.points.flat());
  const col=new Float32Array(s.colors.flat().map(v=>v/255));
  n=pts.length/3;
  if(n){let sx=0,sy=0,sz=0;
   for(let i=0;i<n;i++){sx+=pts[3*i];sy+=pts[3*i+1];sz+=pts[3*i+2];}
   cx=sx/n;cy=sy/n;cz=sz/n;}
  gl.bindBuffer(gl.ARRAY_BUFFER,bufP);
  gl.bufferData(gl.ARRAY_BUFFER,pts,gl.DYNAMIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufC);
  gl.bufferData(gl.ARRAY_BUFFER,col,gl.DYNAMIC_DRAW);
  // trajectory (green polyline) + camera frusta (yellow), the
  // reference viewer's camera actors
  const lp=[],lc=[];
  const tr=s.trajectory||[];
  for(let i=0;i+1<tr.length;i++){
   lp.push(...tr[i],...tr[i+1]);
   lc.push(0.2,0.9,0.3, 0.2,0.9,0.3);}
  for(const seg of (s.frusta||[])){
   lp.push(...seg[0],...seg[1]);
   lc.push(0.95,0.8,0.2, 0.95,0.8,0.2);}
  nl=lp.length/3;
  gl.bindBuffer(gl.ARRAY_BUFFER,bufLP);
  gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(lp),gl.DYNAMIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufLC);
  gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(lc),gl.DYNAMIC_DRAW);
  const stale=s.stale?' [engaged: view is stale until next refresh]':'';
  document.getElementById('hud').textContent=
   `pvo_tpu live — kf ${s.counter}, ${n} pts${stale}`;
 }catch(e){}
 setTimeout(poll,1000);}
poll();draw();
</script></body></html>
"""


def _frustum_lines(pose_c2w_mats, scale=0.25):
    """Camera frusta as line segments (reference create_camera_actor),
    one 5-vertex pyramid per keyframe in world coordinates."""
    tip = np.array([0.0, 0.0, 0.0])
    base = scale * np.array([[-0.5, -0.375, 1], [0.5, -0.375, 1],
                             [0.5, 0.375, 1], [-0.5, 0.375, 1]])
    segs = []
    for M in pose_c2w_mats:
        R, t = M[:3, :3], M[:3, 3]
        tw = R @ tip + t
        bw = base @ R.T + t
        for k in range(4):
            segs.append([tw.tolist(), bw[k].tolist()])
            segs.append([bw[k].tolist(), bw[(k + 1) % 4].tolist()])
    return segs


class LiveViewer:
    """Background HTTP viewer over a live :class:`DepthVideo`.

    Call :meth:`update` from the tracking loop (the reference calls
    its visualization callback once per keyframe). ``decimate`` keeps
    the JSON snapshot small; the filter parameters mirror
    droid_visualization's (visualization.py:55-154). The server binds
    127.0.0.1:``port`` (0: a free port, read back from ``self.port``);
    a port it cannot bind raises ``OSError``.
    """

    def __init__(self, video, port=0, decimate=16,
                 filter_thresh=0.005, min_count=2):
        self.video = video
        self.decimate = decimate
        self.filter_thresh = filter_thresh
        self.min_count = min_count
        self._lock = threading.Lock()
        self._state = {"counter": 0, "points": [], "colors": [],
                       "trajectory": [], "frusta": []}

        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.rstrip("/") in ("", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif self.path.endswith("state.json"):
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def mark_stale(self, stale=True):
        """Flag the snapshot as stale (the planner is engaged: a refresh
        would stall its device pipeline, so the view freezes until the
        next disengage; the page's HUD says so)."""
        with self._lock:
            self._state = {**self._state, "stale": bool(stale)}

    def update(self, stale=False):
        """Refresh the snapshot from the video buffers (one read of the
        masked points). Raises while the planner is engaged."""
        check_readable(self.video)
        if self.video.counter < 2:
            return
        pts, cols = filtered_pointcloud(
            self.video, filter_thresh=self.filter_thresh,
            min_count=self.min_count)
        pts = pts[::self.decimate]
        cols = cols[::self.decimate]
        mats = keyframe_c2w(self.video)
        traj = mats[:, :3, 3]
        with self._lock:
            self._state = {
                "counter": int(self.video.counter),
                "points": np.round(pts, 4).tolist(),
                "colors": cols.astype(int).tolist(),
                "trajectory": np.round(traj, 4).tolist(),
                "frusta": _frustum_lines(mats[-8:]),
                "stale": bool(stale),
            }

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
