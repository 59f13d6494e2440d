"""The web viewer, the port of ``ngp_tpu/utils/viewer.py``: a small HTTP
server around ``Testbed.frame()`` (the counterpart of the reference's
ImGui window, ``src/testbed.cu:1003-2743``). The browser polls
``/frame.jpg``: each poll trains a chunk and renders at the dynamic
resolution, encoded by the port's JPEG encoder (``data/jpeg.py``) at
quality 90; it posts orbit-camera updates. One lock serialises the
requests that touch the testbed.

Usage::

    python -m ngp_tpu_torch.scripts.viewer SCENE --port 8080 [--device cpu]

Endpoints:
  GET  /            the HTML/JS client (canvas, mouse orbit, keys)
  GET  /frame.jpg   one heartbeat frame as JPEG (?w=&h=&train=0/1)
  GET  /state       JSON: step, loss, meters, camera, crop, path length, and
                    the last frame's resolution and render ms
  POST /camera      JSON: {yaw, pitch, radius, fov} (partial ok)
  POST /crop        JSON: {min:[3], max:[3]} render crop box
                    (m_render_aabb, the GUI crop gizmo,
                    src/testbed.cu:1409-1541); NeRF mode only
  GET  /histograms  JSON: per-level hash-table weight histograms
                    (the GUI's encoding view, src/testbed.cu:1932)
  POST /path        JSON: {op: add|clear|play|stop} camera-path editor
                    (src/testbed.cu:1019-1147); ``add`` keyframes the
                    current orbit camera
  GET  /path.json   the keyframes in the reference's camera-path JSON
                    dialect (``python -m ngp_tpu_torch.run
                    --video_camera_path`` reads it)
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ngp_tpu_torch.data.jpeg import encode_jpeg
from ngp_tpu_torch.utils.camera_path import CameraKeyframe, CameraPath

FRAME_JPEG_QUALITY = 90  # the JAX viewer's
HISTOGRAM_BINS = 32

_PAGE = """<!DOCTYPE html>
<html><head><title>ngp_tpu_torch viewer</title><style>
body { margin:0; background:#111; color:#ccc; font:13px monospace; }
#hud { position:fixed; top:8px; left:8px; white-space:pre; }
#side { position:fixed; top:8px; right:8px; width:230px; }
#side div { margin-bottom:4px; }
input[type=range] { width:110px; vertical-align:middle; }
button { font:12px monospace; background:#222; color:#ccc;
         border:1px solid #555; margin-right:3px; }
canvas.view { display:block; margin:auto; image-rendering:pixelated; }
#hist { background:#181818; }
a { color:#8cf; }
</style></head><body>
<div id="hud"></div>
<canvas id="c" class="view" width="512" height="512"></canvas>
<div id="side">
 <div><b>crop box</b> <span id="cropv"></span></div>
 <div id="crop"></div>
 <div><b>camera path</b> (<span id="nkeys">0</span> keys)
  <button onclick="pathOp('add')">add [k]</button>
  <button onclick="pathOp('clear')">clear</button>
  <button id="playbtn" onclick="togglePlay()">play</button>
  <a href="/path.json" download="base_cam.json">export</a></div>
 <div><b>hash levels</b> (log|w|)</div>
 <canvas id="hist" width="230" height="120"></canvas>
</div>
<script>
let yaw=0, pitch=0.3, radius=1.6, fov=50, training=1, dragging=false, lx=0, ly=0;
let playing=false;
const c=document.getElementById('c'), ctx=c.getContext('2d');
c.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>dragging=false;
window.onmousemove=e=>{ if(!dragging) return;
  yaw+=(e.clientX-lx)*0.01; pitch+=(e.clientY-ly)*0.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); lx=e.clientX; ly=e.clientY;
  postCam(); };
window.onwheel=e=>{ radius*=Math.exp(e.deltaY*0.001); postCam(); };
window.onkeydown=e=>{ if(e.key==='t'){training^=1;}
  if(e.key==='k'){pathOp('add');} };
function postCam(){ fetch('/camera',{method:'POST',
  body:JSON.stringify({yaw:yaw,pitch:pitch,radius:radius,fov:fov})}); }
function pathOp(op){ fetch('/path',{method:'POST',
  body:JSON.stringify({op:op})}).then(r=>r.json()).then(s=>{
    document.getElementById('nkeys').textContent=s.n_keyframes; }); }
function togglePlay(){ playing=!playing;
  document.getElementById('playbtn').textContent=playing?'stop':'play';
  pathOp(playing?'play':'stop'); }
// crop sliders: 6 ranges in [0,1]
const cropDiv=document.getElementById('crop');
const cropVals=[0,0,0,1,1,1];
'xmin ymin zmin xmax ymax zmax'.split(' ').forEach((n,i)=>{
  const r=document.createElement('input');
  r.type='range'; r.min=0; r.max=1; r.step=0.01; r.value=cropVals[i];
  r.oninput=()=>{ cropVals[i]=parseFloat(r.value); postCrop(); };
  const d=document.createElement('div');
  d.textContent=n+' '; d.appendChild(r); cropDiv.appendChild(d); });
function postCrop(){
  document.getElementById('cropv').textContent=cropVals.map(v=>v.toFixed(2)).join(',');
  fetch('/crop',{method:'POST',body:JSON.stringify(
    {min:cropVals.slice(0,3), max:cropVals.slice(3,6)})}); }
async function drawHist(){
  try {
    const h=await (await fetch('/histograms')).json();
    const hc=document.getElementById('hist'), g=hc.getContext('2d');
    g.clearRect(0,0,hc.width,hc.height);
    const L=h.levels.length, bh=hc.height/L;
    h.levels.forEach((lev,li)=>{
      const mx=Math.max(...lev,1e-9), n=lev.length;
      g.fillStyle='hsl('+(li*37%360)+',60%,55%)';
      lev.forEach((v,bi)=>{ const bw=hc.width/n;
        g.fillRect(bi*bw, (li+1)*bh-(v/mx)*(bh-2), bw, (v/mx)*(bh-2)); });
    });
  } catch(e) {}
  setTimeout(drawHist, 4000);
}
drawHist();
async function loop(){
  const img=new Image();
  img.onload=()=>{ ctx.drawImage(img,0,0,c.width,c.height); loop(); };
  img.onerror=()=>setTimeout(loop,500);
  img.src='/frame.jpg?train='+training+'&t='+Date.now();
  const s=await (await fetch('/state')).json();
  document.getElementById('nkeys').textContent=s.n_keyframes;
  document.getElementById('hud').textContent=
    'step '+s.step+'  loss '+(s.loss||0).toFixed(5)+
    '  '+(s.frame_ms||0).toFixed(0)+' ms/frame  [t] train='+training+
    (s.playing?'  [path playback]':'');
}
loop();
</script></body></html>"""


class ViewerState:
    """The orbit camera: yaw and pitch (radians) about ``center`` at
    ``radius``, a vertical field of view of ``fov`` degrees."""

    def __init__(self, center=(0.5, 0.5, 0.5), radius=1.6):
        self.yaw = 0.0
        self.pitch = 0.3
        self.radius = radius
        self.fov = 50.0
        self.center = np.asarray(center, np.float32)
        self.last = {}

    def xform(self) -> np.ndarray:
        """The orbit camera as a (3, 4) camera-to-world matrix (NGP
        convention: x right, y down, z forward, as the loaders give)."""
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        eye = self.center + self.radius * np.asarray([cy * cp, sy * cp, sp], np.float32)
        f = self.center - eye
        f /= np.linalg.norm(f)
        up = np.asarray([0.0, 0.0, 1.0], np.float32)
        r = np.cross(f, up)
        n = np.linalg.norm(r)
        r = r / n if n > 1e-6 else np.asarray([1.0, 0.0, 0.0], np.float32)
        d = np.cross(f, r)
        m = np.zeros((3, 4), np.float32)
        m[:, 0], m[:, 1], m[:, 2], m[:, 3] = r, d, f, eye
        return m


def _histograms(testbed) -> dict:
    """The served (EMA) model's per-level grid histograms, or the error
    where the mode's engine serves no NeRF model with a grid encoding (no
    ``inference_params``, ``pos_encoding`` or ``level_histograms``), as the
    JAX viewer answers."""
    try:
        model = testbed.engine.inference_params(testbed.state)
        counts, means = model.pos_encoding.level_histograms(n_bins=HISTOGRAM_BINS)
    except AttributeError as e:
        return {"levels": [], "error": repr(e)[:120]}
    return {"levels": counts.cpu().tolist(), "mean_abs_w": means.cpu().tolist()}


def make_server(testbed, host: str = "127.0.0.1", port: int = 8080,
                n_train_steps: int = 8) -> HTTPServer:
    """Build (not start) the server: ``serve_forever()`` runs it, or
    :func:`serve` for the blocking CLI path. ``port`` 0 takes a free port
    (``server_address`` names it); ``viewer_camera`` is the orbit camera."""
    cam = ViewerState()
    lock = threading.Lock()
    # the camera-path editor (src/testbed.cu:1019-1147): keyframes in the
    # reference's parametrisation; playback advances t by dt a frame
    path = CameraPath()
    play = {"on": False, "t": 0.0, "dt": 1.0 / 120.0}

    def state() -> dict:
        m = getattr(testbed.engine, "meters", None)
        fm = testbed.frame_meters
        box = testbed.render_aabb if testbed.mode == "nerf" else None
        return {
            "step": testbed.training_step,
            "loss": None if testbed.loss != testbed.loss else testbed.loss,
            "loss_ema": m.loss_ema if m else None,
            "frame_ms": fm["frame_ms"].value if fm else None,
            "camera": {"yaw": cam.yaw, "pitch": cam.pitch, "radius": cam.radius,
                       "fov": cam.fov},
            "crop": None if box is None else [np.asarray(b).tolist() for b in box],
            "n_keyframes": len(path.keyframes),
            "playing": play["on"],
            "resolution": cam.last.get("resolution"),
            "render_ms": cam.last.get("render_ms"),
        }

    def frame(query: dict) -> bytes:
        w = int(query.get("w", ["512"])[0])
        h = int(query.get("h", ["512"])[0])
        train = query.get("train", ["1"])[0] == "1"
        with lock:
            testbed.shall_train = train
            cm = cam.xform()
            if play["on"] and len(path.keyframes) >= 2:
                cm = np.asarray(path.eval_camera_path(play["t"]).matrix(), np.float32)
                play["t"] += play["dt"]
                if play["t"] >= 1.0:
                    play["t"] = 0.0
            out = testbed.frame(width=w, height=h, n_train_steps=n_train_steps if train else 0,
                                camera_matrix=cm, fov_deg=cam.fov)
            cam.last = {"resolution": out["resolution"], "frame_ms": out["frame_ms"],
                        "render_ms": out["render_ms"]}
        img = np.clip(np.asarray(out["image"]) * 255.0, 0, 255).astype(np.uint8)
        return encode_jpeg(img, FRAME_JPEG_QUALITY)

    def path_op(op) -> dict:
        if op == "add":
            path.keyframes.append(CameraKeyframe.from_matrix(cam.xform(), fov=cam.fov))
        elif op == "clear":
            path.keyframes.clear()
            play["on"] = False
        elif op == "play":
            play["on"], play["t"] = True, 0.0
        elif op == "stop":
            play["on"] = False
        return {"n_keyframes": len(path.keyframes), "playing": play["on"]}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, doc: dict):
            self._send(200, json.dumps(doc).encode(), "application/json")

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif u.path == "/state":
                self._json(state())
            elif u.path == "/histograms":
                with lock:
                    self._json(_histograms(testbed))
            elif u.path == "/path.json":
                self._send(200, path.to_json().encode(), "application/json")
            elif u.path == "/frame.jpg":
                self._send(200, frame(parse_qs(u.query)), "image/jpeg")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path == "/camera":
                upd = self._body()
                for k in ("yaw", "pitch", "radius", "fov"):
                    if k in upd:
                        setattr(cam, k, float(upd[k]))
                self._send(200, b"{}", "application/json")
            elif self.path == "/crop":
                upd = self._body()
                with lock:
                    if testbed.mode != "nerf":  # other modes 404, as in the GUI
                        self._send(404, b"nerf mode only", "text/plain")
                        return
                    testbed.render_aabb = (np.asarray(upd["min"], np.float32),
                                           np.asarray(upd["max"], np.float32))
                self._send(200, b"{}", "application/json")
            elif self.path == "/path":
                self._json(path_op(self._body().get("op")))
            else:
                self._send(404, b"not found", "text/plain")

    srv = HTTPServer((host, port), Handler)
    srv.viewer_camera = cam  # for tests and tools
    return srv


def serve(testbed, host: str = "127.0.0.1", port: int = 8080, **kw) -> None:
    srv = make_server(testbed, host, port, **kw)
    print(f"ngp_tpu_torch viewer on http://{host}:{srv.server_address[1]}/", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
