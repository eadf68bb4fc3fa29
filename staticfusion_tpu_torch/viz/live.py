"""Live during-run view: an in-process HTTP panel server (port of
staticfusion_tpu/viz/live.py).

The reference shows tracking/segmentation and the fused model live while
running (Utils/GUI.h:87-99 image panels, refreshed every frame from
FrontEnd.cpp:1148-1292) and reads confidence/depth-cutoff sliders back into
the run every frame (FrontEnd.cpp:1285-1286).  This serves the same six
panels (RGB, depth-norm, fused-model render, static-probability weights,
cluster labels, predicted ModelImg) plus live metrics over HTTP, and
exposes the reference's runtime controls: a confidence slider, a
depth-cutoff slider, and pause — `/set?conf=...&depth=...&pause=...` is
read back by the app's frame loop (`LiveViewer.params()`), so any browser
is the display and the control surface.

Panels are composed with NumPy (viz/offline.py), encoded by the port's PNG
encoder (io/png.py) and held in memory; a thread runs an `http.server`
that serves "/" (a self-refreshing page with the controls), "/frame.png",
"/metrics.json", "/params.json" and "/set".  `close()` stops the server
and joins its thread.
"""

from __future__ import annotations

import http.server
import json
import threading
import urllib.parse
from typing import Optional

import numpy as np

from staticfusion_tpu_torch.io.png import encode_png
from staticfusion_tpu_torch.viz.offline import compose_panels

__all__ = ["LiveViewer", "compose_panels"]

_PAGE = b"""<!doctype html>
<html><head><title>StaticFusion-TPU live</title>
<style>body{background:#111;color:#ddd;font-family:monospace;margin:1em}
img{image-rendering:pixelated;width:100%;max-width:1920px}
pre{color:#8c8}
.ctl{margin:0.5em 0}
.ctl label{display:inline-block;width:14em}
input[type=range]{width:20em;vertical-align:middle}
button{background:#333;color:#ddd;border:1px solid #555;padding:0.2em 1em}
</style></head>
<body><h3>StaticFusion-TPU live</h3>
<div class="ctl"><label>confidence threshold <span id="cv"></span></label>
<input type="range" id="conf" min="0" max="1" step="0.01"></div>
<div class="ctl"><label>depth cutoff (m) <span id="dv"></span></label>
<input type="range" id="depth" min="0.5" max="8" step="0.1"></div>
<div class="ctl"><button id="pause">pause</button></div>
<img id="f" src="/frame.png"><pre id="m"></pre>
<script>
let paused = false;
async function set(q){ try{ await fetch('/set?' + q); }catch(e){} }
async function initCtl(){
  const r = await fetch('/params.json');
  const p = await r.json();
  conf.value = p.conf; depth.value = p.depth; paused = p.pause;
  cv.textContent = p.conf; dv.textContent = p.depth;
  pause.textContent = paused ? 'resume' : 'pause';
}
conf.oninput = () => { cv.textContent = conf.value;
                       set('conf=' + conf.value); };
depth.oninput = () => { dv.textContent = depth.value;
                        set('depth=' + depth.value); };
pause.onclick = () => { paused = !paused;
                        pause.textContent = paused ? 'resume' : 'pause';
                        set('pause=' + (paused ? 1 : 0)); };
async function tick(){
  try{
    document.getElementById('f').src = '/frame.png?' + Date.now();
    const r = await fetch('/metrics.json');
    document.getElementById('m').textContent =
        JSON.stringify(await r.json(), null, 1);
  }catch(e){}
  setTimeout(tick, 500);
}
initCtl(); tick();
</script></body></html>
"""


class LiveViewer:
    """Start with `LiveViewer(port)`; call `update()` per (Nth) frame and
    `params()` to read back the browser-side controls."""

    def __init__(self, port: int = 8500, host: str = "127.0.0.1",
                 conf: float = 0.25, depth: float = 4.5):
        self._lock = threading.Lock()
        self._png: bytes = encode_png(np.zeros((2, 2, 3), np.uint8))
        self._metrics: bytes = b"{}"
        # Runtime controls, reference slider semantics
        # (FrontEnd.cpp:1285-1286): read back into the run loop each frame.
        self._params = {"conf": float(conf), "depth": float(depth),
                        "pause": False}
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                parsed = urllib.parse.urlparse(self.path)
                path = parsed.path
                if path == "/":
                    body, ctype = _PAGE, "text/html"
                elif path == "/frame.png":
                    with viewer._lock:
                        body, ctype = viewer._png, "image/png"
                elif path == "/metrics.json":
                    with viewer._lock:
                        body, ctype = viewer._metrics, "application/json"
                elif path in ("/params.json", "/set"):
                    q = urllib.parse.parse_qs(parsed.query)
                    with viewer._lock:
                        if path == "/set":
                            p = viewer._params
                            if "conf" in q:
                                p["conf"] = min(1.0, max(
                                    0.0, float(q["conf"][0])))
                            if "depth" in q:
                                p["depth"] = min(60.0, max(
                                    0.1, float(q["depth"][0])))
                            if "pause" in q:
                                p["pause"] = q["pause"][0] in (
                                    "1", "true", "on")
                        body = json.dumps(viewer._params).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]  # resolved if port=0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def params(self) -> dict:
        """Current browser-side control values (thread-safe copy)."""
        with self._lock:
            return dict(self._params)

    def update(self, rgb: np.ndarray, depth_mm: np.ndarray, out,
               model: Optional[np.ndarray] = None,
               model_img: Optional[np.ndarray] = None,
               **metrics) -> None:
        """Publish the current frame's panels + metrics (arrays, or tensors
        on any device; `out` is a StepOutputs with static_prob/labels,
        either may be None pre-bootstrap; `model`/`model_img` are optional
        uint8 renders of the fused map and the predicted view)."""
        png = encode_png(compose_panels(
            rgb, depth_mm, getattr(out, "static_prob", None),
            getattr(out, "labels", None), model=model, model_img=model_img))
        blob = json.dumps(metrics).encode()
        with self._lock:
            self._png = png
            self._metrics = blob

    def close(self) -> None:
        """Stop serving, close the socket and join the server thread."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
