"""Live interactive session: the progressive viewer of the reference.

The reference is an interactive browser app — canvas blit + drag-to-pan
(``src_ts/client/render_target.ts:63-149``), key-driven camera wired
into the running worker loop (``src_ts/client/index.ts:66-76``),
settings switchable mid-run (``src_ts/worker/worker.ts:154-168``),
pause/resume (``worker.ts:191-209``).  This module recreates that as:

- :class:`LiveSession` — the control surface: a background render
  thread steps the :class:`Driver` continuously; every control mutation
  (camera keys, scene/settings switches, viewport, pause/resume) is
  DEFERRED and applied at the top of the next tick, the reference's
  eventual-consistency pattern (``worker.ts:61-69,133-144``).  The
  latest frame is cached as PNG bytes after each step (the analog of
  the SharedArrayBuffer blit, ``worker.ts:84-86``).
- :class:`LiveServer` — a dependency-free HTTP streamer
  (``http.server``) serving a one-page viewer: the browser polls
  ``/frame.png`` and posts keys/controls back, replacing the Elm
  panels with query endpoints.

Usage:  python -m wasm_pathtracer_tpu.runtime.live --scene 100 --port 8000
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from wasm_pathtracer_tpu.config import RenderSettings, RenderType
from wasm_pathtracer_tpu.models.camera import initial_camera
from wasm_pathtracer_tpu.runtime.camera_controller import CameraController
from wasm_pathtracer_tpu.runtime.driver import Driver
from wasm_pathtracer_tpu.runtime.session import Session
from wasm_pathtracer_tpu.utils.png import encode_png


class LiveSession:
    """Driver + CameraController + frame cache behind a control queue.

    All session mutations run on the render thread (device buffers are
    donated between steps, so cross-thread mutation would race); control
    calls enqueue and return immediately.
    """

    def __init__(self, session: Session, target_tick: float = 0.05):
        self.session = session
        self.driver = Driver(session, on_frame=self._capture,
                             target_tick=target_tick)
        self.controller = CameraController(
            session.camera, on_update=self._on_camera)
        self.paused = False
        self.show_sampling = False
        # drag-to-pan state: offset of the render target within the
        # fixed on-screen window (``render_target.ts:63-149``).  Pure
        # view state — never touches the session, so it mutates
        # synchronously under the lock (the reference likewise pans on
        # the main thread without involving the worker).
        self.window_w = 512
        self.window_h = 512
        self.pan_x = 0
        self.pan_y = 0
        self._pending = []                 # deferred control closures
        self._lock = threading.Lock()
        self._frame_png: bytes = b""
        self._frame_id = 0
        self._alive = False
        self._thread: threading.Thread | None = None
        self._capture(session)

    # -- render thread ------------------------------------------------
    def start(self):
        self._alive = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._alive = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self):
        while self._alive:
            self.tick()

    def tick(self):
        """One render step (or an idle pause beat) + pending controls.
        Public so tests can drive the loop synchronously."""
        with self._lock:
            pending, self._pending = self._pending, []
        for fn in pending:
            fn(self.session)
        if self.paused:
            # pause preserves accumulation (worker.ts:191-209)
            time.sleep(0.02)
            return 0.0
        return self.driver.step()

    def _capture(self, session: Session):
        png = encode_png(session.results(show_sampling=self.show_sampling))
        with self._lock:
            self._frame_png = png
            self._frame_id += 1

    # -- frames ---------------------------------------------------------
    def frame_png(self) -> bytes:
        with self._lock:
            return self._frame_png

    # -- controls (all deferred to the next tick) -----------------------
    def _defer(self, fn):
        with self._lock:
            self._pending.append(fn)

    def _on_camera(self, cam):
        self._defer(lambda s: s.update_camera(
            tuple(np.asarray(cam.location, np.float32)),
            float(cam.rot_x), float(cam.rot_y)))

    def key(self, name: str, count: int = 1):
        """Camera key (WASD/arrows/pageup/pagedown), reference step sizes
        (``camera_controller.ts:47-88``).  Deferred: HTTP handler threads
        must not mutate controller state while the render thread reads
        it (concurrent /key requests would lose updates)."""
        self._defer(lambda s: self.controller.key(name, count))

    def pause(self):
        self._defer(lambda s: setattr(self, "paused", True))

    def resume(self):
        # applied in tick()'s pending sweep, which runs even while
        # paused — so resume always takes effect on the next tick
        self._defer(lambda s: setattr(self, "paused", False))

    def set_scene(self, scene_id: int):
        def apply(s: Session):
            s.update_scene(scene_id)
            cam = initial_camera(scene_id)
            s.camera = cam
            self.controller.set_silent(cam)
        self._defer(apply)

    def set_settings(self, left: RenderSettings, right: RenderSettings):
        """Mid-run estimator/sampler switch — restart-from-scratch
        semantics like ``update_settings`` (``wasm_interface.rs:173-204``)."""
        self._defer(lambda s: s.update_settings(left, right))

    def set_viewport(self, width: int, height: int):
        def apply(s: Session):
            s.update_viewport(width, height)
            # a resized target must stay inside the window
            # (``CanvasElement.updateTarget`` -> ``reclamp``)
            with self._lock:
                self._reclamp_locked()
        self._defer(apply)

    # -- drag-to-pan (``CanvasElement``, render_target.ts:63-149) -------
    def _reclamp_locked(self):
        """Reference ``reclamp`` semantics: a target smaller than the
        window is bounded WITHIN the window; a larger target must fully
        occupy it (no background visible past an edge)."""
        tw, th = self.session.width, self.session.height
        if tw < self.window_w:
            self.pan_x = min(max(self.pan_x, 0), self.window_w - tw)
        else:
            self.pan_x = min(max(self.pan_x, self.window_w - tw), 0)
        if th < self.window_h:
            self.pan_y = min(max(self.pan_y, 0), self.window_h - th)
        else:
            self.pan_y = min(max(self.pan_y, self.window_h - th), 0)

    def pan(self, dx: int, dy: int) -> tuple[int, int]:
        """Drag the render target by (dx, dy) inside the window,
        reclamped; returns the new offsets (the reference's mousemove
        accumulation, ``render_target.ts:91-102``)."""
        with self._lock:
            self.pan_x += int(dx)
            self.pan_y += int(dy)
            self._reclamp_locked()
            return self.pan_x, self.pan_y

    def recenter(self) -> tuple[int, int]:
        """Center the target in the window (``render_target.ts:116-122``)."""
        with self._lock:
            self.pan_x = round((self.window_w - self.session.width) / 2)
            self.pan_y = round((self.window_h - self.session.height) / 2)
            return self.pan_x, self.pan_y

    def set_show_sampling(self, flag: bool):
        self._defer(lambda s: setattr(self, "show_sampling", bool(flag)))

    def status(self) -> dict:
        return dict(paused=self.paused,
                    total_ticks=self.driver.total_ticks,
                    ticks_per_step=self.driver.ticks_per_step,
                    frame_id=self._frame_id,
                    width=self.session.width, height=self.session.height,
                    scene=self.session.scene_id,
                    bvh_visits=self.session.num_bvh_hits,
                    pan_x=self.pan_x, pan_y=self.pan_y)


_PAGE = """<!doctype html><html><head><title>wasm_pathtracer_tpu</title>
<style>body{background:#111;color:#ccc;font-family:monospace}
img{image-rendering:pixelated;position:absolute;left:0;top:0}
#win{position:relative;overflow:hidden;width:512px;height:512px;
border:1px solid #444;background:#3e3e3e;cursor:grab}</style></head><body>
<h3>wasm_pathtracer_tpu &mdash; live</h3>
<div id=win><img id=v draggable=false></div>
<button onclick="fetch('/pause')">pause</button>
<button onclick="fetch('/resume')">resume</button>
<button onclick="pan('/recenter')">recenter</button>
scene:<select id=sc onchange="fetch('/scene?id='+this.value)">
<option value=0>museum</option><option value=2>bunny</option>
<option value=3>cloud100</option><option value=4>cloud10k</option>
<option value=5>cloud100k</option>
<option value=100 selected>sphere+plane</option>
<option value=101>whitted</option></select>
left:<select id=lt onchange="st()"><option value=0>NoNEE</option>
<option value=1 selected>NEE</option><option value=2>PNEE</option></select>
right:<select id=rt onchange="st()"><option value=0>NoNEE</option>
<option value=1 selected>NEE</option><option value=2>PNEE</option></select>
<label><input id=ra type=checkbox onchange="st()">right adaptive</label>
<span id=stat></span>
<script>
function st(){fetch('/settings?left='+lt.value+'&right='+rt.value+
  '&right_adaptive='+(ra.checked?1:0))}
// drag-to-pan (reference CanvasElement, render_target.ts:63-149):
// deltas accumulate client-side and drain through ONE in-flight
// request at a time — per-mousemove fetches would race (out-of-order
// responses apply stale offsets) and flood the server
async function pan(url){const r=await(await fetch(url)).json();
  v.style.left=r.x+'px';v.style.top=r.y+'px'}
let down=false,pdx=0,pdy=0,panning=false;
async function flushPan(){if(panning)return;panning=true;
  try{while(pdx||pdy){const dx=pdx,dy=pdy;pdx=0;pdy=0;
    await pan('/pan?dx='+dx+'&dy='+dy)}}finally{panning=false}}
win.addEventListener('mousedown',e=>{down=true;e.preventDefault()});
document.addEventListener('mouseup',()=>{down=false});
document.addEventListener('mousemove',e=>{
  if(down&&(e.buttons&1)){pdx+=e.movementX;pdy+=e.movementY;flushPan()}});
const KEYS={w:'w',a:'a',s:'s',d:'d',ArrowLeft:'left',ArrowRight:'right',
  ArrowUp:'up',ArrowDown:'down',PageUp:'pageup',PageDown:'pagedown'};
document.addEventListener('keydown',e=>{const k=KEYS[e.key];
  if(k){fetch('/key?k='+k+'&n=10');e.preventDefault()}});
setInterval(()=>{v.src='/frame.png?'+Date.now()},250);
setInterval(async()=>{const r=await(await fetch('/status')).json();
  stat.textContent=' ticks:'+r.total_ticks+(r.paused?' [paused]':'')},1000);
</script></body></html>"""


class LiveServer:
    """Tiny stdlib HTTP front-end over a :class:`LiveSession`."""

    def __init__(self, live: LiveSession, host: str = "127.0.0.1",
                 port: int = 8000):
        self.live = live
        live_ref = live

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _ok(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                p = u.path
                if p == "/":
                    return self._ok(_PAGE.encode(), "text/html")
                if p == "/frame.png":
                    return self._ok(live_ref.frame_png(), "image/png")
                if p == "/status":
                    return self._ok(json.dumps(live_ref.status()).encode(),
                                    "application/json")
                if p == "/pan":
                    x, y = live_ref.pan(int(q.get("dx", 0)),
                                        int(q.get("dy", 0)))
                    return self._ok(json.dumps({"x": x, "y": y}).encode(),
                                    "application/json")
                if p == "/recenter":
                    x, y = live_ref.recenter()
                    return self._ok(json.dumps({"x": x, "y": y}).encode(),
                                    "application/json")
                if p == "/key":
                    live_ref.key(q.get("k", ""), int(q.get("n", 1)))
                elif p == "/pause":
                    live_ref.pause()
                elif p == "/resume":
                    live_ref.resume()
                elif p == "/scene":
                    live_ref.set_scene(int(q.get("id", 0)))
                elif p == "/viewport":
                    live_ref.set_viewport(int(q["w"]), int(q["h"]))
                elif p == "/sampling":
                    live_ref.set_show_sampling(q.get("on", "1") == "1")
                elif p == "/settings":
                    def rs(key, akey):
                        return RenderSettings(
                            render_type=RenderType(int(q.get(key, 1))),
                            adaptive=q.get(akey, "0") == "1")
                    live_ref.set_settings(rs("left", "left_adaptive"),
                                          rs("right", "right_adaptive"))
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                return self._ok(b"ok", "text/plain")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", type=int, default=100)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-bounces", type=int, default=8)
    args = p.parse_args(argv)

    from wasm_pathtracer_tpu.runtime import compile_cache
    compile_cache.enable()
    st = RenderSettings(render_type=RenderType.NORMAL_NEE,
                        max_bounces=args.max_bounces)
    sess = Session(args.width, args.height, args.scene, left=st, right=st)
    live = LiveSession(sess)
    server = LiveServer(live, port=args.port)
    server.start()
    live.start()
    print(f"live viewer on http://127.0.0.1:{server.port}/ "
          f"(WASD + arrows to move, scene/estimator switch in the page)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        live.stop()
        server.stop()


if __name__ == "__main__":
    main()
