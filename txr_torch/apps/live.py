"""Interactive live viewer (txr/apps/live.py; the reference's windowed loop,
main.cpp:162-191, and its GLFW input, SceneManager.cpp:76-135), for a
headless host with a card:

  * frames stream to a browser as MJPEG over HTTP on 127.0.0.1 (GET / for
    the viewer page, /stream for the multipart stream);
  * WASD/mouse-look input comes back on the same socket (the page posts
    key and pointer events to /input) and drives a ``FlyCamera``;
  * each frame is the animated demo scene (``apps.demo.update_scene``) with
    the camera's pose written in, rendered by ``render_jit`` (the frame's
    CUDA graphs are captured once, before the server starts, and replayed;
    only this loop's thread touches the card) and converted to uint8 on the
    card.

Frames are pipelined: frame N+1 is converted to u8 on the card and started
before frame N, already copied to pinned host memory, is JPEG-encoded and
streamed.

    python -m txr_torch.apps.live --width 480 --height 270 [--device cpu]

then open the printed URL (``ssh -L`` the port when the host is remote).
Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from txr_torch import resolve_device

_PAGE = """<!doctype html>
<html><head><title>txr live</title><style>
 body { background:#111; color:#ccc; font-family:monospace; text-align:center }
 img { image-rendering:pixelated; width:75vw; outline:none }
</style></head>
<body>
<h3>txr live viewer &mdash; click the image, then WASD/space/ctrl + drag to look, shift = fast</h3>
<img id="v" src="/stream" tabindex="0">
<div id="s"></div>
<script>
const v = document.getElementById('v');
const keys = {};
let dragging = false, lastx = 0, lasty = 0;
function post(o) { fetch('/input', {method:'POST', body: JSON.stringify(o)}); }
setInterval(() => { post({keys: Object.keys(keys).filter(k => keys[k])}); }, 50);
window.addEventListener('keydown', e => { keys[e.key.toLowerCase()] = true; });
window.addEventListener('keyup',   e => { keys[e.key.toLowerCase()] = false; });
v.addEventListener('mousedown', e => { dragging = true; lastx = e.clientX; lasty = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  post({look: [e.clientX - lastx, e.clientY - lasty]});
  lastx = e.clientX; lasty = e.clientY;
});
</script></body></html>"""

# browser keys onto the reference's GLFW bindings (SceneManager.cpp:76-101:
# WASD move, space up, ctrl down, shift fast, alt slow)
KEY_MAP = {"w": "w", "a": "a", "s": "s", "d": "d", " ": "space", "control": "ctrl",
           "shift": "shift", "alt": "alt"}
ALL_KEYS = ("w", "a", "s", "d", "space", "ctrl", "shift", "alt")


class _State:
    """What the render loop and the HTTP handlers share: the latest JPEG,
    the pressed keys, the accumulated mouse deltas; ``closed`` once the
    loop ends, so streaming handlers return."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.frame = b""          # latest JPEG bytes
        self.keys = set()
        self.look = [0.0, 0.0]    # accumulated mouse deltas
        self.fps = 0.0
        self.closed = False

    def put(self, jpg):
        with self.cond:
            self.frame = jpg
            self.cond.notify_all()

    def get(self, timeout=1.0):
        """The next frame, or b"" after ``timeout`` s; None once closed."""
        with self.cond:
            self.cond.wait(timeout)
            return None if self.closed else self.frame

    def close(self):
        with self.cond:
            self.closed = True
            self.cond.notify_all()


def _make_handler(state: _State):
    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/stream":
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while True:
                        jpg = state.get()
                        if jpg is None:
                            return
                        if not jpg:
                            continue
                        self.wfile.write(b"--frame\r\n")
                        self.send_header("Content-Type", "image/jpeg")
                        self.send_header("Content-Length", str(len(jpg)))
                        self.end_headers()
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return
            else:
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        def do_POST(self):
            if self.path != "/input":
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                msg = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                msg = {}
            with state.lock:
                if "keys" in msg:
                    state.keys = set(msg["keys"])
                if "look" in msg:
                    state.look[0] += float(msg["look"][0])
                    state.look[1] += float(msg["look"][1])
            self.send_response(204)
            self.end_headers()

    return H


def _encode_jpeg(img, quality=85):
    """[H, W, 3] uint8 (or float in [0, 1]) numpy image → JPEG bytes (PIL)."""
    from PIL import Image

    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _to_host(u8):
    """Start the copy of a frame to the host → (host tensor, event to wait
    on, None on the CPU).  On the card the copy goes to pinned memory
    without blocking, queued behind the frame's own work."""
    if u8.device.type != "cuda":
        return u8, None
    host = torch.empty(u8.shape, dtype=u8.dtype, pin_memory=True)
    host.copy_(u8, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def main(argv=None):
    """Serve the viewer until ``--max-seconds`` pass (0: until interrupted)
    → dict(frames, seconds, fps, port, camera: the final camera position)."""
    ap = argparse.ArgumentParser(description="txr_torch live MJPEG viewer")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--port", type=int, default=8787, help="0: any free port")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--no-animate", action="store_true")
    ap.add_argument("--max-seconds", type=float, default=0,
                    help="exit after this many seconds (0 = run forever)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from txr_torch.apps.demo import build_scene, demo_textures, update_scene
    from txr_torch.render.render import render_jit
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig, auto_refraction_steps
    from txr_torch.scene.camera import FlyCamera

    dev = resolve_device(args.device)
    scene0, handles = build_scene(args.width, args.height)
    scene0 = scene0.to(dev)
    # the atlas and mip pyramids, built once at load (glGenerateMipmap)
    textures = with_mips(demo_textures().to(dev))
    iters = args.iterations if args.iterations is not None else scene0.reflect_depth
    cfg = RenderConfig(width=args.width, height=args.height, iterations=iters,
                       extra_refraction_steps=auto_refraction_steps(scene0))

    def frame(t, cam):
        s = scene0 if args.no_animate else update_scene(scene0, handles, 0.0, t)
        with torch.no_grad():
            img = render_jit(cam.apply(s), textures, cfg, device=dev)
            return (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    cam = FlyCamera(position=tuple(scene0.camera.pos.tolist()))
    # the first frame captures render_jit's graphs, before any HTTP thread runs
    frame(0.0, cam)
    state = _State()
    server = ThreadingHTTPServer(("127.0.0.1", args.port), _make_handler(state))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"live viewer: http://127.0.0.1:{port}/  ({args.width}x{args.height}, "
          f"{cfg.max_steps}-step budget, {dev})", flush=True)

    t0 = time.time()
    frames, last, fps = 0, t0, 0.0
    pending = None   # frame N on its way to the host while frame N+1 renders
    try:
        while True:
            now = time.time()
            dt, last = now - last, now
            with state.lock:
                pressed = {KEY_MAP[k] for k in state.keys if k in KEY_MAP}
                dx, dy = state.look
                state.look[0] = state.look[1] = 0.0
            # browser y grows downward; the reference's mouse dy looks up
            # (SceneManager.cpp:110-135)
            cam.mouse(dx, -dy)
            for k in ALL_KEYS:
                cam.key(k, k in pressed)
            cam.update(dt)
            new = frame(0.0 if args.no_animate else now - t0, cam)
            if pending is not None:
                host, done = pending
                if done is not None:
                    done.synchronize()
                state.put(_encode_jpeg(host.numpy()))
                frames += 1
            pending = _to_host(new)
            fps = 0.9 * fps + 0.1 / max(dt, 1e-6) if frames > 1 else 1.0 / max(dt, 1e-6)
            state.fps = fps
            if frames and frames % 30 == 0:
                print(f"  {frames} frames, {fps:.1f} FPS", flush=True)
            if args.max_seconds and now - t0 > args.max_seconds:
                break
    except KeyboardInterrupt:
        pass
    finally:
        state.close()
        server.shutdown()
        server.server_close()
    el = time.time() - t0
    print(f"live viewer: {frames} frames in {el:.1f}s = {frames / max(el, 1e-6):.1f} FPS avg",
          flush=True)
    return dict(frames=frames, seconds=el, fps=frames / max(el, 1e-6), port=port,
                camera=cam.position)


if __name__ == "__main__":
    main()
