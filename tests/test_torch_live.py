"""The port's live MJPEG viewer (txr_torch/apps/live.py), on the CPU.

One run of ``main`` at 32×18 with ``--device cpu --max-seconds`` on a free
port of 127.0.0.1, driven by a client in this process: the viewer page
comes back on GET /, a POST of the key "w" to /input moves the fly camera
forward (+z from the demo's start pose), and one part of /stream is a JPEG
that decodes to (18, 32, 3).  The JPEG encoder gives the JAX package's
bytes for the same u8 image (both go through PIL at quality 85).
"""

import http.client
import io
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from txr.apps import live as jlive
from txr_torch.apps import live as tlive

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

W, H = 32, 18


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connect(port, deadline):
    while True:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.connect()
            return conn
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def _read_part(resp):
    """One part of a multipart/x-mixed-replace body → its bytes."""
    while resp.readline().strip() != b"--frame":
        pass
    headers = {}
    while True:
        line = resp.readline().strip()
        if not line:
            break
        k, v = line.decode().split(":", 1)
        headers[k.strip().lower()] = v.strip()
    assert headers["content-type"] == "image/jpeg"
    return resp.read(int(headers["content-length"]))


@pytest.fixture(scope="module")
def session():
    port = _free_port()
    out = {}
    run = threading.Thread(target=lambda: out.update(result=tlive.main(
        ["--width", str(W), "--height", str(H), "--device", "cpu", "--port", str(port),
         "--max-seconds", "4"])))
    run.start()
    try:
        conn = _connect(port, time.monotonic() + 120)
        conn.request("POST", "/input", body=json.dumps({"keys": ["w"]}))
        out["post_status"] = conn.getresponse().status
        conn.request("GET", "/")
        resp = conn.getresponse()
        out["page"] = (resp.status, resp.read().decode())
        conn.close()
        conn = _connect(port, time.monotonic() + 10)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        out["stream_type"] = resp.getheader("Content-Type")
        out["jpeg"] = _read_part(resp)
        conn.close()
    finally:
        run.join(120)
    assert not run.is_alive()
    return out


def test_stream_serves_a_decodable_jpeg(session):
    assert session["stream_type"] == "multipart/x-mixed-replace; boundary=frame"
    img = np.asarray(Image.open(io.BytesIO(session["jpeg"])))
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    assert session["result"]["frames"] >= 1


def test_input_key_moves_the_camera(session):
    assert session["post_status"] == 204
    x, y, z = session["result"]["camera"]
    assert z > -5.0 and (x, y) == (0.0, 0.0), (x, y, z)


def test_viewer_page(session):
    status, body = session["page"]
    assert status == 200 and 'src="/stream"' in body and "/input" in body


def test_encode_jpeg_matches_jax():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    assert tlive._encode_jpeg(u8) == jlive._encode_jpeg(u8)
    f = rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)
    assert tlive._encode_jpeg(f) == jlive._encode_jpeg(f)
