"""The port's demo app and its parts vs the JAX package.

``update_scene`` against JAX's at several (dt, t), leaf by leaf within
1e-5 relative (float32 cos/sin of the same float32 arguments, planet
positions up to 35,000 units); its pose program (``Recorder``'s eager
piece on the CPU) against the eager ``_pose`` bit for bit, a fresh scene
at each call and the input untouched, the eager route of a tensor ``t``
or a leaf that wants a gradient with that gradient, the tracer's pose
counters; ``parse_flight`` against JAX's; a
``FlyCamera`` key and mouse sequence against JAX's, position and
quaternion within 1e-6; the port's PNG writer and reader against PIL (in
both directions, every PNG filter type); ``main(["--device", "cpu",
...])`` at 32×18 for 2 frames writing a PNG and a GIF.
"""

import dataclasses
import io
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from txr.apps import demo as jdemo
from txr.scene.camera import FlyCamera as JFlyCamera
from txr_torch import bridge
from txr_torch.apps import demo as tdemo
from txr_torch.scene.camera import FlyCamera
from txr_torch.utils import image, profiling

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dt,t", [(1 / 30, 60.0), (0.25, 0.0), (0.01, 1234.5)])
def test_update_scene_matches_jax(dt, t):
    jscene, jh = jdemo.build_scene(8, 8)
    tscene, th = tdemo.build_scene(8, 8)
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    want = _jax_leaves(jdemo.update_scene(jscene, jh, dt, t))
    before = bridge.scene_to_numpy(tscene)
    got = bridge.scene_to_numpy(tdemo.update_scene(tscene, th, dt, t))
    assert sorted(got) == sorted(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        moved += not np.array_equal(got[k], before[k])
    assert moved == 5            # spheres.pos, spheres.quat, rings.pos, boxes.quat, toruses.quat
    np.testing.assert_array_equal(bridge.scene_to_numpy(tscene)[".spheres.pos"],
                                  before[".spheres.pos"])         # out of place


def _eager_pose(scene, handles, dt, t):
    """The eager ``_pose`` of the scene's leaves → the posed leaves."""
    flat = tdemo._pose_eagerly(tdemo._pose_leaves(scene), handles, dt, t, scene.device)
    return tdemo._pose_leaves(tdemo._with_posed(scene, flat))


@pytest.mark.parametrize("dt,t", [(1 / 30, 60.0), (0.25, 0.0), (0.01, 1234.5)])
def test_pose_program_matches_eager_pose(dt, t):
    scene, h = tdemo.build_scene(8, 8)
    got = tdemo.update_scene(scene, h, dt, t)
    prog = tdemo._POSE
    assert prog is not None and prog.leaves[0] is scene.spheres.pos
    for a, b in zip(tdemo._pose_leaves(got), _eager_pose(scene, h, dt, t)):
        assert torch.equal(a, b)
    # the same input scene keeps its program; another pose replays it
    tdemo.update_scene(scene, h, dt, t + 1.0)
    assert tdemo._POSE is prog


def test_poses_are_fresh_and_leave_the_input_untouched():
    scene, h = tdemo.build_scene(8, 8)
    before = bridge.scene_to_numpy(scene)
    first = tdemo.update_scene(scene, h, 1 / 30, 60.0)
    kept = [x.clone() for x in tdemo._pose_leaves(first)]
    second = tdemo.update_scene(scene, h, 1 / 30, 60.5)
    for a, b, k in zip(tdemo._pose_leaves(first), tdemo._pose_leaves(second), kept):
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
        assert torch.equal(a, k)                  # the second pose wrote elsewhere
    assert not torch.equal(first.spheres.pos, second.spheres.pos)
    assert first.camera is scene.camera and first.planes is scene.planes
    after = bridge.scene_to_numpy(scene)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)


def _orbit_grad(t):
    """d/dt of the sum of the spheres' positions (float64)."""
    a = [(0.02, 0.0, 20000.0), (0.0082, 1.0, 35000.0), (0.05, 0.5, 10000.0)]
    d = sum(r * w * (np.cos(w * t + o) - np.sin(w * t + o)) for w, o, r in a)
    return d + 3000.0 * 0.05 * np.sin(0.05 * t)


@pytest.mark.parametrize("route", ["tensor_t", "grad_leaf"])
def test_tensor_or_gradient_poses_eagerly(route):
    scene, h = tdemo.build_scene(8, 8)
    tdemo._POSE = None
    if route == "tensor_t":
        t = torch.tensor(60.0, dtype=torch.float32, requires_grad=True)
        got = tdemo.update_scene(scene, h, 1 / 30, t)
        got.spheres.pos.sum().backward()
        np.testing.assert_allclose(float(t.grad), _orbit_grad(60.0), rtol=1e-4)
    else:
        q = scene.spheres.quat.clone().requires_grad_()
        leafy = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, quat=q))
        got = tdemo.update_scene(leafy, h, 1 / 30, 60.0)
        for a, b in zip(tdemo._pose_leaves(got), _eager_pose(scene, h, 1 / 30, 60.0)):
            assert torch.equal(a.detach(), b)
        got.spheres.quat.sum().backward()
        # a still row passes its gradient on whole; a spun one through the spin
        still = [i for i in range(len(q)) if i not in (h.jupiter, h.saturn, h.mars)]
        assert torch.equal(q.grad[still], torch.ones_like(q.grad[still]))
        assert not torch.equal(q.grad[h.saturn], torch.ones(4))
    assert got.spheres.pos.grad_fn is not None and tdemo._POSE is None


def test_pose_counters():
    scene, h = tdemo.build_scene(8, 8)
    was = profiling.tracing(True)
    profiling.reset()
    try:
        for t in (60.0, 60.5, torch.tensor(61.0)):
            tdemo.update_scene(scene, h, 0.0, t)
        with profiling.unit("txr.frame"):
            pass
        counters = profiling.records()[-1]["counters"]
    finally:
        profiling.tracing(was)
        profiling.reset()
    # every pose counted; on the CPU none is a graph replay
    assert counters["poses"] == [1, 1, 1] and "pose_replays" not in counters


def test_parse_flight_matches_jax():
    for script in ("w:3, wd:2:4:0, _:2:0:-2", "s:1,,a:2:1.5", " d:0 , _:1 "):
        assert tdemo.parse_flight(script) == jdemo.parse_flight(script)
    assert tdemo.parse_flight("wd:2:4:0") == [("wd", 4.0, 0.0)] * 2


def test_fly_camera_matches_jax():
    cams = [FlyCamera(position=(0.0, 0.0, -5.0)), JFlyCamera(position=(0.0, 0.0, -5.0))]
    seq = [("w", True, 0, 0), (None, None, 40, 10), ("d", True, 0, 0), ("shift", True, 0, 0),
           ("w", False, -15, 2000), ("space", True, 0, 0), ("alt", True, 5, -30),
           ("d", False, 0, 0), ("a", True, 0, 0), ("ctrl", True, 0, 0), ("s", True, 0, 0)]
    pitches = []
    for name, pressed, dx, dy in seq:
        for cam in cams:
            if name:
                cam.key(name, pressed)
            if dx or dy:
                cam.mouse(dx, dy)
            cam.update(1 / 30)
        got, want = cams
        np.testing.assert_allclose(got.position, want.position, rtol=1e-12)
        assert got.pitch == want.pitch and got.yaw == want.yaw
        np.testing.assert_allclose(got.quat.numpy(), np.asarray(want.quat), atol=1e-6)
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=1e-7)
        pitches.append(got.pitch)
    assert 89.0 in pitches                            # clamped
    scene, _ = tdemo.build_scene(8, 8)
    moved = cams[0].apply(scene)
    assert torch.equal(moved.camera.quat, cams[0].quat) and moved.spheres is scene.spheres


def _filtered_png(arr, filters):
    """A PNG of ``arr`` [H,W,C] uint8 whose row y uses filter filters[y % 5]."""
    h, w, c = arr.shape
    raw, prev = b"", np.zeros(w * c, np.int32)
    for y in range(h):
        cur = arr[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        ft = filters[y % len(filters)]
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - left
        elif ft == 2:
            f = cur - prev
        elif ft == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([ft]) + (f & 255).astype(np.uint8).tobytes()
        prev = cur
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d
                          + struct.pack(">I", zlib.crc32(k + d)))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trip_through_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (11, 7, channels), dtype=np.uint8)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    # the port writes, PIL reads
    got = np.asarray(Image.open(io.BytesIO(image.png_bytes(arr))).convert(mode))
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)
    # every filter type, read by the port and by PIL
    data = _filtered_png(arr, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(image.png_decode(data), arr)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert(mode)).reshape(arr.shape)
    np.testing.assert_array_equal(pil, arr)
    # PIL writes (its own filter choice), the port reads; load_image gives RGBA floats
    path = str(tmp_path / "x.png")
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(path, optimize=True)
    rgba = image.load_image(path)
    want = np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0
    assert rgba.shape == (11, 7, 4)
    np.testing.assert_allclose(rgba, want, atol=1e-7)
    # a float image through save_png: to_uint8 rounds as the JAX package's
    img = rng.uniform(-0.1, 1.1, (5, 6, 3)).astype(np.float32)
    image.save_png(path, torch.from_numpy(img))
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  (np.clip(img.astype(np.float64), 0, 1) * 255 + 0.5)
                                  .astype(np.uint8))


@pytest.mark.parametrize("out", ["demo.png", "demo.gif"])
def test_main_writes_png_and_gif(tmp_path, capsys, out):
    path = str(tmp_path / out)
    frames = str(tmp_path / "frames")
    res = tdemo.main(["--device", "cpu", "--width", "32", "--height", "18", "--frames", "2",
                      "--iterations", "2", "--fly", "w:1, wd:1:4:0", "--out", path,
                      "--frames-dir", frames])
    printed = capsys.readouterr().out
    assert printed.count(" FPS (") == 2 and "rays/s" in printed and f"wrote {path}" in printed
    img = Image.open(path)
    assert img.size == (32, 18)
    if out.endswith(".gif"):
        assert img.n_frames == 2
    else:
        np.testing.assert_array_equal(np.asarray(img), image.to_uint8(res["img"]))
    assert sorted(os.listdir(frames)) == ["frame_00000.png", "frame_00001.png"]
    assert res["img"].shape == (18, 32, 3) and torch.isfinite(res["img"]).all()
    assert len(res["fps"]) == 2
