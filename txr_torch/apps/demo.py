"""The solar-system demo (txr/apps/demo.py, after main.cpp:43-246).

The scene: three shaded spheres, three textured planets, Saturn's ring, a
floor and a crate box, a torus, a cone and a cylinder quadric, a point and
a directional light.  The textures are procedural, made with the same numpy
seeds as the JAX package, so the two texture sets are bit-identical; a
directory of texture files can replace any of them.  ``update_scene``
animates it (planet orbits and spins, the ring following Saturn, the
crate's tumble, the torus's spin), and ``main`` renders an animation,
optionally flown by a scripted ``FlyCamera``.

    python -m txr_torch.apps.demo --width 640 --height 360 --frames 30 \
        [--aa ultra] [--fly 'w:20, wd:10:4:0'] [--out demo.gif] \
        [--device cpu] [--fused off]

Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import numbers
import os
import time

import numpy as np
import torch

from txr_torch import resolve_device
from txr_torch.geometry import quaternion as quat
from txr_torch.render.graphs import Recorder
from txr_torch.render.texture import TextureSet
from txr_torch.scene import surface_factory as sf
from txr_torch.scene.factories import SceneBuilder
from txr_torch.utils.profiling import count, span

SATURN_RADIUS = 4150.0
SATURN_PITCH = quat.from_euler([math.radians(15.0), 0.0, 0.0])


def _rgba(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _banded_planet(h, w, bands, base, alt, seed):
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    phase = rng.uniform(0, 2 * np.pi, 3)
    mix = 0.5 + 0.5 * np.sin(bands * 2 * np.pi * y + phase[0])
    mix += 0.15 * np.sin(3.1 * bands * 2 * np.pi * y + phase[1])
    mix = np.clip(mix, 0, 1)
    rgb = np.asarray(base) * (1 - mix[..., None]) + np.asarray(alt) * mix[..., None]
    rgb = np.broadcast_to(rgb, (h, w, 3)).copy()
    rgb += rng.normal(0, 0.01, (h, w, 3))
    a = np.ones((h, w, 1))
    return _rgba(np.clip(np.concatenate([rgb, a], -1), 0, 1))


def _ring_texture(h, w):
    """Radial bands with alpha gaps; u = normalised (r²−r1)/(r2−r1)."""
    rng = np.random.default_rng(7)
    u = np.linspace(0, 1, w)[None, :]
    color = 0.55 + 0.25 * np.sin(40 * np.pi * u) + rng.normal(0, 0.02, (1, w))
    alpha = np.clip(0.8 + 0.4 * np.sin(23 * np.pi * u + 1.3), 0, 1) * (u > 0.02)
    rgb = np.broadcast_to(color[..., None] * np.array([1.0, 0.9, 0.75]), (h, w, 3))
    a = np.broadcast_to(alpha[..., None], (h, w, 1))
    return _rgba(np.clip(np.concatenate([rgb, a], -1), 0, 1))


def _crate_texture(h, w):
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    border = (np.minimum.reduce([xx, 1 - xx, yy, 1 - yy]) < 0.08).astype(float)
    planks = 0.5 + 0.2 * np.sin(6 * np.pi * yy)
    rgb = np.stack([0.55 + 0.2 * planks, 0.35 + 0.15 * planks, 0.15 + 0.05 * planks], -1)
    border = border[..., None]
    rgb = rgb * (1 - border) + border * np.array([0.35, 0.22, 0.1])
    a = np.ones((h, w, 1))
    return _rgba(np.concatenate([rgb, a], -1))


def _starfield_cubemap(size=256, density=4e-4, seed=3):
    rng = np.random.default_rng(seed)
    cm = np.zeros((6, size, size, 4), np.float32)
    cm[..., :3] = rng.uniform(0.0, 0.015, (6, size, size, 3))
    n_stars = int(6 * size * size * density)
    f = rng.integers(0, 6, n_stars)
    y = rng.integers(0, size, n_stars)
    x = rng.integers(0, size, n_stars)
    mag = rng.uniform(0.3, 1.0, n_stars)
    tint = rng.uniform(0.7, 1.0, (n_stars, 3))
    cm[f, y, x, :3] = (mag[:, None] * tint).astype(np.float32)
    cm[..., 3] = 1.0
    return _rgba(cm)


# each planet's bands, base and alternate colours and seed: _banded_planet's
# arguments after its size
PLANETS = {
    "jupiter": (9, (0.80, 0.64, 0.48), (0.55, 0.38, 0.28), 1),
    "saturn": (6, (0.85, 0.76, 0.55), (0.70, 0.60, 0.42), 2),
    "mars": (2, (0.72, 0.35, 0.20), (0.48, 0.22, 0.14), 3),
}
_PROCEDURAL = {
    "jupiter": lambda: _banded_planet(512, 1024, *PLANETS["jupiter"]),
    "saturn": lambda: _banded_planet(512, 1024, *PLANETS["saturn"]),
    "mars": lambda: _banded_planet(256, 512, *PLANETS["mars"]),
    "ring": lambda: _ring_texture(64, 1024),
    "box": lambda: _crate_texture(256, 256),
}
_CUBE_FACES = ("px", "nx", "py", "ny", "pz", "nz")


def _find_asset(asset_dir, name):
    for ext in ("png", "jpg", "jpeg", "bmp"):
        p = os.path.join(asset_dir, f"{name}.{ext}")
        if os.path.exists(p):
            return p
    return None


def demo_textures(asset_dir=None):
    """The demo texture set (jupiter, saturn, mars, ring, crate, starfield
    cubemap).  With ``asset_dir``, files jupiter/saturn/mars/ring/box.* and
    cubemap_{px,nx,py,ny,pz,nz}.* there replace the procedural textures,
    any mix (main.cpp:137-153); cubemap faces of unequal sizes are resized
    to the largest, bilinearly."""
    from txr_torch.utils.image import load_image

    def tex(name):
        p = _find_asset(asset_dir, name) if asset_dir else None
        return _rgba(load_image(p)) if p else _PROCEDURAL[name]()

    cubemap = None
    faces = [_find_asset(asset_dir, f"cubemap_{f}") for f in _CUBE_FACES] if asset_dir else []
    if faces and all(faces):
        imgs = [_rgba(load_image(p)).permute(2, 0, 1)[None] for p in faces]
        side = max(i.shape[-2] for i in imgs)
        imgs = [i if i.shape[-2:] == (side, side) else torch.nn.functional.interpolate(
            i, size=(side, side), mode="bilinear", align_corners=False) for i in imgs]
        cubemap = torch.cat(imgs).permute(0, 2, 3, 1).contiguous()
    return TextureSet(sphere=(tex("jupiter"), tex("saturn"), tex("mars")), ring=tex("ring"),
                      box=tex("box"),
                      cubemap=_starfield_cubemap() if cubemap is None else cubemap)


@dataclasses.dataclass
class DemoHandles:
    jupiter: int
    saturn: int
    saturn_rings: int
    mars: int
    box: int
    torus: int


def build_scene(width=1280, height=720):
    """The demo scene and the indices of its animated primitives.  (width
    and height are kept for the JAX signature; the scene does not use them.)"""
    b = SceneBuilder(camera_pos=(0.0, 0.0, -5.0))
    b.ambient_color = (0.025, 0.025, 0.025)   # main.cpp:48
    b.shadow_ambient = (0.1, 0.1, 0.1)        # main.cpp:47

    b.add_light_point((3, 5, 0), (1, 1, 1), 25.5, radius=0.1)   # main.cpp:51
    b.add_light_direct((3, -1, 1), (1, 1, 1), 1.5)              # main.cpp:52

    # blue / red / transparent spheres (main.cpp:55-62)
    b.add_sphere((2, 0, 6), 1, b.material((0, 0, 1), specular=50, reflect=0.35))
    b.add_sphere((-1, 0, 6), 1, b.material((1, 0, 0), specular=100, reflect=0.1), hollow=True)
    b.add_sphere(
        (0.5, 2, 6), 1,
        b.material((1, 1, 1), specular=200, reflect=0.1, refract=1.125,
                   absorb=(1, 0, 2), diffuse=1.0),
        hollow=True,
    )

    # planets (main.cpp:64-85)
    pitch = tuple(SATURN_PITCH.tolist())
    jupiter = b.add_sphere((0, 0, 0), 5000, b.material((0, 0, 0)), texture=1)
    saturn = b.add_sphere((0, 0, 0), SATURN_RADIUS, b.material((0, 0, 0)), texture=2,
                          quat=pitch)
    mars = b.add_sphere((0, 0, 0), 500, b.material((0, 0, 0)), texture=3)

    # saturn ring (main.cpp:88-95)
    ring_q = quat.mul(quat.from_axis_angle([1.0, 0.0, 0.0], math.radians(90.0)), SATURN_PITCH)
    rings = b.add_ring((0, 0, 0), SATURN_RADIUS * 1.1166, SATURN_RADIUS * 2.35,
                       b.material((0, 0, 0)), texture=4, quat=tuple(ring_q.tolist()))

    # floor + crate (main.cpp:98-105)
    b.add_box((0, -1.2, 6), (10, 0.2, 5), b.material((1, 0.6, 0), specular=100, reflect=0.05))
    box = b.add_box((8, 1, 6), (1, 1, 1), b.material((0.8, 0.7, 0), specular=50), texture=5)

    # torus (main.cpp:110-114)
    tq = quat.from_euler([math.radians(45.0), 0.0, 0.0])
    torus = b.add_torus((-9, 0.5, 6), (1.0, 0.5),
                        b.material((0.5, 0.4, 1), specular=200, reflect=0.2),
                        quat=tuple(tq.tolist()))

    # cone + cylinder quadrics (main.cpp:117-132)
    rq = tuple(quat.from_euler([math.radians(90.0), 0.0, 0.0]).tolist())
    b.add_surface(
        sf.elliptic_cone(1 / 3.0, 1 / 3.0, 1.0),
        b.material((234 / 255, 17 / 255, 82 / 255), specular=200, reflect=0.2),
        pos=(-5, 4, 6), quat=rq,
        v_min=(-3.0e38, -1.0, -3.0e38), v_max=(3.0e38, 4.0, 3.0e38),
    )
    b.add_surface(
        sf.elliptic_cylinder(1 / 2.0, 1 / 2.0),
        b.material((200 / 255, 1.0, 0.0), specular=200, reflect=0.2),
        pos=(5, 0, 6), quat=rq,
        v_min=(-3.0e38, -1.0, -3.0e38), v_max=(3.0e38, 1.0, 3.0e38),
    )

    handles = DemoHandles(jupiter=jupiter, saturn=saturn, saturn_rings=rings,
                          mars=mars, box=box, torus=torus)
    return b.build(), handles


# -- animation (main.cpp:197-246) ------------------------------------------

# the leaves the pose writes, in the order of its flat buffer
POSED = (("spheres", "pos"), ("spheres", "quat"), ("rings", "pos"), ("boxes", "quat"),
         ("toruses", "quat"))
Y_AXIS = (0.0, 1.0, 0.0)
BOX_AXIS = (0.5774, 0.5774, 0.5774)
# glm's `vec3(0,1,0) * saturn_pitch` rotates by the inverse quat
SATURN_AXIS = quat.rotate(quat.inv(SATURN_PITCH), torch.tensor(Y_AXIS))
# each spin's axis: jupiter, saturn, mars, the box, the torus
SPIN_AXES = (*Y_AXIS, *SATURN_AXIS.tolist(), *Y_AXIS, *BOX_AXIS, *Y_AXIS)
# the orbits' radii: jupiter, saturn, mars, saturn (its ring), mars's height
ORBIT_RADII = (20000.0, 35000.0, 10000.0, 35000.0, -3000.0)


def _pose_leaves(scene):
    return [getattr(getattr(scene, group), name) for group, name in POSED]


def _frame_scalars(dt, t):
    """The frame's scalars (main.cpp:197-246) as ``_pose`` reads them: the
    orbit angles whose cosines and sines it takes, their radii, the spin
    angles and the spin axes."""
    return [t * 0.02, t * 0.0082 + 1.0, t * 0.05 + 0.5, t * 0.0082 + 1.0, t * 0.05,
            *ORBIT_RADII, dt / 15.0, dt / 10.0, dt / 5.0, dt, dt, *SPIN_AXES]


def _writes(handles, leaves):
    """Where ``_pose`` writes in the flat buffer of ``leaves`` (``POSED``):
    the x of the orbits and the ring and mars's height (cosines), their z
    (sines), then the five spun quaternions."""
    offsets, o = [], 0
    for x in leaves:
        offsets.append((o, x.shape[-1]))
        o += x.numel()
    at = lambda leaf, row, col: offsets[leaf][0] + row * offsets[leaf][1] + col
    h = handles
    xs = [at(0, h.jupiter, 0), at(0, h.saturn, 0), at(0, h.mars, 0),
          at(2, h.saturn_rings, 0), at(0, h.mars, 1)]
    zs = [at(0, h.jupiter, 2), at(0, h.saturn, 2), at(0, h.mars, 2), at(2, h.saturn_rings, 2)]
    spun = [at(leaf, row, c) for leaf, row in ((1, h.jupiter), (1, h.saturn), (1, h.mars),
                                               (3, h.box), (4, h.torus)) for c in range(4)]
    return xs + zs + spun


def _on_device(values, dev, dtype=torch.float32):
    """``values`` as a [len(values)] tensor on ``dev``.  Python numbers go in
    one copy from pinned memory that does not wait on the device (no host
    sync), so frames can follow each other back to back; tensors are
    stacked where they are."""
    if any(torch.is_tensor(v) for v in values):
        return torch.stack([torch.as_tensor(v, dtype=dtype).to(dev) for v in values])
    host = torch.tensor(values, dtype=dtype, pin_memory=dev.type == "cuda")
    return host.to(dev, non_blocking=True)


def _pose(leaves, u, idx):
    """The posed ``leaves`` (``POSED``) in one flat tensor: the leaves in
    order, with the orbits' coordinates and the five spun rows written at
    ``idx`` (``_writes``); ``u``: the frame's scalars (``_frame_scalars``)
    on the leaves' device.  The five spins are one batched product."""
    flat = torch.cat([x.reshape(-1) for x in leaves])
    ang, radius = u[0:5], u[5:10]
    spin = quat.from_axis_angle(u[15:30].view(5, 3), u[10:15])
    spun = quat.mul(flat[idx[9:]].view(5, 4), spin)
    vals = torch.cat([torch.cos(ang) * radius, torch.sin(ang[:4]) * radius[:4], spun.view(-1)])
    return flat.index_put_((idx,), vals)


class _PoseProgram:
    """``_pose`` as one piece of a ``graphs.Recorder``: a CUDA graph on the
    card, captured at the first call, run eagerly on the CPU.  Its static
    input is the frame's scalars ``u``; it reads the input ``leaves`` in
    place (it holds them, so their storage stays theirs), and writes the
    posed leaves into one flat buffer, which each call copies out."""

    def __init__(self, key, leaves, handles, dev):
        self.key, self.leaves = key, leaves
        self.rec = Recorder(dev)
        self.u = torch.empty(len(_frame_scalars(0.0, 0.0)), device=dev)
        self.idx = _on_device(_writes(handles, leaves), dev, torch.int64)
        self.piece = None

    def _run(self):
        self.flat = _pose(self.leaves, self.u, self.idx)

    def __call__(self, dt, t):
        """The posed leaves at (dt, t), in a flat tensor of their own."""
        host = torch.tensor(_frame_scalars(dt, t), dtype=torch.float32, pin_memory=self.rec.cuda)
        self.u.copy_(host, non_blocking=True)
        if self.piece is None:
            self.rec.warm_up(self._run)
            self.piece = self.rec.capture(self._run)
        self.piece.replay()
        if self.rec.cuda:
            count("pose_replays", 1)
        return self.flat.clone()


_POSE = None        # the last pose program (one key at a time)


def _pose_program(leaves, handles, dev):
    """The pose program of these leaves and handles: the cached one, or a
    new one in its place."""
    global _POSE
    key = (dev, dataclasses.astuple(handles),
           tuple((x.data_ptr(), tuple(x.shape), x.dtype) for x in leaves))
    if _POSE is None or _POSE.key != key:
        _POSE = None    # the old graph's memory goes before the new one's
        _POSE = _PoseProgram(key, leaves, handles, dev)
    return _POSE


def _is_number(x):
    return isinstance(x, numbers.Real) and not torch.is_tensor(x)


def update_scene(scene, handles: DemoHandles, dt, t):
    """The scene at time ``t`` after a frame of ``dt`` seconds: a new scene,
    the input untouched (txr/apps/demo.py:233-287).  ``dt`` and ``t`` are
    floats or tensors; the result lives on the scene's device.

    With numbers for ``dt`` and ``t`` and no leaf that wants a gradient,
    the pose is one replay of a program captured per input scene
    (``_PoseProgram``: a CUDA graph on the card, its eager piece on the
    CPU); with tensors, or a gradient, the same ``_pose`` runs eagerly and
    is differentiable.  Tracer counters: ``poses``, 1 a call;
    ``pose_replays``, 1 a graph replay."""
    with span("txr.pose"):
        count("poses", 1)
        return _posed(scene, handles, dt, t)


def _posed(scene, handles, dt, t):
    dev = scene.device
    leaves = _pose_leaves(scene)
    if (_is_number(dt) and _is_number(t)
            and not (torch.is_grad_enabled() and any(x.requires_grad for x in leaves))):
        flat = _pose_program(leaves, handles, dev)(dt, t)
    else:
        flat = _pose_eagerly(leaves, handles, dt, t, dev)
    return _with_posed(scene, flat)


def _pose_eagerly(leaves, handles, dt, t, dev):
    """``_pose`` run as it is (differentiable) → the flat posed leaves."""
    return _pose(leaves, _on_device(_frame_scalars(dt, t), dev),
                 _on_device(_writes(handles, leaves), dev, torch.int64))


def _with_posed(scene, flat):
    """The scene with its ``POSED`` leaves read from ``flat``, in order."""
    olds = _pose_leaves(scene)
    pos, sq, rpos, bq, tq = (v.view(x.shape) for v, x in
                             zip(flat.split([x.numel() for x in olds]), olds))
    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(scene.spheres, pos=pos, quat=sq),
        rings=dataclasses.replace(scene.rings, pos=rpos),
        boxes=dataclasses.replace(scene.boxes, quat=bq),
        toruses=dataclasses.replace(scene.toruses, quat=tq),
    )


def parse_flight(script):
    """A flight script → list of per-frame (keys, dx, dy).

    Comma-separated segments ``<keys>:<frames>[:<dx>:<dy>]``: keys is any
    subset of ``wasd``, or ``_`` for none; dx, dy is a per-frame mouse-look
    delta in the reference's pixel units (0.05°/px, SceneManager.cpp:124).
    e.g. ``w:30, wd:20:4:0, _:15:0:-2``."""
    frames = []
    for seg in script.split(","):
        seg = seg.strip()
        if not seg:
            continue
        parts = seg.split(":")
        keys = parts[0].replace("_", "")
        n = int(parts[1])
        dx = float(parts[2]) if len(parts) > 2 else 0.0
        dy = float(parts[3]) if len(parts) > 3 else 0.0
        frames += [(keys, dx, dy)] * n
    return frames


def main(argv=None):
    """Render the animated demo; print each frame's rate; write the last
    frame as a PNG or every frame as a GIF.  → dict(img=last frame [H, W, 3],
    fps=[per frame])."""
    from txr_torch.render.render import render_jit
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig, auto_refraction_steps
    from txr_torch.utils import image
    from txr_torch.utils.profiling import fence

    p = argparse.ArgumentParser(description="txr_torch solar-system demo")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--dt", type=float, default=1 / 30)
    p.add_argument("--t0", type=float, default=60.0)
    p.add_argument("--supersample", type=int, default=1)
    p.add_argument("--aa", choices=("off", "low", "medium", "high", "ultra"), default=None,
                   help="quality preset (the reference's SMAA presets as an edge-AA factor); "
                        "overrides --supersample")
    p.add_argument("--iterations", type=int, default=None,
                   help="bounce depth (default: the scene's reflect_depth, 5)")
    p.add_argument("--out", default="txr_demo.png",
                   help=".png (last frame) or .gif (all frames animated)")
    p.add_argument("--frames-dir", default=None,
                   help="also write every frame as a PNG into this directory")
    p.add_argument("--assets", default=None,
                   help="directory of texture files (jupiter/saturn/mars/ring/box.*, "
                        "cubemap_{px,nx,py,ny,pz,nz}.*); missing ones are procedural")
    p.add_argument("--fly", default=None,
                   help="FlyCamera flight script, e.g. 'w:30, wd:20:4:0' (see parse_flight)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first op that makes a NaN or an Inf (slow)")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler Chrome trace of the frame loop here")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--fused", default="auto", choices=("auto", "on", "off"))
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    scene, handles = build_scene(args.width, args.height)
    scene = scene.to(dev)
    # the atlas and mip pyramids, built once (glGenerateMipmap, GLWrapper.cpp:343)
    textures = with_mips(demo_textures(args.assets).to(dev))
    iters = args.iterations if args.iterations is not None else scene.reflect_depth
    cfg = RenderConfig(width=args.width, height=args.height, iterations=iters,
                       supersample=args.supersample,
                       extra_refraction_steps=auto_refraction_steps(scene), fused=args.fused)
    if args.aa:
        cfg = cfg.with_aa_preset(args.aa)
    flight = parse_flight(args.fly) if args.fly else None
    cam = None
    if flight:
        from txr_torch.scene.camera import FlyCamera

        cam = FlyCamera(position=tuple(scene.camera.pos.tolist()))
    if args.frames_dir:
        os.makedirs(args.frames_dir, exist_ok=True)
    want_gif = args.out.lower().endswith(".gif")

    with contextlib.ExitStack() as stack:
        if args.debug_nans:
            from txr_torch.utils.debug import disable_nan_checks, enable_nan_checks

            enable_nan_checks()
            stack.callback(disable_nan_checks)
        if args.profile:
            from txr_torch.utils.profiling import profile_trace

            stack.enter_context(profile_trace(args.profile))
        gif_frames, fps_all = [], []
        t = args.t0
        last = time.perf_counter()
        for frame in range(args.frames):
            animated = update_scene(scene, handles, args.dt, t)
            if cam is not None:
                keys, dx, dy = flight[min(frame, len(flight) - 1)]
                for k in "wasd":
                    cam.key(k, k in keys)
                if dx or dy:
                    cam.mouse(dx, dy)
                cam.update(args.dt)
                animated = cam.apply(animated)
            with torch.no_grad():
                img = render_jit(animated, textures, cfg, device=dev)
            fence(img)
            now = time.perf_counter()
            fps = 1.0 / max(now - last, 1e-9)
            last = now
            fps_all.append(fps)
            print(f"frame {frame}: {fps:.1f} FPS "
                  f"({args.width * args.height * cfg.supersample ** 2 * fps:,.0f} rays/s)",
                  flush=True)
            t += args.dt
            if want_gif or args.frames_dir:
                u8 = image.to_uint8(img)
                if want_gif:
                    gif_frames.append(u8)
                if args.frames_dir:
                    image.save_png(os.path.join(args.frames_dir, f"frame_{frame:05d}.png"), u8)
    if args.profile:
        print(f"profile trace in {args.profile}")
    if want_gif:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in gif_frames]
        imgs[0].save(args.out, save_all=True, append_images=imgs[1:],
                     duration=max(int(args.dt * 1000), 20), loop=0)
    else:
        image.save_png(args.out, img)
    print(f"wrote {args.out}")
    return dict(img=img, fps=fps_all)


if __name__ == "__main__":
    main()
