"""Inverse-rendering example on the port (txr/apps/inverse.py): recover a
sphere's position, radius and colour and the camera pose from a target
image by gradient descent on the render.

    python -m txr_torch.apps.inverse --steps 200 [--size 64] [--device cpu]
        [--fused off] [--metrics steps.jsonl] [--out inverse.png]
        [--checkpoint run.npz --checkpoint-every 10 [--resume]]

Runs on CUDA unless ``--device cpu``.  With ``--checkpoint`` and
``--checkpoint-every k`` the run's state is written every k steps and at
the end; ``--resume`` continues a killed run from that file to ``--steps``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from txr_torch import resolve_device
from txr_torch.diff.optimize import optimize_scene
from txr_torch.render.render import render_jit
from txr_torch.render.texture import TextureSet
from txr_torch.render.trace import RenderConfig
from txr_torch.scene.factories import SceneBuilder
from txr_torch.utils.image import save_png, side_by_side

# optimise the camera quat through a normalise: rotate() follows the
# reference (conjugate, not inverse — rt.frag:305-311), so a non-unit quat
# scales the rotation; normalising keeps descent on the rotation manifold
QUAT_NORMALIZE = {"camera.quat": lambda q: q / torch.sqrt((q * q).sum() + 1e-12)}


def make_scene(sphere_pos, sphere_radius, color, cam_pos, cam_quat=(0, 0, 0, 1)):
    b = SceneBuilder(camera_pos=cam_pos)
    b.ambient_color = (0.05,) * 3
    b.shadow_ambient = (0.1,) * 3
    b.add_light_point((3, 5, -2), (1, 1, 1), 25.5)
    b.add_sphere(sphere_pos, sphere_radius, b.material(color, specular=50, reflect=0.0))
    b.add_box((0, -1.5, 6), (10, 0.2, 8), b.material((0.6, 0.6, 0.65), specular=20))
    scene = b.build()
    return dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, quat=torch.tensor(cam_quat, dtype=torch.float32)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--fused", default="auto", choices=("auto", "on", "off"))
    p.add_argument("--metrics", default=None, help="one JSON record per step here")
    p.add_argument("--out", default=None, help="write target | recovered as a PNG here")
    p.add_argument("--checkpoint", default=None, help="the run's state file (.npz)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write the state every k steps and at the end")
    p.add_argument("--resume", action="store_true",
                   help="continue from --checkpoint, if it exists, to --steps")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = RenderConfig(width=args.size, height=args.size, iterations=2,
                       refractive_glossy=False, fused=args.fused)
    tex = TextureSet()
    target_scene = make_scene((0.3, 0.2, 6.0), 1.0, (0.1, 0.2, 0.9), (0, 0, -5))
    with torch.no_grad():
        target = render_jit(target_scene, tex, cfg, device=dev)
    # perturbed initial guess: wrong sphere and wrong camera pose
    guess = make_scene((-0.4, -0.3, 6.5), 0.8, (0.5, 0.5, 0.5), (0.3, 0.2, -5.2),
                       cam_quat=(0.0, 0.02, 0.0, 1.0))
    decay = max(args.steps // 4, 1)
    recovered, losses = optimize_scene(
        guess, tex, cfg, target, steps=args.steps,
        lr=lambda step: args.lr * 0.4 ** (step / decay),     # optax.exponential_decay
        param_paths=["spheres.pos", "spheres.radius", "spheres.mat.color",
                     "camera.pos", "camera.quat"],
        param_transform=QUAT_NORMALIZE, metrics_path=args.metrics, device=dev,
        checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
        resume=args.resume)
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.6f}")
    show = lambda t: np.round(t.detach().cpu().numpy(), 4)
    for name, a, b in (("sphere pos", target_scene.spheres.pos[0], recovered.spheres.pos[0]),
                       ("radius", target_scene.spheres.radius, recovered.spheres.radius),
                       ("colour", target_scene.spheres.mat.color[0],
                        recovered.spheres.mat.color[0]),
                       ("camera pos", target_scene.camera.pos, recovered.camera.pos),
                       ("camera quat", target_scene.camera.quat, recovered.camera.quat)):
        print(f"{name:12s} true {show(a)}  recovered {show(b)}")
    if args.out:
        with torch.no_grad():
            final = render_jit(recovered, tex, cfg, device=dev)
        save_png(args.out, side_by_side(target, final, gap=2))
        print(f"wrote {args.out}  (left: target, right: recovered)")
    return losses


if __name__ == "__main__":
    main()
