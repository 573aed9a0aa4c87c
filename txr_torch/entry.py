"""The port's entry points (after __graft_entry__.py).

``entry()``               → (a forward render of the demo scene at 192×108
                            on the card, its arguments): a one-card check.
``dryrun_multichip(n)``   → a world of n ranks (``dist.mesh.spawn_world``)
                            renders the demo scene sharded, takes one full
                            sharded train step (forward, local backward, one
                            all_reduce of the gradients, Adam) and checks
                            the primitive-sharded ring sweep against the
                            whole scene's nearest hit, at 48×32.

    python -m txr_torch.entry [--device cpu]

runs both: on the cards by default, a rank per card; 4 ranks on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from txr_torch import resolve_device

# the trainable leaves of the dry run (__graft_entry__.py:67-68)
DRYRUN_PARAMS = ["spheres.pos", "spheres.radius", "spheres.mat.color", "camera", "toruses",
                 "surfaces.coef"]


def _small_scene():
    from txr_torch.apps.demo import build_scene, demo_textures

    scene, _ = build_scene()
    return scene, demo_textures()


def entry(device=None):
    """(fn, (scene, textures)): ``fn(scene, textures)`` renders the demo
    scene at 192×108, 5 bounces, on ``device`` (CUDA unless "cpu")."""
    from txr_torch.render.render import render
    from txr_torch.render.trace import RenderConfig

    dev = resolve_device(device)
    scene, textures = _small_scene()
    cfg = RenderConfig(width=192, height=108, iterations=5)

    def fn(scene, textures):
        return render(scene, textures, cfg, device=dev)

    return fn, (scene, textures)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(device, n):
    """One rank of ``dryrun_multichip`` → dict(lines, loss, launches)."""
    from txr_torch.dist.mesh import make_mesh
    from txr_torch.dist.ring import ring_nearest_hit
    from txr_torch.dist.sharded import make_train_step, render_sharded
    from txr_torch.kernels import launch_counts, reset_launch_counts
    from txr_torch.render.intersect import nearest_hit
    from txr_torch.render.raygen import primary_rays
    from txr_torch.render.trace import RenderConfig

    reset_launch_counts()
    # 2D mesh when possible: dp × sp over the rays
    shape = (n // 2, 2) if n % 2 == 0 and n > 2 else (n, 1)
    mesh = make_mesh(shape)
    scene, textures = _small_scene()
    cfg = RenderConfig(width=48, height=32, iterations=3)

    img = render_sharded(scene, textures, cfg, mesh, device=device)
    _check(tuple(img.shape) == (32, 48, 3), f"image shape {tuple(img.shape)}")

    # the full train step: forward, local backward, all_reduce, Adam
    init, step = make_train_step(textures, cfg, mesh,
                                 lambda ps: torch.optim.Adam(ps, lr=1e-3, eps=1e-8),
                                 param_paths=DRYRUN_PARAMS, device=device)
    _, _, loss = step(scene, init(scene), img)
    loss = float(loss)
    _check(loss == loss and abs(loss) != float("inf"), f"loss {loss}")
    lines = [f"dryrun_multichip({n}): mesh={shape} loss={loss:.6f} ok"]

    # the primitive-sharded ring sweep over a 1-axis mesh of the same ranks
    ring = make_mesh((n,), axis_names=("ring",))
    scene = scene.to(device)
    ro, rd = primary_rays(scene.camera, 48, 32, 1)
    t_r, ty_r, _ = ring_nearest_hit(scene, ro, rd, ring, device=device)
    with torch.no_grad():
        t_0, ty_0, _ = nearest_hit(scene, ro, rd)
    finite = torch.isfinite(t_0)
    _check(bool((ty_r == ty_0).all()), "ring type mismatch")
    # rtol covers f32 quartic rounding between the shard and whole-scene
    # sweeps (torus pixels); the strict contract is tests/test_torch_ring.py's
    _check(torch.allclose(t_r[finite], t_0[finite], rtol=5e-3, atol=1e-3), "ring t mismatch")
    lines.append(f"dryrun_multichip({n}): ring sweep mode ok")
    return dict(lines=lines, loss=loss, launches=launch_counts())


def dryrun_multichip(n, device=None):
    """The dry run in a spawned world of n ranks (on the cards unless
    ``device="cpu"``; ``spawn_world``'s timeout); prints rank 0's two lines
    → [each rank's dict(lines, loss, launches)]."""
    from txr_torch.dist.mesh import spawn_world

    out = spawn_world(n, _dryrun_rank, n, device=device)
    for line in out[0]["lines"]:
        print(line, flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="txr_torch entry points: a render, then a dry run "
                                            "of the multi-rank paths")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    fn, fargs = entry(dev)
    out = fn(*fargs)
    print("entry:", tuple(out.shape), out.dtype, flush=True)
    # one rank per card, as the JAX dry run takes every device; 4 on the CPU
    n = torch.cuda.device_count() if dev.type == "cuda" else 4
    return dryrun_multichip(n, args.device)


if __name__ == "__main__":
    # through the module's own name, so the spawned ranks import it by name
    from txr_torch.entry import main as _main

    _main()
