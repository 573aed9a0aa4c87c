"""The bounce loop (txr/render/trace.py, rt.frag:804-902).

Every ray carries an ``alive`` mask and the state updates are masked, as in
the JAX package; the loop runs ``cfg.max_steps`` steps and stops early once
no ray is alive.  A refraction event does not consume a bounce (the ``i--``
at rt.frag:870-872), so the loop length is ``iterations +
extra_refraction_steps``.  The environment is fetched once, after the loop,
for the rays that missed.
"""

from __future__ import annotations

import dataclasses

import torch

from txr_torch import resolve_device
from txr_torch.render import texture as tx
from txr_torch.render.fused import fused_step_fwd


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The render options that change a pixel — the reference's feature
    defines (rt.frag:15-22)."""

    width: int = 1280
    height: int = 720
    iterations: int = 5               # reflect_depth, SceneManager.cpp:233
    supersample: int = 1
    # budget for the non-consuming refraction steps (rt.frag:870-872)
    extra_refraction_steps: int = 6
    shadow_enabled: bool = True       # SHADOW_ENABLED, rt.frag:15
    do_fresnel: bool = True           # DO_FRESNEL, rt.frag:20
    total_internal_reflection: bool = True  # rt.frag:19
    plane_oneside: bool = True        # PLANE_ONESIDE, rt.frag:21
    reflect_reduce_iteration: bool = True   # rt.frag:22
    texture_lod: bool = True          # ray-footprint mip LOD
    refractive_glossy: bool = True    # getReflectedColor pass, rt.frag:787-802
    # "edge" re-renders luma-edge pixels at supersample² (not ported yet);
    # "ssaa" box-averages a uniformly supersampled frame
    aa_mode: str = "edge"

    @property
    def max_steps(self):
        if self.reflect_reduce_iteration:
            return self.iterations + self.extra_refraction_steps
        return self.iterations


def auto_refraction_steps(scene, cap: int = 6) -> int:
    """The refraction budget a scene needs: ``cap`` when any material
    refracts, else 0."""
    for g in (scene.spheres, scene.planes, scene.surfaces, scene.boxes,
              scene.toruses, scene.rings):
        if g.mat.refract.numel() and bool((g.mat.refract > 0).any()):
            return cap
    return 0


def _pix_angle(cfg):
    """Radians per sample: raygen normalises by height (rt.frag:313-317)."""
    return 1.0 / (cfg.height * cfg.supersample) if cfg.texture_lod else None


def _background(scene, textures, rd):
    if textures.cube is not None:
        return tx.sample_cubemap(textures, rd)
    return scene.bg_color.expand(rd.shape)


def initial_state(ro, rd):
    zero = torch.zeros(ro.shape[0], dtype=ro.dtype, device=ro.device)
    return dict(
        ro=ro, rd=rd, color=torch.zeros_like(ro), mask=torch.ones_like(ro),
        absorb_dist=zero,
        bounces=torch.zeros(ro.shape[0], dtype=torch.int32, device=ro.device),
        alive=torch.ones(ro.shape[0], dtype=torch.bool, device=ro.device),
        # a ray misses at most once (it dies, and a dead ray's rd and mask
        # never change), so one bit defers its environment fetch
        missed=torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device),
    )


def trace(scene, textures, cfg: RenderConfig, ro, rd, device=None):
    """ro, rd [R,3] → RGB [R,3].  Scene, textures and rays move to
    ``device`` (CUDA unless the caller passes "cpu")."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    textures = tx.with_mips(textures.to(dev))
    st = initial_state(ro.to(dev, torch.float32).contiguous(),
                       rd.to(dev, torch.float32).contiguous())
    for _ in range(cfg.max_steps):
        if not st["alive"].any():
            break
        st = fused_step_fwd(scene, textures, cfg, st)
    missed = st["missed"]
    if not missed.any():
        return st["color"]
    env = _background(scene, textures, st["rd"])   # rd frozen at the miss
    return st["color"] + env * torch.where(missed[..., None], st["mask"], 0.0)
