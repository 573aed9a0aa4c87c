"""The port's render_jit (render/render.py, render/graphs.py) on the CPU.

On the CPU the frame's pieces (head, bounce step, tail of each trace) run
eagerly through the same driver that replays them as CUDA graphs on the
card, so everything but the capture itself is covered here.  The CPU's
render takes the same fixed-shape sub-passes (``intersect.lane_lists``);
the card's lane lists are held to render_jit bit for bit by chip_smoke.py.

* render_jit equals the port's render bit for bit (atol=0) on both routes,
  with edge AA (24×16, k = 4) and with ray chunks and compacted steps;
* against JAX's render_jit, test_torch_render.py's criterion: at most
  1.5 % of pixels over 2e-3, and where the two differ by more than 0.1 the
  port is the one closer to the f64 oracle (torus pixels);
* a second call after update_scene at another time equals render at that
  time (no stale static buffer), and a TextureSet of other storage is
  copied in without writing into the captured one;
* the pieces make no host read: they run under a dispatch mode that raises
  on aten.nonzero, aten._local_scalar_dense (.item(), bool()), boolean
  mask indexing and tensors made from host data, everywhere but inside the
  kernels' CPU twins, which read the packed table on the host where the
  kernels read it on the card;
* steps on the live lanes gathered into fewer rows (the card's
  ``graphs.capacities``, forced here: the CPU steps every lane) equal
  render's full-width steps bit for bit.  The capacities are powers of two
  and the ray counts multiples of 32, so every lane takes ATen's
  vectorised path in both (its scalar remainder rounds atan2 and pow
  otherwise);
* a step on a state where every lane is dead changes no bit, on both
  routes, and the driver runs at most one step past the last live one;
* a call that wants a gradient raises.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from txr.apps import demo as jdemo
from txr.ref.cpu_reference import render_oracle
from txr.render.render import render_jit as jax_render_jit
from txr.render.texture import with_mips as jax_with_mips
from txr.render.trace import RenderConfig as JConfig
from txr_torch.apps import demo as tdemo
from txr_torch.kernels import nearest_hit as nh
from txr_torch.kernels import shadow_sweep as ss
from txr_torch.kernels import step_probe as sp
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.render import graphs
from txr_torch.render import render as rr
from txr_torch.render import trace as tr
from txr_torch.render.intersect import fixed_shapes
from txr_torch.render.raygen import primary_rays
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import RenderConfig

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

SMALL = dict(width=32, height=18, iterations=3, extra_refraction_steps=2)
ROUTES = ("auto", "off")
aten = torch.ops.aten


@pytest.fixture(scope="module")
def demo():
    """The demo scene at 32×18, its animation handles, its textures with
    their mips built once (as the apps pass them), and each route's render
    and render_jit images."""
    scene, handles = tdemo.build_scene(32, 18)
    tex = with_mips(tdemo.demo_textures())
    imgs = {}
    for fused in ROUTES:
        cfg = RenderConfig(**SMALL, fused=fused)
        imgs[fused] = (rr.render(scene, tex, cfg, device="cpu"),
                       rr.render_jit(scene, tex, cfg, device="cpu"))
    return scene, handles, tex, imgs


@pytest.mark.parametrize("fused", ROUTES)
def test_render_jit_equals_render(demo, fused):
    _, _, _, imgs = demo
    want, got = imgs[fused]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("fused", ROUTES)
def test_render_jit_equals_render_edge_aa(demo, fused):
    """24×16 with k = 4: K = 384 pixels, fills included, through the edge
    pass (ray chunks: test_pieces_make_no_host_read)."""
    scene = tdemo.build_scene(24, 16)[0]
    cfg = RenderConfig(**{**SMALL, "width": 24, "height": 16, "supersample": 4}, fused=fused)
    want = rr.render(scene, demo[2], cfg, device="cpu")
    got = rr.render_jit(scene, demo[2], cfg, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = rr.render(scene, demo[2], dataclasses.replace(cfg, supersample=1), device="cpu")
    assert 0 < int((got != one).any(-1).sum()) < cfg.width * cfg.height


def test_render_jit_matches_jax_render_jit(demo):
    """test_torch_render.py's criterion against JAX's render_jit."""
    jscene, _ = jdemo.build_scene(32, 18)
    jtex = jax.jit(jax_with_mips)(jdemo.demo_textures())
    want = np.asarray(jax_render_jit(jscene, jtex, JConfig(**SMALL, fused="off")), np.float64)
    oracle = np.asarray(render_oracle(jscene, jdemo.demo_textures(), JConfig(**SMALL)),
                        np.float64)
    got = demo[3]["auto"][1].numpy().astype(np.float64)
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 2e-3).mean() <= 0.015, (diff > 2e-3).mean()
    far = diff > 0.1
    err_port = np.abs(got - oracle).max(axis=-1)[far]
    err_jax = np.abs(want - oracle).max(axis=-1)[far]
    assert (err_port < err_jax).all(), (np.argwhere(far), err_port, err_jax)


def test_second_call_streams_new_parameters(demo):
    """The demo at t = 60 s, then at 61.5 s with the camera moved: each
    render_jit equals render of that scene, and a TextureSet of the same
    layout in other storage is copied in, leaving the captured one as it
    was."""
    scene, handles, tex, imgs = demo
    cfg = RenderConfig(**SMALL)
    first = rr.render_jit(scene, tex, cfg, device="cpu")
    torch.testing.assert_close(first, imgs["auto"][1], rtol=0, atol=0)
    later = tdemo.update_scene(scene, handles, 0.0, 61.5)
    later = dataclasses.replace(later, camera=dataclasses.replace(
        later.camera, pos=later.camera.pos + torch.tensor([0.3, -0.1, 0.2])))
    got = rr.render_jit(later, tex, cfg, device="cpu")
    want = rr.render(later, tex, cfg, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, first)

    texels = tex.atlas.texels.clone()
    dark = dataclasses.replace(tex, atlas=dataclasses.replace(
        tex.atlas, texels=tex.atlas.texels * 0.5))
    got = rr.render_jit(scene, dark, cfg, device="cpu")
    torch.testing.assert_close(got, rr.render(scene, dark, cfg, device="cpu"), rtol=0, atol=0)
    assert torch.equal(tex.atlas.texels, texels)
    torch.testing.assert_close(rr.render_jit(scene, tex, cfg, device="cpu"),
                               imgs["auto"][1], rtol=0, atol=0)


class _NoHostRead(TorchDispatchMode):
    """Raises on every op that reads a tensor on the host or makes one from
    host data (a sync, or a host-to-device copy, on the card), but inside a
    kernel's twin (``kernel`` > 0)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.kernel:
            return func(*args, **kwargs)
        self.ops += 1
        bad = func.overloadpacket in (aten.nonzero, aten._local_scalar_dense, aten.lift_fresh)
        if func.overloadpacket in (aten.index, aten.index_put, aten.index_put_):
            idx = args[1]
            bad = bad or any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                             for i in idx)
        if bad:
            raise AssertionError(f"host read in a captured piece: {func}")
        return func(*args, **kwargs)


@pytest.mark.parametrize("fused", ROUTES)
def test_pieces_make_no_host_read(demo, monkeypatch, fused):
    """Every piece of a frame with edge AA, ray chunks of two sizes (576 and
    1200 rays of the edge pass's 2304) and compacted steps (capacities 512
    down to 32) runs under _NoHostRead, and the image equals render's; the
    same mode catches render's early exit (alive.any())."""
    scene, _, tex, _ = demo
    mode = _NoHostRead()
    eager = graphs._Eager.replay

    def replay(self):
        with mode:
            eager(self)

    def as_kernel(twin):
        def run(*args, **kwargs):
            mode.kernel += 1
            try:
                return twin(*args, **kwargs)
            finally:
                mode.kernel -= 1
        return run

    monkeypatch.setattr(graphs._Eager, "replay", replay)
    for mod, name in ((sp, "step_probe_ref"), (nh, "nearest_hit_ref"), (ss, "shadow_sweep_ref")):
        monkeypatch.setattr(mod, name, as_kernel(getattr(mod, name)))
    monkeypatch.setattr(graphs, "capacities",
                        lambda R, dev: [R] + [c for c in (512, 256, 128, 64, 32) if c < R])
    cfg = RenderConfig(**SMALL, fused=fused, supersample=2, ray_chunk=1200)
    rr.clear_jit_cache()
    img = rr.render_jit(scene, tex, cfg, device="cpu")
    stepped = [u.steps_run for p in rr._FRAMES[next(iter(rr._FRAMES))].programs
               for u in p.units.values()]
    assert mode.ops > 1000 and any(c < 512 for caps in stepped for c in caps), stepped
    torch.testing.assert_close(img, rr.render(scene, tex, cfg, device="cpu"), rtol=0, atol=0)
    with pytest.raises(AssertionError, match="host read"), _NoHostRead():
        rr.render(scene, tex, RenderConfig(**SMALL, fused=fused), device="cpu")


def _bits(st):
    return {k: v.view(torch.int32) if v.dtype == torch.float32 else v for k, v in st.items()}


@pytest.mark.parametrize("fused", ROUTES)
def test_step_on_dead_state_is_identity(demo, fused):
    """Two live steps of the fixed-shape body, then every lane marked dead:
    one more step returns the state bit for bit."""
    scene, _, tex, _ = demo
    cfg = RenderConfig(**SMALL, fused=fused)
    table = pack_scene(scene, tex.atlas)
    step = tr.make_step(scene, tex, cfg, table)
    st = tr.initial_state(*primary_rays(scene.camera, 32, 18))
    with fixed_shapes(), torch.no_grad():
        for _ in range(2):
            st = step(st)
        dead = dict(st, alive=torch.zeros_like(st["alive"]))
        assert bool(dead["missed"].any()) and bool((dead["bounces"] > 0).any())
        after = step(dead)
    want, got = _bits(dead), _bits(after)
    for k in tr.STATE_KEYS:
        assert torch.equal(got[k], want[k]), k


def test_driver_runs_at_most_one_step_past_the_last_live_one(demo):
    """The early exit read one step late: with a 9-step budget the eager
    loop stops after n < 9 steps, and the driver after min(n + 1, 9)."""
    scene, _, tex, _ = demo
    cfg = RenderConfig(**{**SMALL, "extra_refraction_steps": 6})
    st = tr.initial_state(*primary_rays(scene.camera, 32, 18))
    step = tr.make_step(scene, tex, cfg, pack_scene(scene, tex.atlas))
    n = 0
    with torch.no_grad():
        while n < cfg.max_steps and bool(st["alive"].any()):
            st = step(st)
            n += 1
    assert 1 <= n < cfg.max_steps
    rr.clear_jit_cache()
    got = rr.render_jit(scene, tex, cfg, device="cpu")
    (frame,) = rr._FRAMES.values()
    (unit,) = frame.programs[0].units.values()
    assert len(unit.steps_run) == min(n + 1, cfg.max_steps)
    torch.testing.assert_close(got, rr.render(scene, tex, cfg, device="cpu"), rtol=0, atol=0)


def test_render_jit_refuses_a_gradient(demo):
    scene, _, tex, _ = demo
    cfg = RenderConfig(**SMALL)
    pos = scene.spheres.pos.clone().requires_grad_(True)
    wants_grad = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, pos=pos))
    with pytest.raises(ValueError, match=r"render\(\) is the differentiable route"):
        rr.render_jit(wants_grad, tex, cfg, device="cpu")
    texels = tex.atlas.texels.clone().requires_grad_(True)
    tex_grad = dataclasses.replace(tex, atlas=dataclasses.replace(tex.atlas, texels=texels))
    with pytest.raises(ValueError, match="requires grad"):
        rr.render_jit(scene, tex_grad, cfg, device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(rr.render_jit(wants_grad, tex, cfg, device="cpu"),
                                   demo[3]["auto"][1], rtol=0, atol=0)
