"""The port's captured train step (``diff/optimize.py: _Fit``,
``render.train_frame``, the VJP pieces of ``render/graphs.py``) on the CPU.

On the CPU the step's pieces (forward, loss, backward, gradient norm,
update) run eagerly through the same code that replays them as CUDA
graphs on the card, so everything but the capture itself is covered here;
chip_smoke.py phase 24 holds the capture at 1080p.  Scenes:
``apps.inverse.make_scene`` at 24×24 (2 iterations, no glossy pass;
every float leaf trains) and the demo scene (textures, rings, glass,
every float leaf) at 16×8 and 8×8.

* (a) the first captured step against the op-by-op ``_eager_step``, on
  both routes: the loss bit for bit, each leaf's gradient within 1e-6 of
  its norm; three steps of ``optimize_scene`` (camera quat through
  ``QUAT_NORMALIZE``) descend, and the first loss is within 1e-4 of the
  JAX package's (the value of its ``optimize_scene``'s first step, its
  ``diff.scene_grad`` at the guess, whose quat is unit);
* (b) the first step's gradients against ``txr.diff.scene_grad`` of the
  same loss, within tests/test_torch_grads.py's tolerance (rtol 2e-2,
  atol 1e-4·(1 + max|g|));
* (c) steps on the live lanes gathered into fewer rows (the card's
  ``graphs.capacities``, forced here as tests/test_torch_jit.py does), with
  a step whose live count is below its capacity, so fill lanes reach the
  backward: the loss bit for bit and every gradient within 1e-6 of its
  norm of the full-width step's;
* (d) every piece of a step with edge AA, ray chunks of two sizes and
  compacted steps (forward, loss, backward, gradient norm, update) runs
  under test_torch_jit's ``_NoHostRead``;
* (e) that step's loss bit for bit and gradients within 1e-6 of the eager
  step's;
* (f) a run resumed from its checkpoint is bit-identical to an
  uninterrupted one (losses, parameters, Adam's moments);
* the captured update equals the optimiser's own steps bit for bit,
  wherever its state starts; one built with capturable=False is refused
  on the card;
* a run's train frame is its own, and the one kept after it is the next
  run's; a scene of another topology raises;
* ``trace.vjp``'s seeds give autograd's float32 summation order;
* (g) the captured step at a fixed pose of the demo's animation (rtbench's
  fit traffic: every float leaf, mean(img²), Adam at rate 0), at 1 spp and
  with edge AA: three steps give the first step's loss and gradients bit
  for bit and leave the parameters as they were.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_jit import _NoHostRead
from txr.apps import inverse as jinv
from txr.diff.optimize import image_loss as jimage_loss
from txr.diff.optimize import scene_grad as jscene_grad
from txr.render.render import render_jit as jrender_jit
from txr.render.texture import TextureSet as JTextureSet
from txr.render.trace import RenderConfig as JConfig
from txr_torch import bridge
from txr_torch.apps import demo as tdemo
from txr_torch.apps import inverse as tinv
from txr_torch.diff import optimize as om
from txr_torch.kernels import nearest_hit as nh
from txr_torch.kernels import shadow_sweep as ss
from txr_torch.kernels import step_probe as sp
from txr_torch.render import graphs
from txr_torch.render import render as rr
from txr_torch.render.render import clear_jit_cache, render
from txr_torch.render.texture import TextureSet, with_mips
from txr_torch.render import trace as tr
from txr_torch.render.trace import RenderConfig
from txr_torch.utils.checkpoint import load_arrays

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

ROUTES = ("auto", "off")
SIZE = 24
TRUE = ((0.3, 0.2, 6.0), 1.0, (0.1, 0.2, 0.9), (0, 0, -5))
GUESS = ((-0.4, -0.3, 6.5), 0.8, (0.5, 0.5, 0.5), (0.3, 0.2, -5.2))
QUAT = tuple(np.array([0.0, 0.02, 0.0, 1.0]) / math.hypot(0.02, 1.0))
PARAMS = ["spheres.pos", "spheres.radius", "spheres.mat.color", "camera.pos", "camera.quat"]
INV = dict(width=SIZE, height=SIZE, iterations=2, refractive_glossy=False)
DEMO = dict(iterations=2, extra_refraction_steps=1)
# the card's compacted capacities, at the sizes of these frames
CAPS = (64, 32)


def _first_step(scene, tex, cfg, target, captured, paths=None):
    """One step of a fit of every float leaf (or ``paths``) → (loss,
    {path: gradient}, the fit)."""
    fit = om._Fit(scene, tex, cfg, target, paths, device="cpu", captured=captured)
    loss, _ = fit.step(0)
    return float(loss), {p: torch.zeros_like(v) if v.grad is None else v.grad.clone()
                         for p, v in fit.params.items()}, fit


def _assert_grads_close(got, want, rel=1e-6):
    assert set(got) == set(want)
    bad = [(p, float((got[p] - w).norm()), float(w.norm())) for p, w in want.items()
           if float((got[p] - w).norm()) > rel * float(w.norm())]
    assert not bad, bad
    assert sum(float(w.norm()) > 0 for w in want.values()) >= 10


@pytest.fixture(scope="module")
def inverse():
    """The JAX side (target, value and gradients of image_loss at the
    guess) and, per route, the captured and eager first steps."""
    jcfg = JConfig(**INV)
    target = jrender_jit(jinv.make_scene(*TRUE), JTextureSet(), jcfg)
    jguess = jinv.make_scene(*GUESS, cam_quat=QUAT)
    val, g = jscene_grad(lambda s: jimage_loss(jrender_jit(s, JTextureSet(), jcfg), target),
                         jguess)
    leaves = {jax.tree_util.keystr(p): np.asarray(v)
              for p, v in jax.tree_util.tree_leaves_with_path(g) if jnp.issubdtype(v.dtype,
                                                                                   jnp.floating)}
    guess = tinv.make_scene(*GUESS, cam_quat=QUAT)
    target = torch.from_numpy(np.array(target))
    steps = {}
    for fused in ROUTES:
        cfg = RenderConfig(**INV, fused=fused)
        steps[fused] = {captured: _first_step(guess, TextureSet(), cfg, target, captured)[:2]
                        for captured in (True, False)}
    return dict(target=target, guess=guess, jax_loss=float(val), jax_grads=leaves, steps=steps)


@pytest.mark.parametrize("fused", ROUTES)
def test_first_step_equals_eager_step(inverse, fused):
    (loss, grads), (eloss, egrads) = inverse["steps"][fused][True], inverse["steps"][fused][False]
    assert loss == eloss
    _assert_grads_close(grads, egrads)


@pytest.mark.parametrize("fused", ROUTES)
def test_first_step_grads_match_jax(inverse, fused):
    want = inverse["jax_grads"]
    got = bridge.grads_to_numpy(inverse["steps"][fused][True][1])
    assert set(got) == set(want)
    bad = [(k, np.abs(got[k] - w).max(), np.abs(w).max()) for k, w in want.items()
           if w.size and not np.allclose(got[k], w, rtol=2e-2, atol=1e-4 * (1.0 + np.abs(w).max()))]
    assert not bad, bad


@pytest.mark.parametrize("fused", ROUTES)
def test_optimize_scene_descends_from_jax_first_loss(inverse, fused):
    cfg = RenderConfig(**INV, fused=fused)
    recovered, losses = om.optimize_scene(
        inverse["guess"], TextureSet(), cfg, inverse["target"], steps=3, lr=3e-2,
        param_paths=PARAMS, param_transform=tinv.QUAT_NORMALIZE, device="cpu")
    want = inverse["jax_loss"]
    assert abs(losses[0] - want) <= 1e-4 * want, (losses[0], want)
    assert losses[2] < losses[1] < losses[0], losses
    assert abs(float((recovered.camera.quat ** 2).sum()) - 1.0) < 1e-5


@pytest.fixture(scope="module")
def demo():
    scene, _ = tdemo.build_scene(16, 8)
    return scene, with_mips(tdemo.demo_textures())


def _target(scene, tex, cfg):
    with torch.no_grad():
        return 0.9 * render(scene, tex, cfg, device="cpu")


def _force_caps(monkeypatch):
    monkeypatch.setattr(graphs, "capacities", lambda R, dev: [R] + [c for c in CAPS if c < R])


@pytest.mark.parametrize("fused", ROUTES)
def test_compacted_backward_equals_full_width(demo, monkeypatch, fused):
    scene, tex = demo
    cfg = RenderConfig(width=16, height=8, **DEMO, fused=fused)
    target = _target(scene, tex, cfg)
    clear_jit_cache()
    loss, grads, _ = _first_step(scene, tex, cfg, target, True)
    _force_caps(monkeypatch)
    clear_jit_cache()
    closs, cgrads, fit = _first_step(scene, tex, cfg, target, True)
    clear_jit_cache()
    (unit,) = fit.frame.programs[0].units.values()
    caps, counts = unit.steps_run, unit.counts.tolist()
    # a compacted step whose live count (after the step before) is below
    # its capacity: its fill lanes went through the backward
    assert any(C < unit.R and counts[k - 1] < C for k, C in enumerate(caps) if k), (caps, counts)
    assert closs == loss
    _assert_grads_close(cgrads, grads)


@pytest.fixture(scope="module", params=ROUTES)
def edge_chunks(request):
    """The demo at 8×8 toward a black target with edge AA (k = 2, a budget
    of 32 pixels: 128 sub-sample rays in chunks of 96 and 32) and compacted
    steps: one captured step with every piece under _NoHostRead, and the
    eager step."""
    fused = request.param
    mp = pytest.MonkeyPatch()
    scene, _ = tdemo.build_scene(8, 8)
    tex = with_mips(tdemo.demo_textures())
    cfg = RenderConfig(width=8, height=8, **DEMO, supersample=2, edge_budget_mult=2,
                       ray_chunk=96, fused=fused)
    target = torch.zeros((8, 8, 3))
    mode, ran = _NoHostRead(), set()
    eager = graphs._Eager.replay

    def replay(self):
        fn = self.fn
        ran.add(getattr(fn, "func", fn).__name__)
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

    try:
        mp.setattr(graphs._Eager, "replay", replay)
        for mod, name in ((sp, "step_probe_ref"), (nh, "nearest_hit_ref"),
                          (ss, "shadow_sweep_ref")):
            mp.setattr(mod, name, as_kernel(getattr(mod, name)))
        _force_caps(mp)
        clear_jit_cache()
        loss, grads, fit = _first_step(scene, tex, cfg, target, True)
        stepped = [u.steps_run for p in fit.frame.programs for u in p.units.values()]
    finally:
        mp.undo()
        clear_jit_cache()
    eager_step = _first_step(scene, tex, cfg, target, False)[:2]
    return dict(mode=mode, ran=ran, stepped=stepped, captured=(loss, grads), eager=eager_step,
                chunks=[R for p in fit.frame.programs for _, R in p.chunks])


def test_pieces_make_no_host_read(edge_chunks):
    ran = edge_chunks["ran"]
    assert {"_params_in", "_head", "_step", "_tail", "_loss", "_tail_bwd", "_step_bwd",
            "_head_bwd", "_params_out", "step"} <= ran, ran
    assert edge_chunks["mode"].ops > 1000
    # a compacted step ran (step 0 runs at the unit's full width)
    assert any(min(caps) < caps[0] for caps in edge_chunks["stepped"]), edge_chunks["stepped"]


def test_edge_aa_and_ray_chunks_equal_eager_step(edge_chunks):
    assert edge_chunks["chunks"] == [64, 96, 32]
    (loss, grads), (eloss, egrads) = edge_chunks["captured"], edge_chunks["eager"]
    assert loss == eloss
    _assert_grads_close(grads, egrads)


def test_resume_is_bit_identical(inverse, tmp_path):
    cfg = RenderConfig(**INV)
    kw = dict(lr=lambda i: 3e-2 * 0.7 ** i, param_paths=PARAMS, device="cpu",
              param_transform=tinv.QUAT_NORMALIZE)
    args = (inverse["guess"], TextureSet(), cfg, inverse["target"])
    whole, ck = str(tmp_path / "whole.npz"), str(tmp_path / "run.npz")
    s4, l4 = om.optimize_scene(*args, steps=4, checkpoint_path=whole, checkpoint_every=4, **kw)
    om.optimize_scene(*args, steps=2, checkpoint_path=ck, checkpoint_every=2, **kw)
    s, losses = om.optimize_scene(*args, steps=4, checkpoint_path=ck, checkpoint_every=2,
                                  resume=True, **kw)
    assert losses == l4
    assert torch.equal(s.camera.quat, s4.camera.quat) and torch.equal(s.spheres.pos,
                                                                       s4.spheres.pos)
    got, want = load_arrays(ck)[0], load_arrays(whole)[0]
    assert set(got) == set(want) and any(k.startswith("opt_state.") for k in want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("make", [
    lambda ps, lr: torch.optim.Adam(ps, lr=lr, capturable=False),
    lambda ps, lr: torch.optim.AdamW(ps, lr=lr, capturable=False),
    lambda ps, lr: torch.optim.NAdam(ps, lr=lr, capturable=False),
    lambda ps, lr: torch.optim.Rprop(ps, lr=lr, capturable=False),
    lambda ps, lr: torch.optim.ASGD(ps, lr=lr, capturable=False)])
def test_optimizer_that_cannot_be_captured_raises(make):
    """The card's refusal, made before any CUDA call (the recorder says it
    is the card's): an optimiser built with capturable=False."""
    x = torch.zeros(8, requires_grad=True)
    x.grad = torch.ones(8)
    rec = graphs.Recorder(torch.device("cpu"))
    rec.cuda = True
    with pytest.raises(ValueError, match="cannot be captured"):
        rec.capture_update(make([x], 0.1))
    assert not x.detach().any()


class _KeepGrads(torch.optim.SGD):
    def step(self, closure=None):
        self.grads = [p.grad.detach().clone() for p in self.param_groups[0]["params"]]
        return super().step(closure)


@pytest.mark.parametrize("make", [
    lambda ps: torch.optim.Adam(ps, lr=0.1, amsgrad=True),
    lambda ps: torch.optim.AdamW(ps, lr=0.1),
    lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9, nesterov=True),
    lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9, dampening=0.5),
    lambda ps: _KeepGrads(ps, lr=0.1),
    lambda ps: torch.optim.RAdam(ps, lr=0.1),
    lambda ps: torch.optim.Adamax(ps, lr=0.1),
    lambda ps: torch.optim.Adadelta(ps, lr=0.1),
    lambda ps: torch.optim.Adagrad(ps, lr=0.1, initial_accumulator_value=0.1),
    lambda ps: torch.optim.NAdam(ps, lr=0.1),
    lambda ps: torch.optim.Rprop(ps, lr=0.1),
    lambda ps: torch.optim.ASGD(ps, lr=0.1)])
def test_captured_update_equals_fresh_optimizer(make):
    """The captured update (on the card: the first replay runs the update
    as it is, the second captures it) takes the optimiser's own steps,
    whatever its state starts from (NAdam's mu_product at 1, Rprop's step size and ASGD's eta at lr,
    Adagrad's accumulator and SGD's dampened momentum elsewhere than 0)."""
    rng = np.random.default_rng(0)
    x0, grads = rng.standard_normal(64), rng.standard_normal((4, 64))
    runs = []
    for captured in (False, True):
        x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
        x.grad = torch.zeros_like(x)        # static, as a train frame's
        opt, update = make([x]), None
        for g in grads:
            x.grad.copy_(torch.from_numpy(g))
            if captured and update is None:
                update = graphs.Recorder(torch.device("cpu")).capture_update(opt)
            update.replay() if captured else opt.step()
        runs.append(x.detach())
    assert not torch.equal(runs[0], torch.tensor(x0, dtype=torch.float32))
    assert torch.equal(*runs)


def test_train_frame_is_the_runs_own(inverse):
    cfg = RenderConfig(**INV)
    args = (inverse["guess"], TextureSet(), cfg, inverse["target"], PARAMS)
    clear_jit_cache()
    a, b = om._Fit(*args, device="cpu"), om._Fit(*args, device="cpu")
    assert a.frame is not b.frame
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a.params.values(),
                                                            b.params.values()))
    kept = b.frame
    a.close()
    b.close()
    # one kept at most: the run's that ended last
    assert [f for f in rr._FRAMES.values() if isinstance(f, rr._TrainFrame)] == [kept]
    c = om._Fit(*args, device="cpu")
    assert c.frame is kept and not any(isinstance(f, rr._TrainFrame) for f in rr._FRAMES.values())
    other = tinv.make_scene(*GUESS, cam_quat=QUAT)
    other = dataclasses.replace(other, spheres=dataclasses.replace(
        other.spheres, radius=other.spheres.radius.repeat(2)))
    with pytest.raises(ValueError, match="another topology"):
        c.frame.load(other, c.textures, dict(c.params), c.target)
    clear_jit_cache()


def test_vjp_seeds_keep_autograds_order():
    """The leaf gradient of two pieces, the second's VJP seeded with the
    first's, equals one backward over both bit for bit; added afterwards it
    does not (float32 sums associate)."""
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(4096, generator=gen)
    cot = torch.randn(4096, generator=gen)

    def inner(x):
        return x.sin() * x

    def outer(h, x):
        return h * x.exp()

    x = x0.clone().requires_grad_(True)
    (whole,) = torch.autograd.grad(outer(inner(x), x), x, cot)
    h = inner(x0)
    g_h, g_x = tr.vjp(outer, [h, x0], [cot])
    (seeded,) = tr.vjp(inner, [x0], [g_h], seeds={0: g_x})
    (added,) = tr.vjp(inner, [x0], [g_h])
    assert torch.equal(seeded, whole)
    assert not torch.equal(added + g_x, whole)


@pytest.mark.parametrize("supersample", [1, 2], ids=["1spp", "edge"])
@pytest.mark.parametrize("fused", ROUTES)
def test_fixed_pose_steps_repeat(demo, fused, supersample):
    """(g): the demo at t = 60 s toward a black target; edge AA at k = 2
    with a budget of 48 pixels."""
    scene, handles = tdemo.build_scene(16, 8)
    posed = tdemo.update_scene(scene, handles, 0.0, 60.0)
    cfg = RenderConfig(width=16, height=8, **DEMO, supersample=supersample, edge_budget_mult=2,
                       fused=fused)
    fit = om._Fit(posed, demo[1], cfg, torch.zeros((8, 16, 3)), lr=0.0, device="cpu")
    params0 = {p: v.detach().clone() for p, v in fit.params.items()}
    steps = []
    for i in range(3):
        loss, _ = fit.step(i)
        steps.append((loss.clone(), {p: v.grad.clone() for p, v in fit.params.items()}))
    (loss, grads), later = steps[0], steps[1:]
    assert float(loss) > 0 and all(bool(g.isfinite().all()) for g in grads.values())
    assert sum(bool(g.any()) for g in grads.values()) >= 10
    for lk, gk in later:
        assert torch.equal(lk, loss)
        assert all(torch.equal(gk[p], g) for p, g in grads.items())
    assert all(torch.equal(v.detach(), params0[p]) for p, v in fit.params.items())
