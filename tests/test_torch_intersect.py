"""The port's intersectors, sweep twins and nearest-hit backward vs the JAX package.

Inputs come from numpy seeds and cross over as numpy.  The per-type
intersectors compare to 1e-5 + 1e-5·|x| (float32 in another operation
order).  The sweep twins run against the Pallas kernels in interpret mode
on one 2048-ray tile: the 32×18 demo primary rays plus random rays (and,
for the shadow sweep, rays aimed at Saturn's ring); slot, solid and
ring-hit bits agree on ≥ 99.5 % of lanes, t and uv as in
tests/test_torch_probe.py.  Torus lanes are held to 5e-3 relative: the
port polishes the torus root on the factored quartic, the JAX package on
the expanded one (txr_torch/geometry/torus.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.apps import demo as jdemo
from txr.geometry import intersect as jgi
from txr.geometry import torus as jtorus
from txr.kernels.pallas_intersect import nearest_hit_pallas, shadow_sweep_pallas
from txr.render import intersect as jri
from txr.render.raygen import primary_rays as jprimary_rays
from txr_torch import bridge
from txr_torch.geometry import intersect as tgi
from txr_torch.geometry import quaternion as tq
from txr_torch.geometry import torus as ttorus
from txr_torch.kernels import nearest_hit as tnh
from txr_torch.kernels import shadow_sweep as tss
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.render import intersect as tri
from txr_torch.scene.types import TYPE_TORUS, float_leaves

R, P = 512, 3
LANES = 2048


def _rays(seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3))
    return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _prims(kind, rng):
    u = lambda lo, hi, *s: rng.uniform(lo, hi, (P,) + s).astype(np.float32)
    if kind == "sphere":
        return dict(pos=u(-2, 2, 3), radius=u(0.5, 1.5), hollow=np.array([False, True, True]))
    if kind in ("plane", "plane2"):
        n = rng.normal(size=(P, 3))
        return dict(pos=u(-2, 2, 3), normal=(n / np.linalg.norm(n, axis=-1,
                                                               keepdims=True)).astype(np.float32))
    if kind == "ring":
        return dict(pos=u(-2, 2, 3), q=_quats(rng, P), r1=u(0.1, 0.5), r2=u(1.0, 3.0))
    if kind == "box":
        return dict(pos=u(-2, 2, 3), q=_quats(rng, P), form=u(0.3, 1.5, 3))
    if kind == "surface":
        coef = np.array([[1, 1, -1, 0, 0, 0], [1, 1, 0, 0, 0, -1], [1, 0.5, 0.3, 0.1, 0.2, -1]],
                        np.float32)
        big = np.float32(3e38)
        return dict(pos=u(-2, 2, 3), q=_quats(rng, P), coef=coef,
                    v_min=np.array([[-big, -1, -big], [-2, -2, -2], [-big] * 3], np.float32),
                    v_max=np.array([[big, 2, big], [2, 2, 2], [big] * 3], np.float32))
    raise ValueError(kind)


def _close(got, want, share=0.999):
    """Hit masks agree on ≥ ``share`` of lanes; values within 1e-5 + 1e-5·|x|
    where both hit."""
    got, want = np.asarray(got), np.asarray(want)
    fin_g, fin_w = np.isfinite(got), np.isfinite(want)
    assert (fin_g == fin_w).mean() >= share, (fin_g == fin_w).mean()
    both = fin_g & fin_w
    assert both.sum() > 10
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["sphere", "plane", "plane2", "ring", "box", "surface"])
def test_intersector_t_and_normal_match_jax(kind):
    rng = np.random.default_rng(1)
    ro, rd = _rays(2)
    p = _prims(kind, rng)
    J = {k: jnp.asarray(v) for k, v in p.items()}
    T = {k: torch.from_numpy(v) for k, v in p.items()}
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)
    tro, trd = torch.from_numpy(ro), torch.from_numpy(rd)
    one = lambda d, j: {k: v[j] for k, v in d.items()}
    if kind == "sphere":
        want = jgi.sphere_t(jro, jrd, J["pos"], J["radius"], J["hollow"])
        got = tgi.sphere_t(tro, trd, T["pos"], T["radius"], T["hollow"])
        wn = jgi.sphere_normal(jro + jrd, J["pos"][0])
        gn = tgi.sphere_normal(tro + trd, T["pos"][0])
    elif kind.startswith("plane"):
        side = kind == "plane"
        want = jgi.plane_t(jro, jrd, J["pos"], J["normal"], side)
        got = tgi.plane_t(tro, trd, T["pos"], T["normal"], side)
        wn, gn = jgi.safe_normalize(J["normal"]), tgi.safe_normalize(T["normal"])
    elif kind == "ring":
        want = jgi.ring_t(jro, jrd, J["pos"], J["q"], J["r1"], J["r2"])
        got = tgi.ring_t(tro, trd, T["pos"], T["q"], T["r1"], T["r2"])
        wn, gn = jgi.ring_normal(J["q"]), tgi.ring_normal(T["q"])
        t0 = np.where(np.isfinite(np.asarray(want[:, 0])), np.asarray(want[:, 0]), 0.0)
        wuv = jgi.ring_uv(jro, jrd, jnp.asarray(t0), *(one(J, 0)[k] for k in
                                                        ("pos", "q", "r1", "r2")))
        guv = tgi.ring_uv(tro, trd, torch.from_numpy(t0), *(one(T, 0)[k] for k in
                                                             ("pos", "q", "r1", "r2")))
        np.testing.assert_allclose(guv.numpy(), np.asarray(wuv), rtol=1e-5, atol=1e-5)
    elif kind == "box":
        want = jgi.box_t(jro, jrd, J["pos"], J["q"], J["form"])
        got = tgi.box_t(tro, trd, T["pos"], T["q"], T["form"])
        wn = jgi.box_normal(jro, jrd, *(one(J, 1)[k] for k in ("pos", "q", "form")))
        gn = tgi.box_normal(tro, trd, *(one(T, 1)[k] for k in ("pos", "q", "form")))
    else:
        want = jgi.surface_t(jro, jrd, J["pos"], J["q"], J["coef"], J["v_min"], J["v_max"])
        got = tgi.surface_t(tro, trd, T["pos"], T["q"], T["coef"], T["v_min"], T["v_max"])
        t0 = np.where(np.isfinite(np.asarray(want[:, 2])), np.asarray(want[:, 2]), 0.0)
        wn = jgi.surface_normal(jro, jrd, jnp.asarray(t0), *(one(J, 2)[k] for k in
                                                             ("pos", "q", "coef")))
        gn = tgi.surface_normal(tro, trd, torch.from_numpy(t0), *(one(T, 2)[k] for k in
                                                                  ("pos", "q", "coef")))
    _close(got.numpy(), want)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-5, atol=1e-5)


def _torus_case():
    """Rays from a ring of origins aimed at points on a rotated torus's
    tube, with JAX's sweep root t0."""
    rng = np.random.default_rng(3)
    pos = np.array([0.3, -0.2, 4.0], np.float32)
    q = _quats(rng, 1)[0]
    form = np.array([1.0, 0.4], np.float32)
    th, ph = rng.uniform(0, 2 * np.pi, (2, R))
    local = np.stack([(1.0 + 0.4 * np.cos(ph)) * np.cos(th), (1.0 + 0.4 * np.cos(ph)) * np.sin(th),
                      0.4 * np.sin(ph)], -1).astype(np.float32)
    target = tq.rotate(tq.conj(torch.from_numpy(q)), torch.from_numpy(local)).numpy() + pos
    ro = (pos + rng.normal(size=(R, 3)) * 4.0).astype(np.float32)
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    t0 = np.asarray(jtorus.torus_t(jnp.asarray(ro), jnp.asarray(rd), pos[None], q[None],
                                   form[None]))[:, 0]
    return ro, rd, pos, q, form, t0


def test_torus_polish_and_gradient_match_jax():
    """torus_polish_t from JAX's sweep root, and d(Σt)/d(ro, rd, pos, quat,
    form) vs jax.grad, 5e-3 relative in norm, on the non-grazing lanes
    (|cos| ≥ 0.3 between ray and normal) where the two polished roots agree
    to 1e-4.
    The two polish different forms of the same quartic; the implicit
    gradient of the root is the same, but the expanded form loses the root
    to cancellation on far rays.  On every non-grazing lane the port's f32
    gradient is held, 5e-3, to the same polish in float64."""
    ro, rd, pos, q, form, t0 = _torus_case()
    B = lambda a: np.broadcast_to(a, (R,) + a.shape).copy()
    args = [ro, rd, B(pos), B(q), B(form)]
    tt = torch.from_numpy(np.where(np.isfinite(t0), t0, 0.0).astype(np.float32))
    targs0 = [torch.from_numpy(a) for a in args]
    gn = ttorus.torus_normal(*targs0[:2], tt, *targs0[2:])
    lanes = np.isfinite(t0) & (np.abs((gn.numpy() * rd).sum(-1)) > 0.3)
    jargs = [jnp.asarray(a) for a in args]

    def jloss(*a):
        t = jtorus.torus_polish_t(*a, jnp.asarray(t0))
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    def port(dtype):
        xs = [torch.from_numpy(a.astype(dtype)).requires_grad_(True) for a in args]
        t = ttorus.torus_polish_t(*xs, torch.from_numpy(t0.astype(dtype)))
        g = torch.autograd.grad(torch.where(torch.isfinite(t), t, 0.0).sum(), xs)
        return t.detach().numpy(), [x.numpy() for x in g]

    want_g = [np.asarray(g) for g in jax.grad(jloss, argnums=tuple(range(5)))(*jargs)]
    want_t = np.asarray(jtorus.torus_polish_t(*jargs, jnp.asarray(t0)))
    got_t, got_g = port(np.float32)
    _, ref_g = port(np.float64)
    with np.errstate(invalid="ignore"):
        agree = lanes & (np.abs(got_t - want_t) <= 1e-4 * np.abs(want_t))
    assert lanes.sum() > R // 4 and agree.sum() > R // 4
    np.testing.assert_allclose(got_t[lanes], want_t[lanes], rtol=5e-3)
    for g, w, r in zip(got_g, want_g, ref_g):
        assert np.linalg.norm(g[agree] - w[agree]) <= 5e-3 * np.linalg.norm(w[agree])
        np.testing.assert_allclose(g[lanes], r[lanes], rtol=5e-3,
                                   atol=5e-3 * np.abs(r[lanes]).max())
    wn = jtorus.torus_normal(*jargs[:2], jnp.asarray(tt.numpy()), *jargs[2:])
    np.testing.assert_allclose(gn.numpy()[lanes], np.asarray(wn)[lanes], rtol=1e-4, atol=1e-4)


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def demo_tile():
    """(JAX scene, port scene, ro, rd, torus slot) with one 2048-lane tile of
    rays: the 32×18 demo primary rays, then random rays."""
    jscene, _ = jdemo.build_scene(32, 18)
    ro, rd = jprimary_rays(jscene.camera, 32, 18, 1)
    rng = np.random.default_rng(0)
    n = LANES - 32 * 18
    ro2 = rng.uniform([-12, -3, -6], [12, 6, 10], (n, 3)).astype(np.float32)
    rd2 = rng.normal(size=(n, 3))
    rd2 = (rd2 / np.linalg.norm(rd2, axis=-1, keepdims=True)).astype(np.float32)
    RO = np.concatenate([np.asarray(ro), ro2])
    RD = np.concatenate([np.asarray(rd), rd2])
    tscene = bridge.scene_from_numpy(_jax_leaves(jscene))
    torus_slot = int(np.nonzero(tri._type_tables(tscene)[0].numpy() == TYPE_TORUS)[0][0])
    return jscene, tscene, RO, RD, torus_slot


def test_nearest_hit_twin_matches_pallas(demo_tile):
    jscene, tscene, RO, RD, torus_slot = demo_tile
    wt, ws = (np.asarray(a) for a in nearest_hit_pallas(jscene, jnp.asarray(RO), jnp.asarray(RD)))
    buf, hdr = pack_scene(tscene, None)
    launches = tnh.launch.launches
    gt, gs = tnh.nearest_hit_sweep(buf, hdr, torch.from_numpy(RO), torch.from_numpy(RD))
    assert tnh.launch.launches == launches              # the CPU path is the twin
    gt = np.where(gt.numpy() >= 1e30, np.inf, gt.numpy())
    gs = gs.numpy()
    hit = np.isfinite(wt) & np.isfinite(gt)
    assert (np.isfinite(wt) == np.isfinite(gt)).mean() >= 0.995
    agree = hit & (ws == gs)
    assert agree.sum() / np.isfinite(wt).sum() >= 0.995
    torus = agree & (ws == torus_slot)
    rest = agree & ~torus
    np.testing.assert_allclose(gt[rest], wt[rest], rtol=1e-4, atol=1e-4)
    assert torus.sum() >= 10
    np.testing.assert_allclose(gt[torus], wt[torus], rtol=5e-3)


def test_shadow_sweep_twin_matches_pallas(demo_tile):
    """Shadow rays: the tile's rays with random distances, half of them
    re-aimed at points of Saturn's ring from outside it, so ring hits and
    their uv are exercised."""
    jscene, tscene, RO, RD, _ = demo_tile
    rng = np.random.default_rng(4)
    ro, rd = RO.copy(), RD.copy()
    half = LANES // 2
    r1, r2 = float(tscene.rings.r1[0]), float(tscene.rings.r2[0])
    rad = np.sqrt(rng.uniform(r1, r2, half))
    ang = rng.uniform(0, 2 * np.pi, half)
    local = np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros(half)], -1).astype(np.float32)
    rq = tscene.rings.quat[0]
    target = tq.rotate(tq.conj(rq), torch.from_numpy(local)).numpy() + tscene.rings.pos[0].numpy()
    ro[:half] = target + rng.normal(size=(half, 3)).astype(np.float32) * 3000.0
    d = target - ro[:half]
    rd[:half] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    dist = rng.uniform(0.5, 3e4, LANES).astype(np.float32)
    ro, rd = ro.astype(np.float32), rd.astype(np.float32)
    ws, wh, wuv = (np.asarray(a) for a in shadow_sweep_pallas(
        jscene, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(dist)))
    buf, hdr = pack_scene(tscene, None)
    launches = tss.launch.launches
    gs, gh, guv = tss.shadow_sweep(buf, hdr, torch.from_numpy(ro), torch.from_numpy(rd),
                                   torch.from_numpy(dist))
    assert tss.launch.launches == launches
    gs, gh, guv = gs.numpy(), gh.numpy(), guv.numpy()
    assert (gs == ws).mean() >= 0.995
    assert (gh == wh).mean() >= 0.995 and wh.sum() >= 100
    both = gh & wh
    np.testing.assert_allclose(guv[both], wuv[both], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_nearest_vjp():
    """(t, ty, scene, ro and rd cotangents) of jax.vjp of the JAX nearest_hit's
    custom VJP for a cotangent ct of t, zero where t misses."""
    @jax.jit
    def jax_side(s, o, d, ct):
        (t, ty, _), vjp = jax.vjp(lambda s, o, d: jri.nearest_hit(s, o, d, True, "jnp"), s, o, d)
        zero = np.zeros(LANES, jax.dtypes.float0)
        return (t, ty) + vjp((jnp.where(jnp.isfinite(t), ct, 0.0), zero, zero))

    return jax_side


def _backward_vs_jax(demo_tile, jax_side, alive):
    """The port's nearest_hit backward, with lane mask ``alive`` (or None),
    vs jax.vjp with the cotangent zeroed on the dead lanes: ro, rd per live
    non-torus lane to 1e-3 of the lane's gradient norm, zero on dead lanes;
    every scene leaf to 2e-2 of its norm (torus leaves 5e-2)."""
    jscene, tscene, RO, RD, torus_slot = demo_tile
    rng = np.random.default_rng(5)
    ct = rng.normal(size=LANES).astype(np.float32)
    live = np.ones(LANES, bool) if alive is None else alive.numpy()
    t_j, ty_j, g_scene, g_ro, g_rd = jax_side(jscene, jnp.asarray(RO), jnp.asarray(RD),
                                              jnp.asarray(np.where(live, ct, 0.0)))
    t_j = np.asarray(t_j)
    leaves = float_leaves(tscene)
    ro, rd = torch.from_numpy(RO).requires_grad_(True), torch.from_numpy(RD).requires_grad_(True)
    for v in leaves.values():
        v.requires_grad_(True)
    t, ty, _ = tri.nearest_hit(tscene, ro, rd, alive=alive)
    assert not torch.isfinite(t[~torch.from_numpy(live)]).any()
    loss = (torch.where(torch.isfinite(t), t, 0.0) * torch.from_numpy(ct)).sum()
    grads = torch.autograd.grad(loss, [ro, rd, *leaves.values()], allow_unused=True)
    same = (ty.numpy() == np.asarray(ty_j)) & np.isfinite(t_j) & live
    assert same.sum() >= 0.99 * (np.isfinite(t_j) & live).sum()
    torus = ty.numpy() == TYPE_TORUS
    lanes = same & ~torus
    for g, w in ((grads[0], g_ro), (grads[1], g_rd)):      # per lane, 1e-3 of |w|
        assert (g.numpy()[~live] == 0).all()
        g, w = g.numpy()[lanes], np.asarray(w)[lanes]
        err = np.linalg.norm(g - w, axis=-1)
        assert (err <= 1e-3 * np.linalg.norm(w, axis=-1) + 1e-4).all(), err.max()
    want = {k: np.asarray(v) for k, v in _jax_leaves(g_scene).items() if k in
            {f".{p}" for p in leaves}}
    got = bridge.grads_to_numpy(dict(zip(leaves, grads[2:])))
    for k, w in want.items():
        if not w.size:
            continue
        g = got.get(k, np.zeros_like(w))
        rtol = 5e-2 if "toruses" in k else 2e-2
        assert np.linalg.norm(g - w) <= rtol * np.linalg.norm(w) + 1e-4, (k, g, w)


def test_nearest_hit_backward_matches_jax_vjp(demo_tile, jax_nearest_vjp):
    """The autograd.Function's backward (t_of_winner on the winner) vs
    jax.vjp of the JAX nearest_hit's custom VJP, for a random cotangent of t
    (``_backward_vs_jax``), every lane traced."""
    _backward_vs_jax(demo_tile, jax_nearest_vjp, None)


def test_nearest_hit_backward_masked_matches_jax_vjp(demo_tile, jax_nearest_vjp):
    """The same with a lane mask on 40 % of the lanes: the live lanes as
    jax.vjp's, the dead lanes missed and without gradient."""
    alive = torch.from_numpy(np.random.default_rng(6).random(LANES) < 0.4)
    _backward_vs_jax(demo_tile, jax_nearest_vjp, alive)


@pytest.mark.parametrize("mod", ["nearest_hit", "shadow_sweep"])
def test_launch_refuses_cpu_tensors(mod):
    """A kernel launcher never runs the twin: CPU rays raise, nothing counted."""
    scene = bridge.scene_from_numpy(_jax_leaves(jdemo.build_scene(8, 8)[0]))
    buf, hdr = pack_scene(scene, None)
    ro = torch.zeros((4, 3))
    m = dict(nearest_hit=tnh, shadow_sweep=tss)[mod]
    args = (buf, hdr, ro, ro + 1.0) + ((torch.ones(4),) if mod == "shadow_sweep" else ())
    before = m.launch.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        m.launch(*args)
    assert m.launch.launches == before


def test_all_t_matches_jax(demo_tile):
    """all_t, every (ray, slot) t of the demo tile, vs the JAX package's:
    hit masks agree on ≥ 99.5 % of pairs, t to 1e-4 (torus slot 5e-3)."""
    jscene, tscene, RO, RD, torus_slot = demo_tile
    want = np.asarray(jri.all_t(jscene, jnp.asarray(RO), jnp.asarray(RD)))
    got = tri.all_t(tscene, torch.from_numpy(RO), torch.from_numpy(RD)).numpy()
    assert got.shape == want.shape
    assert (np.isfinite(got) == np.isfinite(want)).mean() >= 0.995
    both = np.isfinite(got) & np.isfinite(want)
    torus = np.zeros_like(both)
    torus[:, torus_slot] = True
    assert both.sum() >= 256
    np.testing.assert_allclose(got[both & ~torus], want[both & ~torus], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[both & torus], want[both & torus], rtol=5e-3)
