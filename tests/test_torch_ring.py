"""The port's primitive-sharded ring sweep (txr_torch/dist/ring.py) against
the JAX package's replicated ``nearest_hit`` and its ``ring_nearest_hit``,
on the CPU.

Two spawned worlds of gloo ranks, of 4 and of 8, each run every ring case
once (``tests/_torch_dist_worker.py: ring_cases``): tests/test_golden.py's
full scene at 40×24 and at 13×7 (91 rays, not divisible by the world), and
a tie scene of 8 identical spheres (one per shard at n = 8).  The contract
is tests/test_ring.py's: the port's ring and JAX's replicated sweep agree on
hit and t (rtol 1e-3, atol 2e-3) on all but 2 % of the rays, each
disagreement carries a silhouette certificate both ways, and the rays with
a clear winner agree on type and index.  An exact cross-shard tie goes to
index 0 on every ray, from every home shard.  At n = 4 the port's ring is
held against JAX's ``ring_nearest_hit`` itself, under the same contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dist_worker as worker
from tests.test_golden import full_scene
from tests.test_ring import GAP, JITTER, T_TOL
from txr.dist.mesh import make_mesh as jmake_mesh
from txr.dist.ring import pad_scene_for_ring as jpad_scene_for_ring
from txr.dist.ring import ring_nearest_hit as jring_nearest_hit
from txr.render.intersect import all_t as jall_t
from txr.render.intersect import nearest_hit as jnearest_hit
from txr.render.raygen import primary_rays as jprimary_rays
from txr.scene.factories import SceneBuilder
from txr_torch import bridge
from txr_torch.dist.mesh import spawn_world
from txr_torch.dist.ring import pad_scene_for_ring
from txr_torch.render.intersect import nearest_hit
from txr_torch.render.raygen import primary_rays

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

SIZES = dict(full=(40, 24), odd=(13, 7), tie=(16, 8))


def _leaves(scene):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]}


def _tie_scene():
    b = SceneBuilder(camera_pos=(0, 0, -5))
    for _ in range(8):
        b.add_sphere((0, 0, 3), 1.0, b.material((1, 0, 0)))
    return b.build()


def _scenes():
    return dict(full=full_scene()[0], odd=full_scene()[0], tie=_tie_scene())


@pytest.fixture(scope="module")
def rings():
    """{n: {case: (t, type, index) of every rank}} from worlds of 4 and 8."""
    cases = [(name, _leaves(s), *SIZES[name]) for name, s in _scenes().items()]
    return {n: spawn_world(n, worker.ring_cases, cases, device="cpu", timeout_s=240)
            for n in (4, 8)}


_nearest = jax.jit(lambda s, o, d: jnearest_hit(s, o, d))
_all_t = jax.jit(lambda s, o, d: jall_t(s, o, d))
CERT_RAYS = 64      # rays per certificate call, padded: one compilation


@pytest.fixture(scope="module")
def refs():
    """{case: (scene, ro, rd, JAX's replicated (t, type, index), clear)}:
    ``clear`` marks the rays whose nearest t beats the runner-up by more
    than GAP (tests/test_ring.py: _clear_winners)."""
    out = {}
    for name, scene in _scenes().items():
        ro, rd = jprimary_rays(scene.camera, *SIZES[name], 1)
        T = np.asarray(_all_t(scene, ro, rd))
        T = np.where(np.isfinite(T), T, 1e30)
        two = np.sort(T, axis=-1)[:, :2]
        clear = (two[:, 1] - two[:, 0]) > GAP if T.shape[1] > 1 else np.ones(len(T), bool)
        out[name] = (scene, ro, rd, tuple(np.asarray(x) for x in _nearest(scene, ro, rd)), clear)
    return out


def _certified(scene, ro, rd, rays, ty_want, idx_want):
    """tests/test_ring.py's silhouette certificate: for each listed ray, some
    JITTER-perturbed direction makes JAX's replicated sweep report
    (ty_want, idx_want).  The rays go in blocks of CERT_RAYS."""
    out = np.zeros(len(rays), bool)
    for s in range(0, len(rays), CERT_RAYS):
        blk = np.resize(rays[s:s + CERT_RAYS], CERT_RAYS)
        k = min(CERT_RAYS, len(rays) - s)
        rd_b = rd[blk]
        side = jnp.cross(rd_b, jnp.array([0.0, 1.0, 0.0]))
        side = side / jnp.linalg.norm(side, axis=-1, keepdims=True)
        vert = jnp.cross(rd_b, side)
        for du, dv in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1)):
            rdp = rd_b + JITTER * (du * side + dv * vert)
            rdp = rdp / jnp.linalg.norm(rdp, axis=-1, keepdims=True)
            _, ty_j, idx_j = _nearest(scene, ro[blk], rdp)
            out[s:s + k] |= ((np.asarray(ty_j)[:k] == ty_want[s:s + k])
                             & (np.asarray(idx_j)[:k] == idx_want[s:s + k]))
    return out


def _check_contract(ref, want, got, require_clear_majority=True):
    """tests/test_ring.py's contract between (t, type, index) ``want`` (JAX)
    and ``got`` (the port's ring)."""
    scene, ro, rd, _, clear = ref
    t0, ty0, i0 = (np.asarray(x) for x in want)
    t1, ty1, i1 = got
    agree = (np.isfinite(t0) == np.isfinite(t1)) & (
        ~np.isfinite(t0) | np.isclose(t1, t0, rtol=1e-3, atol=T_TOL))
    bad = np.where(~agree)[0]
    assert len(bad) <= max(2, int(0.02 * len(t0))), f"{len(bad)}/{len(t0)} rays disagree"
    if len(bad):
        cert_ring = _certified(scene, ro, rd, bad, ty1[bad], i1[bad])
        cert_repl = _certified(scene, ro, rd, bad, ty0[bad], i0[bad])
        assert (cert_ring & cert_repl).all(), bad[~(cert_ring & cert_repl)]
    hit = np.isfinite(t0) & agree
    clear = clear & hit
    if require_clear_majority:
        assert clear.sum() > 0.5 * hit.sum()
    np.testing.assert_array_equal(ty1[clear], ty0[clear])
    np.testing.assert_array_equal(i1[clear], i0[clear])


def _same_on_every_rank(world, name):
    """Every rank holds rank 0's answer bit for bit (one all_gather)."""
    for rank in world[1:]:
        for a, b in zip(rank[name], world[0][name]):
            np.testing.assert_array_equal(a, b)
    return world[0][name]


def test_padded_scene_never_hits_padding():
    """The port's padding equals JAX's leaf for leaf, and the port's sweep
    over the padded scene meets only phantoms past the cap."""
    scene = full_scene()[0]
    want = _leaves(jpad_scene_for_ring(scene, 8))
    tscene = bridge.scene_from_numpy(_leaves(scene))
    padded = pad_scene_for_ring(tscene, 8)
    got = bridge.scene_to_numpy(padded)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k, c in padded.counts.items():
        assert c % 8 == 0 and c >= tscene.counts[k]
    ro, rd = primary_rays(tscene.camera, 40, 24, 1)
    with torch.no_grad():
        t0, ty0, i0 = nearest_hit(tscene, ro, rd)
        t1, ty1, i1 = nearest_hit(padded, ro, rd)
    t1 = torch.where(t1 >= 1e8, torch.inf, t1)
    torch.testing.assert_close(t1, t0, rtol=0, atol=0)
    assert torch.equal(ty1, ty0) and torch.equal(i1[torch.isfinite(t0)], i0[torch.isfinite(t0)])


@pytest.mark.parametrize("n", [4, 8])
def test_ring_matches_replicated(rings, refs, n):
    _check_contract(refs["full"], refs["full"][3], _same_on_every_rank(rings[n], "full"))


@pytest.mark.parametrize("n", [4, 8])
def test_ring_exact_tie_deterministic(rings, refs, n):
    """Every ray ties across all 8 identical spheres: the lower global slot,
    index 0, wins on every ray, from every home shard, with JAX's t."""
    t0, ty0, i0 = refs["tie"][3]
    hit = np.isfinite(t0)
    assert hit.any() and (i0[hit] == 0).all()
    for rank in rings[n]:
        t1, ty1, i1 = rank["tie"]
        np.testing.assert_array_equal(t1, t0)
        np.testing.assert_array_equal(ty1, ty0)
        np.testing.assert_array_equal(i1, np.where(hit, 0, -1))


@pytest.mark.parametrize("n", [4, 8])
def test_ring_odd_ray_count(rings, refs, n):
    got = _same_on_every_rank(rings[n], "odd")
    assert got[0].shape == (91,)
    _check_contract(refs["odd"], refs["odd"][3], got, require_clear_majority=False)


def test_ring_matches_jax_ring(rings, refs):
    scene, ro, rd, _, _ = refs["full"]
    mesh = jmake_mesh((4,), axis_names=("sp",), devices=jax.devices()[:4])
    want = jring_nearest_hit(scene, ro, rd, mesh)
    _check_contract(refs["full"], want, _same_on_every_rank(rings[4], "full"))
