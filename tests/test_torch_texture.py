"""txr_torch texture sampling vs the JAX package's samplers.

Both sides store quantised RGBA8 values (k/255 in float32) and lerp them
with the same float32 operations, so samples agree to 1e-6 absolute (a few
ulps of reassociation).  Textures and sample points come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.render import texture as jtx
from txr_torch.render import texture as ttx

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

SIZES = [(64, 128), (32, 64), (32, 32), (16, 256)]   # sphere ×2, box, ring
# a deep pyramid: 9 levels (1024×2048 down to 4×8), sampled at LOD up to
# 11, past its last level (the clamp)
DEEP = (1024, 2048)
ATOL = 1e-6


def _textures():
    rng = np.random.default_rng(5)
    texs = [rng.uniform(-0.1, 1.1, s + (4,)).astype(np.float32) for s in SIZES]
    cube = rng.uniform(0.0, 1.0, (6, 16, 16, 4)).astype(np.float32)
    j = jtx.TextureSet(sphere=(jnp.asarray(texs[0]), jnp.asarray(texs[1])),
                       box=jnp.asarray(texs[2]), ring=jnp.asarray(texs[3]),
                       cubemap=jnp.asarray(cube))
    t = ttx.TextureSet(sphere=(torch.from_numpy(texs[0]), torch.from_numpy(texs[1])),
                       box=torch.from_numpy(texs[2]), ring=torch.from_numpy(texs[3]),
                       cubemap=torch.from_numpy(cube))
    return texs, jax.jit(jtx.with_mips)(j), ttx.with_mips(t)    # as render_jit builds it


@pytest.fixture(scope="module")
def sets():
    return _textures()


@pytest.fixture(scope="module")
def deep():
    return np.random.default_rng(10).uniform(-0.1, 1.1, DEEP + (4,)).astype(np.float32)


@pytest.mark.parametrize("k", list(range(len(SIZES))) + ["deep"])
def test_mip_levels_match_jax(sets, deep, k):
    """Quantisation and the integer-exact 2×2 pyramid: bit-identical."""
    tex = deep if k == "deep" else sets[0][k]
    want = jtx._mip_levels(jnp.asarray(tex))
    got = ttx._mip_levels(torch.from_numpy(tex))
    assert len(got) == len(want) == (9 if k == "deep" else len(got))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_atlas_slot_map_matches_jax(sets):
    _, j, t = sets
    sa = j.atlas2d
    assert (t.atlas.n_sphere, t.atlas.box_slot, t.atlas.ring_slot) == (
        sa.n_sphere, sa.box_slot, sa.ring_slot)
    assert t.atlas.dims == tuple(zip(sa.pa.h0, sa.pa.w0))
    assert tuple(t.atlas.levels.tolist()) == sa.pa.levels


@pytest.mark.parametrize("trilinear,is_deep", [(False, False), (True, False), (True, True)],
                         ids=["False", "True", "deep"])
def test_sample_atlas_matches_jax_sample_packed(sets, deep, trilinear, is_deep):
    texs, _, t = sets
    if is_deep:
        # the deep texture in a sphere slot beside a small one
        texs = [deep, texs[1]]
        t = ttx.with_mips(ttx.TextureSet(sphere=tuple(torch.from_numpy(x) for x in texs)))
    pa = jtx.build_packed_atlas([jnp.asarray(x) for x in texs])   # same slot order
    rng = np.random.default_rng(6)
    n = 4096
    k = rng.integers(0, len(texs), n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 11.0 if is_deep else 8.0, n).astype(np.float32) if trilinear else None
    want = jtx.sample_packed(pa, jnp.asarray(k), jnp.asarray(uv),
                             None if lod is None else jnp.asarray(lod))
    got = ttx.sample_atlas(t.atlas, torch.from_numpy(k).long(), torch.from_numpy(uv),
                           None if lod is None else torch.from_numpy(lod))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_cubemap_matches_jax(sets):
    _, j, t = sets
    rng = np.random.default_rng(7)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:8] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
             [1, 1, 0], [0, -1, -1]]     # axes and face edges
    want = jtx.sample_cubemap_packed(j.cubemap_packed, jnp.asarray(d))
    got = ttx.sample_cubemap(t, torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    fj, uvj = jtx._cube_face_uv(jnp.asarray(d))
    ft, uvt = ttx._cube_face_uv(torch.from_numpy(d))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_allclose(uvt.numpy(), np.asarray(uvj), rtol=0, atol=ATOL)


def test_ring_alpha_matches_jax(sets):
    _, j, t = sets
    rng = np.random.default_rng(8)
    uv = rng.uniform(-0.5, 1.5, (4096, 2)).astype(np.float32)
    rap = j.ring_alpha_packed
    want = jtx.sample_packed(rap, jnp.zeros(4096, jnp.int32), jnp.asarray(uv), None)[..., 0]
    got = ttx.sample_ring_alpha(t, torch.from_numpy(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_sphere_uv_matches_jax():
    rng = np.random.default_rng(9)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    want = jtx.sphere_uv(jnp.asarray(n))
    got = ttx.sphere_uv(torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
