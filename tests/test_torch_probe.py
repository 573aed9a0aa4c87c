"""The step probe's plain twin vs the JAX package's Pallas step probe.

One JAX call of step_probe_pallas (interpret mode on the CPU) on one
2048-lane tile: the 32×18 demo primary rays plus random rays made with
numpy.  The port's step_probe runs on the same rays with device="cpu",
which is its plain twin.  Lanes are compared where both hit the same slot.

Torus lanes are held apart: the port polishes the accepted torus root on
the factored quartic, which is accurate in float32, while the JAX package
polishes on the expanded coefficients, whose cancellation leaves ~1e-3
relative error at the demo's distances.  Their t is compared to 5e-3
relative; their other rows, and the shadow bits of rays that leave from
them, follow that t and are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.apps import demo as jdemo
from txr.kernels.pallas_step import step_probe_pallas
from txr.render.raygen import primary_rays as jprimary_rays
from txr.render.texture import with_mips as jwith_mips
from txr_torch.apps import demo as tdemo
from txr_torch.kernels.step_probe import step_probe, unpack
from txr_torch.render.texture import with_mips
from txr_torch.scene.types import TYPE_TORUS

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

W, H, LANES = 32, 18, 2048
TORUS_SLOT = 10      # demo slot order: 6 spheres, 2 surfaces, 2 boxes, the torus


@pytest.fixture(scope="module")
def probes():
    jscene, _ = jdemo.build_scene(W, H)
    jtex = jax.jit(jwith_mips)(jdemo.demo_textures())    # as render_jit builds it
    ro, rd = jprimary_rays(jscene.camera, W, H, 1)
    rng = np.random.default_rng(0)
    n = LANES - W * H
    ro2 = rng.uniform([-12, -3, -6], [12, 6, 10], (n, 3)).astype(np.float32)
    rd2 = rng.normal(size=(n, 3))
    rd2 = (rd2 / np.linalg.norm(rd2, axis=-1, keepdims=True)).astype(np.float32)
    RO = np.concatenate([np.asarray(ro), ro2])
    RD = np.concatenate([np.asarray(rd), rd2])
    want = step_probe_pallas(jscene, jtex.atlas2d, jnp.asarray(RO), jnp.asarray(RD),
                             pix_angle=1.0 / H, shade_flipped=True)
    want = {k: np.asarray(v) for k, v in want.items() if v is not None}

    tscene, _ = tdemo.build_scene(W, H)
    ttex = with_mips(tdemo.demo_textures())
    launches = step_probe.launches
    f, i = step_probe(tscene, ttex.atlas, torch.from_numpy(RO), torch.from_numpy(RD),
                      pix_angle=1.0 / H, shade_flipped=True, device="cpu")
    assert step_probe.launches == launches          # the CPU path is the twin
    got = {k: v.numpy() for k, v in unpack(f, i, tscene.counts).items() if v is not None}
    hit = np.isfinite(want["t"]) & np.isfinite(got["t"])
    agree = hit & (want["slot"] == got["slot"])
    return want, got, agree, agree & (want["slot"] != TORUS_SLOT)


def test_slot_agreement(probes):
    want, got, agree, _ = probes
    assert (np.isfinite(want["t"]) == np.isfinite(got["t"])).mean() >= 0.995
    assert agree.sum() / np.isfinite(want["t"]).sum() >= 0.995
    tdemo_scene, _ = tdemo.build_scene(W, H)
    from txr_torch.render.intersect import _type_tables
    assert int(_type_tables(tdemo_scene)[0][TORUS_SLOT]) == TYPE_TORUS


@pytest.mark.parametrize("key", ["slot", "kind", "req_k", "outside"])
def test_int_and_flag_rows_equal(probes, key):
    want, got, agree, _ = probes
    np.testing.assert_array_equal(got[key][agree], want[key][agree])


@pytest.mark.parametrize("key", ["light_solid", "ring_hit"])
def test_shadow_bits_equal(probes, key):
    want, got, _, lanes = probes
    np.testing.assert_array_equal(got[key][lanes].astype(bool), want[key][lanes].astype(bool))


@pytest.mark.parametrize("key", ["t", "n", "rm", "req", "tex_w", "color", "absorb", "diffuse",
                                 "reflect", "refract", "specular", "kd", "ks", "light_s",
                                 "ring_uv"])
def test_float_rows_close(probes, key):
    """1e-4 + 1e-4·|x|: XLA on the CPU contracts multiply-adds, PyTorch
    does not, so the last bits differ."""
    want, got, _, lanes = probes
    np.testing.assert_allclose(got[key][lanes], want[key][lanes], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key", ["light_spec", "lod"])
def test_spec_and_lod_close(probes, key):
    """1e-3: pow(·, specular ≤ 200) and log2 amplify last-bit differences."""
    want, got, _, lanes = probes
    np.testing.assert_allclose(got[key][lanes], want[key][lanes], rtol=0, atol=1e-3)


def test_launch_refuses_cpu_tensors():
    """The kernel launcher never runs the twin: CPU rays raise."""
    from txr_torch.kernels.step_probe import launch, pack_scene

    scene, _ = tdemo.build_scene(W, H)
    buf, hdr = pack_scene(scene, with_mips(tdemo.demo_textures()).atlas)
    ro = torch.zeros((4, 3))
    launches = step_probe.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        launch(buf, hdr, ro, ro + 1.0)
    assert step_probe.launches == launches


def test_torus_t_close(probes):
    want, got, agree, _ = probes
    torus = agree & (want["slot"] == TORUS_SLOT)
    assert torus.sum() >= 10
    np.testing.assert_allclose(got["t"][torus], want["t"][torus], rtol=5e-3)
