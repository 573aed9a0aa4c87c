"""txr_torch forward render of the demo scene vs the JAX package and the f64 oracle.

The port renders on the CPU (device="cpu": the probe kernel's plain twin).
Against the JAX jnp body the criterion is test_fused_step's: finite, at
most 1.5 % of pixels over 2e-3.  Where the two differ by more than 0.1
(test_fused_step's bound on the largest difference), the port must be the
one closer to the f64 oracle: those pixels are torus pixels, where the
JAX package's float32 root polish is off by up to ~1e-3 relative — as
large as the shadow-ray bias — and the port's is not (see
txr_torch/geometry/torus.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from txr.apps import demo as jdemo
from txr.ref.cpu_reference import render_oracle
from txr.render.render import render_jit
from txr.render.trace import RenderConfig as JConfig
from txr_torch.apps import demo as tdemo
from txr_torch.render import render as rr
from txr_torch.render.trace import RenderConfig
from txr_torch.utils.image import golden_check

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

SMALL = dict(width=32, height=18, iterations=3, extra_refraction_steps=2)


@pytest.fixture(scope="module")
def small():
    jscene, _ = jdemo.build_scene(32, 18)
    jtex = jdemo.demo_textures()
    want = np.asarray(render_jit(jscene, jtex, JConfig(**SMALL, fused="off")), np.float64)
    oracle = np.asarray(render_oracle(jscene, jtex, JConfig(**SMALL)), np.float64)
    scene, _ = tdemo.build_scene(32, 18)
    got = rr.render(scene, tdemo.demo_textures(), RenderConfig(**SMALL), device="cpu")
    return got.numpy().astype(np.float64), want, oracle


def test_render_matches_jax_32x18(small):
    got, want, oracle = small
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 2e-3).mean() <= 0.015, (diff > 2e-3).mean()
    far = diff > 0.1
    err_port = np.abs(got - oracle).max(axis=-1)[far]
    err_jax = np.abs(want - oracle).max(axis=-1)[far]
    assert (err_port < err_jax).all(), (np.argwhere(far), err_port, err_jax)


def test_render_matches_oracle_32x18(small):
    """test_golden's criterion (1 % of pixels over 2e-3, interior ≤ 0.5)."""
    got, _, oracle = small
    ok, frac, worst = golden_check(got, oracle, edge_frac=0.01)
    assert ok, (frac, worst)


def test_render_off_matches_oracle_32x18(small):
    """The eager route (fused="off": step_jnp over the nearest-hit and
    shadow-sweep twins) passes the same criterion against the oracle."""
    _, _, oracle = small
    scene, _ = tdemo.build_scene(32, 18)
    got = rr.render(scene, tdemo.demo_textures(), RenderConfig(**SMALL, fused="off"),
                    device="cpu").numpy().astype(np.float64)
    ok, frac, worst = golden_check(got, oracle, edge_frac=0.01)
    assert ok, (frac, worst)


def test_gate_render_matches_oracle_96x54():
    """The bench gate: 96×54, iterations=5, extra_refraction_steps=6 vs the
    cached f64 oracle image (txr/ref/gate_oracle.npz)."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "txr" / "ref" / "gate_oracle.npz"
    want = np.load(path)["img"]
    scene, _ = tdemo.build_scene(96, 54)
    cfg = RenderConfig(width=96, height=54, iterations=5, extra_refraction_steps=6)
    got = rr.render(scene, tdemo.demo_textures(), cfg, device="cpu").numpy()
    ok, frac, worst = golden_check(got, want)
    assert ok, (frac, worst)


def test_tiled_ray_order_matches(monkeypatch):
    """The 8×64 screen-tile ray order is a pure permutation."""
    scene, _ = tdemo.build_scene(64, 16)
    tex = tdemo.demo_textures()
    cfg = RenderConfig(width=64, height=16, iterations=2, extra_refraction_steps=1)
    tiled = rr.render(scene, tex, cfg, device="cpu")
    monkeypatch.setattr(rr, "TILE_W", 1 << 20)     # 16 % TILE_H == 0, 64 % TILE_W != 0
    plain = rr.render(scene, tex, cfg, device="cpu")
    torch.testing.assert_close(tiled, plain, rtol=0, atol=0)


def test_supersampling_modes():
    """SSAA box-averages a supersampled frame; edge AA (the default mode)
    re-renders some pixels of the 1-spp frame (tests/test_torch_aa.py)."""
    scene, _ = tdemo.build_scene(16, 8)
    tex = tdemo.demo_textures()
    cfg = RenderConfig(width=16, height=8, iterations=2, extra_refraction_steps=1,
                       supersample=2, aa_mode="ssaa")
    img = rr.render(scene, tex, cfg, device="cpu")
    assert img.shape == (8, 16, 3) and torch.isfinite(img).all()
    edge = rr.render(scene, tex, dataclasses.replace(cfg, aa_mode="edge"), device="cpu")
    one = rr.render(scene, tex, dataclasses.replace(cfg, supersample=1), device="cpu")
    assert edge.shape == (8, 16, 3) and torch.isfinite(edge).all()
    assert 0 < int((edge != one).any(-1).sum()) < 16 * 8
