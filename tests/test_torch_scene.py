"""txr_torch scene model, demo scene, quaternions and package boundary.

The port's demo scene and textures are built independently of the JAX
package and must equal it leaf for leaf (exactly: both pack the same
float32 values from the same numpy seeds); the JAX scene crosses over as
numpy through txr_torch.bridge.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.apps import demo as jdemo
from txr.geometry import quaternion as jq
from txr_torch import bridge
from txr_torch.apps import demo as tdemo
from txr_torch.geometry import quaternion as tq
from txr_torch.render.render import render
from txr_torch.render.trace import RenderConfig

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def test_demo_scene_matches_jax_leaf_for_leaf():
    jscene, jh = jdemo.build_scene(96, 54)
    tscene, th = tdemo.build_scene(96, 54)
    want = _jax_leaves(jscene)
    got = bridge.scene_to_numpy(tscene)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tscene.counts == jscene.counts
    assert tscene.reflect_depth == jscene.reflect_depth
    assert th == tdemo.DemoHandles(**vars(jh))
    # the bridge rebuilds the same scene from the JAX leaves
    crossed = bridge.scene_to_numpy(bridge.scene_from_numpy(want, jscene.reflect_depth))
    for k in want:
        np.testing.assert_array_equal(crossed[k], want[k], err_msg=k)


def test_demo_textures_match_jax():
    jt = jdemo.demo_textures()
    tt = tdemo.demo_textures()
    pairs = [(a, b) for a, b in zip(jt.sphere, tt.sphere)]
    pairs += [(jt.ring, tt.ring), (jt.box, tt.box), (jt.cubemap, tt.cubemap)]
    assert len(tt.sphere) == len(jt.sphere)
    for a, b in pairs:
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    crossed = bridge.textures_from_numpy(
        sphere=[np.asarray(s) for s in jt.sphere], ring=np.asarray(jt.ring),
        box=np.asarray(jt.box), cubemap=np.asarray(jt.cubemap))
    np.testing.assert_array_equal(crossed.cubemap.numpy(), tt.cubemap.numpy())


@pytest.mark.parametrize("fn", ["rotate", "conj", "mul", "from_euler", "from_axis_angle"])
def test_quaternion_matches_jax(fn):
    """Tolerance 1e-6 abs: float32 transcendentals may differ by an ulp."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    J = jnp.asarray
    if fn == "rotate":
        want, got = jq.rotate(J(q), J(v)), tq.rotate(torch.from_numpy(q), torch.from_numpy(v))
    elif fn == "conj":
        want, got = jq.conj(J(q)), tq.conj(torch.from_numpy(q))
    elif fn == "mul":
        want, got = jq.mul(J(q), J(q2)), tq.mul(torch.from_numpy(q), torch.from_numpy(q2))
    elif fn == "from_euler":
        want, got = jq.from_euler(J(ang)), tq.from_euler(torch.from_numpy(ang))
    else:
        want = jq.from_axis_angle(J(v), J(ang[:, 0]))
        got = tq.from_axis_angle(torch.from_numpy(v), torch.from_numpy(ang[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_txr():
    files = sorted((ROOT / "txr_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "txr")]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["render", "trace", "step_probe"])
def test_entry_points_without_cuda_raise(monkeypatch, entry):
    """No device argument means CUDA; without a card an entry point raises
    instead of carrying on on the CPU."""
    from txr_torch.kernels.step_probe import step_probe
    from txr_torch.render.raygen import primary_rays
    from txr_torch.render.trace import trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, _ = tdemo.build_scene(8, 8)
    tex = tdemo.demo_textures()
    cfg = RenderConfig(width=8, height=8)
    ro, rd = primary_rays(scene.camera, 8, 8)
    call = dict(render=lambda: render(scene, tex, cfg),
                trace=lambda: trace(scene, tex, cfg, ro, rd),
                step_probe=lambda: step_probe(scene, None, ro, rd))[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    launches = step_probe.launches
    assert render(scene, tex, cfg, device="cpu").shape == (8, 8, 3)
    assert step_probe.launches == launches     # the CPU path launches nothing


@pytest.mark.parametrize("rows", [6, 300])
def test_take_matches_indexing(rows):
    """utils.index.take: the values of table[idx] and the same gradient, by
    the one-hot product (small tables) or index_add (large ones), to f32
    rounding."""
    from txr_torch.utils.index import ONE_HOT_ROWS, take

    assert (rows <= ONE_HOT_ROWS) == (rows == 6)
    rng = np.random.default_rng(rows)
    table = torch.from_numpy(rng.normal(size=(rows, 3)).astype(np.float32)).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, rows, (64, 5)))
    w = torch.from_numpy(rng.normal(size=(64, 5, 3)).astype(np.float32))
    got = take(table, idx)
    torch.testing.assert_close(got, table[idx], rtol=0, atol=0)
    (g,) = torch.autograd.grad((got * w).sum(), table)
    (want,) = torch.autograd.grad((table[idx] * w).sum(), table)
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
