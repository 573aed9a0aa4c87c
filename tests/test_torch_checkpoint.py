"""The port's checkpoints: bit-identical resume, a SIGKILL mid-run, and
scene files shared with the JAX package.

``optimize_scene`` on ``apps.inverse.make_scene`` at 16×16 with Adam and a
decaying lr: 8 steps in one run against 4 steps with a checkpoint every 2
and a resume to 8 in a fresh optimiser — losses, parameters and Adam's
moments bit-identical on the CPU.  A worker process that imports only
``txr_torch`` is killed with SIGKILL after its step-4 checkpoint, as
tests/test_fault_injection.py kills the JAX package's, and a fresh
process resumes from the file to the uninterrupted run's result, bit for
bit.  Scene files written by ``txr.utils.checkpoint.save_scene`` load
through the port's ``restore_scene`` and the reverse, every leaf equal.
"""

import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from txr.apps import demo as jdemo
from txr.utils import checkpoint as jck
from txr_torch import bridge
from txr_torch.apps import demo as tdemo
from txr_torch.utils import checkpoint as tck

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The run, as the worker below and the in-process tests both make it.
_RUN = """
import torch
from txr_torch.apps import inverse as tinv
from txr_torch.diff.optimize import optimize_scene
from txr_torch.render.render import render
from txr_torch.render.texture import TextureSet
from txr_torch.render.trace import RenderConfig

torch.set_num_threads(1)
CFG = RenderConfig(width=16, height=16, iterations=2, refractive_glossy=False)
TEX = TextureSet()
with torch.no_grad():
    TARGET = render(tinv.make_scene((0.3, 0.2, 6.0), 1.0, (0.1, 0.2, 0.9), (0, 0, -5)), TEX,
                    CFG, device="cpu")
GUESS = tinv.make_scene((-0.4, -0.3, 6.5), 0.8, (0.5, 0.5, 0.5), (0.3, 0.2, -5.2),
                        cam_quat=(0.0, 0.02, 0.0, 1.0))
KW = dict(lr=lambda step: 3e-2 * 0.7 ** step, device="cpu",
          param_paths=["spheres.pos", "spheres.radius", "camera.pos", "camera.quat"],
          param_transform=tinv.QUAT_NORMALIZE)


def run(steps, **kw):
    return optimize_scene(GUESS, TEX, CFG, TARGET, steps=steps, **KW, **kw)
"""

_WORKER = _RUN + """
import sys
import time

import numpy as np

ckpt, steps, resume, out, ready = sys.argv[1:6]


def on_step(i, _scene, _loss):
    # once step 4's checkpoint exists, say so and crawl, so that the
    # parent's SIGKILL lands between steps, mid-run
    if ready != "-" and i + 1 >= 4:
        if i + 1 == 4:
            open(ready, "w").write("ok")
        time.sleep(1.0)


scene, losses = run(int(steps), checkpoint_path=ckpt, checkpoint_every=2,
                    resume=resume == "1", callback=on_step)
np.savez(out, losses=np.array(losses), pos=scene.spheres.pos.numpy(),
         cam=scene.camera.pos.numpy(), quat=scene.camera.quat.numpy())
print("DONE")
"""

_ns = {}
exec(compile(_RUN, "<run>", "exec"), _ns)


def test_resume_is_bit_identical(tmp_path):
    ref_scene, ref_losses = _ns["run"](8)
    ck = str(tmp_path / "run.npz")
    _, first = _ns["run"](4, checkpoint_path=ck, checkpoint_every=2)
    saved = tck.load_arrays(ck)[0]
    assert int(saved["step"]) == 4 and list(saved["losses"]) == first
    scene, losses = _ns["run"](8, checkpoint_path=ck, checkpoint_every=2, resume=True)
    assert losses == ref_losses and losses[:4] == first
    for a, b in ((scene.spheres.pos, ref_scene.spheres.pos),
                 (scene.spheres.radius, ref_scene.spheres.radius),
                 (scene.camera.pos, ref_scene.camera.pos),
                 (scene.camera.quat, ref_scene.camera.quat)):
        assert torch.equal(a, b)
    # the file after 8 steps holds the optimiser of the uninterrupted run
    ck8 = str(tmp_path / "ref.npz")
    _ns["run"](8, checkpoint_path=ck8, checkpoint_every=8)
    resumed, whole = tck.load_arrays(ck)[0], tck.load_arrays(ck8)[0]
    assert sorted(resumed) == sorted(whole)
    assert {k.rsplit(".", 1)[-1] for k in whole if k.startswith("opt_state.")} == {
        "exp_avg", "exp_avg_sq", "step"}
    for k in whole:
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)


def test_restore_state_round_trip(tmp_path):
    """Parameters and Adam moments come back bit for bit, with the
    template's dtype and device, through an optimiser's load_state_dict."""
    ck = str(tmp_path / "run.npz")
    _ns["run"](2, checkpoint_path=ck, checkpoint_every=1)
    arrays = tck.load_arrays(ck)[0]
    template = {"params": {"camera.pos": torch.zeros(3), "spheres.radius": torch.zeros(1)},
                "step": np.int64(0), "losses": np.zeros(0)}
    st = tck.restore_state(ck, template)
    assert st["step"] == 2 and st["params"]["camera.pos"].dtype == torch.float32
    np.testing.assert_array_equal(st["params"]["camera.pos"].numpy(), arrays["params.camera.pos"])
    np.testing.assert_array_equal(st["losses"], arrays["losses"])


def test_sigkill_and_resume_matches_uninterrupted(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(ckpt, steps, resume, out, ready="-", kill=False):
        p = subprocess.Popen([sys.executable, "-c", _WORKER, str(ckpt), str(steps), resume,
                              str(out), str(ready)], env=env, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        if kill:
            deadline = time.time() + 300
            while time.time() < deadline and not os.path.exists(ready):
                if p.poll() is not None:
                    so, se = p.communicate()
                    raise AssertionError(f"worker exited before the kill point:\n{so}\n{se}")
                time.sleep(0.05)
            assert os.path.exists(ready), "worker never reached the kill point"
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=60)
            return None
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0 and "DONE" in so, f"{so}\n{se}"
        return np.load(out)

    ref_scene, ref_losses = _ns["run"](8)
    ready = tmp_path / "ready"
    run(tmp_path / "inv.npz", 8, "0", tmp_path / "dead.npz", ready=ready, kill=True)
    assert os.path.exists(tmp_path / "inv.npz"), "no checkpoint survived the kill"
    assert not os.path.exists(tmp_path / "dead.npz")
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    res = run(tmp_path / "inv.npz", 8, "1", tmp_path / "res.npz")
    assert list(res["losses"]) == ref_losses
    np.testing.assert_array_equal(res["pos"], ref_scene.spheres.pos.numpy())
    np.testing.assert_array_equal(res["cam"], ref_scene.camera.pos.numpy())
    np.testing.assert_array_equal(res["quat"], ref_scene.camera.quat.numpy())


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scene_files_interchange(tmp_path, writer):
    """The demo scene and its raw textures, written by one package and
    read by the other, every leaf equal (dtype included)."""
    jscene, _ = jdemo.build_scene(8, 8)
    rng = np.random.default_rng(4)
    ring = rng.uniform(0, 1, (4, 16, 4)).astype(np.float32)
    sphere = (rng.uniform(0, 1, (8, 16, 4)).astype(np.float32),)
    jtex = jdemo.TextureSet(sphere=tuple(map(jax.numpy.asarray, sphere)),
                            ring=jax.numpy.asarray(ring))
    tscene = bridge.scene_from_numpy(_jax_leaves(jscene), jscene.reflect_depth)
    ttex = bridge.textures_from_numpy(sphere=sphere, ring=ring)
    path = str(tmp_path / "scene.npz")
    extra = {"note": np.arange(3)}
    if writer == "jax":
        jck.save_scene(path, jscene, jtex, extra=extra)
        scene, tex = tck.restore_scene(path, tdemo.build_scene(8, 8)[0],
                                       bridge.textures_from_numpy(sphere=sphere, ring=ring))
        got, want = bridge.scene_to_numpy(scene), _jax_leaves(jscene)
        assert scene.reflect_depth == jscene.reflect_depth
        assert torch.equal(tex.ring, torch.from_numpy(ring)) and tex.box is None
    else:
        tck.save_scene(path, tscene, ttex, extra=extra)
        scene, tex = jck.restore_scene(path, jdemo.build_scene(8, 8)[0], jtex)
        got, want = _jax_leaves(scene), bridge.scene_to_numpy(tscene)
        assert scene.reflect_depth == tscene.reflect_depth
        np.testing.assert_array_equal(np.asarray(tex.ring), ring)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(tck.load_arrays(path)[0]["extra.note"], np.arange(3))
