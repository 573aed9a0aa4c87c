"""The port's entry points (txr_torch/entry.py), on the CPU.

``entry(device="cpu")`` hands back the JAX package's entry arguments (the
demo scene, leaf for leaf, and its textures) and a render of them at
192×108; ``dryrun_multichip(4, device="cpu")`` runs its world of 4 gloo
ranks through the sharded render, one sharded Adam step and the ring sweep
against the whole scene's nearest hit, and every rank reports the same
finite loss.
"""

import jax
import numpy as np
import torch

import __graft_entry__ as jentry
from txr_torch import bridge
from txr_torch import entry as tentry

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)


def test_entry_renders_the_demo_scene():
    fn, (scene, textures) = tentry.entry(device="cpu")
    _, (jscene, jtex) = jentry.entry()
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jscene)[0]}
    got = bridge.scene_to_numpy(scene)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for a, b in zip(textures.sphere, jtex.sphere):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    img = fn(scene, textures)
    assert tuple(img.shape) == (108, 192, 3) and img.device.type == "cpu"
    assert bool(torch.isfinite(img).all())


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    out = tentry.dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out
    assert "dryrun_multichip(4): mesh=(2, 2) loss=" in lines
    assert "dryrun_multichip(4): ring sweep mode ok" in lines
    assert len(out) == 4 and np.isfinite(out[0]["loss"])
    assert all(o["loss"] == out[0]["loss"] for o in out)
    assert all(o["launches"] == {"step_probe": 0, "glossy_rays": 0, "step_consume": 0,
                                 "nearest_hit": 0, "shadow_sweep": 0, "lane_compact": 0,
                                 "lane_scatter": 0}
               for o in out)
