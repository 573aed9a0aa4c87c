"""The benchmark's own CPU tests (run with ``python -m pytest rtbench/tests``).

``bench_copy`` makes a copy of the benchmark (BENCHMARK.json and
rtbench/) with its traffic mixes shortened for the CPU, in which the
tests run cells and add files; the program is imported from the repo.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# a traffic mix's values shortened for a CPU run at a tiny size
QUICK = dict(check_span_s=0.1, trace_skip=1, trace_units=2, first_steps=3)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


# the fit cell: out of BENCHMARK.json while the program's captured step
# gives a NaN gradient at some poses (PERF.md §7); its loop, limits and
# metrics stay, and the tests run it from a copy of the manifest
FIT = dict(
    workload=dict(name="demo-1080p-fit", config="demo-1080p", traffic="fit-fixed-pose", chips=1,
                  why="the captured inverse-rendering step"),
    end_to_end=[dict(name="step_ms", unit="ms", better="lower", bound=0.05, source="host_clock",
                     workloads=["demo-1080p-fit"])],
    per_layer=[dict(name=n, unit=u, better=b, source="device_trace", layer=lay,
                    moves="step_ms", workloads=["demo-1080p-fit"])
               for n, u, b, lay in (("device_ms.fit", "ms", "lower", "train step"),
                                    ("idle_share.fit", "%", "lower", "device"),
                                    ("step_probe_roofline.fit", "%", "higher", "kernels"),
                                    ("step_consume_roofline.fit", "%", "higher", "kernels"),
                                    ("mfu.fit", "%", "higher", "kernels"))])


def with_fit(manifest):
    """The manifest with the fit cell and its metrics (the fit's first
    call records the program's capture spans too)."""
    manifest["workloads"].append(FIT["workload"])
    manifest["end_to_end"] += FIT["end_to_end"]
    manifest["per_layer"] += FIT["per_layer"]
    for m in manifest["per_layer"]:
        if m["name"] == "capture_graph_s":
            m["workloads"].append(FIT["workload"]["name"])
    return manifest


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark at tmp_path with quick traffic mixes and the
    fit cell."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(with_fit(json.load(f))))
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for p in (tmp_path / "rtbench" / "traffic").iterdir():
        mix = json.loads(p.read_text())
        mix.update({k: v for k, v in QUICK.items() if k in mix})
        p.write_text(json.dumps(mix))
    return tmp_path


def run_cell(root, *args, timeout=600):
    """``python3 rtbench/run.py`` in ``root`` on the CPU → (returncode, the
    last line of standard output parsed or None, standard error)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "rtbench/run.py", *args, "--device", "cpu"], cwd=root,
                       env=env, capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


def spheres_config(n):
    """A static configuration that is not the demo: ``n`` spheres in a
    square grid on a thin floor box, three point lights without
    attenuation, a background colour; no textures, handles or animation.
    The same ``n`` gives the same scene."""
    rng = np.random.default_rng(n)
    side = int(np.ceil(np.sqrt(n)))
    pitch = 16.0 / side
    mats = [dict(color=[0.5, 0.45, 0.35], specular=30, reflect=0.5),
            dict(color=[0.2, 0.4, 0.8], specular=60, reflect=0.3),
            dict(color=[0.9, 0.9, 0.9], specular=10, reflect=0.0)]
    spheres = []
    for k in range(n):
        r = pitch * float(0.2 + 0.25 * rng.random())
        x, z = -8.0 + pitch * (k % side + 0.5), 2.0 + pitch * (k // side + 0.5)
        spheres.append(dict(name=f"s{k}", pos=[x, -1.5 + r, z], radius=r, mat=mats[k % 3]))
    return dict(
        name=f"spheres-{n}", precision="float32",
        render=dict(width=1920, height=1080, iterations=5, extra_refraction_steps=0,
                    aa_preset=None, fused="auto", texture_lod=True, edge_threshold=0.02,
                    edge_budget_mult=20),
        material_defaults=dict(color=[0.0, 0.0, 0.0], specular=0.0, reflect=0.0, refract=0.0,
                               absorb=[0.0, 0.0, 0.0], diffuse=0.7, kd=0.8, ks=0.2),
        scene=dict(
            camera=dict(pos=[0.0, 4.0, -6.0], quat=dict(euler_deg=[20.0, 0.0, 0.0])),
            ambient_color=[0.05, 0.05, 0.05], shadow_ambient=[0.1, 0.1, 0.1],
            bg_color=[0.078, 0.361, 0.753],
            lights_point=[dict(pos=p, color=[1.0, 1.0, 1.0], intensity=0.6, radius=0.1,
                               linear_k=0.0, quadratic_k=0.0)
                          for p in ([4.0, 6.0, 2.0], [-5.0, 8.0, 4.0], [0.0, 5.0, -3.0])],
            spheres=spheres,
            boxes=[dict(name="floor", pos=[0.0, -1.6, 10.0], form=[9.0, 0.1, 9.0],
                        mat=dict(color=[0.8, 0.8, 0.7], specular=10))]))
