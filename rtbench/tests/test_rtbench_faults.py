"""A whole run (past the look for a card) with the timed path broken
underneath sees ``correct`` come out false, once for each fault the cell
can have; unbroken, it comes out true.  One chip, so no exchange between
chips to leave out."""

from __future__ import annotations

import importlib.util
import json

import pytest
import torch


def run(root, capsys, cell, size, seed=101):
    spec = importlib.util.spec_from_file_location("rtbench_run_copy", root / "rtbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.set_num_threads(2)
    assert mod.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", "0",
                     "--device", "cpu", "--size", size]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _altered(render_jit):
    def broken(*a, **k):
        img = render_jit(*a, **k).clone()
        img[: img.shape[0] // 4, : img.shape[1] // 4] += 0.25
        return img
    return broken


def _half_rows(render_jit):
    def broken(*a, **k):
        img = render_jit(*a, **k).clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    return broken


def _stale(render_jit):
    first = []

    def broken(scene, *a, **k):
        if not first:
            first.append(scene)
        return render_jit(first[0], *a, **k)
    return broken


@pytest.mark.parametrize("fault", [None, "altered", "half_rows", "stale"])
def test_view_faults(bench_copy, capsys, monkeypatch, fault):
    from txr_torch.render import render as rr

    if fault:
        wrap = dict(altered=_altered, half_rows=_half_rows, stale=_stale)[fault]
        monkeypatch.setattr(rr, "render_jit", wrap(rr.render_jit))
    line = run(bench_copy, capsys, "demo-1080p-view", "64x36")
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_rows", "loss_altered"])
def test_fit_faults(bench_copy, capsys, monkeypatch, fault):
    from txr_torch.diff import optimize

    if fault == "state_unchanged":
        # the step renders and differentiates but never updates its state
        def step(self, i):
            self.lr.fill_(self.rate(i))
            self.frame.step()
            return self.frame.flat[0], self.frame.gnorm
        monkeypatch.setattr(optimize._Fit, "step", step)
    elif fault == "half_rows":
        loss = optimize.image_loss
        monkeypatch.setattr(optimize, "image_loss",
                            lambda img, t, kind="l2": loss(img[: img.shape[0] // 2],
                                                           t[: t.shape[0] // 2], kind))
    elif fault == "loss_altered":
        loss = optimize.image_loss
        monkeypatch.setattr(optimize, "image_loss", lambda *a, **k: 1.05 * loss(*a, **k))
    line = run(bench_copy, capsys, "demo-1080p-fit", "48x27")
    assert line["correct"] is (fault is None), line["checks"]
