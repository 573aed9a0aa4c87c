"""rtbench/control.py at a size a test run holds: the bfloat16 reference in
the program's place fails each cell's limits, and so does the fit's
half-rows fault."""

from __future__ import annotations

import pytest
import torch

from rtbench import check
from rtbench import control


@pytest.mark.parametrize("cell,config,traffic", [
    ("demo-1080p-view", "demo-1080p", "viewer-30fps"),
    ("demo-1080p-ultra-view", "demo-1080p-ultra", "viewer-30fps"),
    ("demo-1080p-fit", "demo-1080p", "fit-fixed-pose")])
def test_control_fails(cell, config, traffic):
    torch.set_num_threads(2)
    got = control.readings(config, traffic, 3000000051, "bfloat16", torch.device("cpu"),
                           size=(48, 27))
    lim = check.limits(cell)
    assert got and all(not check.decide(nums, lim)[0] for nums in got.values()), got
