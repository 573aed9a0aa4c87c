#!/usr/bin/env python3
"""The controls of the check (not run by the benchmark's own runs).

    python3 rtbench/control.py --workload <cell> --seeds 1,2,3 [--dtype bfloat16]

For each seed it puts the plain reference, computed in ``--dtype`` (the
precision below the configuration's float32), in the program's place and
compares it with the float64 reference exactly as a run compares the
program: the numbers it prints are the control's readings, the upper ends
of the limits in ``rtbench/limits/<cell>.json`` (PERF.md).  For a fit cell
it also reads the fault "half of the batch left out": the float64
reference's loss and gradient of the mean over the top half of the rows.
It does not run the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def readings(config, traffic, seed, dtype, dev, size=None):
    """{reading name: numbers} of one seed's control (and faults) for the
    configuration and traffic mix named."""
    import torch

    from rtbench import loops, scenedata

    cfg = scenedata.load_config(config)
    with open(os.path.join(HERE, "traffic", f"{traffic}.json")) as f:
        traffic = json.load(f)
    loop = loops.LOOPS[traffic["loop"]](cfg, traffic, seed, dev, size=size)
    dt = getattr(torch, dtype)
    out = {dtype: loop.compare(loop.control(dt))[0]}
    if traffic["loop"] == "fit":
        half = slice(0, loop.settings.height // 2)
        out["half_rows"] = loop.compare(loop.control(torch.float64, rows=half))[0]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    dev = torch.device(args.device)
    size = tuple(int(x) for x in args.size.split("x")) if args.size else None
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        w = {c["name"]: c for c in json.load(f)["workloads"]}[args.workload]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              **readings(w["config"], w["traffic"], seed, args.dtype, dev,
                                         size))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
