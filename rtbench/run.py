#!/usr/bin/env python3
"""One run of one cell of the port's benchmark (BENCHMARK.json).

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``rtbench/configs/<config>.json``) and a
traffic mix (``rtbench/traffic/<traffic>.json``, driven by
``rtbench/loops.py``).  A run makes its textures and draws its poses from
``--seed``, builds and warms up the system (``setup_s``: from the process's
start to the first timed unit), measures for ``--seconds``, copies what the
timed path produced to the host, frees the program's state and compares
it with the plain reference (``rtbench/reference``, limits in
``rtbench/limits/<cell>.json``).  With ``--trace 0`` the result line holds
the cell's end-to-end metrics; with ``--trace 1`` a profiler traces a few
of the window's units and the line holds the cell's per-layer metrics,
each read by ``rtbench/metrics/<metric>.py``, and a breakdown.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then checks: each
number compared with its limit, also the last lines of standard error.
With no CUDA card, fewer cards than the cell asks for, JAX loaded once the
window has closed, or the program missing, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this folder leads sys.path: its modules must not shadow
# the standard library's or the program's, so they are imported as rtbench.*
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
FORBIDDEN = ("jax", "jaxlib", "flax", "txr")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man, workload, section):
    """The metrics of ``section`` that the cell reports: those whose
    ``workloads`` list it, or that have no such list."""
    return [m for m in man[section] if workload in m.get("workloads", [workload])]


def readers(metrics):
    """{metric name: its reader module} (``rtbench/metrics/<name>.py``)."""
    return {m["name"]: _load(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                             f"rtbench_metric_{i}") for i, m in enumerate(metrics)}


def least_ms(cfg, tallies):
    """{kernel: least ms a unit} of the reference's tallies (one per priced
    unit), by the frozen work model; the textures counted are those the
    configuration names (maybe none)."""
    from rtbench import scenedata
    from rtbench.work import prices

    if not tallies:
        return {}
    rows = scenedata.scene_rows(cfg)
    cnt = {k: len(rows[k]) for k in ("spheres", "planes", "surfaces", "boxes", "toruses",
                                      "rings", "lights_point", "lights_direct")}
    names = cfg.get("textures", {})
    n_tex = len(names.get("sphere", ())) + bool(names.get("box")) + bool(names.get("ring"))
    out = {}
    for tally in tallies:
        for k, row in prices.frame(cnt, n_tex, tally).items():
            out[k] = out.get(k, 0.0) + row["least_ms"] / len(tallies)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the CPU tests only: the plain CPU path at a small size
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--size", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"rtbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    w = cells[args.workload]
    # the program's kernel caches stay inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".rtbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.path.insert(0, ROOT)

    t = time.perf_counter()
    import torch

    phases = dict(start=t - T_START, import_torch=time.perf_counter() - t)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            print(f"rtbench: {args.workload} needs {w['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        dev = torch.device("cuda", 0)
        t = time.perf_counter()
        torch.empty(1, device=dev)
        phases["cuda_init"] = time.perf_counter() - t
    else:
        dev = torch.device(args.device)
    size = tuple(int(x) for x in args.size.split("x")) if args.size else None

    from rtbench import check, loops, scenedata

    cfg = scenedata.load_config(w["config"])
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    traced = bool(args.trace)
    metrics = cell_metrics(man, args.workload, "per_layer" if traced else "end_to_end")
    read = readers(metrics) if traced else {}
    kernels = sorted({k for r in read.values() for k in getattr(r, "KERNELS", ())})
    priced = any(getattr(r, "PRICED", False) for r in read.values())

    loop = loops.LOOPS[traffic["loop"]](cfg, traffic, args.seed, dev, traced=traced, size=size)
    capture_s = loop.setup()
    setup_s = time.perf_counter() - T_START
    phases.update(loop.phases)
    res = loop.window(args.seconds)
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    prof = loop.prof.read(kernels) if traced else None
    t_ref = time.perf_counter()
    out = loop.outputs()
    numbers, tallies = loop.compare(out, tally=priced)
    print(f"rtbench: setup {setup_s:.1f} s (capture {capture_s:.1f} s), window "
          f"{res['window_s']:.1f} s, reference {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    print("rtbench: setup phases (s) " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    correct, rows = check.decide(numbers, check.limits(args.workload))

    if traced:
        ctx = dict(kind=loop.kind, units=res["traced_units"], profile=prof,
                   host_ms=res.get("host_ms", []), wall_ms=res["wall_ms"], capture_s=capture_s,
                   least_ms=least_ms(cfg, tallies))
        values = {name: read[name].read(ctx) for name in read}
    else:
        values = dict(res, setup_s=setup_s)
    got = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in metrics
           if values.get(m["name"]) is not None}

    loaded = sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"rtbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4

    device = dict(platform="gpu" if cuda else dev.type,
                  kind=torch.cuda.get_device_name(dev) if cuda else dev.type,
                  count=w["chips"], memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=res["units"], failed=0 if correct else 1,
                  metrics=got, device=device)
    if traced and prof is not None:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"check {name} {v!r} " + ("(reading)" if lim is None else f"<= {lim!r}"),
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def bytecode_cache():
    """Keep the bytecode of every module this process imports (PyTorch's
    two thousand sources among them) in a fixed folder of the checkout.
    Where the environment forbids writing bytecode and the installation
    ships none, each run would compile them all again: several seconds of
    host work at every import of torch, which spread with the host's load.
    So the first run of a checkout compiles them and the later runs read
    them."""
    sys.pycache_prefix = os.path.join(ROOT, ".rtbench_cache", "pycache")
    sys.dont_write_bytecode = False


if __name__ == "__main__":
    bytecode_cache()
    sys.exit(main())
