"""What the benchmark may import and read: nothing of JAX or of the JAX
package anywhere under rtbench/, nothing of the program in the reference
and the work model, and none of the files that the old benchmark and the
JAX package keep."""

from __future__ import annotations

import ast
import os

from conftest import ROOT

BENCH = os.path.join(ROOT, "rtbench")
NEVER = {"jax", "jaxlib", "flax", "txr"}
# paths of the JAX package's and the former benchmark's files
NOT_READ = ("bench.py", "bench_torch.py", "txr/", "txr_torch/ref", "scripts/")


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                with open(p) as fh:
                    yield os.path.relpath(p, ROOT), ast.parse(fh.read())


def imported(tree):
    """Top-level names of every absolute import, whole (txr_torch is not
    txr)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def literals(tree):
    """String constants that are not docstrings."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_nothing_imports_jax_or_the_jax_package():
    bad = {p: imported(t) & NEVER for p, t in sources() if imported(t) & NEVER}
    assert not bad


def test_reference_and_work_model_import_nothing_of_the_program():
    for p, t in sources():
        if p.startswith(("rtbench/reference", "rtbench/work")):
            assert "txr_torch" not in imported(t), p


def test_no_file_of_the_old_benchmark_or_the_jax_package_is_read():
    for p, t in sources():
        if "/tests/" in p:
            continue
        for s in literals(t):
            assert not any(x in s for x in NOT_READ), (p, s)


def test_the_scan_compares_whole_names():
    assert imported(ast.parse("import txr_torch.render\nfrom txr_torch import x")) == {"txr_torch"}
    assert imported(ast.parse("import txr.render")) & NEVER == {"txr"}
