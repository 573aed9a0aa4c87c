"""Build and load the CUDA kernels: one shared library per source in
``csrc/``, compiled with ``nvcc`` at first use into ``kernels/_build``.

Each library is named by a hash of the compiler flags, its source and every
header the source includes, so a change to ``txr_common.cuh`` rebuilds all
three.  ``build_all`` starts one ``nvcc`` per source at once.  Each library
has a plain C interface (``extern "C"`` launchers) and is loaded with
ctypes; pointers and the stream pass as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("step_probe", "nearest_hit", "shadow_sweep")
# -fmad=false: no multiply-add contraction, so each kernel rounds as its twin
# does (the f32 torus quartic is too ill-conditioned to tolerate either)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_libs = {}
_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _files(path, seen=None):
    """``path`` and every local header it includes, recursively."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    with open(path) as f:
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M):
            _files(os.path.join(os.path.dirname(path), inc), seen)
    return seen


def lib_path(name):
    """Where the library of ``csrc/<name>.cu`` lives for its current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _files(os.path.join(CSRC, f"{name}.cu")):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtxr_{name}_{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES):
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  → {name: (path, compiler
    log)}; a log is empty when nothing was compiled.  Raises if any
    compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, out = {}, {}
    for name in names:
        path = lib_path(name)
        if os.path.exists(path):
            out[name] = (path, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        jobs[name] = (path, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (path, tmp, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, path)
        out[name] = (path, err)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name, symbol, argtypes):
    """The ctypes function ``symbol`` of library ``name``, built if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build_all((name,))[name][0])
        fn = getattr(_libs[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


def run(name, symbol, argtypes, device, hdr, *args):
    """Launch through ``symbol`` on ``device``'s current stream: the scene
    header as host ints, then ``args`` (ints for pointers and counts), then
    the stream.  Raises on a non-zero CUDA error."""
    import torch

    fn = load(name, symbol, argtypes)
    hdr_c = (ctypes.c_int * len(hdr))(*hdr)     # host memory, read by the launcher
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.addressof(hdr_c), *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
