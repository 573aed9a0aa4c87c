"""Build and load the CUDA kernels: shared libraries compiled from
``csrc/`` with ``nvcc`` at first use into ``kernels/_build``.

A library is a source and its ``-D`` defines.  ``step_probe``,
``step_consume``, ``shadow_sweep`` and ``lane_map`` take every scene in one
library; ``nearest_hit`` fixes the scene's slot counts at compile time, so
it is built once per topology
(``topology(hdr)``), as the Pallas kernel bakes its counts in at trace
time.  Each library is named by a hash of the compiler flags, its defines,
its source and every header the source includes, so a change to
``txr_common.cuh`` rebuilds all of them.  ``build_all`` starts one ``nvcc``
per library at once.  Each library has a plain C interface (``extern "C"``
launchers) and is loaded with ctypes; pointers and the stream pass as
``c_void_p``.  A failed build or launch raises: nothing falls back to
another library or to a twin.
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
# the defines of a topology: the counts of the seven slot types, in the
# header's order (scene_table.py SLOT_ORDER)
COUNT_DEFINES = ("TXR_N_PL", "TXR_N_SP", "TXR_N_SU", "TXR_N_BX", "TXR_N_TO", "TXR_N_RI",
                 "TXR_N_LP")
# -fmad=false: no multiply-add contraction, so each kernel rounds as its twin
# does (the f32 torus quartic is too ill-conditioned to tolerate either)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_libs = {}
_lock = threading.Lock()


def topology(hdr):
    """The defines that fix a packed table's slot counts: ("NAME=n", ...)."""
    return tuple(f"{k}={n}" for k, n in zip(COUNT_DEFINES, hdr[:len(COUNT_DEFINES)]))


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


def lib_path(name, defines=()):
    """Where the library of ``csrc/<name>.cu`` with ``defines`` lives for its
    current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for src in _files(os.path.join(CSRC, f"{name}.cu")):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtxr_{name}_{h.hexdigest()[:16]}.so")


def build_all(libs):
    """Compile every library (name, defines) in ``libs`` that is not built
    yet, one ``nvcc`` each, all started together.  → {(name, defines):
    (path, compiler log)}; a log is empty when nothing was compiled.  Raises
    if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, out = {}, {}
    for name, defines in libs:
        key = (name, tuple(defines))
        path = lib_path(*key)
        if os.path.exists(path):
            out[key] = (path, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in key[1]), "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        jobs[key] = (path, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
    errors = []
    for key, (path, tmp, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {key} ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, path)
        out[key] = (path, err)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name, symbol, argtypes, defines=()):
    """The ctypes function ``symbol`` of library (``name``, ``defines``),
    built if needed."""
    key = (name, tuple(defines))
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(build_all([key])[key][0])
        fn = getattr(_libs[key], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


def run(name, symbol, argtypes, device, hdr, *args, defines=()):
    """Launch through ``symbol`` of library (``name``, ``defines``) on
    ``device``'s current stream: the scene header as host ints (none for a
    library that reads no scene: ``hdr`` None), then ``args`` (ints for
    pointers and counts), then the stream.  Raises on a
    non-zero return: a CUDA error, or (negative) a table the library was
    not built for.  Nothing here waits on the device, so a CUDA graph can
    capture the launch once the library is loaded (``render_jit`` loads
    every library in its warm-up frame before it captures)."""
    import torch

    fn = load(name, symbol, argtypes, defines)
    if hdr is not None:
        hdr_c = (ctypes.c_int * len(hdr))(*hdr)     # host memory, read by the launcher
        args = (ctypes.addressof(hdr_c),) + args
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc < 0:
        raise RuntimeError(f"{name}: the packed table does not match the library's topology "
                           f"{defines}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
