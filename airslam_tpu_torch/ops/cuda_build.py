"""Build and load the port's CUDA kernels (``airslam_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``. Builds happen at
first use, into ``airslam_tpu_torch/_build/`` (listed in ``.gitignore``), under
a name that carries a hash of the source and its flags, so an edited source
is rebuilt and a built one is reused. :func:`build` starts one ``nvcc`` per
source, all at once.

Nothing here runs at import: the CPU tests import every module on machines
without ``nvcc``, and only a CUDA tensor reaches this code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.normpath(os.path.join(_HERE, "..", "csrc"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))

# per-source extra flags; remap and bilerp keep their plain versions'
# unfused arithmetic (bit-equal to gridsample.remap, bilerp_plain and
# loi_features_plain), pose_gn keeps FMA contraction on purpose (see the
# note in its source), attention writes its fused multiply-adds out
KERNELS = {"remap": ("-fmad=false",), "bilerp": ("-fmad=false",), "pose_gn": (),
           "attention": ()}
_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str):
    src = os.path.join(SRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha1(f.read())
    h.update(" ".join(_COMMON + KERNELS[name]).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns each compiled source's compiler output
    (``-Xptxas=-v``: registers, shared memory, spills). Raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    running = []
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *_COMMON, *KERNELS[name], "-o", tmp, src]
        running.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs = {}
    for name, so, tmp, proc in running:
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
        logs[name] = out
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(_target(name)[1])
    return lib
