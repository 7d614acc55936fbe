"""Builds the sources under gpy_tpu_torch/csrc/ at first use.

Each CUDA source (`.cu`) compiles with nvcc, each host source (`.cpp`, the
state-space model's C++ engine) with g++, into a shared library with a
plain C interface in gpy_tpu_torch/_build/, which ctypes loads. Nothing is
built on import: only a wrapper that launches a kernel, or runs the host
engine, calls `load`. A library older than its source is rebuilt; a missing
compiler or a failed build raises. Each build and each first load is logged
at INFO on this module's logger (util/diagnostics.log_compiles).
"""
from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_libs: dict = {}
_lock = threading.Lock()
log = logging.getLogger(__name__)


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the C++ state-space engine needs a C++ compiler")
    return found


def _paths(name: str):
    """(source, library): csrc/<name>.cu, else csrc/<name>.cpp."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    if not os.path.exists(src):
        src = os.path.join(CSRC_DIR, name + ".cpp")
    return src, os.path.join(BUILD_DIR, f"lib{name}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu (nvcc) or csrc/<name>.cpp (g++) into
    _build/lib<name>.so and return the compiler's report (nvcc's with
    -Xptxas -v: registers, shared memory and spills per kernel)."""
    src, so = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ([_nvcc(), *NVCC_FLAGS] if src.endswith(".cu") else [_gxx(), *GXX_FLAGS])
    r = subprocess.run([*cmd, "-o", tmp, src], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed on {src}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees the old or the new file
    log.info("built %s from %s", so, src)
    return r.stdout + r.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu or .cpp, building it when it is
    missing or older than its source."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src, so = _paths(name)
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                build(name)
            lib = _libs[name] = ctypes.CDLL(so)
            log.info("loaded %s", so)
        return lib
