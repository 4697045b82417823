"""Build and load the port's CUDA kernels at first use.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  Libraries go to ``_build_out/`` (listed in .gitignore),
named by a hash of the sources, so an edited source is rebuilt and an
unchanged one is not.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build_out")
SOURCES = ("pair_sweep", "cells")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [
            os.path.join(CSRC, name + ".cu")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, temporary output, final path)."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None, None, path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def _finish(name: str, proc, tmp: str, path: str) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source that needs it, all nvcc processes at once.
    Returns {name: compiler log} (empty for sources already built)."""
    started = {name: _start(name) for name in names}
    return {name: _finish(name, *started[name]) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        _libs[name] = lib
    return lib


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")
