"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The JAX package has no counterpart: Pallas kernels are compiled by XLA.
Each ``csrc/*.cu`` source of a kernel package is compiled on first use into
its own shared library with a plain C interface, under ``build/repro_torch/``
in the checkout (git ignores ``build/``), and loaded with :mod:`ctypes`.
A library's file name carries a digest of its sources and flags, so an
edited source is rebuilt and a stale library is never loaded.  All the
sources that :func:`build` is given are compiled by parallel nvcc
processes.

Nothing here runs at import time; the CPU tests import every module of the
port on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
BUILD_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build",
    "repro_torch"))

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit (set CUDA_HOME)")


def _library_path(source: str) -> str:
    csrc = os.path.dirname(source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(csrc)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(name.encode() + f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(sources: list[str]) -> dict[str, float]:
    """Compile every source whose library is missing, all at once; returns
    the seconds from the start until each compile had finished.  Raises
    with nvcc's output on failure."""
    todo = [(s, _library_path(s)) for s in sources
            if not os.path.exists(_library_path(s))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    t0 = time.perf_counter()
    for src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    seconds, errors = {}, []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        seconds[os.path.basename(src)] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src}:\n{out.decode()}")
        else:
            os.replace(tmp, lib)   # atomic: concurrent builders never clash
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        build([source])
        lib = _LOADED[source] = ctypes.CDLL(_library_path(source))
    return lib


__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "nvcc_path"]
