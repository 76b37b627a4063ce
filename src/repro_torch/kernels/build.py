"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The JAX package has no counterpart: Pallas kernels are compiled by XLA.
Each ``csrc/*.cu`` source of a kernel package is compiled on first use into
its own shared library with a plain C interface, under ``build/repro_torch/``
in the checkout (git ignores ``build/``), and loaded with :mod:`ctypes`.
Headers shared between kernel packages (``lif.cuh``) live in
``kernels/include/``, which every compile gets as ``-I``.  A library's
file name carries a digest of its flags, of the sources in its own
``csrc/`` and of the shared headers, so an edited source or header is
rebuilt and a stale library is never loaded.  All the sources that
:func:`build` is given are compiled by parallel nvcc processes.

:func:`function` returns a kernel's C launch function with its argument
types set; :func:`stream` and :func:`raise_on` are the launch-side glue
every wrapper uses.  A launch through ctypes is invisible to PyTorch's
dispatcher, so a wrapper also reports its work with :func:`charge` to the
counter of :mod:`repro_torch.launch.hlo`, when one is active.

Nothing here runs at import time; the CPU tests import every module of the
port on a machine with no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
INCLUDE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "include")
BUILD_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build",
    "repro_torch"))

_LOADED: dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict[tuple[str, str], object] = {}

#: The active counters of :func:`repro_torch.launch.hlo.count`, the
#: innermost last (it pushes and pops them).
COUNTERS: list = []


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit (set CUDA_HOME)")


def library_path(source: str) -> str:
    """Where the library built from ``source`` lives (the name carries a
    digest of the flags, the sources and the shared headers)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for d in (os.path.dirname(source), INCLUDE_DIR):
        for name in sorted(os.listdir(d)):
            if name.endswith((".cu", ".cuh")):
                with open(os.path.join(d, name), "rb") as f:
                    h.update(name.encode() + f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(sources: list[str]) -> dict[str, float]:
    """Compile every source whose library is missing, all at once; returns
    the seconds from the start until each compile had finished.  Raises
    with nvcc's output on failure."""
    todo = [(s, library_path(s)) for s in sources
            if not os.path.exists(library_path(s))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    t0 = time.perf_counter()
    for src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", INCLUDE_DIR, "-o", tmp, src]
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
        lib = _LOADED[source] = ctypes.CDLL(library_path(source))
    return lib


def function(source: str, name: str, argtypes: list):
    """The C function ``name`` of ``source``'s library (built on first
    use), returning ``int`` (a ``cudaError_t``) and taking ``argtypes``."""
    fn = _FUNCTIONS.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FUNCTIONS[(source, name)] = fn
    return fn


def stream(dev) -> int:
    """The current stream of CUDA device ``dev``; the kernels launch on the
    current device, so the tensors must be there."""
    import torch
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(rc: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def charge(kernel: str, flops: float, nbytes: float) -> None:
    """Charge one launch of ``kernel``, doing ``flops`` and moving
    ``nbytes``, to the innermost active counter; nothing without one."""
    if COUNTERS:
        COUNTERS[-1].charge(kernel, flops, nbytes)


@contextlib.contextmanager
def unseen():
    """Run the body unseen by every active counter: its ops and storage
    are not counted (a kernel's plain version standing in for a launch
    that :func:`charge` counts)."""
    with contextlib.ExitStack() as stack:
        for c in COUNTERS:
            stack.enter_context(c.unseen())
        yield


def check_tensor(name: str, x, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's pointer arithmetic assumes."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, want {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


__all__ = ["BUILD_DIR", "COUNTERS", "INCLUDE_DIR", "NVCC_FLAGS", "build",
           "charge", "check_tensor", "function", "library_path", "load",
           "nvcc_path", "raise_on", "stream", "unseen"]
