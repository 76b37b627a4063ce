"""JAX's threefry-2x32 stream as one CUDA kernel a call.

No counterpart in ``repro/kernels/``: the reference draws through
``jax.random``, which XLA fuses.  The port draws through
:mod:`repro_torch.random`, and these wrappers are its device path:

================== ============================================= ===========
wrapper            replaces                                      CUDA source
================== ============================================= ===========
threefry_split     ``split``: the int64 chain of :mod:`.ref`       threefry.cu
threefry_bits      ``random_bits``: the same chain               threefry.cu
threefry_bernoulli ``bernoulli``: the chain and compare          threefry.cu
================== ============================================= ===========

The chain issues ~175 elementwise launches a call; the kernel is one, and
gives the same bits in both threefry modes (the source's note has the
design).  A wrapper takes the chain for keys on the CPU, launches the
kernel for keys on a CUDA device, and returns an empty result of the right
shape on ``meta``; there is no fallback from one to the other.  Under an
active counter (:mod:`repro_torch.launch.hlo`) every device charges one
launch with the kernel's bytes (the keys and the result; FLOPs 0, as the
counter counts products only), and the CPU runs the chain unseen by it
(:func:`repro_torch.kernels.build.unseen`), so a count on ``meta`` equals
the count on the CPU.  ``LAUNCHES``
counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels import build
from .ref import bernoulli_ref, random_bits_ref, split_ref

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "threefry.cu")
SOURCES = {"threefry_split": SOURCE, "threefry_bits": SOURCE,
           "threefry_bernoulli": SOURCE}

#: Kernel launches per wrapper (plain-version calls are not counted).
LAUNCHES = {name: 0 for name in SOURCES}

# the kernel's out_kind: both words, 32-bit words, Bernoulli draws
_KEYS, _BITS, _DRAWS = 0, 1, 2

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P, _L, _L, _L, _L, _I, _I, _P, _F, _P]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _key_rows(key: torch.Tensor) -> torch.Tensor:
    """``key`` [..., 2] as [L, 2] rows: a view where the strides allow it
    (the carry's key, a strided view of the last split, is one)."""
    if key.dtype != torch.int64 or key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"keys must be int64 [..., 2], got {key.dtype} "
                         f"{tuple(key.shape)}")
    return key.reshape(-1, 2)


def _call(name: str, key: torch.Tensor, shape: tuple, dtype, plain, *,
          size: int, kind: int, partitionable: bool, p: float = 0.0
          ) -> torch.Tensor:
    """One call: ``plain()`` on the CPU, one launch on CUDA, an empty
    ``shape`` on meta; ``size`` counters (counts in the original mode) a
    key row."""
    rows = _key_rows(key)
    dev = key.device
    if dev.type == "cpu" and not build.COUNTERS:
        return plain()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: no kernel for {dev}")
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type == "cpu":
        # the kernel's result, computed by the chain where no counter sees
        # the chain's ops or temporaries: the count is the kernel's, as on
        # meta
        with build.unseen():
            out.copy_(plain())
    elif dev.type == "cuda":
        rc = build.function(SOURCE, "threefry_launch", _ARGTYPES)(
            rows.data_ptr(), rows.stride(0), rows.stride(1), rows.shape[0],
            size, int(partitionable), kind, out.data_ptr(), p,
            build.stream(dev))
        build.raise_on(rc, name)
        LAUNCHES[name] += 1
    build.charge(name, 0.0,
                 16 * rows.shape[0] + out.numel() * out.element_size())
    return out


def threefry_split(key: torch.Tensor, num: int, partitionable: bool
                   ) -> torch.Tensor:
    """``jax.random.split`` of int64 keys ``[..., 2]`` -> ``[..., num,
    2]``."""
    shape = tuple(key.shape[:-1]) + (num, 2)
    return _call("threefry_split", key, shape, torch.int64,
                 lambda: split_ref(key, num, partitionable),
                 size=num if partitionable else 2 * num,
                 kind=_KEYS if partitionable else _BITS,
                 partitionable=partitionable)


def threefry_bits(key: torch.Tensor, size: int, partitionable: bool
                  ) -> torch.Tensor:
    """``size`` 32-bit words of ``jax.random.bits`` (int64) a key:
    ``[..., size]``."""
    return _call("threefry_bits", key, tuple(key.shape[:-1]) + (size,),
                 torch.int64,
                 lambda: random_bits_ref(key, size, partitionable),
                 size=size, kind=_BITS, partitionable=partitionable)


def threefry_bernoulli(key: torch.Tensor, p: float, size: int,
                       partitionable: bool) -> torch.Tensor:
    """``size`` Bernoulli draws a key, ``u < p`` with ``p`` a float32
    value: ``[..., size]`` bool."""
    return _call("threefry_bernoulli", key, tuple(key.shape[:-1]) + (size,),
                 torch.bool, lambda: bernoulli_ref(key, p, size, partitionable),
                 size=size, kind=_DRAWS, partitionable=partitionable, p=p)


__all__ = ["LAUNCHES", "SOURCE", "SOURCES", "reset_launches",
           "threefry_bernoulli", "threefry_bits", "threefry_split"]
