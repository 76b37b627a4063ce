"""JAX's threefry2x32 PRNG in PyTorch, bit for bit.

The simulator is seeded through ``jax.random.PRNGKey(seed)`` and consumes
its stream through ``split``, ``uniform`` and ``bernoulli`` (the call
sites are ``core/engine.py`` for the key, ``core/step.py`` for the
per-step split, and ``exp/stimulus.py`` / ``core/neuron.py`` for the
Bernoulli draws).  The same seed must give the same stimulus here, so
this module reproduces those functions exactly, in both settings of JAX's
``jax_threefry_partitionable`` flag (``partitionable=True`` is the
default of jax 0.5 and later).

A key is a ``[2]`` int64 tensor holding the two uint32 words, on whatever
device the caller keeps it; a batch of keys is ``[..., 2]`` (a trial
batch's ``[B, 2]``), and every function then draws for each key what it
draws for that key alone, along leading axes of its result, as the
reference does under ``vmap``.  Every function here stays on the keys'
device and never reads a value back to the host.

Each ``split``, ``random_bits`` and ``bernoulli`` is one launch of the
threefry kernel on a CUDA device (:mod:`repro_torch.kernels.threefry`), and
its plain version, the int64 chain of ``kernels/threefry/ref.py``, on the
CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.threefry import kernel as _kernel
from repro_torch.kernels.threefry.ref import threefry2x32, uniform_from_bits

_MASK = 0xFFFFFFFF


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2, *,
          partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``[..., num, 2]`` keys."""
    return _kernel.threefry_split(key, num, partitionable)


def _size(shape: tuple[int, ...]) -> int:
    size = math.prod(shape)
    if size >= _MASK:
        raise NotImplementedError("more than 2**32 - 1 draws from one key")
    return size


def random_bits(key: torch.Tensor, shape: tuple[int, ...], *,
                partitionable: bool = True) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` (as int64 words);
    ``[..., *shape]`` for keys ``[..., 2]``."""
    bits = _kernel.threefry_bits(key, _size(shape), partitionable)
    return bits.reshape(key.shape[:-1] + tuple(shape))


def uniform(key: torch.Tensor, shape: tuple[int, ...], *,
            partitionable: bool = True) -> torch.Tensor:
    """float32 ``jax.random.uniform(key, shape)`` on [0, 1): the top 23
    bits become the mantissa of a float in [1, 2), minus one."""
    return uniform_from_bits(random_bits(key, shape,
                                         partitionable=partitionable))


def bernoulli(key: torch.Tensor, p: float, shape: tuple[int, ...], *,
              partitionable: bool = True) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with ``p`` a Python float:
    ``uniform < float32(p)``."""
    draws = _kernel.threefry_bernoulli(key, float(np.float32(p)),
                                       _size(shape), partitionable)
    return draws.reshape(key.shape[:-1] + tuple(shape))


__all__ = ["PRNGKey", "bernoulli", "random_bits", "split", "threefry2x32",
           "uniform"]
