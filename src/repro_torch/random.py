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
device the caller keeps it; every function here stays on that device and
never reads a value back to the host.  Words are held in int64 and masked
to 32 bits after each add and shift, because PyTorch's uint32 dtype lacks
most arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block function on uint32 words held in
    int64 tensors (``k0``/``k1`` broadcast against ``x0``/``x1``)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _hash_counts(key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``jax._src.prng.threefry_2x32``: hash a flat uint32 count vector by
    pairing its first half with its second half (odd sizes pad a zero)."""
    n = counts.shape[0]
    if n % 2:
        counts = torch.cat([counts, counts.new_zeros(1)])
    half = counts.shape[0] // 2
    y0, y1 = threefry2x32(key[0], key[1], counts[:half], counts[half:])
    return torch.cat([y0, y1])[:n]


def _hash_iota(key: torch.Tensor, size: int) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Partitionable mode: hash each flat index ``i`` as the 64-bit count
    ``(hi, lo) = (i >> 32, i & 0xFFFFFFFF)``."""
    i = torch.arange(size, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], i >> 32, i & _MASK)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2, *,
          partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``[num, 2]`` keys."""
    if partitionable:
        return torch.stack(_hash_iota(key, num), dim=1)
    counts = torch.arange(2 * num, dtype=torch.int64, device=key.device)
    return _hash_counts(key, counts).reshape(num, 2)


def random_bits(key: torch.Tensor, shape: tuple[int, ...], *,
                partitionable: bool = True) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` (as int64 words)."""
    size = math.prod(shape)
    if size >= _MASK:
        raise NotImplementedError("more than 2**32 - 1 draws from one key")
    if partitionable:
        b0, b1 = _hash_iota(key, size)
        bits = b0 ^ b1
    else:
        counts = torch.arange(size, dtype=torch.int64, device=key.device)
        bits = _hash_counts(key, counts)
    return bits.reshape(shape)


def uniform(key: torch.Tensor, shape: tuple[int, ...], *,
            partitionable: bool = True) -> torch.Tensor:
    """float32 ``jax.random.uniform(key, shape)`` on [0, 1): the top 23
    bits become the mantissa of a float in [1, 2), minus one."""
    bits = random_bits(key, shape, partitionable=partitionable)
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape: tuple[int, ...], *,
              partitionable: bool = True) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with ``p`` a Python float:
    ``uniform < float32(p)``."""
    u = uniform(key, shape, partitionable=partitionable)
    return u < float(np.float32(p))


__all__ = ["PRNGKey", "bernoulli", "random_bits", "split", "threefry2x32",
           "uniform"]
