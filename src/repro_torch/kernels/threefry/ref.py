"""Plain version of the threefry kernel: JAX's threefry2x32 stream as a
chain of int64 PyTorch ops.

Words are held in int64 and masked to 32 bits after each add and shift,
because PyTorch's uint32 dtype lacks most arithmetic.  Keys are ``[..., 2]``
and every function draws for each key what it draws for that key alone,
along leading axes of its result.
"""

from __future__ import annotations

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


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A key's two words, ``[..., 1]`` each, to broadcast against counts."""
    return key[..., 0, None], key[..., 1, None]


def _hash_counts(key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``jax._src.prng.threefry_2x32``: hash a flat uint32 count vector by
    pairing its first half with its second half (odd sizes pad a zero);
    ``[..., n]`` for keys ``[..., 2]``."""
    n = counts.shape[0]
    if n % 2:
        counts = torch.cat([counts, counts.new_zeros(1)])
    half = counts.shape[0] // 2
    y0, y1 = threefry2x32(*_words(key), counts[:half], counts[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def _hash_iota(key: torch.Tensor, size: int) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Partitionable mode: hash each flat index ``i`` as the 64-bit count
    ``(hi, lo) = (i >> 32, i & 0xFFFFFFFF)``; ``[..., size]`` each."""
    i = torch.arange(size, dtype=torch.int64, device=key.device)
    return threefry2x32(*_words(key), i >> 32, i & _MASK)


def split_ref(key: torch.Tensor, num: int, partitionable: bool
              ) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``[..., num, 2]`` keys."""
    if partitionable:
        return torch.stack(_hash_iota(key, num), dim=-1)
    counts = torch.arange(2 * num, dtype=torch.int64, device=key.device)
    return _hash_counts(key, counts).reshape(key.shape[:-1] + (num, 2))


def random_bits_ref(key: torch.Tensor, size: int, partitionable: bool
                    ) -> torch.Tensor:
    """``size`` 32-bit words of ``jax.random.bits`` (as int64):
    ``[..., size]`` for keys ``[..., 2]``."""
    if partitionable:
        b0, b1 = _hash_iota(key, size)
        return b0 ^ b1
    counts = torch.arange(size, dtype=torch.int64, device=key.device)
    return _hash_counts(key, counts)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 on [0, 1) from 32-bit words: the top 23 bits become the
    mantissa of a float in [1, 2), minus one."""
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def bernoulli_ref(key: torch.Tensor, p: float, size: int,
                  partitionable: bool) -> torch.Tensor:
    """``size`` draws of ``jax.random.bernoulli(key, p)`` with ``p`` the
    float32 of the probability: ``uniform < p``; ``[..., size]`` for keys
    ``[..., 2]``."""
    return uniform_from_bits(random_bits_ref(key, size, partitionable)) < p


__all__ = ["bernoulli_ref", "random_bits_ref", "split_ref", "threefry2x32",
           "uniform_from_bits"]
