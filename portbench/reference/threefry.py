"""JAX's threefry2x32 stream in plain PyTorch, frozen for the reference.

The program draws its stimulus from ``jax.random``'s stream (threefry
2x32, the partitionable counter layout of jax 0.5 and later), so the
reference has to draw the same bits from the same keys.  This is an
independent copy of that published algorithm: a key is two uint32 words
held in int64 (``[..., 2]``), masked to 32 bits after every add and
shift.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block (Salmon et al., SC 2011) on words
    in int64 tensors; ``k0``/``k1`` broadcast against ``x0``/``x1``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` of a 32-bit seed: the words (0, seed)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def _hash(keys: torch.Tensor, size: int):
    """Hash the counters 0..size-1 under each key: ``[..., size]`` twice."""
    i = torch.arange(size, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0, None], keys[..., 1, None], i >> 32,
                        i & MASK)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` keys -> ``[..., num, 2]``."""
    return torch.stack(_hash(keys, num), dim=-1)


def bernoulli(keys: torch.Tensor, p: float, size: int) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (size,))`` for ``[..., 2]`` keys:
    the draw's 32 bits (the block's two words xor-ed), their top 23 bits
    as the mantissa of a float in [1, 2), minus one, below float32(p)."""
    b0, b1 = _hash(keys, size)
    bits = b0 ^ b1
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u < float(np.float32(p))
