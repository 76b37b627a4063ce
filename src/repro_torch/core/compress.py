"""Weight quantization (paper §3.2.3): the part of ``repro/core/compress.py``
that the simulation path uses.  The ELL and bin-compressed formats and the
fan statistics are not ported yet."""

from __future__ import annotations

import numpy as np

WEIGHT_BITS = 9  # paper: 9-bit signed weights


def quantize_weights(w: np.ndarray, bits: int = WEIGHT_BITS) -> np.ndarray:
    """Cap integer weights to the signed `bits`-bit range (paper §3.2.3)."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return np.clip(w, lo, hi).astype(np.int32)


__all__ = ["WEIGHT_BITS", "quantize_weights"]
