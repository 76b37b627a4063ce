"""Int8 gradient compression with error feedback.

Counterpart of ``repro/optim/compress.py``'s numerics: per-tensor
symmetric int8 quantization, and an error-feedback residual that carries
each step's quantization error to the next.  The reference's train step
runs them under ``jax.jit``, and the port computes what XLA's CPU code
computes there:

* the scale ``max(amax, 1e-12) / 127`` is a multiply by
  ``float32(1 / 127)`` (XLA divides by a constant so; ROADMAP finding 5);
* ``round`` is half to even (``torch.round``, as ``jnp.round``);
* the residual ``g - q * scale`` is one fused multiply-add (XLA contracts
  it), :func:`repro_torch.core.neuron.fma_f32`, which works in float64
  and so takes 8 bytes an element of scratch.

The reference's ``compressed_psum`` (an int8 all-reduce across pods) needs
its process groups and waits for the port of ``parallel/``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.neuron import fma_f32

_INV_127 = float(np.float32(1) / np.float32(127))


def compress_int8(x):
    """Returns (q int8, scale float32 0-d) per tensor."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-12) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q, scale):
    return q.float() * scale


def error_feedback_update(grad, residual):
    """(grad + residual) -> (compressed-then-decompressed grad, new
    residual)."""
    g = grad.float() + residual
    q, s = compress_int8(g)
    qf = q.float()
    return qf * s, fma_f32(-qf, s, g)


__all__ = ["compress_int8", "decompress_int8", "error_feedback_update"]
