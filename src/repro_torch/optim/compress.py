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

* ``xf / scale`` stays a division (the optimized HLO of both the jitted
  ``compress_int8`` and ``compressed_psum`` under ``shard_map`` keeps a
  ``divide`` there: the scale is not a constant).

:func:`compressed_psum` is the reference's hierarchical reduction over a
:class:`repro_torch.launch.mesh.Mesh` of ranks: a float32 sum over the
in-pod ``data`` axis, then int8 across pods.
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


def compressed_psum(x, mesh, *, pod_axis: str, data_axis: str | None = None):
    """The sum of every rank's ``x``: float32 over ``data_axis`` first,
    then across ``pod_axis`` in int8.  A ``MAX`` all-reduce agrees on a
    shared scale across pods (one float32 a tensor on the wire), each
    rank quantizes with it as :func:`compress_int8` does, the int8
    payloads are summed as int32 and the sum is dequantized with the
    shared scale: what a real int8 all-reduce across pods would give.
    Standalone, as in the reference (the train step does not call it)."""
    if data_axis is not None:
        x = mesh.all_reduce(x, data_axis)
    xf = x.float()
    amax = mesh.all_reduce(xf.abs().amax(), pod_axis, op="max")
    scale = amax.clamp_min(1e-12) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    q_sum = mesh.all_reduce(q.to(torch.int32), pod_axis)
    return q_sum.float() * scale


__all__ = ["compress_int8", "compressed_psum", "decompress_int8",
           "error_feedback_update"]
