"""Delivery per synapse for the blocked_fused engine's local step: each
delayed spike's fan-out scattered into int32 sums with atomics, then the
LIF step on the unpadded ``[B, n]`` state (CUDA, sm_90a), with a plain
PyTorch version beside them."""

from .kernel import (LAUNCHES, SOURCE, SOURCES, Accumulator, check_fanout,
                     fanout_step)
from .ref import fanout_step_ref, fanout_sums

__all__ = ["Accumulator", "LAUNCHES", "SOURCE", "SOURCES", "check_fanout",
           "fanout_step", "fanout_step_ref", "fanout_sums"]
