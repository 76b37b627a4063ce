"""The delay_event engine's kernels: the pending ring's read, the count
drive and the LIF step in one kernel, and delivery at each synapse's own
delay in another (CUDA, sm_90a), with plain PyTorch versions beside
them."""

from .kernel import LAUNCHES, SOURCE, delay_step
from .ref import delay_deliver_ref, delay_step_ref, unpack

__all__ = ["LAUNCHES", "SOURCE", "delay_deliver_ref", "delay_step",
           "delay_step_ref", "unpack"]
