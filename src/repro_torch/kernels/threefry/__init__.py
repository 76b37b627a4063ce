"""JAX's threefry-2x32 key split, bits and Bernoulli draws as one kernel a
call (CUDA, sm_90a), with the int64 PyTorch chain as its plain version."""

from .kernel import threefry_bernoulli, threefry_bits, threefry_split
from .ref import bernoulli_ref, random_bits_ref, split_ref, threefry2x32

__all__ = ["bernoulli_ref", "random_bits_ref", "split_ref",
           "threefry2x32", "threefry_bernoulli", "threefry_bits",
           "threefry_split"]
