"""Map a function over the tensors of a state object.

The reference's states, stimuli and carries are JAX pytrees, and its
partitioned runner maps over their leaves.  Here they are frozen
dataclasses, NamedTuples, tuples, lists and dicts of tensors;
:func:`map_tensors` rebuilds such an object with ``fn`` applied to every
tensor it holds, in a fixed order (other values kept).
"""

from __future__ import annotations

import dataclasses

import torch


def map_tensors(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(map_tensors(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(map_tensors(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: map_tensors(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: map_tensors(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


__all__ = ["map_tensors"]
