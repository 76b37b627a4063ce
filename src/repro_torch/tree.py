"""Map a function over the tensors of a state object.

The reference's states, stimuli and carries are JAX pytrees, and its
partitioned runner maps over their leaves.  Here they are frozen
dataclasses, NamedTuples, tuples, lists and dicts of tensors;
:func:`map_tensors` rebuilds such an object with ``fn`` applied to every
tensor it holds, in a fixed order (other values kept).

The LM's parameters are an ``nn.Module``; :func:`named_tensors` gives
them, or a dict of gradients or optimizer moments keyed the same way, as
one flat name -> tensor dict.
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


def named_tensors(tree) -> dict:
    """``tree`` as a flat name -> tensor dict: a module's
    ``named_parameters()`` (``embed``, ``stack.0.mixer.wq``, ...), or a
    dict of tensors keyed by those names as it is."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


__all__ = ["map_tensors", "named_tensors"]
