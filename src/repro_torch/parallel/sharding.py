"""Logical-axis -> mesh-axis sharding rules with a divisibility-aware
solver, and the shard layout on a mesh of ranks.

Counterpart of ``repro/parallel/sharding.py``.  Every parameter dim
carries a logical name (``embed``, ``heads``, ``mlp``, ``vocab``,
``experts``, ...; :func:`repro_torch.models.param_axes`), and the solver
maps the names to mesh axes:

* the tensor-parallel names (heads / mlp / vocab / experts) go to
  ``model``;
* ``embed`` is FSDP-sharded over ``data``, or over ``("pod", "data")`` on
  a multi-pod mesh;
* a dim whose size does not divide its mesh axes' extent is replicated,
  and the solver records it in ``fallbacks``;
* each mesh axis shards at most one dim of a tensor.

A :class:`Spec` is the port's counterpart of ``PartitionSpec``: for each
dim one mesh axis, a tuple of axes, or None, trailing Nones dropped.
:func:`shard_of` cuts this rank's block of a tensor and :func:`gather`
puts the blocks back together.  A dim over a tuple of axes splits major
to minor (``("pod", "data")``: pod's index times data's extent plus
data's), as XLA lays out a ``NamedSharding``.  A :class:`Mesh` layout
without processes is enough for the rules and the layout; :func:`gather`
needs the ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


class Spec(tuple):
    """One entry a dim: a mesh axis name, a tuple of them, or None; a
    tuple of one axis is that axis, as ``PartitionSpec`` has it."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, (tuple, list)) and len(p) == 1 else
            tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple            # ((logical_name, mesh_axis_or_tuple), ...)
    fsdp: bool = True       # shard "embed" over the data axes

    def as_dict(self):
        return dict(self.rules)


DEFAULT_RULES = ShardingRules(rules=(
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("experts", "model"),
    ("embed", "data"),       # FSDP; ("pod", "data") when multi-pod
    ("layers", None),
))


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_size(sizes, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def solve_rules(mesh, rules: ShardingRules = DEFAULT_RULES) -> ShardingRules:
    """The default rules adapted to the mesh: FSDP over the pod axis too
    where there is one."""
    sizes = _sizes(mesh)
    out = []
    for name, ax in rules.rules:
        if name == "embed" and rules.fsdp:
            ax = ("pod", "data") if "pod" in sizes else "data"
        out.append((name, ax))
    return ShardingRules(rules=tuple(out), fsdp=rules.fsdp)


def logical_to_spec(axes: tuple, mesh, rules: ShardingRules,
                    dims: Optional[tuple] = None,
                    fallbacks: Optional[list] = None) -> Spec:
    """One parameter's logical axes (and dim sizes, for the divisibility
    check) -> its :class:`Spec`; each replicated-for-divisibility dim is
    appended to ``fallbacks`` as ``(name, size, mesh axes, extent)``."""
    table = rules.as_dict()
    sizes = _sizes(mesh)
    used: set = set()
    parts = []
    for i, name in enumerate(axes):
        ax = table.get(name)
        if ax is None:
            parts.append(None)
            continue
        key = _axes(ax)
        if any(a in used for a in key):
            parts.append(None)          # each mesh axis used at most once
            continue
        n = _axis_size(sizes, ax)
        if dims is not None and dims[i] % n != 0:
            if fallbacks is not None:
                fallbacks.append((name, dims[i], ax, n))
            parts.append(None)
            continue
        used.update(key)
        parts.append(ax)
    while parts and parts[-1] is None:
        parts.pop()
    return Spec(*parts)


def make_param_shardings(mesh, param_axes: dict, abstract: dict,
                         rules: Optional[ShardingRules] = None):
    """(name -> logical axes, name -> tensor or meta tensor) -> (name ->
    :class:`Spec`, fallbacks), the names those of
    :func:`repro_torch.models.param_axes`."""
    rules = solve_rules(mesh, rules or DEFAULT_RULES)
    fallbacks: list = []
    specs = {k: logical_to_spec(tuple(param_axes[k]), mesh, rules,
                                tuple(t.shape), fallbacks)
             for k, t in abstract.items()}
    return specs, fallbacks


def batch_spec(mesh, ndim: int, batch_divisible: bool = True) -> Spec:
    """Shard the leading (batch) dim over all data-parallel axes."""
    sizes = _sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    if not dp or not batch_divisible:
        return Spec(*([None] * ndim))
    return Spec(dp, *([None] * (ndim - 1)))


def data_axis_size(mesh) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


def shard_index(shape, spec: Spec, mesh, coords: Optional[dict] = None
                ) -> tuple:
    """The block of a tensor of ``shape`` that the rank at ``coords``
    (default: this rank) holds under ``spec``: one ``slice`` a dim."""
    coords = mesh.coords if coords is None else coords
    sizes = _sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        key = _axes(spec[i]) if i < len(spec) else ()
        if not key:
            out.append(slice(0, dim))
            continue
        n = _axis_size(sizes, key)
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {key} ({n})")
        idx = 0
        for a in key:
            idx = idx * sizes[a] + int(coords[a])
        block = dim // n
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)


def shard_of(tensor: torch.Tensor, spec: Spec, mesh,
             coords: Optional[dict] = None) -> torch.Tensor:
    """This rank's block of ``tensor`` under ``spec``, as a contiguous
    copy of its own (the whole tensor can then be freed)."""
    return tensor[shard_index(tensor.shape, spec, mesh, coords)].clone(
        memory_format=torch.contiguous_format)


def gather(shard: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (:func:`shard_of`): each
    sharded dim all-gathered over its mesh axes and concatenated in the
    axes' order.  On every rank alike."""
    out = shard
    for i, entry in enumerate(spec):
        key = _axes(entry)
        if key and mesh.axis_size(key) > 1:
            out = torch.cat(mesh.all_gather(out, key), dim=i)
    return out


__all__ = ["DEFAULT_RULES", "ShardingRules", "Spec", "batch_spec",
           "data_axis_size", "gather", "logical_to_spec",
           "make_param_shardings", "shard_index", "shard_of", "solve_rules"]
