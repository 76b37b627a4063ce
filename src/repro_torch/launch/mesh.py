"""Meshes of ranks: the port's counterpart of ``repro/launch/mesh.py``.

The reference lays a model out over a ``jax.sharding.Mesh`` of devices
and lets GSPMD insert the collectives.  Here a :class:`Mesh` is a grid of
``torch.distributed`` ranks, one process a rank: its axis names and shape,
this rank's coordinates and device, and one process group for each set of
axes a collective runs over (``("data",)``, ``("model",)``,
``("pod", "data")``, ...).  Rank ``r`` sits at the row-major coordinates
of ``r`` in the shape.

A mesh without ranks (:func:`mesh_layout`, :func:`make_production_mesh`)
holds the layout only: the sharding rules and specs read it, and
:func:`join` turns it into a mesh of processes.

Collectives share :class:`repro_torch.core.distributed.CoreMesh`'s
transport (:func:`repro_torch.core.distributed.staged_all_gather`).
``nccl`` moves payloads device to device and needs one card a rank.
``gloo`` puts any number of ranks on one card or on the CPU; it has no
CUDA collectives, so a payload on the card crosses host memory, by an
explicit copy into pinned host memory and a copy back to the rank's
device: that is the transport, not a fallback.  A gather is one send to
and one receive from each peer of the group, and a reduction folds the
gathered payloads on the device in the group's order, so its bits are the
same on every rank.  DTensor and FSDP are not used: their collectives
need ``nccl``, which refuses two ranks on one device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.distributed import (BACKENDS, CoreMesh, host_buffer,
                                          make_core_mesh, rank_device,
                                          send_buffer, staged_all_gather)


class MeshSizeError(ValueError):
    """The world holds another number of ranks than the mesh needs."""

    def __init__(self, need: int, have: int, sizes: dict):
        super().__init__(f"need {need} ranks for the mesh {sizes}, "
                         f"have {have}")
        self.need, self.have = need, have


def _key(axes) -> tuple:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of ranks.  ``rank``, ``device``, ``backend`` and ``groups``
    are None on a layout without processes."""

    axis_names: tuple
    shape: tuple
    rank: Optional[int] = None
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    groups: Any = None          # axes tuple (in mesh order) -> group

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def devices(self) -> np.ndarray:
        """The rank of every mesh position (the reference's ``devices``
        array, whose ``.shape`` the sharding rules read)."""
        return np.arange(self.size).reshape(self.shape)

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def coords(self) -> dict:
        """This rank's coordinate on every axis."""
        if self.rank is None:
            raise ValueError("a mesh layout has no rank")
        return {a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(self.rank, self.shape))}

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        return math.prod(self.sizes[a] for a in _key(axes))

    def axis_index(self, axes, coords: Optional[dict] = None) -> int:
        """The linear index of ``coords`` (default: this rank's) along
        ``axes``, major to minor in the order given."""
        coords = self.coords if coords is None else coords
        idx = 0
        for a in _key(axes):
            idx = idx * self.sizes[a] + int(coords[a])
        return idx

    def _ordered(self, axes) -> tuple:
        key = _key(axes)
        unknown = [a for a in key if a not in self.axis_names]
        if unknown:
            raise ValueError(f"no axis {unknown} in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in key)

    def group_ranks(self, axes) -> list[int]:
        """The global ranks of this rank's group along ``axes``, in the
        order of the axes' linear index (``axes`` major to minor)."""
        key = _key(axes)
        here = self.coords
        out = []
        for pos in itertools.product(*(range(self.sizes[a]) for a in key)):
            c = dict(here, **dict(zip(key, pos)))
            out.append(int(np.ravel_multi_index(
                tuple(c[a] for a in self.axis_names), self.shape)))
        return out

    def group(self, axes):
        return self.groups[self._ordered(axes)]

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type != "cpu"

    def all_gather(self, x: torch.Tensor, axes) -> list[torch.Tensor]:
        """Every rank's ``x`` along ``axes`` (the same shape and dtype on
        each), in the order of the axes' linear index, each a new tensor:
        :func:`repro_torch.core.distributed.staged_all_gather`, the
        simulator's transport."""
        return staged_all_gather(x, self.group_ranks(axes), self.rank,
                                 self.backend)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """The elementwise ``op`` (``sum`` or ``max``) of every rank's
        ``x`` along ``axes``: the gathered payloads folded on the rank's
        device in the axes' order, so every rank of the group computes
        the same bits.  A new tensor."""
        fold = {"sum": torch.add, "max": torch.maximum}[op]
        parts = self.all_gather(x, axes)
        out = parts[0]
        for part in parts[1:]:
            out = fold(out, part)
        return out

    def broadcast(self, x: torch.Tensor, axes, src: int) -> torch.Tensor:
        """The ``x`` of the rank at linear index ``src`` along ``axes``,
        on every rank of the group (``x`` gives the shape and dtype)."""
        import torch.distributed as dist
        if self.axis_size(axes) == 1:
            return x
        buf = send_buffer(x, self._staged(x))
        buf = x.clone() if buf is x else buf
        dist.broadcast(buf, src=self.group_ranks(axes)[src],
                       group=self.group(axes))
        return buf.to(x.device)

    def exchange(self, send: Optional[torch.Tensor], dst: Optional[int],
                 recv_like: Optional[torch.Tensor], src: Optional[int]):
        """Send ``send`` to global rank ``dst`` and receive a tensor shaped
        as ``recv_like`` from global rank ``src`` at once
        (``batch_isend_irecv``); either side may be None.  Returns the
        received tensor on this rank's device, or None."""
        import torch.distributed as dist
        ops, buf = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend,
                                  send_buffer(send, self._staged(send)), dst))
        if recv_like is not None:
            buf = host_buffer(recv_like, self._staged(recv_like))
            ops.append(dist.P2POp(dist.irecv, buf, src))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return None if buf is None else buf.to(self.device)

    def barrier(self) -> None:
        import torch.distributed as dist
        if self.size > 1:
            dist.barrier()


def mesh_layout(shape, axis_names) -> Mesh:
    """A mesh's layout without processes."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} for axes {axis_names}")
    return Mesh(axis_names, shape)


def join(layout: Mesh, *, backend: str = "gloo", devices=None,
         init_method: Optional[str] = None) -> Mesh:
    """``layout`` as a mesh of this process and its peers.

    Uses the default process group if one is initialized (its backend
    must be ``backend``), else initializes it from ``init_method``
    (default ``env://``, what ``torchrun`` sets).  Raises
    :class:`MeshSizeError` (a ``ValueError``) unless the world holds
    exactly the mesh's ranks (a world of one
    process when no process group is running and no ``RANK`` is set; a
    one-rank mesh needs no process group).
    ``devices[rank]`` is the rank's device; by default ``cuda:LOCAL_RANK``
    modulo the host's cards, and without a card that raises: no rank runs
    on the CPU unless asked.  Every rank creates every group, in the same
    order."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    n = layout.size
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()!r}, not {backend!r}")
        world = dist.get_world_size()
    elif "RANK" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    else:
        world = 1
    if world != n:
        raise MeshSizeError(n, world, layout.sizes)
    if not dist.is_initialized() and world > 1:
        if init_method in (None, "env://"):
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=int(os.environ["RANK"]),
                                    world_size=world)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        device = rank_device(backend, rank, n, devices)
    except ValueError as e:     # not a too-small world: never run unsharded
        raise RuntimeError(str(e)) from e
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if n == 1:
        return Mesh(layout.axis_names, layout.shape, rank, device, backend,
                    {})
    groups = {}
    names, shape = layout.axis_names, layout.shape
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            rest = [a for a in names if a not in axes]
            for fixed in itertools.product(*(range(layout.sizes[a])
                                             for a in rest)):
                base = dict(zip(rest, fixed))
                ranks = []
                for pos in itertools.product(*(range(layout.sizes[a])
                                               for a in axes)):
                    c = dict(base, **dict(zip(axes, pos)))
                    ranks.append(int(np.ravel_multi_index(
                        tuple(c[a] for a in names), shape)))
                g = dist.new_group(sorted(ranks), backend=backend)
                if rank in ranks:
                    groups[axes] = g
    mesh = Mesh(names, shape, rank, device, backend, groups)
    # one write: the ranks share torchrun's stdout
    print(f"[mesh] rank {rank} of {n} at {mesh.coords} on {device} "
          f"({backend})\n", end="", flush=True)
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layouts: one pod (data=16, model=16), 256 ranks, or
    a leading pure-DP ``pod`` axis (2, 16, 16), 512.  A layout: the
    sharding rules read it; :func:`join` runs it on that many ranks."""
    if multi_pod:
        return mesh_layout((2, 16, 16), ("pod", "data", "model"))
    return mesh_layout((16, 16), ("data", "model"))


def make_host_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                   **join_kw) -> Mesh:
    """A small (pod, data, model) mesh over the ranks of this job
    (:func:`join`'s keywords: ``backend``, ``devices``,
    ``init_method``).  Raises :class:`MeshSizeError` (a ``ValueError``)
    when the world holds another number of ranks than the mesh needs;
    the training CLI then runs unsharded in a world of one process, as
    the reference's does on a host without the devices."""
    if pod:
        layout = mesh_layout((pod, data, model), ("pod", "data", "model"))
    else:
        layout = mesh_layout((data, model), ("data", "model"))
    return join(layout, **join_kw)


def make_flat_mesh(n_cores: int, *, devices=None, backend: str = "nccl",
                   init_method: Optional[str] = None) -> CoreMesh:
    """The 1-D mesh of the distributed SNN simulator, one neuron
    partition a rank: :func:`repro_torch.core.distributed.make_core_mesh`."""
    return make_core_mesh(n_cores, devices, backend=backend,
                          init_method=init_method)


__all__ = ["Mesh", "MeshSizeError", "join", "make_flat_mesh",
           "make_host_mesh", "make_production_mesh", "mesh_layout"]
