"""A step's cost, counted as it runs: the port's counterpart of
``repro/launch/hlo.py``.

The reference parses XLA's optimized HLO and multiplies each while loop's
body by its trip count.  The port has no compiled program to parse: its
step is the sequence of PyTorch ops (and hand-written kernels) that eager
mode issues.  So :func:`count` runs the step under a
``TorchDispatchMode`` that sees every op, usually on ``meta`` tensors,
which have shapes and dtypes and no memory: a full-size configuration
costs no memory and no arithmetic, only the host's dispatches.  Counted,
for one rank and one call:

* ``flops``: ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (and ``mv``,
  ``addmv``, ``dot``) at 2 x |result| x the contracted size, the
  reference's ``_dot_flops`` rule: products only, elementwise work shows
  in ``bytes``;
* ``bytes``: operand bytes plus result bytes of every op that is neither
  a view nor a bare allocation (``empty``).  In eager mode each such op
  is a kernel that reads its operands from HBM and writes its result, so
  this is the port's own traffic (an expanded operand counts its
  distinct elements);
* ``launches``: those ops, plus the hand-written kernels' launches, which
  ctypes hides from the dispatcher: a wrapper charges its own FLOPs,
  bytes and launch (:func:`repro_torch.kernels.build.charge`; ``kernels``
  counts them by name);
* ``peak_bytes``: the bytes of the ``resident`` tensors given to
  :func:`count`, plus the high-water mark of the bytes of the storages
  the call creates, each counted from the op that creates it until it is
  freed (``weakref.finalize`` on the storage);
* collectives: :class:`CountingMesh` stands in for a
  :class:`repro_torch.launch.mesh.Mesh` (and for the simulator's
  ``gather``) at one rank's coordinates.  It returns tensors of the
  right shapes and records each collective with the ring factors of the
  reference's docstring: all-gather (g-1)/g x result, all-reduce
  2 (g-1)/g x operand, broadcast and a point-to-point exchange 1 x
  operand (``link_bytes``; ``coll_bytes`` and ``coll_count`` by op);
* ``trips``: the ``(label, n)`` of each :func:`repeat` region.

Python numbers made into 0-d tensors on the host (``torch.tensor(theta)``)
and the ops computed from them alone are host arithmetic, passed to a
kernel by value: they are not counted.

**Loops.**  The recurrent scans issue ops per token
(:func:`repro_torch.models.layers.scan_in_chunks`).  On ``meta`` under a
counter they run their body once inside :func:`repeat` ``(n)``, which
multiplies everything counted inside by ``n`` (the counterpart of the
reference's trip-count multiplication), and give results of the stacked
shape.  Runs on real tensors do not change.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import build as kbuild

_aten = torch.ops.aten

# dot ops: (index of the left operand, its contracted dim)
_DOTS = {
    _aten.mm.default: (0, -1), _aten.addmm.default: (1, -1),
    _aten.bmm.default: (0, -1), _aten.baddbmm.default: (1, -1),
    _aten.mv.default: (0, -1), _aten.addmv.default: (1, -1),
    _aten.dot.default: (0, -1),
}
# bare allocations: storage, no kernel
_ALLOCS = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default,
}
# Python numbers made into host tensors (0-d: a numpy array stays data)
_HOST_MAKERS = {_aten.lift_fresh.default, _aten.lift_fresh_copy.default}


@dataclasses.dataclass
class StepCost:
    """What one rank's call did (see the module docstring); the
    counterpart of the reference's ``HloCost``."""

    flops: float = 0.0
    bytes: float = 0.0
    link_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_count: dict = dataclasses.field(default_factory=dict)
    launches: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    trips: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        """The collectives in the reference's keys."""
        return {"flops": self.flops, "bytes": self.bytes,
                "link_bytes": self.link_bytes,
                "raw_bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_count)}


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` addresses (an expanded
    dim, stride 0, reads one element)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


_WRITES: dict = {}


def _writes(func) -> bool:
    """Whether ``func`` writes one of its arguments (in place or out=)."""
    w = _WRITES.get(func)
    if w is None:
        w = _WRITES[func] = any(
            a.alias_info is not None and a.alias_info.is_write
            for a in func._schema.arguments)
    return w


class Counter(TorchDispatchMode):
    """The dispatch mode of :func:`count`; its ``cost`` is the
    :class:`StepCost` so far."""

    def __init__(self, device: torch.device, resident=()):
        super().__init__()
        self.cost = StepCost()
        self.device_type = torch.device(device).type
        self._n = 1                 # the trips of the enclosing repeats
        self._unseen = False        # inside unseen(): nothing is counted
        self.last_op = (0.0, 0)     # (flops, bytes) of the last op counted
        self._live = 0
        self._storages: dict[int, int] = {}
        self._host: set[int] = set()      # ids of live host tensors
        for leaf in tree_leaves(resident, is_leaf=lambda x: isinstance(
                x, torch.nn.Module)):
            for t in (leaf.parameters() if isinstance(leaf, torch.nn.Module)
                      else [leaf]):
                if isinstance(t, torch.Tensor) and self._counted(t):
                    self._track(t)

    # -- live bytes ---------------------------------------------------------

    def _free(self, key: int) -> None:
        self._live -= self._storages.pop(key, 0)

    def _bump(self) -> None:
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        nbytes = st.nbytes()
        self._storages[key] = nbytes
        self._live += nbytes
        weakref.finalize(st, self._free, key)
        self._bump()

    @property
    def live(self) -> int:
        """The bytes counted as live now."""
        return self._live

    @contextlib.contextmanager
    def uncounted(self):
        """Storage made inside is tracked; its ops are not counted (what
        a transport writes into a received buffer)."""
        n, self._n = self._n, 0
        try:
            yield
        finally:
            self._n = n

    @contextlib.contextmanager
    def unseen(self):
        """Nothing made or run inside is counted: no ops, no bytes, no
        storage (a kernel's plain version run in its place, whose
        temporaries the kernel never makes; the kernel charges itself)."""
        was, self._unseen = self._unseen, True
        try:
            yield
        finally:
            self._unseen = was

    def hold(self, nbytes: int) -> None:
        """Count ``nbytes`` more (or, negative, fewer) as live."""
        self._live += nbytes
        self._bump()

    # -- ops ----------------------------------------------------------------

    def _is_host(self, t: torch.Tensor) -> bool:
        return id(t) in self._host

    def _mark_host(self, t: torch.Tensor) -> None:
        if id(t) not in self._host:
            self._host.add(id(t))
            weakref.finalize(t, self._host.discard, id(t))

    def _counted(self, t: torch.Tensor) -> bool:
        return t.device.type == self.device_type and not self._is_host(t)

    def charge(self, kernel: str, flops: float, nbytes: float) -> None:
        """One launch of a hand-written kernel (ctypes; see
        :func:`repro_torch.kernels.build.charge`)."""
        self._add(flops, nbytes, 1)
        self.cost.kernels[kernel] = self.cost.kernels.get(kernel, 0) \
            + self._n

    def collective(self, op: str, group: int, link_bytes: float) -> None:
        n = self._n
        self.cost.link_bytes += n * link_bytes
        self.cost.coll_bytes[op] = self.cost.coll_bytes.get(op, 0.0) \
            + n * link_bytes
        self.cost.coll_count[op] = self.cost.coll_count.get(op, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._unseen:
            return func(*args, **kwargs)
        # under inference_mode composite ops (matmul) reach the mode whole:
        # count the kernels they decompose into, as under no_grad
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if (func in _HOST_MAKERS and all(t.dim() == 0 for t in outs)) or (
                ins and all(map(self._is_host, ins))
                and all(t.device.type == "cpu" for t in outs)):
            for t in outs:              # host arithmetic: log(theta)
                self._mark_host(t)
            return out
        dev_ins = [t for t in ins if self._counted(t)]
        dev_outs = [t for t in outs if self._counted(t)]
        if not dev_ins and not dev_outs:
            return out
        for t in dev_outs:
            self._track(t)
        if func in _ALLOCS or func.is_view:
            return out
        if not _writes(func) and dev_outs:
            in_st = {t.untyped_storage()._cdata for t in dev_ins}
            if all(t.untyped_storage()._cdata in in_st for t in dev_outs):
                return out          # a view under another name
        nbytes = (sum(map(tensor_bytes, dev_ins))
                  + sum(map(tensor_bytes, dev_outs)))
        dot = _DOTS.get(func)
        flops = 0.0 if dot is None else (
            2.0 * max(out.numel(), 1) * args[dot[0]].shape[dot[1]])
        self.last_op = (flops, nbytes)
        self._add(flops, nbytes, 1)
        return out

    def _add(self, flops: float, nbytes: float, launches: int) -> None:
        n = self._n
        self.cost.flops += n * flops
        self.cost.bytes += n * nbytes
        self.cost.launches += n * launches

    def uncount(self, flops: float, nbytes: float, launches: int) -> None:
        """Take back work counted that did not run (at the current
        repeat)."""
        self._add(-flops, -nbytes, -launches)


def active() -> Optional[Counter]:
    """The innermost active counter, or None."""
    return kbuild.COUNTERS[-1] if kbuild.COUNTERS else None


@contextlib.contextmanager
def count(device="meta", resident=()):
    """Count what runs inside on ``device``'s tensors (see the module
    docstring); yields the :class:`Counter`, whose ``cost`` holds the
    count.  ``resident``: tensors (any tree) that are live for the
    whole call (parameters, optimizer state, a cache): their bytes start
    the peak."""
    c = Counter(device, resident)
    kbuild.COUNTERS.append(c)
    try:
        with c:
            yield c
    finally:
        kbuild.COUNTERS.remove(c)


def repeating(x: torch.Tensor) -> bool:
    """Whether a loop over ``x`` may run its body once under
    :func:`repeat`: a counter is active and ``x`` is on ``meta``."""
    return bool(kbuild.COUNTERS) and x.device.type == "meta"


@contextlib.contextmanager
def repeat(n: int, label: str = ""):
    """Everything the active counter counts inside counts ``n`` times:
    the body of a loop of ``n`` identical trips, run once.  Records
    ``(label, n)`` in ``trips``."""
    c = active()
    if c is None:
        raise RuntimeError("repeat() needs an active count()")
    c.cost.trips.append((label, n))
    c._n *= n
    try:
        yield c
    finally:
        c._n //= n


def hold(nbytes: int):
    """A context that counts ``nbytes`` more as live inside (what the
    other trips of a repeated loop keep); nothing without a counter."""
    c = active()

    @contextlib.contextmanager
    def held():
        if c is not None:
            c.hold(nbytes)
        try:
            yield
        finally:
            if c is not None:
                c.hold(-nbytes)
    return held()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _record(op: str, group: int, payload: float, factor: float) -> None:
    c = active()
    if c is not None and group > 1:
        c.collective(op, group, factor * payload)


class CountingMesh:
    """A stand-in for :class:`repro_torch.launch.mesh.Mesh` at one rank's
    coordinates: the layout's axes and sizes, rank ``rank``, tensors on
    ``device``, and collectives that move nothing.  Each returns new
    tensors of the right shapes (the rank's own payload cloned, as the
    transport does; the peers' buffers, whose filling is the transport's
    and not a kernel's, hold copies of it) and records itself with the
    active counter.  ``backend`` names the transport a record is priced for.
    ``all_gather(x)`` with no axes gathers over the whole mesh, as a
    :class:`repro_torch.core.distributed.CoreMesh` does, so a one-axis
    counting mesh is also the simulator's ``gather``
    (:func:`repro_torch.core.exchange.all_gather_group`)."""

    def __init__(self, layout, rank: int = 0, device="meta",
                 backend: str = "nccl"):
        self.axis_names, self.shape = layout.axis_names, layout.shape
        self.layout = layout
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend

    size = property(lambda self: self.layout.size)
    devices = property(lambda self: self.layout.devices)
    sizes = property(lambda self: self.layout.sizes)
    world_size = size

    @property
    def coords(self) -> dict:
        return dataclasses.replace(self.layout, rank=self.rank).coords

    def axis_size(self, axes) -> int:
        return self.layout.axis_size(axes)

    def axis_index(self, axes, coords=None) -> int:
        return self.layout.axis_index(axes, self.coords if coords is None
                                      else coords)

    @staticmethod
    def _received(like: torch.Tensor) -> torch.Tensor:
        """A buffer the transport fills: a copy of ``like`` (valid values
        for the step that reads it), not counted as a kernel."""
        c = active()
        with c.uncounted() if c is not None else contextlib.nullcontext():
            return like.clone()

    def _gathered(self, x: torch.Tensor, g: int) -> list[torch.Tensor]:
        return [x.clone()] + [self._received(x) for _ in range(g - 1)]

    def all_gather(self, x: torch.Tensor, axes=None) -> list[torch.Tensor]:
        g = self.size if axes is None else self.axis_size(axes)
        _record("all-gather", g, g * tensor_bytes(x), (g - 1) / g)
        return self._gathered(x, g)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        g = self.axis_size(axes)
        _record("all-reduce", g, tensor_bytes(x), 2 * (g - 1) / g)
        fold = {"sum": torch.add, "max": torch.maximum}[op]
        parts = self._gathered(x, g)
        out = parts[0]
        for part in parts[1:]:
            out = fold(out, part)
        return out

    def broadcast(self, x: torch.Tensor, axes, src: int) -> torch.Tensor:
        g = self.axis_size(axes)
        if g == 1:
            return x
        _record("broadcast", g, tensor_bytes(x), 1.0)
        return x.clone()

    def exchange(self, send, dst, recv_like, src):
        if send is not None:
            _record("collective-permute", 2, tensor_bytes(send), 1.0)
        return None if recv_like is None else self._received(recv_like)

    def barrier(self) -> None:
        pass


__all__ = ["Counter", "CountingMesh", "StepCost", "active", "count", "hold",
           "repeat", "repeating", "tensor_bytes"]
