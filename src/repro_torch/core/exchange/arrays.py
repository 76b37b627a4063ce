"""Partition-stacked synaptic arrays shared by the exchange schemes.

Counterpart of ``repro/core/exchange/arrays.py``.
:func:`build_dist_arrays` turns a :class:`repro_torch.core.dcsr.DCSR`
snapshot into the per-partition stores the ``bitmap`` and ``event``
schemes read (the ``blocked`` scheme uses only the fan-out table of
:func:`build_src_gfo`), on the run's device.  The host work is the
reference's: one batched stable argsort and one flat bincount over all
partitions.  Both builds are memoized on the DCSR and the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs

from ..dcsr import DCSR
from .base import memoized_build


class DistArrays(NamedTuple):
    """Stacked per-partition synaptic state.  Leading dim = P."""
    # target-major (bitmap scheme): local in-CSR with global source ids
    syn_src: torch.Tensor      # [P, S] int32 global new id; pad = P*U
    syn_tgt: torch.Tensor      # [P, S] int32 local target; pad = U
    syn_w: torch.Tensor        # [P, S] float32
    # source-major (event scheme): out_indptr[p, s] = start of global
    # source s's run of local synapses on partition p
    out_indptr: torch.Tensor   # [P, P*U + 1] int32
    out_tgt: torch.Tensor      # [P, S] int32 local target; pad = U
    out_w: torch.Tensor        # [P, S] float32
    pad_mask: torch.Tensor     # [P, U] bool, True for real neurons
    src_gfo: torch.Tensor      # [P, U] int32 global fan-out of local
                               # sources: exact drops for spikes beyond
                               # the event capacity


def _host_dist_arrays(d: DCSR) -> dict:
    P_, U = d.n_parts, d.part_size
    n_glob = P_ * U
    # event-scheme regroup, batched over partitions: pad slots carry
    # src = P*U and sort last
    order = np.argsort(d.syn_src, axis=1, kind="stable")
    src_s = np.take_along_axis(d.syn_src, order, axis=1)
    out_tgt = np.take_along_axis(d.syn_tgt_local, order, axis=1)
    out_w = np.take_along_axis(d.syn_w, order, axis=1)

    valid = src_s < n_glob
    part_of = np.broadcast_to(np.arange(P_, dtype=np.int64)[:, None],
                              src_s.shape)
    flat = part_of[valid] * n_glob + src_s[valid]
    counts = np.bincount(flat, minlength=P_ * n_glob).reshape(P_, n_glob)
    out_indptr = np.zeros((P_, n_glob + 1), dtype=np.int32)
    out_indptr[:, 1:] = np.cumsum(counts, axis=1)
    gfo = counts.sum(axis=0).astype(np.int32)   # [P*U]
    return dict(syn_src=d.syn_src, syn_tgt=d.syn_tgt_local, syn_w=d.syn_w,
                out_indptr=out_indptr, out_tgt=out_tgt.astype(np.int32),
                out_w=out_w.astype(np.float32),
                pad_mask=d.inv_perm.reshape(P_, U) >= 0,
                src_gfo=gfo.reshape(P_, U))


def _parts_key(parts) -> str:
    return "all" if parts is None else ",".join(str(int(p)) for p in parts)


def build_dist_arrays(d: DCSR, device, parts=None) -> DistArrays:
    """The bitmap/event stores of ``d`` on ``device`` (with ``parts``,
    only those partitions', still stacked on the leading axis), memoized
    on all three.  The host regroup covers every partition either way."""
    def build():
        with obs.span("build", what="dist_arrays"):
            host = _host_dist_arrays(d)
            pick = slice(None) if parts is None else list(parts)
            return DistArrays(**{k: torch.from_numpy(
                np.ascontiguousarray(v[pick])).to(device)
                for k, v in host.items()})
    return memoized_build(
        d, f"dist_arrays:{torch.device(device)}:{_parts_key(parts)}", build)


def build_src_gfo(d: DCSR, device, parts=None) -> torch.Tensor:
    """[P, U] int32 global fan-out of local sources (with ``parts``, those
    partitions' rows), standalone (one flat bincount), for the
    ``blocked`` scheme's drop accounting."""
    def build():
        n_glob = d.n_parts * d.part_size
        src = d.syn_src[d.syn_src < n_glob]
        gfo = np.bincount(src, minlength=n_glob).astype(np.int32)
        gfo = gfo.reshape(d.n_parts, d.part_size)
        if parts is not None:
            gfo = gfo[list(parts)]
        return torch.from_numpy(np.ascontiguousarray(gfo)).to(device)
    return memoized_build(
        d, f"src_gfo:{torch.device(device)}:{_parts_key(parts)}", build)


__all__ = ["DistArrays", "build_dist_arrays", "build_src_gfo"]
