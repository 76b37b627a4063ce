"""Carry state across from the JAX package to the port.

Each function takes an object of :mod:`repro` whose array fields can be
read with ``np.asarray`` (JAX arrays or numpy arrays) and returns the
port's counterpart on ``device`` (default: the CUDA device; it raises
without one, as ``simulate`` does).  This module imports neither JAX nor
the JAX package: it reads attributes, dict keys and tuple items only.
With it a test can run the reference for k steps, carry the state over,
and run both for k more, or run an LM on the reference's weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.connectome import Connectome
from repro_torch.core.engine import resolve_device
from repro_torch.core.engines.blocked import BlockedState
from repro_torch.core.engines.csr import CsrState
from repro_torch.core.neuron import LIFState
from repro_torch.core.step import SimCarry
from repro_torch.kernels.spike_prop.ops import check_row_order

_CONNECTOME_ARRAYS = ("in_indptr", "in_indices", "in_weights", "out_indptr",
                      "out_indices", "out_weights")


def _t(x, device, dtype=None) -> torch.Tensor:
    a = np.array(x, dtype=dtype, order="C")     # a writable copy, 0-d kept
    return torch.from_numpy(a).to(resolve_device(device))


def connectome_from_jax(c) -> Connectome:
    """The reference's ``Connectome``: n and its six CSR arrays, copied."""
    return Connectome(n=int(c.n), **{k: np.array(getattr(c, k))
                                     for k in _CONNECTOME_ARRAYS})


def blocked_from_jax(state, device=None) -> BlockedState:
    """A reference ``BlockedState`` (or ``BlockedSynapses``) as the port's:
    the float32 ``[tb, e, tgt, src]`` tiles become int16 ``[tb, e, src,
    tgt]``, the layout the kernels read.  Raises ``ValueError`` unless
    every weight is an integer within int16 and every ``blk_id`` row is
    ascending with its pad slots last (``check_row_order``)."""
    w = np.asarray(state.weights)
    w16 = w.astype(np.int16)
    if not np.array_equal(w16.astype(w.dtype), w):
        raise ValueError("tile weights are not integers within int16")
    blk_id = np.asarray(state.blk_id).astype(np.int32)
    n_sb = int(state.n_sb)
    check_row_order(blk_id, n_sb)
    return BlockedState(
        blk_id=_t(blk_id, device), weights=_t(w16.transpose(0, 1, 3, 2),
                                              device),
        n=int(state.n), n_sb=n_sb, occupancy=float(state.occupancy),
        tiles_stored=int((blk_id < n_sb).sum()))


def csr_from_jax(state, device=None) -> CsrState:
    """A reference ``CsrState`` as the port's."""
    return CsrState(src=_t(state.src, device, np.int32),
                    tgt=_t(state.tgt, device, np.int32),
                    w=_t(state.w, device, np.float32), n=int(state.n))


def _tree(x, device):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return _t(x, device)


def carry_from_jax(carry, device=None) -> SimCarry:
    """A reference ``SimCarry``: LIF state, ring, ptr, the uint32 key pair
    (held as int64 words), counts, dropped, stimulus state and stats."""
    lif = carry.lif
    return SimCarry(
        lif=LIFState(v=_t(lif.v, device), g=_t(lif.g, device),
                     refrac=_t(lif.refrac, device, np.int32)),
        ring=_t(carry.ring, device, np.bool_),
        ptr=int(np.asarray(carry.ptr)),
        key=_t(np.asarray(carry.key).astype(np.uint32), device, np.int64),
        counts=_t(carry.counts, device, np.int32),
        dropped=_t(carry.dropped, device, np.int32),
        stim=_tree(carry.stim, device),
        stats=_tree(dict(carry.stats), device))


def _layer(tree, r=None):
    """A block's parameter dict; ``r`` picks one layer of a tree stacked
    on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    a = np.asarray(tree)
    return a if r is None else a[r]


def lm_params_from_jax(params, cfg, device=None):
    """The reference's LM parameter pytree (from ``repro.models.
    init_params``; JAX or numpy leaves) as the port's
    :class:`repro_torch.models.LMParams` for the dense config ``cfg``.

    The reference's ``stack`` holds ``"scan"``, one tree per position of
    ``cfg.block_pattern`` stacked over the pattern's repeats, and
    ``"tail"``, the unrolled remainder; layer ``r * len(pattern) + j`` is
    repeat ``r`` of position ``j``, then the tail follows.  They become
    one ``nn.ModuleList`` of blocks in that order."""
    from torch import nn

    from repro_torch.models import model as lm
    from repro_torch.models.transformer import Block, layer_kinds
    lm.check_supported(cfg)
    device = resolve_device(device)
    pat = cfg.block_pattern
    n_rep = cfg.n_layers // len(pat)
    trees = [_layer(params["stack"]["scan"][j], r) for r in range(n_rep)
             for j in range(len(pat))]
    trees += [_layer(t) for t in params["stack"]["tail"]]
    kinds = layer_kinds(cfg)
    if len(trees) != len(kinds):
        raise ValueError(f"{len(trees)} layers in the tree, {len(kinds)} in "
                         f"{cfg.name}")

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return _t(tree, device)
    stack = nn.ModuleList(Block(kind, tensors(t))
                          for kind, t in zip(kinds, trees))
    return lm.LMParams(
        _t(params["embed"], device),
        None if cfg.tie_embeddings else _t(params["lm_head"], device),
        tensors(_layer(params["final_norm"])), stack)


__all__ = ["blocked_from_jax", "carry_from_jax", "connectome_from_jax",
           "csr_from_jax", "lm_params_from_jax"]
