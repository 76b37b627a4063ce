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
from repro_torch.core.exchange.arrays import DistArrays
from repro_torch.core.exchange.blocked import ShardedBlockedState
from repro_torch.core.neuron import LIFState
from repro_torch.core.step import SimCarry
from repro_torch.kernels.spike_prop.ops import check_row_order

_CONNECTOME_ARRAYS = ("in_indptr", "in_indices", "in_weights", "out_indptr",
                      "out_indices", "out_weights")


def _t(x, device, dtype=None) -> torch.Tensor:
    a = np.array(x, dtype=dtype, order="C")     # a writable copy, 0-d kept
    if a.dtype.name == "bfloat16":              # numpy's ml_dtypes extension
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            resolve_device(device))
    return torch.from_numpy(a).to(resolve_device(device))


def connectome_from_jax(c) -> Connectome:
    """The reference's ``Connectome``: n and its six CSR arrays, copied."""
    return Connectome(n=int(c.n), **{k: np.array(getattr(c, k))
                                     for k in _CONNECTOME_ARRAYS})


def _tiles_from_jax(state, device):
    """A reference store's ``blk_id`` and float32 ``[..., tgt, src]``
    tiles as the kernels' int32 ids and int16 ``[..., src, tgt]`` tiles,
    checked: integer weights within int16, rows in ``check_row_order``."""
    w = np.asarray(state.weights)
    w16 = w.astype(np.int16)
    if not np.array_equal(w16.astype(w.dtype), w):
        raise ValueError("tile weights are not integers within int16")
    blk_id = np.asarray(state.blk_id).astype(np.int32)
    check_row_order(blk_id, int(state.n_sb))
    return blk_id, _t(blk_id, device), _t(np.swapaxes(w16, -1, -2), device)


def blocked_from_jax(state, device=None) -> BlockedState:
    """A reference ``BlockedState`` (or ``BlockedSynapses``) as the port's:
    the float32 ``[tb, e, tgt, src]`` tiles become int16 ``[tb, e, src,
    tgt]``, the layout the kernels read.  Raises ``ValueError`` unless
    every weight is an integer within int16 and every ``blk_id`` row is
    ascending with its pad slots last (``check_row_order``)."""
    blk_id, ids, weights = _tiles_from_jax(state, device)
    n_sb = int(state.n_sb)
    return BlockedState(
        blk_id=ids, weights=weights, n=int(state.n), n_sb=n_sb,
        occupancy=float(state.occupancy),
        tiles_stored=int((blk_id < n_sb).sum()))


def sharded_blocked_from_jax(state, device=None) -> ShardedBlockedState:
    """A reference ``ShardedBlockedState`` (the ``blocked`` scheme's) as
    the port's: float32 ``[P, tb, e, tgt, src]`` tiles become int16 ``[P,
    tb, e, src, tgt]``, checked as :func:`blocked_from_jax` checks."""
    blk_id, ids, weights = _tiles_from_jax(state, device)
    n_sb = int(state.n_sb)
    return ShardedBlockedState(
        blk_id=ids, weights=weights,
        src_gfo=_t(state.src_gfo, device, np.int32), n_sb=n_sb,
        tiles_stored=int((blk_id < n_sb).sum()),
        occupancy=float(state.occupancy))


_DIST_DTYPES = {"syn_src": np.int32, "syn_tgt": np.int32,
                "syn_w": np.float32, "out_indptr": np.int32,
                "out_tgt": np.int32, "out_w": np.float32,
                "pad_mask": np.bool_, "src_gfo": np.int32}


def dist_arrays_from_jax(arrs, device=None) -> DistArrays:
    """A reference ``DistArrays`` (the ``bitmap``/``event`` schemes'
    stores) as the port's."""
    return DistArrays(**{k: _t(getattr(arrs, k), device, dt)
                         for k, dt in _DIST_DTYPES.items()})


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
    :class:`repro_torch.models.LMParams` for ``cfg``.  Leaves keep their
    dtype (bfloat16 too); nested dicts (an MoE block's ``shared`` expert,
    RWKV's ``lora_mix`` and ``lora_w``) stay nested.

    The reference's ``stack`` holds ``"scan"``, one tree per position of
    ``cfg.block_pattern`` stacked over the pattern's repeats, and
    ``"tail"``, the unrolled remainder; layer ``r * len(pattern) + j`` is
    repeat ``r`` of position ``j``, then the tail follows.  They become
    one ``nn.ModuleList`` of blocks in that order.  The enc-dec family's
    ``encoder`` and ``decoder`` are stacked whole on a leading layer axis
    (no tail) and become one ``nn.ModuleList`` each."""
    from torch import nn

    from repro_torch.models import model as lm
    from repro_torch.models.transformer import Block, layer_kinds
    device = resolve_device(device)

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return _t(tree, device)

    def opt(key):
        return _t(params[key], device) if key in params else None
    head = (_t(params["embed"], device),
            None if cfg.tie_embeddings else _t(params["lm_head"], device),
            tensors(_layer(params["final_norm"])))
    if cfg.is_encdec:
        def layers(tree, n, make):
            return nn.ModuleList(make(tensors(_layer(tree, r)))
                                 for r in range(n))
        return lm.LMParams(
            *head, enc_pos=opt("enc_pos"), dec_pos=opt("dec_pos"),
            encoder=layers(params["encoder"], cfg.n_enc_layers,
                           lambda t: Block("attn", t)),
            decoder=layers(params["decoder"], cfg.n_layers, lm.EncDecBlock),
            enc_norm=tensors(_layer(params["enc_norm"])))
    pat = cfg.block_pattern
    n_rep = cfg.n_layers // len(pat)
    trees = [_layer(params["stack"]["scan"][j], r) for r in range(n_rep)
             for j in range(len(pat))]
    trees += [_layer(t) for t in params["stack"]["tail"]]
    kinds = layer_kinds(cfg)
    if len(trees) != len(kinds):
        raise ValueError(f"{len(trees)} layers in the tree, {len(kinds)} in "
                         f"{cfg.name}")
    stack = nn.ModuleList(Block(kind, tensors(t))
                          for kind, t in zip(kinds, trees))
    return lm.LMParams(*head, stack, pos=opt("pos"))


def lm_tree_to_jax_layout(tree, cfg) -> dict:
    """The inverse of :func:`lm_params_from_jax`, for any set of tensors
    shaped as an :class:`repro_torch.models.LMParams`: the module itself,
    or a dict from its parameter names (``named_parameters()``: ``embed``,
    ``stack.3.mixer.wq``, ...) to tensors, such as gradients or AdamW
    moments.  Returns the reference's parameter pytree of numpy arrays:
    ``embed``, ``lm_head`` (unless tied), ``final_norm`` and ``stack`` with
    its ``"scan"`` (per pattern position, stacked over the repeats) and
    ``"tail"`` layers, or for the enc-dec family ``encoder`` and
    ``decoder`` stacked whole beside ``enc_pos``, ``dec_pos`` and
    ``enc_norm``; a dotted name nests (``stack.0.ffn.shared.w_up`` is the
    MoE's shared expert, ``stack.0.mixer.lora_mix.a`` an RWKV LoRA).
    numpy has no bfloat16 of its own, so a bfloat16 tensor comes back as
    float32 (exactly)."""
    from torch import nn

    flat = (dict(tree.named_parameters()) if isinstance(tree, nn.Module)
            else dict(tree))
    nested: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = nested
        for part in path:
            node = node.setdefault(part, {})
        t = t.detach().cpu()
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stacked(trees):
        if isinstance(trees[0], dict):
            return {k: stacked([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)
    if cfg.is_encdec:
        for part, n in (("encoder", cfg.n_enc_layers),
                        ("decoder", cfg.n_layers)):
            nested[part] = stacked([nested[part][str(i)] for i in range(n)])
        return nested
    layers = nested.pop("stack")
    pat = len(cfg.block_pattern)
    n_rep = cfg.n_layers // pat
    scan = tuple(stacked([layers[str(r * pat + j)] for r in range(n_rep)])
                 if n_rep else None for j in range(pat))
    tail = tuple(layers[str(i)] for i in range(n_rep * pat, cfg.n_layers))
    return {**nested, "stack": {"scan": scan, "tail": tail}}


__all__ = ["blocked_from_jax", "carry_from_jax", "connectome_from_jax",
           "csr_from_jax", "dist_arrays_from_jax", "lm_params_from_jax",
           "lm_tree_to_jax_layout", "sharded_blocked_from_jax"]
