"""Blocked-ELL tile-store builder and the glue around the spike_prop kernels.

Counterpart of ``repro/kernels/spike_prop/ops.py``.  The tile store is
built straight onto the target device: the (target block, slot, source
row, target column) index of every synapse is computed in numpy, and the
weights are scattered into an int16 tensor allocated on the device.  No
dense tile array is ever made on the host; at full FlyWire size the store
is 1,088 x 1,088 tiles, 38.8 GB in int16 (77.6 GB in the reference's
float32).  The partitioned store of :func:`build_blocked_sharded` is built
the same way, all partitions into one allocation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.connectome import Connectome
from repro_torch.core.neuron import LIFParams, LIFState, f32
from .kernel import SRC_BLK, TGT_BLK, fused_deliver_lif, spike_deliver_tiles

_I16 = np.iinfo(np.int16)


@dataclasses.dataclass(frozen=True)
class BlockedSynapses:
    """Dense 128 x 128 tiles for the nonempty (target, source) block pairs.

    blk_id[tb, e]  = source-block id of target-block tb's e-th tile (pad
                     slots point at the zero spike block n_sb).
    weights[tb, e] = [SRC_BLK, TGT_BLK] int16 source-major tile.
    """

    blk_id: torch.Tensor    # [n_tb, E] int32
    weights: torch.Tensor   # [n_tb, E, SRC_BLK, TGT_BLK] int16
    n: int                  # original neuron count
    n_tb: int
    n_sb: int
    occupancy: float        # nnz / stored-tile capacity (tile-format density)

    @property
    def tiles_stored(self) -> int:
        return int((self.blk_id < self.n_sb).sum())


def check_row_order(blk_id: np.ndarray, n_sb: int) -> None:
    """Raise ``ValueError`` unless every ``blk_id`` row is strictly
    ascending with its pad slots (``n_sb``) last: the fused kernel finds a
    source block's slot by binary search of its row, and would miss the
    tiles of a row out of order."""
    b = np.asarray(blk_id)
    if b.size and (b.min() < 0 or b.max() > n_sb):
        raise ValueError(f"blk_id holds ids outside [0, {n_sb}]")
    d = np.diff(b, axis=-1)
    if not np.all((d > 0) | ((d == 0) & (b[..., 1:] == n_sb))):
        raise ValueError("every blk_id row must be strictly ascending with "
                         "its pad slots last")


def _check_weights(w: np.ndarray) -> None:
    if len(w) and (w.min() < _I16.min or w.max() > _I16.max):
        raise ValueError(f"weights span [{w.min()}, {w.max()}], outside "
                         f"int16: the int16 tile store cannot hold them")
    if not np.array_equal(w, np.round(w)):
        raise ValueError("tile weights must be integers")


def _tile_slots(tgt: np.ndarray, src: np.ndarray, n_tb: int, n_sb: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """The blocked-ELL layout of an int64 (target, source) COO:
    ``(blk_id [n_tb, E] int32, slot [nnz])``, E being the widest target
    block's tile count, ``slot`` each synapse's tile slot within its
    target block's row."""
    tb, sb = tgt // TGT_BLK, src // SRC_BLK
    pair = tb * n_sb + sb
    order = np.argsort(pair, kind="stable")
    pair_s = pair[order]
    uniq_pairs, first = np.unique(pair_s, return_index=True)
    tiles_per_tb = np.bincount((uniq_pairs // n_sb).astype(np.int64),
                               minlength=n_tb)
    E = int(tiles_per_tb.max()) if len(tiles_per_tb) else 1

    blk_id = np.full((n_tb, E), n_sb, dtype=np.int32)
    slot = np.arange(len(uniq_pairs)) - np.repeat(
        np.concatenate([[0], np.cumsum(tiles_per_tb)[:-1]]), tiles_per_tb)
    blk_id[(uniq_pairs // n_sb).astype(int), slot.astype(int)] = (
        uniq_pairs % n_sb)
    e_of_pair = np.empty(len(pair), dtype=np.int64)
    e_of_pair[order] = np.repeat(slot, np.diff(
        np.concatenate([first, [len(pair_s)]])))
    return blk_id, e_of_pair


def _scatter_tiles(weights: torch.Tensor, tgt, src, slot, w) -> None:
    """Write each synapse's weight into its tile of ``weights`` [n_tb, E,
    SRC_BLK, TGT_BLK] int16 (zero elsewhere)."""
    E = weights.shape[1]
    flat = ((((tgt // TGT_BLK) * E + slot) * SRC_BLK + src % SRC_BLK)
            * TGT_BLK + tgt % TGT_BLK)
    weights.view(-1)[torch.from_numpy(flat).to(weights.device)] = (
        torch.from_numpy(np.asarray(w).astype(np.int16)).to(weights.device))


def tile_coo(tgt: np.ndarray, src: np.ndarray, w: np.ndarray, n_tb: int,
             n_sb: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Group a (target, source, weight) COO into blocked-ELL int16 tiles on
    ``device``: ``(blk_id [n_tb, E] int32, weights [n_tb, E, SRC_BLK,
    TGT_BLK] int16)``, E being the widest target block's tile count, pad
    slots pointing at the zero spike block ``n_sb``.  Raises ``ValueError``
    if a weight does not fit in int16."""
    w = np.asarray(w)
    _check_weights(w)
    tgt, src = tgt.astype(np.int64), src.astype(np.int64)
    blk_id, slot = _tile_slots(tgt, src, n_tb, n_sb)
    check_row_order(blk_id, n_sb)
    weights = torch.zeros((n_tb, blk_id.shape[1], SRC_BLK, TGT_BLK),
                          dtype=torch.int16, device=device)
    _scatter_tiles(weights, tgt, src, slot, w)
    return torch.from_numpy(blk_id).to(device), weights


def build_blocked(c: Connectome, quantized: np.ndarray | None = None,
                  device=None) -> BlockedSynapses:
    """Group the target-major CSR into tiles by (tgt//128, src//128), on
    ``device`` (default: the CUDA device, see ``resolve_device``)."""
    from repro_torch.core.engine import resolve_device
    device = resolve_device(device)
    n = c.n
    with obs.span("build", what="tile_store"):
        n_tb = (n + TGT_BLK - 1) // TGT_BLK
        n_sb = (n + SRC_BLK - 1) // SRC_BLK
        w = quantized if quantized is not None else c.in_weights
        tgt = np.repeat(np.arange(n, dtype=np.int64), c.fan_in)
        blk_id, weights = tile_coo(tgt, c.in_indices, w, n_tb, n_sb, device)
        stored = int((blk_id < n_sb).sum())
        occ = c.nnz / max(1, stored * TGT_BLK * SRC_BLK)
        return BlockedSynapses(blk_id=blk_id, weights=weights, n=n, n_tb=n_tb,
                               n_sb=n_sb, occupancy=float(occ))


@dataclasses.dataclass(frozen=True)
class ShardedBlockedSynapses:
    """Per-partition tile stores over a DCSR partitioning.

    Targets are partition-local (rows of partition p's ``U``-slot slab);
    sources stay global: ``blk_id[p]`` indexes the one ``n_sb``-block
    global spike space, so every partition gates its tiles against the
    same gathered spikes.  All partitions share one tile width E, the
    widest partition's, with pad slots last.
    """

    blk_id: torch.Tensor    # [P, n_tb, E] int32 global source block
    weights: torch.Tensor   # [P, n_tb, E, SRC_BLK, TGT_BLK] int16
    n_tb: int               # local target blocks (ceil U / TGT_BLK)
    n_sb: int               # global source blocks (ceil P*U / SRC_BLK)
    occupancy: float        # nnz / stored-tile capacity, all partitions

    @property
    def tiles_stored(self) -> int:
        return int((self.blk_id < self.n_sb).sum())


def build_blocked_sharded(d, device=None, parts=None
                          ) -> ShardedBlockedSynapses:
    """The stacked per-partition stores of a DCSR snapshot (weights as
    ``build_dcsr`` partitioned and quantized them) on ``device`` (default:
    the CUDA device); with ``parts``, only those partitions' slabs, on the
    leading axis in that order (a rank of the multi-process path builds
    its own: 3.25 GB of the 38.97 GB at full FlyWire with P = 12).  Every
    partition's tile layout is found first, then the int16 store is
    allocated once at the widest E and each partition's weights are
    scattered into its slab: nothing is stacked, so the device never
    holds a second copy.  Raises ``ValueError`` unless the weights are
    integers within int16 and every row is ascending with its pads last
    (``check_row_order``)."""
    from repro_torch.core.engine import resolve_device
    device = resolve_device(device)
    P_, U = d.n_parts, d.part_size
    parts = list(range(P_)) if parts is None else [int(p) for p in parts]
    with obs.span("build", what="tile_store_sharded"):
        n_glob = P_ * U
        n_tb = (U + TGT_BLK - 1) // TGT_BLK
        n_sb = (n_glob + SRC_BLK - 1) // SRC_BLK
        valid = d.syn_src < n_glob
        _check_weights(d.syn_w[parts][valid[parts]])
        coo = []
        for p in parts:
            tgt = d.syn_tgt_local[p][valid[p]].astype(np.int64)
            src = d.syn_src[p][valid[p]].astype(np.int64)
            blk, slot = _tile_slots(tgt, src, n_tb, n_sb)
            coo.append((tgt, src, slot, blk))
        E = max(blk.shape[1] for *_, blk in coo)
        blk_id = np.full((len(parts), n_tb, E), n_sb, dtype=np.int32)
        for i, (*_, blk) in enumerate(coo):
            blk_id[i, :, :blk.shape[1]] = blk
        check_row_order(blk_id, n_sb)
        weights = torch.zeros((len(parts), n_tb, E, SRC_BLK, TGT_BLK),
                              dtype=torch.int16, device=device)
        for i, (p, (tgt, src, slot, _)) in enumerate(zip(parts, coo)):
            _scatter_tiles(weights[i], tgt, src, slot, d.syn_w[p][valid[p]])
        stored = int((blk_id < n_sb).sum())
        occ = int(valid[parts].sum()) / max(1, stored * TGT_BLK * SRC_BLK)
        return ShardedBlockedSynapses(
            blk_id=torch.from_numpy(blk_id).to(device), weights=weights,
            n_tb=n_tb, n_sb=n_sb, occupancy=float(occ))


def spike_blocks(spikes: torch.Tensor, n: int, n_sb: int) -> torch.Tensor:
    """[..., n] bool/float spikes -> [..., n_sb+1, SRC_BLK] float32 blocks
    with a trailing zero pad block (a trial batch's ``[B, n]`` gives the
    kernels' lane axis).  Both kernels also take the per-block counts as
    their gate: see :func:`pad_spike_blocks`."""
    lead = spikes.shape[:-1]
    out = torch.zeros(lead + ((n_sb + 1) * SRC_BLK,), dtype=torch.float32,
                      device=spikes.device)
    out[..., :n] = spikes.to(torch.float32)
    return out.reshape(lead + (n_sb + 1, SRC_BLK))


def pad_spike_blocks(spikes: torch.Tensor, n: int, n_sb: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spike blocks plus their [..., n_sb+1] int32 per-block spike
    counts."""
    spk_pad = spike_blocks(spikes, n, n_sb)
    return spk_pad, spk_pad.sum(dim=-1).to(torch.int32)


def fused_step(blk_id, weights, spk_pad, nspk, lif: LIFState, drive, n: int,
               params: LIFParams, fixed_point: bool
               ) -> tuple[LIFState, torch.Tensor]:
    """Run the fused delivery->LIF kernel on an [..., n]-neuron LIF state
    (a trial batch's ``[B, n]``: one launch for the B lanes), with the
    spike blocks and counts of :func:`pad_spike_blocks` for the same lanes.

    The partitioned path's step (``core/exchange/blocked.py``, a sharded
    store over global source ids) runs it; the local path's
    ``blocked_fused`` step delivers per synapse instead
    (:func:`repro_torch.kernels.fanout.fanout_step`, no pads), and tests
    hold the two against each other.

    Pads the state and the drive channels to [..., n_tb, TGT_BLK] row
    blocks, calls :func:`fused_deliver_lif` and unpads.  ``None`` channels
    stay ``None``.  The fixed-point ``v_mv`` -> weight-unit conversion
    happens here, as ``apply_drive`` does it on the unfused path (an IEEE
    division by a float32 tensor, then round half to even).

    Returns ``(LIFState, spikes [..., n] bool)``.
    """
    n_tb = blk_id.shape[0]
    rows = n_tb * TGT_BLK
    lead = lif.v.shape[:-1]
    sdt = torch.int32 if fixed_point else torch.float32

    def rowblk(x, dtype):
        out = torch.zeros(lead + (rows,), dtype=dtype, device=x.device)
        out[..., :n] = x.to(dtype)
        return out.reshape(lead + (n_tb, TGT_BLK))

    gstim = None if drive.g_units is None else rowblk(drive.g_units,
                                                      torch.float32)
    vin = None
    if drive.v_mv is not None:
        vin = (rowblk(torch.round(drive.v_mv / f32(params.w_scale,
                                                   drive.v_mv)), torch.int32)
               if fixed_point else rowblk(drive.v_mv, torch.float32))
    force = None if drive.force is None else rowblk(drive.force, torch.int32)
    v, g, refrac, spk = fused_deliver_lif(
        blk_id, weights, spk_pad, nspk, rowblk(lif.v, sdt), rowblk(lif.g, sdt),
        rowblk(lif.refrac, torch.int32), gstim, vin, force, params=params,
        fixed_point=fixed_point)

    def unblk(x):
        return x.reshape(lead + (rows,))[..., :n]
    return (LIFState(v=unblk(v), g=unblk(g), refrac=unblk(refrac)),
            unblk(spk) != 0)


def spike_deliver(bs: BlockedSynapses, spikes: torch.Tensor) -> torch.Tensor:
    """spikes: [..., n] bool/float on the store's device.  Returns g drive
    [..., n] float32 (the standalone entry point; the ``blocked`` engine
    calls the kernel wrapper directly)."""
    spk_pad, nspk = pad_spike_blocks(spikes, bs.n, bs.n_sb)
    out = spike_deliver_tiles(bs.blk_id, bs.weights, spk_pad, nspk)
    return out.reshape(spikes.shape[:-1] + (-1,))[..., :bs.n]


__all__ = ["BlockedSynapses", "ShardedBlockedSynapses", "build_blocked",
           "build_blocked_sharded", "check_row_order", "fused_step",
           "pad_spike_blocks", "spike_blocks", "spike_deliver", "tile_coo"]
