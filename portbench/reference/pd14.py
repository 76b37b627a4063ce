"""The plain reference of the cortical microcircuit (Potjans & Diesmann,
Cereb. Cortex 24:785, 2014), stepped in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
gets the network's arrays (source-major: ``out_indptr``, and for each
synapse its target, integer weight and delay in steps), the
configuration and the traffic's drive, and the lane seeds, and works out
everything else itself.  Each step t of each lane (t counted from the
experiment's start):

1. the lane's key is split into three: the first is the next step's key,
   the second draws the count drive, the third is unused;
2. the input due at step t is read from slot ``t % D`` of the lane's ring
   of pending input (``D`` the longest delay + 1) and the slot zeroed;
3. the count drive: one 32-bit threefry word a neuron, and the neuron of
   population p receives as many events, each ``w_ext`` units, as the
   thresholds ``ceil(CDF_p(k) * 2**32)`` of the Poisson CDF of mean
   ``K_ext[p] * rate * dt`` (made here in float64) that the word reaches;
4. the LIF update: in fixed point (Q19.12, or the control's Q23.8) this
   module's :func:`lif_fx`, which takes ``reference/sim.py``'s step with
   its two decay products in 64 bits (at tau_syn 0.5 ms the 32-bit
   product wraps once |g| passes 160 weight units: one inhibitory event);
   in float32 (or the control's bfloat16) ``reference/sim.py``'s; the
   spikes counted;
5. each spike of source s, for every synapse of s with target i, weight w
   and delay d, adds w into slot ``(t + d) % D`` of the ring at neuron i
   (int32 sums, exact in any order; in groups of sources of at most
   ``BLOCK_EVENTS`` events).

The ring comes back as ``[B, n, D]`` int32, slot s holding the input due
at the steps t with ``t % D == s``: the program's layout.  Every lane starts from rest.  ``record=True``
also returns each step's counts for the family's least-work count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import sim, threefry

N_SPLIT = 3                 # the step's key split: next key, count, unused
BLOCK_ELEMENTS = 1 << 25    # lane-neuron words drawn at once
BLOCK_EVENTS = 1 << 25      # synapse events delivered at once
CDF_ONE = 1 << 32


class Result(NamedTuple):
    counts: torch.Tensor    # [B, n] int32
    v: torch.Tensor         # [B, n]
    g: torch.Tensor         # [B, n]
    refrac: torch.Tensor    # [B, n] int32
    pending: torch.Tensor   # [B, n, D] int32
    dropped: torch.Tensor   # [B] int32: always 0, delivery is exact
    stats: dict | None


def count_table(lam) -> torch.Tensor:
    """``[P, K]`` int64: row p holds ``ceil(CDF(k) * 2**32)`` of the
    Poisson distribution of mean ``lam[p]`` for k = 0, 1, ... up to the
    first that reaches ``2**32``, padded with ``2**32``; the CDF summed in
    float64 from ``exp(-lam)``, each next term ``term * lam / k``."""
    rows = []
    for mean in lam:
        term = float(np.exp(-float(mean)))
        cdf, row, k = 0.0, [], 0
        while True:
            cdf += term
            row.append(min(CDF_ONE, int(np.ceil(cdf * CDF_ONE))))
            if row[-1] >= CDF_ONE:
                break
            k += 1
            term = term * float(mean) / k
        rows.append(row)
    width = max(len(r) for r in rows)
    return torch.tensor([r + [CDF_ONE] * (width - len(r)) for r in rows],
                        dtype=torch.int64)


def words(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., n]`` 32-bit words of ``jax.random.bits(key, (n,))`` for
    ``[..., 2]`` keys (partitionable threefry: counter i hashed under the
    key, the block's two words xor-ed)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry.threefry2x32(keys[..., 0, None], keys[..., 1, None],
                                   i >> 32, i & threefry.MASK)
    return b0 ^ b1


def deliver(flat, t: int, D: int, slot_size: int, base, src, indptr, deg,
            tgt, w, dly) -> int:
    """Add the fan-out of the spiking sources ``src`` (their lanes' offsets
    ``base``) into the flat ring, each synapse at slot ``(t + d) % D``, a
    group of sources of at most ``BLOCK_EVENTS`` events at a time (a
    synchronous volley is billions); returns the events."""
    if not len(src):
        return 0
    cnt = deg[src]
    cum = torch.cumsum(cnt, 0)
    total, start = int(cum[-1]), 0
    while start < len(src):
        before = int(cum[start] - cnt[start])
        stop = max(start + 1, int(torch.searchsorted(
            cum, before + BLOCK_EVENTS, right=True)))
        c = cnt[start:stop]
        events = int(cum[stop - 1]) - before
        first = torch.repeat_interleave(indptr[src[start:stop]]
                                        - (torch.cumsum(c, 0) - c), c)
        syn = first + torch.arange(events, device=flat.device)
        at = ((t + dly[syn].long()) % D) * slot_size \
            + torch.repeat_interleave(base[start:stop], c) + tgt[syn].long()
        flat.index_add_(0, at, w[syn].to(torch.int32))
        start = stop
    return total


def lif_fx(v0_, g0, refrac, g_in, m: sim.Model, fx: dict):
    """``reference/sim.py``'s fixed-point step (``g_in`` the integer sum of
    this step's weights) with ``((x >> 2) * c16) >> 14`` taken in 64 bits
    for the membrane and the conductance alike."""
    active = refrac <= 0
    v, g = v0_.long(), g0.long()
    g = torch.where(active, sim.wrap(g + (g_in.long() << fx["frac"])),
                    g0).long()
    x = sim.wrap(fx["v0"] - v + g).long()
    v = torch.where(active, sim.wrap(v + (((x >> 2) * fx["alpha16"]) >> 14)),
                    v.int())
    g = torch.where(active, sim.wrap(g - (((g >> 2) * fx["gdecay16"]) >> 14)),
                    g.int())
    spikes = active & (v > fx["v_th"])
    v = torch.where(spikes, fx["v_r"], v).to(torch.int32)
    g = torch.where(spikes, 0, g).to(torch.int32)
    return v, g, sim._refrac(refrac, spikes, m), spikes


def w_ext_units(conf: dict) -> float:
    """The external input's weight: its PSC as g in mV (PSC x tau_m /
    C_m), in whole weight quanta."""
    m, d = conf["model"], conf["drive"]
    return float(round(d["psc_ext_pa"] * m["tau_m"] / m["c_m_pf"]
                       / m["w_scale"]))


def simulate(net: dict, conf: dict, drive: list, seeds, t_steps: int,
             device, *, record: bool = False, control: bool = False
             ) -> Result:
    """Run ``t_steps`` steps of every lane (one per seed) from rest."""
    (part,) = drive
    if part["kind"] != "poisson_count":
        raise ValueError(f"unknown drive part {part['kind']!r}")
    md = conf["model"]
    m = sim.Model(**{k: md[k] for k in (
        "tau_m", "tau_g", "tau_ref", "v0", "v_r", "v_th", "w_scale", "dt",
        "fixed_point", "weight_bits")}, delay=md["dt"])
    device = torch.device(device)
    n, B = int(net["n"]), len(seeds)
    indptr = torch.as_tensor(np.asarray(net["out_indptr"], np.int64),
                             device=device)
    tgt = torch.as_tensor(np.asarray(net["out_indices"]), device=device)
    w = torch.as_tensor(np.asarray(net["out_weights"]), device=device)
    dly = torch.as_tensor(np.asarray(net["out_delays"]), device=device)
    D = int(dly.max()) + 1 if len(dly) else 2
    deg = indptr[1:] - indptr[:-1]
    bounds = np.asarray(net["pop_bounds"], np.int64)
    pop = torch.as_tensor(np.repeat(np.arange(len(bounds) - 1),
                                    np.diff(bounds)), device=device)
    lam = [k * part["rate_hz"] * m.dt * 1e-3
           for k in conf["drive"]["k_ext"]]
    thr = count_table(lam).to(device)[pop]                   # [n, K]
    w_ext = sim.f32(w_ext_units(conf))

    keys = sim.step_keys(seeds, t_steps, N_SPLIT).to(device)
    block = max(1, min(t_steps, BLOCK_ELEMENTS // max(1, B * n)))

    if m.fixed_point:
        fx = m.fx(8 if control else 12)
        v = torch.full((B, n), fx["v0"], dtype=torch.int32, device=device)
        g = torch.zeros((B, n), dtype=torch.int32, device=device)
    else:
        dt_ = torch.bfloat16 if control else torch.float32
        v = torch.full((B, n), m.v0, dtype=dt_, device=device)
        g = torch.zeros((B, n), dtype=dt_, device=device)
    refrac = torch.zeros((B, n), dtype=torch.int32, device=device)
    counts = torch.zeros((B, n), dtype=torch.int32, device=device)
    ring = torch.zeros((D, B, n), dtype=torch.int32, device=device)
    flat = ring.view(-1)
    lane_base = torch.arange(B, device=device) * n
    per_step, syn_events = [], []
    bits = None

    for t in range(t_steps):
        if t % block == 0:
            bits = words(keys[t:t + block, :, 1], n)        # [span, B, n]
        u = bits[t % block]
        events = torch.zeros((B, n), dtype=torch.int32, device=device)
        for k in range(thr.shape[1]):
            events += (u >= thr[:, k]).to(torch.int32)
        slot = t % D
        due = ring[slot].clone()
        ring[slot] = 0
        g_units = due.to(torch.float32) + events.to(torch.float32) * w_ext
        if m.fixed_point:
            nv, ng, nr, spikes = lif_fx(
                v, g, refrac, torch.round(g_units).to(torch.int32), m, fx)
        elif control:
            nv, ng, nr, spikes = sim.lif_bf16(v, g, refrac, g_units, None, m)
        else:
            nv, ng, nr, spikes = sim.lif_f32(v, g, refrac, g_units, None, m)
        lane, src = spikes.nonzero(as_tuple=True)
        total = deliver(flat, t, D, B * n, lane_base[lane], src, indptr,
                        deg, tgt, w, dly)
        if record:
            per_step.append(torch.stack([
                spikes.sum(), sim._changed(nv, v).sum(),
                sim._changed(ng, g).sum(), (nr != refrac).sum(),
                (due != 0).sum(), events.sum()]))
            syn_events.append(total)
        v, g, refrac = nv, ng, nr
        counts += spikes.to(torch.int32)

    if control:     # the state in the configuration's units and type
        if m.fixed_point:
            v, g = sim.wrap(v.long() << (12 - fx["frac"])), \
                sim.wrap(g.long() << (12 - fx["frac"]))
        else:
            v, g = v.to(torch.float32), g.to(torch.float32)
    stats = None
    if record:
        cols = torch.stack(per_step).cpu().numpy().astype(np.int64)
        stats = {"spikes": cols[:, 0], "v_changed": cols[:, 1],
                 "g_changed": cols[:, 2], "refrac_changed": cols[:, 3],
                 "pending_read": cols[:, 4], "drive_events": cols[:, 5],
                 "syn_events": np.asarray(syn_events, np.int64),
                 "draws": np.full(t_steps, B * (N_SPLIT + n), np.int64)}
    return Result(counts=counts, v=v, g=g, refrac=refrac,
                  pending=ring.permute(1, 2, 0),
                  dropped=torch.zeros(B, dtype=torch.int32, device=device),
                  stats=stats)
