"""The plain reference: the FlyWire LIF network, stepped in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
gets the network's arrays, the configuration's ``model`` entry, the
traffic's ``drive`` list and the lane seeds, and works out everything
else itself.  Each step of each lane, as the paper's §3.2 model (and the
program) defines it:

1. the lane's key is split into ``1 + max(2, parts)`` keys: the first is
   the next step's key, the others go to the drive's parts in order;
2. the spikes of ``delay`` ms ago are read from a ring of ``delay / dt``
   slots and delivered: each spiking source adds its (capped) weight to
   each of its targets, summed exactly in integers;
3. a ``poisson`` part adds ``weight`` units to each of its neurons whose
   Bernoulli(rate * dt) draw fires; a ``background`` part forces a spike
   on each neuron whose draw fires;
4. the LIF update (float32 or Q19.12, below), the spikes written to the
   ring slot just read, and the per-neuron counts.

Float32 follows IEEE single precision with the two fused multiply-adds
the model's reference implementation forms (``g + g_units * w_scale`` and
``v + alpha_m * ((v0 - v) + g)``) and flush-to-zero around every
operation; Q19.12 is int32 arithmetic that wraps, with arithmetic right
shifts.  ``control=True`` computes the same in the nearest precision
below the configuration's: bfloat16 state and arithmetic for float32,
8 fractional bits (Q23.8) for Q19.12.  It is the comparison's control,
never the benchmark's answer.

Delivery runs over the source-major CSR, one batch of all the lanes'
spiking sources a step; the stimulus draws are made for a block of steps
at once.  ``record=True`` also returns, for each step, the counts the
benchmark's least-work yardstick needs (``portbench/yardstick.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from portbench.network import pick

from . import threefry

FLT_MIN = float(np.finfo(np.float32).tiny)
BLOCK_ELEMENTS = 1 << 25     # lane-neuron draws made at once


@dataclasses.dataclass(frozen=True)
class Model:
    tau_m: float
    tau_g: float
    tau_ref: float
    v0: float
    v_r: float
    v_th: float
    w_scale: float
    dt: float
    delay: float
    fixed_point: bool
    weight_bits: int

    @classmethod
    def of(cls, model: dict) -> "Model":
        return cls(**{f.name: model[f.name]
                      for f in dataclasses.fields(cls)})

    @property
    def ref_steps(self) -> int:
        return max(1, round(self.tau_ref / self.dt))

    @property
    def delay_steps(self) -> int:
        return max(1, round(self.delay / self.dt))

    @property
    def alpha_m(self) -> float:
        return self.dt / self.tau_m

    @property
    def decay_g(self) -> float:
        return 1.0 - self.dt / self.tau_g

    def fx(self, frac_bits: int) -> dict:
        """Fixed-point constants at ``frac_bits`` fractional bits, the
        coefficients at 16 and applied as ``((x >> 2) * c16) >> 14``."""
        one = 1 << frac_bits
        return {"frac": frac_bits,
                "alpha16": round(self.alpha_m * (1 << 16)),
                "gdecay16": round((self.dt / self.tau_g) * (1 << 16)),
                "v_th": round(self.v_th / self.w_scale * one),
                "v_r": round(self.v_r / self.w_scale * one),
                "v0": round(self.v0 / self.w_scale * one)}


class Result(NamedTuple):
    counts: torch.Tensor    # [B, n] int32
    v: torch.Tensor         # [B, n]
    g: torch.Tensor         # [B, n]
    refrac: torch.Tensor    # [B, n] int32
    dropped: torch.Tensor   # [B] int32: always 0, delivery is exact
    stats: dict | None      # per-step counts (record=True)


# --------------------------------------------------------------------------
# float32 with flush-to-zero, and its fused multiply-add
# --------------------------------------------------------------------------

def ftz(x):
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def fma_f32(a, b: float, c):
    """Correctly rounded float32 ``a * b + c`` (one rounding) under
    flush-to-zero: the product is exact in float64, the float64 sum and
    its TwoSum error bracket the true value, and a float64 sum exactly
    halfway between two float32 values is moved one step towards it."""
    p = ftz(a).double() * b
    cd = ftz(c).double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    low = s.view(torch.int64) & ((1 << 29) - 1)
    tie = (low == (1 << 28)) & (e != 0)
    away = torch.full_like(s, float("inf")).copysign(e)
    s = torch.where(tie, torch.nextafter(s, away), s)
    return ftz(s.float())


def f32(x: float) -> float:
    return float(np.float32(x))


def wrap(x):
    """int64 -> int32 two's complement."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


# --------------------------------------------------------------------------
# The LIF update of one step, [B, n] state
# --------------------------------------------------------------------------

def _refrac(refrac, spikes, m: Model):
    return torch.where(spikes, m.ref_steps,
                       torch.clamp(refrac - 1, min=0)).to(torch.int32)


def lif_f32(v0_, g0, refrac, g_units, force, m: Model):
    active = refrac <= 0
    g = fma_f32(g_units, f32(m.w_scale), g0)
    v = ftz(v0_)
    v = fma_f32(ftz(ftz(f32(m.v0) - v) + g), f32(m.alpha_m), v)
    g = ftz(g * f32(m.decay_g))
    v = torch.where(active, v, v0_)
    g = torch.where(active, g, g0)
    spikes = active & (v > f32(m.v_th))
    if force is not None:
        spikes = spikes | (active & force)
    v = torch.where(spikes, f32(m.v_r), v)
    g = torch.where(spikes, 0.0, g)
    return v, g, _refrac(refrac, spikes, m), spikes


def lif_bf16(v0_, g0, refrac, g_units, force, m: Model):
    """The control's float path: state and arithmetic in bfloat16."""
    bf = torch.bfloat16
    active = refrac <= 0
    g = g0 + g_units.to(bf) * m.w_scale
    v = v0_ + m.alpha_m * ((m.v0 - v0_) + g)
    g = g * m.decay_g
    v = torch.where(active, v, v0_)
    g = torch.where(active, g, g0)
    spikes = active & (v > m.v_th)
    if force is not None:
        spikes = spikes | (active & force)
    v = torch.where(spikes, torch.tensor(m.v_r, dtype=bf, device=v.device), v)
    g = torch.where(spikes, torch.zeros((), dtype=bf, device=g.device), g)
    return v, g, _refrac(refrac, spikes, m), spikes


def lif_fx(v0_, g0, refrac, g_in, force, m: Model, fx: dict):
    """Fixed point: ``g_in`` the integer sum of this step's weights."""
    active = refrac <= 0
    v, g = v0_.long(), g0.long()
    g = torch.where(active, wrap(g + (g_in.long() << fx["frac"])), g0).long()
    x = wrap(fx["v0"] - v + g).long()
    dv = wrap((x >> 2) * fx["alpha16"]).long() >> 14
    v = torch.where(active, wrap(v + dv), v.int())
    dg = wrap((g >> 2) * fx["gdecay16"]).long() >> 14
    g = torch.where(active, wrap(g - dg), g.int())
    spikes = active & (v > fx["v_th"])
    if force is not None:
        spikes = spikes | (active & force)
    v = torch.where(spikes, fx["v_r"], v).to(torch.int32)
    g = torch.where(spikes, 0, g).to(torch.int32)
    return v, g, _refrac(refrac, spikes, m), spikes


# --------------------------------------------------------------------------
# The run
# --------------------------------------------------------------------------

def _changed(new, old):
    """Entries whose bits changed (a float's sign of zero counts)."""
    if new.dtype == torch.float32:
        return new.view(torch.int32) != old.view(torch.int32)
    return new != old


def _check_drive(drive: list) -> None:
    for part in drive:
        if part["kind"] == "poisson":
            if part.get("target", "g") != "g":
                raise ValueError("the reference drives poisson parts onto g")
        elif part["kind"] != "background":
            raise ValueError(f"unknown drive part {part['kind']!r}")


def step_keys(seeds, t_steps: int, n_split: int) -> torch.Tensor:
    """``[T, B, n_split, 2]``: each step's split of each lane's key (on the
    CPU: the chain is sequential, and tiny)."""
    key = torch.stack([threefry.key(s) for s in seeds])
    out = torch.empty((t_steps, len(seeds), n_split, 2), dtype=torch.int64)
    for t in range(t_steps):
        ks = threefry.split(key, n_split)
        out[t] = ks
        key = ks[:, 0]
    return out


def simulate(net: dict, model: dict, drive: list, seeds, t_steps: int,
             device, *, record: bool = False, control: bool = False
             ) -> Result:
    """Run ``t_steps`` steps of every lane (one per seed) from rest."""
    m = Model.of(model)
    _check_drive(drive)
    device = torch.device(device)
    n, B = int(net["n"]), len(seeds)
    lo, hi = -(1 << (m.weight_bits - 1)), (1 << (m.weight_bits - 1)) - 1
    indptr = torch.as_tensor(np.asarray(net["out_indptr"], np.int64),
                             device=device)
    tgt = torch.as_tensor(np.asarray(net["out_indices"], np.int64),
                          device=device)
    w = torch.as_tensor(np.clip(net["out_weights"], lo, hi).astype(np.int32),
                        device=device)
    deg = indptr[1:] - indptr[:-1]

    n_split = 1 + max(2, len(drive))
    keys = step_keys(seeds, t_steps, n_split).to(device)
    poisson, background = [], []
    for i, part in enumerate(drive):
        prob = part["rate_hz"] * m.dt * 1e-3
        if part["kind"] == "poisson":
            idx = torch.as_tensor(pick(n, part["pick"], part["pick_seed"]),
                                  device=device)
            fires = threefry.bernoulli(keys[:, :, 1 + i], prob, len(idx))
            poisson.append((idx, fires, f32(part["weight"])))
        else:
            background.append((1 + i, prob))
    block = max(1, min(t_steps, BLOCK_ELEMENTS // max(1, B * n)))
    draws_per_step = B * (n_split + sum(len(p[0]) for p in poisson)
                          + n * len(background))

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
    D = m.delay_steps
    ring = torch.zeros((D, B, n), dtype=torch.bool, device=device)
    lane_base = torch.arange(B, device=device) * n
    per_step, syn_events = [], []
    forced = None

    for t in range(t_steps):
        if background and t % block == 0:
            span = min(block, t_steps - t)
            forced = None
            for k, prob in background:
                f = threefry.bernoulli(keys[t:t + span, :, k], prob, n)
                forced = f if forced is None else forced | f
        delayed = ring[t % D]
        lane, src = delayed.nonzero(as_tuple=True)
        summed = torch.zeros(B * n, dtype=torch.int32, device=device)
        cnt = deg[src]
        total = int(cnt.sum()) if len(src) else 0
        if total:
            first = torch.repeat_interleave(indptr[src] - (torch.cumsum(
                cnt, 0) - cnt), cnt)
            syn = first + torch.arange(total, device=device)
            summed.index_add_(0, torch.repeat_interleave(lane_base[lane], cnt)
                              + tgt[syn], w[syn])
        g_units = summed.view(B, n).to(torch.float32)
        for idx, fires, weight in poisson:
            stim = torch.zeros((B, n), dtype=torch.float32, device=device)
            stim[:, idx] = fires[t].to(torch.float32) * weight
            g_units = g_units + stim
        force = None if forced is None else forced[t % block]
        if m.fixed_point:
            nv, ng, nr, spikes = lif_fx(v, g, refrac,
                                        torch.round(g_units).to(torch.int32),
                                        force, m, fx)
        elif control:
            nv, ng, nr, spikes = lif_bf16(v, g, refrac, g_units, force, m)
        else:
            nv, ng, nr, spikes = lif_f32(v, g, refrac, g_units, force, m)
        if record:
            per_step.append(torch.stack([
                spikes.sum(), _changed(nv, v).sum(), _changed(ng, g).sum(),
                (nr != refrac).sum()]))
            syn_events.append(total)
        v, g, refrac = nv, ng, nr
        ring[t % D] = spikes
        counts += spikes.to(torch.int32)

    if control:     # the state in the configuration's units and type
        if m.fixed_point:
            v, g = wrap(v.long() << (12 - fx["frac"])), \
                wrap(g.long() << (12 - fx["frac"]))
        else:
            v, g = v.to(torch.float32), g.to(torch.float32)
    stats = None
    if record:
        cols = torch.stack(per_step).cpu().numpy().astype(np.int64)
        stats = {"spikes": cols[:, 0], "v_changed": cols[:, 1],
                 "g_changed": cols[:, 2], "refrac_changed": cols[:, 3],
                 "syn_events": np.asarray(syn_events, np.int64),
                 "draws": np.full(t_steps, draws_per_step, np.int64)}
    return Result(counts=counts, v=v, g=g, refrac=refrac,
                  dropped=torch.zeros(B, dtype=torch.int32, device=device),
                  stats=stats)
