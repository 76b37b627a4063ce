"""The least work a stretch of steps needs, and the least time it takes.

The count is the benchmark's own, made from what the inputs need and not
from what any implementation does (the program's own counter,
``launch/hlo.py::count``, counts its own ops and bytes, so a change that
moved fewer bytes would move that yardstick with it).  For each step the
plain reference reports how many lane-neurons changed each field of
their state, how many synapse events it delivered, how many spikes it
wrote and how many random draws it made; from those:

* bytes: every state field that changes is read once and written once at
  its least width (v 4 B, g 4 B, the refractory countdown 1 B; a field
  that does not change need not be touched); every synapse event reads
  one synapse at its least width, an 18-bit target id (2**17 < 139,255)
  and a 9-bit weight, 27 bits; every spike is written to and read from
  the delay ring as one bit;
* operations: every random draw is one threefry-2x32 block, 20 rounds of
  an add, a rotate and a xor plus six key injections, counted as 70; every
  synapse event one add; every changed v six and every changed g four.

The least time is the larger of bytes at the card's peak bandwidth and
operations at its peak rate (``PEAKS``, the H100 SXM data sheet; the
float32 rate, which counts a fused multiply-add as two, is taken as the
rate of any one operation, so the time is if anything too short).
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit (NVIDIA's data sheet).
PEAKS = {"hbm_bytes_per_s": 3.35e12, "ops_per_s": 66.9e12}

OPS_PER_DRAW = 70
OPS_PER_V = 6
OPS_PER_G = 4
BYTES_V, BYTES_G, BYTES_REFRAC = 4, 4, 1
BITS_PER_SYNAPSE = 27


def least_work(stats: dict, start: int, stop: int, scale: float = 1.0
               ) -> tuple[float, float]:
    """(bytes, operations) of steps ``start .. stop - 1``; ``scale`` the
    cell's lanes over the lanes the reference ran (a sample of like
    lanes, each from its own seed)."""
    s = {k: scale * np.asarray(v[start:stop], np.float64)
         for k, v in stats.items()}
    nbytes = (2 * (BYTES_V * s["v_changed"].sum()
                   + BYTES_G * s["g_changed"].sum()
                   + BYTES_REFRAC * s["refrac_changed"].sum())
              + BITS_PER_SYNAPSE / 8 * s["syn_events"].sum()
              + 2 / 8 * s["spikes"].sum())
    ops = (OPS_PER_DRAW * s["draws"].sum() + s["syn_events"].sum()
           + OPS_PER_V * s["v_changed"].sum()
           + OPS_PER_G * s["g_changed"].sum())
    return float(nbytes), float(ops)


def least_seconds(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time and which bound sets it."""
    t_mem = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = ops / PEAKS["ops_per_s"]
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")
