"""FlyWire dry run: the paper's workload cut into 256 or 512 partitions,
one a rank, with one rank's delay window counted.

Counterpart of ``repro/launch/flywire_dryrun.py``::

    PYTHONPATH=src python -m repro_torch.launch.flywire_dryrun \
        [--cores 256|512] [--scale bench|full] [--scheme event|bitmap]

Pipeline, the reference's: synthetic FlyWire graph -> greedy SAR
capacity partitioning -> padding to the core count -> SNN-dCSR (9-bit
weights).  Then rank 0's partition runs one delay window (``--steps``,
18 steps of 0.1 ms) through the port's partitioned step
(:func:`repro_torch.core.distributed._run_parts`) under
:func:`repro_torch.launch.hlo.count`, on ``meta`` stand-ins of its
synaptic arrays, stimulus and carry, with a counting ``gather`` in place
of the process group's.  The step has fixed shapes and reads nothing
back, so the values cannot move the count.

Prints and records the rank's resident bytes and peak, its FLOPs, bytes,
launches and link bytes for the window, and the window's terms on one
H100 (:data:`repro_torch.launch.roofline.H100`, ``nccl`` ranks), with
the modelled wall time of a window against the 1.8 ms it simulates.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import torch

from repro_torch.configs.flywire import CONFIG, SMOKE
from repro_torch.core import (build_dcsr, greedy_partition, pad_to_uniform,
                              synthetic_flywire_cached)
from repro_torch.core.capacity import CapacityConfig
from repro_torch.core.compress import CoreBudget
from repro_torch.core.distributed import (AXIS, DistConfig,
                                          _init_dist_carry, _run_parts,
                                          _resolve_dist_probes,
                                          _resolve_dist_stimulus)
from repro_torch.core.exchange import Topology, all_gather_group, get_scheme
from repro_torch.core.exchange.arrays import DistArrays
from repro_torch.core.partition import caps_from_budget
from repro_torch.launch import hlo
from repro_torch.launch.mesh import mesh_layout
from repro_torch.launch.roofline import H100
from repro_torch import random as prng
from repro_torch.tree import map_tensors


def partition(c, cores: int):
    """The reference's partitioning of ``c`` for ``cores`` ranks.  The
    budget is the reference's partitioning parameter (a TPU core's
    VMEM), kept so the partition is the reference's; it is not a
    property of the card."""
    p = greedy_partition(c, caps_from_budget(CoreBudget.tpu_vmem(), "sar"),
                         scheme="sar")
    p = pad_to_uniform(p, cores, c.n)
    return build_dcsr(c, p, quantize_bits=9)


def abstract_dist_arrays(d) -> DistArrays:
    """Meta stand-ins for one partition's :class:`DistArrays` (no host
    regrouping of the event scheme's structures)."""
    U, S, n_glob = d.part_size, d.s_max, d.n_parts * d.part_size

    def sd(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    i32, f32 = torch.int32, torch.float32
    return DistArrays(
        syn_src=sd((S,), i32), syn_tgt=sd((S,), i32), syn_w=sd((S,), f32),
        out_indptr=sd((n_glob + 1,), i32), out_tgt=sd((S,), i32),
        out_w=sd((S,), f32), pad_mask=sd((U,), torch.bool),
        src_gfo=sd((U,), i32))


def count_window(d, sim, scheme_name: str, steps: int, capacity, *,
                 device="meta", seed: int = 0, stimulus=None):
    """One delay window of rank 0's partition, counted: (the
    :class:`~repro_torch.launch.hlo.StepCost`, the rank's resident
    bytes).  On ``meta`` the synaptic arrays are stand-ins; on another
    device the scheme's real arrays of the partition are built there.
    ``stimulus`` (default: the legacy masked sugar drive of ``sim``) is
    sharded onto the partitioning as the run shards it."""
    cfg = DistConfig(sim=sim, scheme=scheme_name, capacity=capacity)
    scheme = get_scheme(scheme_name)
    P_, U, part = d.n_parts, d.part_size, 0
    if torch.device(device).type == "meta":
        state = abstract_dist_arrays(d)
    else:
        state = map_tensors(lambda a: a[0], scheme.build(
            d, sim, cfg.capacity, device, parts=[part]))
    stim = _resolve_dist_stimulus(d, sim, None, stimulus).to(device)
    probes, _, _ = _resolve_dist_probes(d, sim, None)
    keys = prng.split(prng.PRNGKey(seed, device=device), P_)[:, None]
    carry = _init_dist_carry(d, cfg, stim, scheme, keys, device,
                             parts=[part])
    stim = map_tensors(lambda a: a[part], stim)
    pad = torch.from_numpy(
        d.inv_perm[part * U:(part + 1) * U] >= 0).to(device)
    topo = Topology(P_, U, axis=AXIS, index=part)
    mesh = hlo.CountingMesh(mesh_layout((P_,), (AXIS,)), rank=part,
                            device=device)
    resident = (state, carry, stim, pad)
    with hlo.count(device, resident=resident) as c:
        resident_bytes = c.live
        _run_parts(scheme, [state], carry, [stim], [pad], [None], cfg,
                   probes, steps, [topo], True, 0,
                   functools.partial(all_gather_group, mesh=mesh))
    return c.cost, resident_bytes


def window_terms(cost, steps: int, dt_ms: float, peaks=H100,
                 backend: str = "nccl") -> dict:
    """The window's roofline terms on ``peaks`` (float32 compute: the
    simulator's state is float32 or int32) and the modelled wall time of
    a window against the time it simulates."""
    comp = cost.flops / peaks["flops"]["float32"]
    memt = cost.bytes / peaks["hbm_bw"]
    coll = cost.link_bytes / peaks["link_bw"][backend]
    bound = max(comp, memt, coll)
    sim_ms = steps * dt_ms
    return {"compute_s": comp, "memory_s": memt, "collective_s": coll,
            "bound_s": bound, "simulated_ms": sim_ms,
            "realtime_factor": sim_ms / 1e3 / bound if bound else None}


def run(c, cores: int, scheme: str, steps: int, capacity: int, budget: int,
        sim, scale: str = "full", out_dir: str = "") -> dict:
    """Partition ``c`` for ``cores`` ranks, count rank 0's window, print
    the report and return (and, with ``out_dir``, write) the record."""
    t0 = time.time()
    d = partition(c, cores)
    print(f"[flywire-dryrun] graph {c.n}n/{c.nnz}syn -> {d.n_parts} "
          f"cores, U={d.part_size}, S_max={d.s_max} "
          f"(prep {time.time() - t0:.0f}s)", flush=True)
    t1 = time.time()
    cost, resident = count_window(
        d, sim, scheme, steps,
        CapacityConfig(spike_capacity=capacity, syn_budget=budget))
    terms = window_terms(cost, steps, sim.params.dt)
    rec = {
        "arch": "flywire-snn", "cell": f"{scale}_{scheme}",
        "mesh": f"cores{cores}", "n_devices": cores,
        "kind": "simulate", "steps_per_window": steps,
        "count_s": round(time.time() - t1, 1),
        "memory": {"resident_bytes": resident,
                   "peak_device_bytes": cost.peak_bytes},
        "cost": {"flops_per_device": cost.flops,
                 "bytes_per_device": cost.bytes,
                 "launches": cost.launches},
        "collectives": cost.summary(),
        "terms": terms,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(
                out_dir, f"flywire_{scale}_{scheme}_c{cores}_k{capacity}"
                f".json"), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"[flywire-dryrun] count {rec['count_s']}s  resident/rank "
          f"{resident / 2**20:.1f} MiB  peak/rank "
          f"{cost.peak_bytes / 2**20:.1f} MiB  {cost.launches / steps:.0f} "
          f"launches a step  window terms: compute "
          f"{terms['compute_s'] * 1e6:.1f}us  memory "
          f"{terms['memory_s'] * 1e6:.1f}us  collective "
          f"{terms['collective_s'] * 1e6:.1f}us  counts {cost.coll_count}",
          flush=True)
    print(f"[flywire-dryrun] modelled wall/window "
          f"{terms['bound_s'] * 1e3:.3f} ms vs simulated "
          f"{terms['simulated_ms']:.1f} ms -> "
          f"{terms['realtime_factor']:.0f}x faster than realtime (model, "
          f"{H100['name']})", flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cores", type=int, default=256)
    ap.add_argument("--scale", choices=["bench", "full"], default="full")
    ap.add_argument("--scheme", choices=["event", "bitmap"], default="event")
    ap.add_argument("--steps", type=int, default=18,
                    help="steps of the counted window (one 1.8 ms delay)")
    ap.add_argument("--capacity", type=int, default=256,
                    help="event capacity K a core a step (provisioned "
                         "activity: the Loihi 'cost ~ spikes' lever)")
    ap.add_argument("--budget", type=int, default=65536,
                    help="synapse delivery budget a core a step")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    fw = CONFIG if args.scale == "full" else SMOKE
    n, syn = ((fw.n_neurons, fw.target_synapses) if args.scale == "full"
              else (20_000, 600_000))
    c = synthetic_flywire_cached(n=n, seed=0, target_synapses=syn)
    return run(c, args.cores, args.scheme, args.steps, args.capacity,
               args.budget, fw.sim, args.scale, args.out)


if __name__ == "__main__":
    main()


__all__ = ["abstract_dist_arrays", "count_window", "main", "partition",
           "run", "window_terms"]
