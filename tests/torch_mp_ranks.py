"""The rank program of tests/test_torch_multiprocess.py: one process a
partition of the port's multi-process path (``gloo`` on the CPU), spawned
four at a time with ``torch.multiprocessing``.  It imports only the port
(no JAX), and each rank writes what it returned to ``rank<r>.pt`` in the
work directory, for the test process to hold against the emulated runs
and the JAX package's.  The network is the one of the JAX package's
``tests/test_distributed.py::SHARD_MAP_SCRIPT``."""

import os
import shutil

import numpy as np
import torch

N, SYN, NET_SEED, P = 1_600, 48_000, 8, 4
T, SEED = 200, 3
SUGAR = np.arange(20)
VARIANTS = {"bitmap": ("bitmap", "csr"), "event": ("event", "csr"),
            "blocked": ("blocked", "csr"),
            "blocked_fused": ("blocked", "blocked_fused")}
PROBES = dict(raster=True, voltage=(0, 7, 401, 1599), pop_rate=True,
              drops=True)
T_TRIALS, TRIAL_SEEDS = 100, (3, 11)
CHUNK = 50                      # the kill comes after the second chunk
HEALTH_CAP = (4, 256)           # starved event capacities: drops
HEALTH_MAX_DROP_RATE = 40.0
HEALTH_BACKGROUND_HZ = 300.0
# partition 0 holds the driven neurons: its payloads carry spikes
FAULTY = dict(partition=0, drop_payload_at=tuple(range(30, 60)),
              fail_at=(70,))


def network():
    from repro_torch.core import build_dcsr, even_partition, synthetic_flywire
    c = synthetic_flywire(n=N, target_synapses=SYN, seed=NET_SEED)
    return build_dcsr(c, even_partition(c, P))


def dist_config(variant: str, **sim):
    from repro_torch.core import DistConfig, SimConfig
    scheme, engine = VARIANTS[variant]
    return DistConfig(sim=SimConfig(engine=engine, **sim), scheme=scheme)


def health_config():
    from repro_torch.core import CapacityConfig, DistConfig, SimConfig
    from repro_torch.core.health import HealthConfig
    sim = SimConfig(engine="csr", background_rate_hz=HEALTH_BACKGROUND_HZ,
                    health=HealthConfig(max_drop_rate=HEALTH_MAX_DROP_RATE))
    return DistConfig(sim=sim, scheme="event",
                      capacity=CapacityConfig(*HEALTH_CAP))


def faulty_config():
    from repro_torch.core import DistConfig, SimConfig
    from repro_torch.core.exchange import FaultSpec, configure_faulty
    configure_faulty(inner="event", spec=FaultSpec(**FAULTY))
    return DistConfig(sim=SimConfig(engine="csr"), scheme="faulty")


def as_dict(r) -> dict:
    """A DistResult / DistTrialResult as plain tensors (on the CPU)."""
    out = {"counts": r.counts, "dropped": torch.as_tensor(r.dropped),
           "v": r.state.v, "g": r.state.g, "refrac": r.state.refrac}
    out.update({f"rec_{k}": v for k, v in r.records.items()})
    out.update({f"stat_{k}": torch.as_tensor(v) for k, v in r.stats.items()
                if not isinstance(v, dict)})
    return {k: v.cpu() for k, v in out.items()}


def supervised_runs(d, run, work: str, rank: int, mesh) -> dict:
    """The chunked cases, each driven by ``run(cfg, t_steps, **kw)``."""
    from repro_torch.core import SimulationHealthError
    from repro_torch.core.exchange import ExchangeFault, configure_faulty
    out = {}
    fused = dist_config("blocked_fused")
    kill = os.path.join(work, "ck_mp")
    run(fused, 2 * CHUNK, chunk_steps=CHUNK, checkpoint_dir=kill)
    if rank == 0:       # the kill's checkpoints, for an emulated resume
        shutil.copytree(kill, os.path.join(work, "ck_mp_killed"))
    mesh.barrier()
    out["resumed"] = run(fused, T, chunk_steps=CHUNK, checkpoint_dir=kill,
                         resume=True)
    out["from_emulated"] = run(fused, T, chunk_steps=CHUNK, resume=True,
                               checkpoint_dir=os.path.join(work, "ck_emu"))
    try:
        run(health_config(), T, chunk_steps=CHUNK // 5)
        out["health"] = None
    except SimulationHealthError as e:
        out["health"] = (e.kind, e.step, float(e.value))
    cfg = faulty_config()
    ck = os.path.join(work, "ck_faulty")
    try:
        run(cfg, T, chunk_steps=CHUNK, checkpoint_dir=ck)
        out["fault"] = None
    except ExchangeFault as e:
        out["fault"] = str(e)
    out["faulty"] = run(cfg, T, chunk_steps=CHUNK, checkpoint_dir=ck,
                        resume=True)
    configure_faulty()
    return out


def run_rank(rank: int, world: int, work: str) -> None:
    import torch.distributed as dist
    from repro_torch.core import simulate_distributed
    from repro_torch.core.distributed import make_core_mesh
    from repro_torch.exp import ProbeSpec, run_dist_trials
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/init",
                            rank=rank, world_size=world)
    mesh = make_core_mesh(world, ["cpu"] * world, backend="gloo")
    d = network()
    out = {"device": str(mesh.device), "rank": mesh.rank}

    def run(cfg, t_steps, seed=SEED, probes=PROBES, **kw):
        return as_dict(simulate_distributed(
            d, cfg, t_steps, SUGAR, seed=seed, probes=ProbeSpec(**probes),
            emulate=False, mesh=mesh, **kw))

    for name in VARIANTS:
        out[name] = run(dist_config(name), T)
    cfg = dist_config("event")
    out["trials"] = as_dict(run_dist_trials(
        d, cfg, T_TRIALS, SUGAR, seeds=list(TRIAL_SEEDS), mesh=mesh,
        probes=ProbeSpec(raster=True)))
    for s in TRIAL_SEEDS:
        out[f"seed{s}"] = run(cfg, T_TRIALS, seed=s,
                              probes=dict(raster=True))
    out.update(supervised_runs(d, run, work, rank, mesh))
    # a mesh of another backend than the group's is refused
    try:
        make_core_mesh(world, ["cpu"] * world, backend="nccl")
        out["nccl_refused"] = False
    except ValueError:
        out["nccl_refused"] = True
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()
