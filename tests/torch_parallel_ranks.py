"""The rank program of tests/test_torch_parallel.py and
tests/test_torch_train_sharded.py: one process a rank of the port's meshes
(``gloo`` on the CPU), spawned with ``torch.multiprocessing``.  It imports
only the port (no JAX).  Each rank writes what it computed to
``rank<r>.pt`` in the work directory for the test process to hold against
the JAX package and the port's one-process forms.

Jobs: "parallel", four ranks: ``compressed_psum`` on a (pod 2, data 2)
mesh, the GPipe schedule over a 4-stage mesh (a tanh layer and a phi3
SMOKE block a stage) and the shard / gather round trip on a (data 2,
model 2) mesh; "train4", four ranks: 5 sharded train steps on a (data 2,
model 2) mesh; "train2", two ranks: 5 sharded train steps on a (data 1,
model 2) mesh, plain, with 2 microbatches and with int8 compression."""

import os

import numpy as np
import torch

PSUM_SHAPE = (8, 96)
PSUM_CASES = {"data_then_pod": "data", "pod_only": None, "zeros": "data"}
S, M, D_TANH = 4, 6, 16
TANH_MB = (M, 8, D_TANH)
BLOCK_ARCH, BLOCK_SEQ = "phi3-medium-14b", 16
TRAIN_ARCH, STEPS, SEQ, BATCH, LR, WARMUP = "qwen2.5-14b", 5, 32, 8, 1e-3, 2
TRAIN_VARIANTS = {"plain": {}, "microbatched": {"microbatches": 2},
                  "compressed": {"compress_grads": True}}


def psum_input(case: str, rank: int) -> np.ndarray:
    if case == "zeros":
        return np.zeros(PSUM_SHAPE, np.float32)
    rng = np.random.default_rng(100 + rank)
    return (rng.normal(0, 1, PSUM_SHAPE) * (1 + rank)).astype(np.float32)


def tanh_inputs():
    rng = np.random.default_rng(0)
    ws = rng.normal(0, 0.3, (S, D_TANH, D_TANH)).astype(np.float32)
    xs = rng.normal(0, 1, TANH_MB).astype(np.float32)
    return torch.from_numpy(ws), torch.from_numpy(xs)


def tanh_stage(w, x):
    return torch.tanh(x @ w)


def block_stages():
    """Four phi3 SMOKE blocks (one a stage), microbatches [M, 1, 16, d]."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(BLOCK_ARCH, smoke=True), n_layers=S)
    params = init_params(7, cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    xs = torch.randn((M, 1, BLOCK_SEQ, cfg.d_model), generator=gen)
    return cfg, list(params.stack), xs


def block_stage_fn(cfg):
    from repro_torch.models import transformer as tf

    def fn(blk, x):
        return tf.block_apply(blk, x, cfg)[0]
    return fn


def train_setup(cfg, work: str):
    """The test process's weights (``weights.pt``) in a module of the
    port, and the optimizer of the run."""
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW, cosine_schedule
    params = init_params(0, cfg, "cpu")
    want = torch.load(os.path.join(work, "weights.pt"))
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(want[k])
    return params, AdamW(lr=cosine_schedule(LR, WARMUP, STEPS))


def sharded_run(cfg, work: str, mesh, microbatches=1, compress_grads=False):
    """5 sharded steps; the losses, this rank's shards and the gathered
    state, and each leaf's replicas along the mesh axes its spec does
    not use (they must hold the same bits)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.train import (init_train_state, make_train_step,
                                   unshard_train_state)
    params, opt = train_setup(cfg, work)
    state = init_train_state(params, opt, compress=compress_grads, mesh=mesh)
    step = make_train_step(cfg, opt, microbatches=microbatches,
                           compress_grads=compress_grads, mesh=mesh)
    ds = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH, seed=0)
    losses, gnorms = [], []
    for i in range(STEPS):
        state, m = step(state, ds.batch_at(i, "cpu"))
        losses.append(m["loss"].clone())
        gnorms.append(m["grad_norm"].clone())
    sp = state.params
    whole = unshard_train_state(state)
    replicas_equal = {}
    for k, s in sp.shards.items():
        used = {a for e in sp.specs[k] if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        free = tuple(a for a in mesh.axis_names if a not in used)
        if free and mesh.axis_size(free) > 1:
            got = mesh.all_gather(s, free)
            replicas_equal[k] = all(torch.equal(got[0], g) for g in got)
    return {"losses": torch.stack(losses), "gnorms": torch.stack(gnorms),
            "shards": {k: v.clone() for k, v in sp.shards.items()},
            "m": dict(state.opt.m), "v": dict(state.opt.v),
            "specs": {k: tuple(v) for k, v in sp.specs.items()},
            "params": {k: p.detach().clone()
                       for k, p in whole.params.named_parameters()},
            "whole_m": whole.opt.m, "whole_v": whole.opt.v,
            "residual": state.residual, "replicas_equal": replicas_equal,
            "released": all(p.numel() == 0
                            for p in sp.module.parameters())}


def job_parallel(rank: int, work: str) -> dict:
    from repro_torch.launch.mesh import join, make_host_mesh, mesh_layout
    from repro_torch.optim import compressed_psum
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import Spec, gather, shard_of
    out = {}
    pd = join(mesh_layout((2, 2), ("pod", "data")), devices=["cpu"] * 4)
    out["coords"] = {a: int(c) for a, c in pd.coords.items()}
    out["psum"] = {case: compressed_psum(
        torch.from_numpy(psum_input(case, rank)), pd, pod_axis="pod",
        data_axis=ax) for case, ax in PSUM_CASES.items()}

    stages = join(mesh_layout((S,), ("stage",)), devices=["cpu"] * 4)
    ws, xs = tanh_inputs()
    out["pipe_tanh"] = pipeline_apply(tanh_stage, ws, xs, stages, S)
    cfg, blocks, bxs = block_stages()
    local = [b if i == stages.coords["stage"] else None
             for i, b in enumerate(blocks)]
    with torch.no_grad():
        out["pipe_block"] = pipeline_apply(block_stage_fn(cfg), local, bxs,
                                           stages, S)

    mesh = make_host_mesh(data=2, model=2, devices=["cpu"] * 4)
    out["mesh_coords"] = {a: int(c) for a, c in mesh.coords.items()}
    gen = torch.Generator().manual_seed(11)
    full = torch.randn((8, 12, 6), generator=gen)
    trips = {}
    for spec in [(("data", "model"), None, None), ("model", "data"),
                 (None, "data", "model"), ("data",), ()]:
        sp = Spec(*spec)
        mine = shard_of(full, sp, mesh)
        trips[repr(sp)] = (mine, torch.equal(gather(mine, sp, mesh), full))
    out["trips"] = trips
    return out


def job_train4(rank: int, work: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=2, model=2, devices=["cpu"] * 4)
    cfg = get_config(TRAIN_ARCH, smoke=True)
    return {"train_2x2": sharded_run(cfg, work, mesh),
            "coords": {a: int(c) for a, c in mesh.coords.items()}}


def job_train2(rank: int, work: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=1, model=2, devices=["cpu"] * 2)
    cfg = get_config(TRAIN_ARCH, smoke=True)
    return {"train_1x2": {name: sharded_run(cfg, work, mesh, **kw)
                          for name, kw in TRAIN_VARIANTS.items()},
            "coords": {a: int(c) for a, c in mesh.coords.items()}}


JOBS = {"parallel": (4, job_parallel), "train4": (4, job_train4),
        "train2": (2, job_train2)}


def run_rank(rank: int, job: str, work: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    world, fn = JOBS[job]
    dist.init_process_group("gloo", init_method=f"file://{work}/init",
                            rank=rank, world_size=world)
    out = fn(rank, work)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
