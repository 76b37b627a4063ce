"""The port's sharded train step (``make_train_step(..., mesh=)``) and the
training CLI's mesh path, on ``gloo`` CPU ranks.

The parity targets are the reference's per-device arithmetic (its
sharding specs and shard layout, tests/test_torch_parallel.py) and its
unsharded train step: its own CLI's mesh path fails where the mesh
builds (its optimizer-state shardings hold ``None`` for the step), and
GSPMD keeps the unsharded step's semantics.

* (data 1, model 2), two ranks (tests/torch_parallel_ranks.py, job
  "train2"), 5 AdamW steps of the qwen2.5 SMOKE config on the
  reference's weights, plain, with 2 microbatches and with int8
  compression: losses, grad norms, every rank's shards of the parameters
  and both moments bitwise the slices of the port's unsharded run
  (tolerance 0), the gathered state bitwise the whole.
* (data 2, model 2), four ranks (job "train4"): the 5-step losses within
  rtol 2e-6 of the reference's unsharded jitted step
  (tests/test_torch_train.py's trajectory tolerance; measured on this
  CPU 2.3e-7) and the parameters within atol 1e-4 of its (measured
  3.3e-5: AdamW's normalized step turns a gradient entry near zero that
  sums in another order into an update up to lr apart; the port's
  unsharded run is itself 3.2e-5 from the reference's); against the
  port's unsharded run, losses within rtol 1e-6 and parameters within
  atol 5e-6 (measured 1.5e-7 and 1.6e-6: only the data axis's
  summation order differs).
* On both meshes every replicated block is bitwise equal across the
  ranks that hold it, and a rank holds no full parameter between steps.
* ``python -m repro_torch.launch.train --smoke --data 2 --model 1``
  under ``torchrun`` (2 ranks, ``--device cpu``), with a checkpoint
  every 3 steps and a failure injected at step 4: rank 0 alone prints
  the ``[train]`` lines, which equal the unsharded run's at their printed
  precision (one unit of the last digit), the run recovers from the
  mesh's checkpoint, written in the unsharded layout, and an unsharded
  run resumes from it.
* A ``torchrun`` of 2 ranks for a (2, 2) mesh is refused on every rank
  (``MeshSizeError``) before any step or checkpoint; in one process the
  CLI runs unsharded, and every other error of the mesh propagates.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as R
from repro.configs import get_config as ref_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import init_params as ref_init
from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import init_train_state as ref_init_state
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh as M
from repro_torch.launch import train as cli
from repro_torch.models import init_params
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel.sharding import shard_index
from repro_torch.train import (init_train_state, make_train_step,
                               read_checkpoint_arrays, restore_checkpoint,
                               shard_train_state, unshard_train_state)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CLI_FLAGS = ["--arch", R.TRAIN_ARCH, "--smoke", "--steps", "6", "--batch",
             "4", "--seq", "16", "--warmup", "2", "--log-every", "1",
             "--device", "cpu"]


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def port_run(cfg, weights, microbatches=1, compress_grads=False):
    """The port's unsharded run of the ranks' 5 steps."""
    params = init_params(0, cfg, "cpu")
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(weights[k])
    opt = AdamW(lr=cosine_schedule(R.LR, R.WARMUP, R.STEPS))
    state = init_train_state(params, opt, compress=compress_grads)
    step = make_train_step(cfg, opt, microbatches=microbatches,
                           compress_grads=compress_grads)
    ds = SyntheticLM(vocab=cfg.vocab, seq=R.SEQ, global_batch=R.BATCH,
                     seed=0)
    losses, gnorms = [], []
    for i in range(R.STEPS):
        state, m = step(state, ds.batch_at(i, "cpu"))
        losses.append(m["loss"].clone())
        gnorms.append(m["grad_norm"].clone())
    return {"losses": torch.stack(losses), "gnorms": torch.stack(gnorms),
            "params": {k: p.detach() for k, p in
                       state.params.named_parameters()},
            "m": state.opt.m, "v": state.opt.v, "residual": state.residual}


def ref_run(rc, rp):
    """The reference's unsharded jitted step, 5 steps."""
    opt = RefAdamW(lr=ref_cosine(R.LR, R.WARMUP, R.STEPS))
    state = ref_init_state(rp, opt)
    step = jax.jit(ref_make_train_step(rc, opt))
    ds = RefSyntheticLM(vocab=rc.vocab, seq=R.SEQ, global_batch=R.BATCH,
                        seed=0)
    losses = []
    for i in range(R.STEPS):
        state, m = step(state, ds.batch_at(i))
        losses.append(float(m["loss"]))
    return np.asarray(losses, np.float64), state.params


def _spawn(job, work):
    world = R.JOBS[job][0]
    os.makedirs(work, exist_ok=True)
    return mp.start_processes(R.run_rank, args=(job, str(work)),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, work, world):
    while not ctx.join(timeout=300):
        pass
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _torchrun(args, work):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args],
        cwd=str(work), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn both rank jobs and the torchrun CLI once; meanwhile run the
    reference and the port unsharded (on one torch thread, as the
    ranks)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _runs(tmp_path_factory.mktemp("sharded"))
    finally:
        torch.set_num_threads(old)


def _runs(work):
    rc = ref_config(R.TRAIN_ARCH, smoke=True)
    pc = get_config(R.TRAIN_ARCH, smoke=True)
    rp = jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(0), rc))
    weights = {k: p.detach().clone() for k, p in
               convert.lm_params_from_jax(rp, pc, "cpu").named_parameters()}
    for job in ("train2", "train4"):
        os.makedirs(work / job)
        torch.save(weights, work / job / "weights.pt")
    ctx2 = _spawn("train2", work / "train2")
    ctx4 = _spawn("train4", work / "train4")
    ckpt = work / "cli_ck"
    proc = _torchrun(CLI_FLAGS + ["--data", "2", "--model", "1",
                                  "--ckpt-dir", str(ckpt), "--ckpt-every",
                                  "3", "--fail-at", "4"], work)
    wrong_ckpt = work / "wrong_ck"
    wrong = _torchrun(CLI_FLAGS + ["--data", "2", "--model", "2",
                                   "--ckpt-dir", str(wrong_ckpt),
                                   "--ckpt-every", "1"], work)
    port = {name: port_run(pc, weights, **kw)
            for name, kw in R.TRAIN_VARIANTS.items()}
    ref_losses, ref_params = ref_run(rc, rp)
    two = _join(ctx2, work / "train2", 2)
    four = _join(ctx4, work / "train4", 4)
    out, err = proc.communicate(timeout=600)
    w_out, w_err = wrong.communicate(timeout=600)
    return dict(cfg=pc, port=port, ref_losses=ref_losses,
                ref_params=ref_params, two=two, four=four,
                cli=(proc.returncode, out, err), ckpt=str(ckpt),
                wrong=(wrong.returncode, w_out, w_err, str(wrong_ckpt)))


def _mesh(ranks):
    names = tuple(ranks[0]["coords"])
    shape = tuple(max(r["coords"][a] for r in ranks) + 1 for a in names)
    return M.mesh_layout(shape, names)


def _slice(full, spec, mesh, coords):
    return full[shard_index(full.shape, spec, mesh, coords)]


@pytest.mark.parametrize("variant", list(R.TRAIN_VARIANTS))
def test_1x2_losses_bitwise_unsharded(runs, variant):
    want = runs["port"][variant]
    for rank in runs["two"]:
        got = rank["train_1x2"][variant]
        assert torch.equal(got["losses"], want["losses"])
        assert torch.equal(got["gnorms"], want["gnorms"])


@pytest.mark.parametrize("variant", list(R.TRAIN_VARIANTS))
def test_1x2_shards_bitwise_slices_of_unsharded(runs, variant):
    """Every rank's shard of every parameter, both moments and the
    residual is bitwise the slice of the unsharded run's."""
    want = runs["port"][variant]
    mesh = _mesh(runs["two"])
    sharded = 0
    for rank in runs["two"]:
        got = rank["train_1x2"][variant]
        c = rank["coords"]
        for k, spec in got["specs"].items():
            for part, full in (("shards", want["params"]), ("m", want["m"]),
                               ("v", want["v"])):
                assert torch.equal(got[part][k],
                                   _slice(full[k], spec, mesh, c)), (part, k)
            if want["residual"] is not None:
                assert torch.equal(got["residual"][k], _slice(
                    want["residual"][k], spec, mesh, c)), k
            sharded += got["shards"][k].numel() < want["params"][k].numel()
    assert sharded > 0


@pytest.mark.parametrize("variant", list(R.TRAIN_VARIANTS))
def test_1x2_gathered_state_bitwise_whole(runs, variant):
    want = runs["port"][variant]
    for rank in runs["two"]:
        got = rank["train_1x2"][variant]
        assert got["released"]
        assert all(got["replicas_equal"].values())
        for k in want["params"]:
            assert torch.equal(got["params"][k], want["params"][k]), k
            assert torch.equal(got["whole_m"][k], want["m"][k]), k
            assert torch.equal(got["whole_v"][k], want["v"][k]), k


def test_2x2_losses_match_reference(runs):
    for rank in runs["four"]:
        got = rank["train_2x2"]["losses"].double().numpy()
        np.testing.assert_allclose(got, runs["ref_losses"], rtol=2e-6)
    want = runs["port"]["plain"]["losses"].double().numpy()
    np.testing.assert_allclose(
        runs["four"][0]["train_2x2"]["losses"].double().numpy(), want,
        rtol=1e-6)


def test_2x2_parameters_match_reference(runs):
    got = runs["four"][0]["train_2x2"]["params"]
    ref = convert.lm_tree_to_jax_layout(got, runs["cfg"])
    flat_r = jax.tree.leaves(jax.tree.map(np.asarray, runs["ref_params"]))
    flat_g = jax.tree.leaves(ref)
    assert len(flat_r) == len(flat_g)
    for a, b in zip(flat_r, flat_g):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
    port = runs["port"]["plain"]["params"]
    for k, p in port.items():
        np.testing.assert_allclose(got[k].numpy(), p.numpy(), atol=5e-6,
                                   rtol=0)


def test_2x2_ranks_agree(runs):
    """The gathered state is the same on every rank; each rank's shards
    are its slices of it; replicated blocks are bitwise equal across the
    ranks that hold them; no full parameter is held between steps."""
    ranks = runs["four"]
    mesh = _mesh(ranks)
    first = ranks[0]["train_2x2"]
    for rank in ranks:
        got = rank["train_2x2"]
        assert got["released"] and all(got["replicas_equal"].values())
        assert got["replicas_equal"]
        assert torch.equal(got["losses"], first["losses"])
        for k, spec in got["specs"].items():
            assert torch.equal(got["params"][k], first["params"][k])
            assert torch.equal(got["shards"][k], _slice(
                got["params"][k], spec, mesh, rank["coords"]))
            assert torch.equal(got["m"][k], _slice(
                got["whole_m"][k], spec, mesh, rank["coords"]))


def _train_lines(text):
    return [line for line in text.splitlines() if line.startswith("[train]")]


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def test_cli_under_torchrun_prints_the_unsharded_lines(runs, capsys,
                                                       tmp_path):
    code, out, err = runs["cli"]
    assert code == 0, err[-3000:]
    lines = _train_lines(out)
    # rank 0 alone prints; both ranks say where their tensors are
    assert len(re.findall(r"\[mesh\] rank \d of 2 at \{[^}]*\} on cpu "
                          r"\(gloo\)", out)) == 2
    assert "[train] resumed from step 3" in lines
    assert lines[-1] == "[train] done at step 6"
    cli.main(CLI_FLAGS + ["--ckpt-dir", str(tmp_path / "ck"),
                          "--ckpt-every", "3", "--fail-at", "4"])
    want = _train_lines(capsys.readouterr().out)
    assert [re.sub(r"[-\d.]+", "#", x) for x in lines] == [
        re.sub(r"[-\d.]+", "#", x) for x in want]
    for a, b in zip(lines, want):
        for x, y in zip(_numbers(a), _numbers(b)):
            assert abs(x - y) <= 1.5e-3, (a, b)


def test_cli_checkpoint_is_the_unsharded_layout(runs, capsys):
    """The mesh's checkpoint restores into an unsharded state (the
    elastic restore), which shards onto a one-rank mesh and back; an
    unsharded run resumes from it and finishes."""
    cfg = get_config(R.TRAIN_ARCH, smoke=True)
    opt = AdamW(lr=cosine_schedule(1e-3, 2, 6))
    template = init_train_state(init_params(5, cfg, "cpu"), opt)
    state, meta = restore_checkpoint(runs["ckpt"], 6, template)
    assert meta["arch"] == R.TRAIN_ARCH and int(state.opt.step) == 6
    assert read_checkpoint_arrays(runs["ckpt"], 6)[1]["loss"] == meta["loss"]
    whole = {k: p.detach().clone() for k, p in
             state.params.named_parameters()}
    one = M.make_host_mesh(data=1, model=1, devices=["cpu"])
    back = unshard_train_state(shard_train_state(state, one))
    for k, p in back.params.named_parameters():
        assert torch.equal(p, whole[k])
    cli.main(CLI_FLAGS + ["--steps", "8", "--ckpt-dir", runs["ckpt"],
                          "--resume"])
    lines = _train_lines(capsys.readouterr().out)
    assert lines[0] == "[train] resumed from step 6"
    assert lines[-1] == "[train] done at step 8"


def test_one_rank_mesh_step_is_the_unsharded_step():
    """On a 1 x 1 mesh (no process group) the sharded step is bitwise the
    unsharded one, with 2 microbatches and int8 compression."""
    cfg = get_config(R.TRAIN_ARCH, smoke=True)
    mesh = M.make_host_mesh(data=1, model=1, devices=["cpu"])
    ds = SyntheticLM(vocab=cfg.vocab, seq=16, global_batch=4, seed=1)
    out = []
    for m in (None, mesh):
        opt = AdamW(lr=cosine_schedule(1e-3, 1, 3))
        state = init_train_state(init_params(2, cfg, "cpu"), opt,
                                 compress=True, mesh=m)
        step = make_train_step(cfg, opt, microbatches=2, compress_grads=True,
                               mesh=m)
        losses = []
        for i in range(3):
            state, metrics = step(state, ds.batch_at(i, "cpu"))
            losses.append(metrics["loss"])
        if m is not None:
            module = state.params.module
            assert all(p.numel() == 0 for p in module.parameters())
            state = unshard_train_state(state)
        out.append((torch.stack(losses), dict(state.params.named_parameters()),
                    state.opt.m, state.residual))
    (l0, p0, m0, r0), (l1, p1, m1, r1) = out
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]) and torch.equal(m0[k], m1[k])
        assert torch.equal(r0[k], r1[k])


def test_cli_refuses_a_torchrun_of_another_size(runs):
    """2 ranks for --data 2 --model 2: each rank raises MeshSizeError, no
    rank trains, prints a [train] line or writes a checkpoint."""
    code, out, err, ckpt = runs["wrong"]
    assert code != 0
    assert "MeshSizeError: need 4 ranks" in err, err[-3000:]
    assert not _train_lines(out)
    assert not os.path.exists(ckpt) or not os.listdir(ckpt)


def test_host_mesh_passes_other_errors_on(monkeypatch):
    """host_mesh turns only a too-small world of one process into an
    unsharded run: a world of several ranks, and any other error of the
    mesh (a process group of another backend), propagate."""
    args = cli.parser().parse_args(CLI_FLAGS + ["--data", "2"])

    def raising(err):
        def make(**_kw):
            raise err
        return make
    monkeypatch.setattr(cli, "make_host_mesh",
                        raising(M.MeshSizeError(2, 1, {"data": 2})))
    assert cli.host_mesh(args) is None
    monkeypatch.setattr(cli, "make_host_mesh",
                        raising(M.MeshSizeError(2, 4, {"data": 2})))
    with pytest.raises(M.MeshSizeError, match="have 4"):
        cli.host_mesh(args)
    monkeypatch.setattr(cli, "make_host_mesh", raising(ValueError(
        "the process group runs 'nccl', not 'gloo'")))
    with pytest.raises(ValueError, match="process group runs"):
        cli.host_mesh(args)


def test_cli_without_the_ranks_runs_unsharded(capsys):
    """--data 2 in one process: make_host_mesh raises, the run is
    unsharded (the reference's fallback) and prints the same lines as
    --data 1."""
    cli.main(CLI_FLAGS + ["--steps", "3", "--data", "2"])
    a = _train_lines(capsys.readouterr().out)
    cli.main(CLI_FLAGS + ["--steps", "3"])
    b = _train_lines(capsys.readouterr().out)
    assert a == b and a[-1] == "[train] done at step 3"
