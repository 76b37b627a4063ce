"""The port's multi-process partitioned path (``simulate_distributed(
emulate=False)``, ``run_dist_trials(mesh=...)`` and the CLI's
``--distributed`` under ``torchrun``) against the emulated path and the
JAX package's, bitwise (tolerance 0).

Four CPU ranks on ``gloo`` (``torch.multiprocessing``, a ``file://``
rendezvous in the test's own directory, one intra-op thread each) run
tests/torch_mp_ranks.py once for every case, on the network of the JAX
package's ``tests/test_distributed.py::SHARD_MAP_SCRIPT`` (n = 1,600,
48,000 synapses, seed 8, ``even_partition`` into 4, 200 steps, seed 3):
``bitmap``, ``event``, ``blocked`` and ``blocked_fused``, each equal to
the reference's and the port's ``emulate=True`` run (counts, LIF state,
``dropped``, every probe record, the tile counters) on every rank;
``run_dist_trials(seeds=[3, 11])`` equal to the per-seed runs; a
chunked run killed after its second chunk and resumed, equal to the
whole run, and the checkpoint layouts crossing both ways (an emulated
checkpoint resumes the ranks, theirs resumes an emulated run); the
health check reading the counters summed over the ranks (the emulated
run's error, kind, step and value); the ``faulty`` scheme's host-side
failure raised on every rank and its dropped payloads counted; and a
``torchrun`` CLI run on 2 ranks printing the emulated run's digest."""

import contextlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mp_ranks as R
from repro.core import SimConfig as RefSim
from repro.core import connectome as ref_conn
from repro.core.dcsr import build_dcsr as ref_build_dcsr
from repro.core.distributed import DistConfig as RefDist
from repro.core.distributed import simulate_distributed as ref_simulate
from repro.core.partition import even_partition as ref_even
from repro.exp import ProbeSpec as RefProbes
from repro_torch.core import SimulationHealthError, simulate_distributed
from repro_torch.core.distributed import make_core_mesh, rank_device
from repro_torch.core.exchange import ExchangeFault, configure_faulty
from repro_torch.exp import ProbeSpec
from repro_torch.launch import simulate as cli

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@contextlib.contextmanager
def prng_mode(mode: bool):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", mode)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _emulated(d, cfg, t_steps, seed=R.SEED, probes=R.PROBES, **kw):
    return R.as_dict(simulate_distributed(
        d, cfg, t_steps, R.SUGAR, seed=seed, probes=ProbeSpec(**probes),
        device="cpu", **kw))


def _reference(variant):
    rc = ref_conn.synthetic_flywire(n=R.N, target_synapses=R.SYN,
                                    seed=R.NET_SEED)
    rd = ref_build_dcsr(rc, ref_even(rc, R.P))
    scheme, engine = R.VARIANTS[variant]
    r = ref_simulate(rd, RefDist(sim=RefSim(engine=engine), scheme=scheme),
                     R.T, R.SUGAR, seed=R.SEED, emulate=True,
                     probes=RefProbes(**R.PROBES))
    out = {"counts": r.counts, "dropped": np.int64(r.dropped),
           "v": r.state[0], "g": r.state[1], "refrac": r.state[2]}
    out.update({f"rec_{k}": v for k, v in r.records.items()})
    out.update({f"stat_{k}": v for k, v in r.stats.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _torchrun_cli(work) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1", "REPRO_CACHE": str(work / "cache")}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.simulate"]
        + CLI_ARGS + ["--cores", "2", "--dist-backend", "gloo",
                      "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


CLI_ARGS = ["--scale", "smoke", "--distributed", "--t-ms", "10", "--digest",
            "--dist-scheme", "blocked", "--engine", "blocked_fused"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the four ranks once; meanwhile run the emulated checkpoint
    the ranks resume from, the torchrun CLI and the reference."""
    work = tmp_path_factory.mktemp("ranks")
    with one_thread(), prng_mode(True):
        d = R.network()
        _emulated(d, R.dist_config("blocked_fused"), 2 * R.CHUNK,
                  chunk_steps=R.CHUNK, checkpoint_dir=str(work / "ck_emu"))
        ctx = mp.start_processes(R.run_rank, args=(R.P, str(work)),
                                 nprocs=R.P, join=False,
                                 start_method="spawn")
        proc = _torchrun_cli(work)
        refs = {v: _reference(v) for v in R.VARIANTS}
        while not ctx.join(timeout=300):
            pass
        cli_out, cli_err = proc.communicate(timeout=300)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(R.P)]
    return dict(work=work, d=d, ranks=ranks, refs=refs,
                cli=(proc.returncode, cli_out, cli_err))


@pytest.fixture(autouse=True)
def pin_prng_mode():
    with prng_mode(True), one_thread():
        yield


def _np(v) -> np.ndarray:
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def _assert_bitwise(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = _np(want[k]), _np(got[k])
        if k.startswith("stat_"):
            assert int(a) == int(b), k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        if a.dtype.kind == "f":
            a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("variant", list(R.VARIANTS))
def test_matches_reference_and_emulated(run, variant):
    want = run["refs"][variant]
    assert want["counts"].sum() > 0
    emulated = _emulated(run["d"], R.dist_config(variant), R.T)
    _assert_bitwise(want, emulated)
    for r, out in enumerate(run["ranks"]):
        assert out["rank"] == r and out["device"] == "cpu"
        _assert_bitwise(want, out[variant])


def test_dist_trials_equal_per_seed_runs(run):
    cfg = R.dist_config("event")
    emulated = {s: _emulated(run["d"], cfg, R.T_TRIALS, seed=s,
                             probes=dict(raster=True))
                for s in R.TRIAL_SEEDS}
    for out in run["ranks"]:
        tr = out["trials"]
        assert tr["counts"].shape == (2, R.N)
        for b, s in enumerate(R.TRIAL_SEEDS):
            one = out[f"seed{s}"]
            _assert_bitwise(one, {k: v[b] for k, v in tr.items()})
            _assert_bitwise(emulated[s], one)
    assert not torch.equal(tr["counts"][0], tr["counts"][1])


def test_chunked_kill_and_resume_equals_whole_run(run):
    for out in run["ranks"]:
        _assert_bitwise(out["blocked_fused"], out["resumed"])
    # the ranks wrote every chunk's checkpoint, in the emulated layout
    assert sorted(os.listdir(run["work"] / "ck_mp_killed")) == [
        "step_100", "step_50"]
    assert sorted(os.listdir(run["work"] / "ck_mp")) == [
        "step_100", "step_150", "step_200", "step_50"]


def test_checkpoint_layouts_cross(run):
    """An emulated run's checkpoint resumes the ranks, and the ranks'
    resumes an emulated run: both equal to the whole run."""
    whole = run["ranks"][0]["blocked_fused"]
    for out in run["ranks"]:
        _assert_bitwise(whole, out["from_emulated"])
    resumed = _emulated(run["d"], R.dist_config("blocked_fused"), R.T,
                        chunk_steps=R.CHUNK, resume=True,
                        checkpoint_dir=str(run["work"] / "ck_mp_killed"))
    _assert_bitwise(whole, resumed)


def test_health_reads_counters_summed_over_ranks(run):
    with pytest.raises(SimulationHealthError) as err:
        _emulated(run["d"], R.health_config(), R.T,
                  chunk_steps=R.CHUNK // 5)
    e = err.value
    want = (e.kind, e.step, float(e.value))
    assert want[0] == "drop_rate"
    assert [out["health"] for out in run["ranks"]] == [want] * R.P


def test_faulty_plan_runs_on_every_rank(run, tmp_path):
    cfg = R.faulty_config()
    ck = str(tmp_path / "ck")
    try:
        with pytest.raises(ExchangeFault) as err:
            _emulated(run["d"], cfg, R.T, chunk_steps=R.CHUNK,
                      checkpoint_dir=ck)
        want = _emulated(run["d"], cfg, R.T, chunk_steps=R.CHUNK,
                         checkpoint_dir=ck, resume=True)
    finally:
        configure_faulty()
    clean = _emulated(run["d"], R.dist_config("event"), R.T)
    assert int(want["dropped"]) > int(clean["dropped"])
    for out in run["ranks"]:
        assert out["fault"] == str(err.value)
        _assert_bitwise(want, out["faulty"])


def test_cli_under_torchrun_prints_the_emulated_digest(run, capsys,
                                                       monkeypatch):
    code, out, err = run["cli"]
    assert code == 0, err[-3000:]
    monkeypatch.setenv("REPRO_CACHE", str(run["work"] / "cache"))
    cli.main(CLI_ARGS + ["--emulate", "--cores", "2", "--device", "cpu"])
    emulated = capsys.readouterr().out

    def lines(text):
        return [ln for ln in text.splitlines() if ln.startswith(
            ("[simulate] digest", "[simulate] mean total spikes"))]
    assert len(lines(emulated)) == 2 and lines(out) == lines(emulated)
    # only rank 0 printed
    assert out.count("[simulate] connectome:") == 1


def test_mesh_refusals(run):
    assert all(out["nccl_refused"] for out in run["ranks"])
    with pytest.raises(ValueError, match="one GPU a rank"):
        rank_device("nccl", 0, 2, ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="one GPU a rank"):
        rank_device("nccl", 0, 1, ["cpu"])
    assert rank_device("gloo", 1, 2, ["cpu", "cpu"]) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device("gloo", 0, 2)
    with pytest.raises(ValueError, match="backend"):
        make_core_mesh(4, backend="mpi")
    with pytest.raises(TypeError, match="CoreMesh"):
        simulate_distributed(run["d"], R.dist_config("event"), 3,
                             mesh=object(), device="cpu")
