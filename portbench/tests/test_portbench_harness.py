"""Whole runs of the harness on the CPU at the tests' size (its look for a
card skipped): a cell added as files alone, the traced run's record, the
program with its timed path broken underneath (``correct`` must come out
false for each fault a cell can have), the lower-precision control, and
``run.py``'s refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, harness, spec
from portbench.tests.smoke import make_root

SEED = 2**31 + 99
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"), t_steps=40)


def run(root, cell, trace=False, seconds=1.0):
    return harness.run(root, cell, SEED, seconds, trace, "cpu",
                       time.perf_counter())


def test_a_cell_added_as_files_alone(root, tmp_path):
    """A new traffic file and a ``BENCHMARK.json`` entry: no code edit."""
    new = str(tmp_path / "root")
    shutil.copytree(root, new)
    mix = {"lanes": 2, "t_steps": 40, "chunk_steps": 10, "drive": [
        {"kind": "poisson", "pick": 50, "pick_seed": 3, "rate_hz": 100.0,
         "weight": 120.0, "target": "g"},
        {"kind": "background", "rate_hz": 5.0}]}
    with open(os.path.join(new, "portbench", "traffic", "mix-b2.json"),
              "w") as f:
        json.dump(mix, f)
    bench = spec.benchmark(new)
    bench["workloads"].append({"name": "f32-mix-b2", "config": "flywire-f32",
                               "traffic": "mix-b2", "chips": 1, "why": "t"})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = run(new, "f32-mix-b2")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"bio_s_per_s", "chunk_ms_p95", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


def test_a_traced_run(root):
    out = run(root, CELLS[0], trace=True)
    assert out["correct"]
    # on the CPU no device activity is traced: only the host's metric
    assert set(out["metrics"]) == {"boundary_ms"}
    assert out["metrics"]["boundary_ms"]["value"] > 0
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(self, state, spikes, lif, drive, cfg):
    return lif, torch.zeros_like(spikes), torch.zeros(
        spikes.shape[:-1], dtype=torch.int32, device=spikes.device)


def _altered(original):
    def deliver(self, state, spikes, lif, drive, cfg):
        lif, out, drop = original(self, state, spikes, lif, drive, cfg)
        out = out.clone()
        out[0, 0] = True                # an extra spike where it is made
        return lif, out, drop
    return deliver


def _half_batch(original):
    def run_trials(c, cfg, t_steps, *args, seeds, **kw):
        half = seeds[:max(1, len(seeds) // 2)]
        res = original(c, cfg, t_steps, *args, seeds=half, **kw)
        B = len(seeds)

        def fill(x):
            mean = x.double().mean(dim=0, keepdim=True).to(x.dtype)
            return torch.cat([x, mean.expand((B - len(half),) + x.shape[1:])])
        return res._replace(counts=fill(res.counts),
                            dropped=fill(res.dropped),
                            state=type(res.state)(*(fill(x)
                                                    for x in res.state)))
    return run_trials


def test_a_sample_of_the_lanes(root, monkeypatch):
    """Above ``CHECK_LANES`` lanes the comparison checks a sample of them,
    drawn from the run's seed."""
    from portbench import check
    monkeypatch.setattr(check, "CHECK_LANES", 2)
    assert spec.check_lanes(SEED, 3, 2) == spec.check_lanes(SEED, 3, 2)
    assert len(set(spec.check_lanes(SEED, 3, 2))) == 2
    out = run(root, "q19-storm-b32", trace=True)
    assert out["correct"] and out["attempted"] >= 1


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_batch"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault,
                                            sample):
    from portbench import check
    from repro_torch.core.engines.blocked_fused import BlockedFusedEngine
    from repro_torch.exp import trials
    if sample:
        monkeypatch.setattr(check, "CHECK_LANES", 2)
    if fault == "unchanged":
        monkeypatch.setattr(BlockedFusedEngine, "deliver_fused", _unchanged)
    elif fault == "altered":
        monkeypatch.setattr(BlockedFusedEngine, "deliver_fused",
                            _altered(BlockedFusedEngine.deliver_fused))
    else:
        monkeypatch.setattr(trials, "run_trials",
                            _half_batch(trials.run_trials))
    out = run(root, "q19-sweep-b32")
    assert not out["correct"]
    assert out["failed"] == out["attempted"] >= 1
    assert out["checks"]["count_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_does_not(root, cell):
    out = control.readings(root, cell, [SEED], [SEED, SEED + 1], "cpu",
                           log=lambda s: None)
    assert all(v == 0 for v in out["program_max"].values())
    assert out["control_min"]["state_mismatch"] > 0


def _run_py(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    p = _run_py(spec.ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""
