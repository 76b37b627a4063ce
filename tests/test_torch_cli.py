"""The port's simulation CLI (``python -m repro_torch.launch.simulate``,
driven in process through ``main(argv)``) against the JAX package's CLI
(``repro.launch.simulate``, its stdout captured) at ``--scale smoke``:
the same ``digest`` and ``mean total spikes`` lines on the supervised
path (``--chunk-steps 125``), after ``--inject-fail-at-chunk 2`` and
``--resume``, and on ``--distributed --emulate --cores 4``; every
``--scenario`` runs; telemetry and profile outputs; the refusals."""

import contextlib
import os
import sys

import jax
import pytest
import torch

from repro.launch import simulate as ref_cli
from repro_torch.launch import simulate as cli
from repro_torch.obs import check


@contextlib.contextmanager
def prng_mode(mode: bool):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", mode)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def pin_prng_mode():
    with prng_mode(True):
        yield


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one intra-op thread (see tests/test_torch_event.py:
    under the parallel test run, threads a worker contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """One connectome cache per package, shared by this file's runs."""
    root = tmp_path_factory.mktemp("cli_cache")
    return str(root / "ref"), str(root / "port")


def _lines(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("[simulate] digest "):
            out["digest"] = line
        elif line.startswith("[simulate] mean total spikes"):
            out["spikes"] = line
        elif line.startswith("[simulate] injected kill"):
            out["kill"] = line
    return out


def run_ref(argv, capsys, monkeypatch, caches) -> dict:
    monkeypatch.setenv("REPRO_CACHE", caches[0])
    monkeypatch.setattr(sys, "argv", ["simulate"] + argv)
    ref_cli.main()
    return _lines(capsys.readouterr().out)


def run_port(argv, capsys, monkeypatch, caches) -> dict:
    monkeypatch.setenv("REPRO_CACHE", caches[1])
    cli.main(argv + ["--device", "cpu"])
    return _lines(capsys.readouterr().out)


SMOKE = ["--scale", "smoke", "--digest"]


def test_supervised_digest_matches_reference(capsys, monkeypatch, caches):
    argv = SMOKE + ["--engine", "csr", "--t-ms", "25", "--chunk-steps",
                    "125"]
    want = run_ref(argv, capsys, monkeypatch, caches)
    got = run_port(argv, capsys, monkeypatch, caches)
    assert set(want) == {"digest", "spikes"} and got == want


def test_kill_and_resume_digest_matches_reference(capsys, monkeypatch,
                                                  caches, tmp_path):
    argv = SMOKE + ["--engine", "event", "--fixed-point", "--scenario",
                    "pulse_probe", "--t-ms", "40", "--chunk-steps", "125"]
    whole = run_port(argv, capsys, monkeypatch, caches)
    for run, tag in ((run_ref, "ref"), (run_port, "port")):
        ck = ["--checkpoint-dir", str(tmp_path / tag)]
        killed = run(argv + ck + ["--inject-fail-at-chunk", "2"], capsys,
                     monkeypatch, caches)
        assert set(killed) == {"kill"}
        resumed = run(argv + ck + ["--resume"], capsys, monkeypatch, caches)
        assert resumed == whole, tag
    assert sorted(os.listdir(tmp_path / "port")) == [
        "step_125", "step_250", "step_375", "step_400"]


def test_distributed_digest_matches_reference(capsys, monkeypatch, caches):
    argv = SMOKE + ["--distributed", "--emulate", "--cores", "4",
                    "--t-ms", "10"]
    want = run_ref(argv, capsys, monkeypatch, caches)
    got = run_port(argv, capsys, monkeypatch, caches)
    assert set(want) == {"digest", "spikes"} and got == want


@pytest.mark.parametrize("scenario", cli.available_scenarios())
def test_every_scenario_runs(scenario, capsys, monkeypatch, caches):
    run_port(["--scale", "smoke", "--engine", "csr", "--scenario", scenario,
              "--t-ms", "2", "--trials", "2"], capsys, monkeypatch, caches)


def test_telemetry_and_profile(capsys, monkeypatch, caches, tmp_path):
    path = str(tmp_path / "run.jsonl")
    run_port(SMOKE + ["--engine", "csr", "--t-ms", "3", "--health",
                      "--max-drop-rate", "5", "--telemetry", path,
                      "--profile", str(tmp_path / "prof")],
             capsys, monkeypatch, caches)
    assert check.main([path]) == 0
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_refusals(capsys, monkeypatch, caches):
    with pytest.raises(SystemExit):
        cli.main(["--scale", "smoke", "--distributed", "--device", "cpu"])
    assert "multi-device path" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--scale", "smoke", "--trials", "2", "--chunk-steps", "5",
                  "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--scale", "smoke", "--inject-fail-at-chunk", "1",
                  "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--scale", "smoke"])
