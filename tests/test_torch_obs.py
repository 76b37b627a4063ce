"""The port's telemetry (repro_torch.obs) against the JAX package's:
results bitwise equal with a session on and off; the event stream of a
supervised run (run_start, span, compile, chunk, checkpoint, health,
run_end) passes the port's own checker and the reference's
``validate_record``, with the reference's compile-cache hit/miss counts;
the report summarizes it; ``schema.json`` is the reference's byte for
byte; and with no session nothing is recorded."""

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core import HealthConfig as RefHealth
from repro.core import SimConfig as RefSim
from repro.core import connectome as ref_conn
from repro.core import simulate as ref_simulate
from repro.exp import build_scenario as ref_scenario
from repro_torch import convert, obs
from repro_torch.core import (DistConfig, SimConfig, build_dcsr,
                              even_partition, simulate, simulate_distributed)
from repro_torch.core.health import HealthConfig, SimulationHealthError
from repro_torch.exp import (ProbeSpec, StepCurrent, build_scenario,
                             per_neuron)
from repro_torch.obs import check, report, schema

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))


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
def net():
    rc = ref_conn.synthetic_flywire(n=400, target_synapses=8_000, seed=0)
    return rc, convert.connectome_from_jax(rc)


FX = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False)


def _bits(r) -> list:
    out = [r.counts, r.state.v, r.state.g, r.state.refrac, r.dropped,
           *r.records.values()]
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in out]


def _run(pc, t_steps=45, **kw):
    cfg = SimConfig(engine="event", health=HealthConfig(), **FX)
    return simulate(pc, cfg, t_steps, seed=1, device="cpu",
                    stimulus=build_scenario("pulse_probe", pc, cfg,
                                            period_ms=1.3),
                    probes=ProbeSpec(raster=True, pop_rate=True), **kw)


def test_telemetry_changes_no_result(net, tmp_path):
    _, pc = net
    assert obs.active() is None
    off = _run(pc, chunk_steps=20)
    with obs.telemetry(str(tmp_path / "a.jsonl")) as session:
        assert obs.active() is session
        on = _run(pc, chunk_steps=20, checkpoint_dir=str(tmp_path / "ck"))
    assert obs.active() is None
    for a, b in zip(_bits(off), _bits(on), strict=True):
        np.testing.assert_array_equal(a, b)
    assert "compile_cache" in on.stats and "compile_cache" not in off.stats
    # a session also sends an unchunked run through the chunk loop
    plain = _run(pc)
    with obs.telemetry(None):
        one = _run(pc)
    for a, b in zip(_bits(plain), _bits(one), strict=True):
        np.testing.assert_array_equal(a, b)


def test_stream_is_valid_and_matches_reference_cache_counts(net, tmp_path):
    rc, pc = net
    path = str(tmp_path / "run.jsonl")
    with obs.telemetry(path):
        # chunk sizes no other test of this file uses: the signature cache
        # outlives a session, as the reference's compiled programs do
        res = _run(pc, 40, chunk_steps=15,
                   checkpoint_dir=str(tmp_path / "ck"))
        with pytest.raises(SimulationHealthError):
            simulate(pc, SimConfig(health=HealthConfig()), 30, device="cpu",
                     stimulus=StepCurrent(per_neuron([0], np.nan, pc.n),
                                          target="v"), chunk_steps=10)
        pd = build_dcsr(pc, even_partition(pc, 4))
        simulate_distributed(pd, DistConfig(sim=SimConfig(), scheme="bitmap"),
                             12, device="cpu", chunk_steps=5)
    assert check.main([path]) == 0
    events = [json.loads(line) for line in open(path)]
    for e in events:
        assert ref_obs.validate_record(e) == [], e
    types = {e["type"] for e in events}
    assert types >= {"run_start", "span", "compile", "chunk", "checkpoint",
                     "health", "run_end"}
    chunks = [e for e in events if e["type"] == "chunk"][:3]
    assert [(c["step"], c["steps"]) for c in chunks] == [(15, 15), (30, 15),
                                                          (40, 10)]
    assert chunks[-1]["counters"]["spikes"] == int(res.counts.sum())
    health = [e for e in events if e["type"] == "health"]
    assert [(h["kind"], h["step"]) for h in health] == [("nonfinite", 10)]
    starts = [e for e in events if e["type"] == "run_start"]
    assert [s["kind"] for s in starts] == ["simulate", "simulate",
                                           "simulate_distributed"]
    # the reference's jit cache over the same chunking: 15, 15, 10
    rcfg = RefSim(engine="event", health=RefHealth(), **FX)
    with ref_obs.telemetry(None):
        want = ref_simulate(rc, rcfg, 40, seed=1, chunk_steps=15,
                            stimulus=ref_scenario("pulse_probe", rc, rcfg,
                                                  period_ms=1.3))
    cache = want.stats["compile_cache"]
    assert (res.stats["compile_cache"]["hits"],
            res.stats["compile_cache"]["misses"]) == (cache["hits"],
                                                      cache["misses"])


def test_report_summarizes_the_stream(net, tmp_path, capsys):
    _, pc = net
    path = str(tmp_path / "run.jsonl")
    with obs.telemetry(path):
        _run(pc, chunk_steps=18, checkpoint_dir=str(tmp_path / "ck"))
    assert report.main([path]) == 0
    text = capsys.readouterr().out
    assert "run: simulate (event) n=400 t_steps=45 chunk_steps=18" in text
    assert "[fixed-point]" in text
    assert "throughput: 45 steps" in text and "over 3 chunk(s)" in text
    assert "checkpoints: 3 (steps 18, 36, 45)" in text
    assert "compile cache: 2 compile(s) (hits=1 misses=2)" in text
    for phase in ("simulate", "chunk", "build"):
        assert f"\n{phase} " in text
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert report.main([str(empty)]) == 1
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"t": 0, "type": "nope"}\nnot json\n')
    assert check.main([str(bad), path]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_schema_is_the_reference_schema():
    ours = os.path.join(ROOT, "src", "repro_torch", "obs", "schema.json")
    ref = os.path.join(ROOT, "src", "repro", "obs", "schema.json")
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    rec = {"t": 0.1, "type": "chunk", "step": 3, "steps": 3, "wall_s": 0.1,
           "steps_per_s": 30.0, "counters": {"spikes": 1}, "delta": {}}
    assert schema.validate_record(rec) == ref_obs.validate_record(rec) == []
    rec["counters"] = {"spikes": "1"}
    assert schema.validate_record(rec) == ref_obs.validate_record(rec) != []


def test_no_session_records_nothing_and_sinks(tmp_path):
    seen = []
    with obs.span("x") as sp:
        pass
    assert sp.wall_s is None
    calls = obs.InstrumentedCall(lambda a: a + 1, "f")
    assert calls(1) == 2
    with obs.telemetry(seen.append, validate=True) as s:
        with obs.span("outer"):
            with obs.span("inner", what=1):
                pass
        assert calls(torch.ones(2)).sum() == 4
        calls(torch.ones(2))
        calls(torch.ones(3))
        with pytest.raises(ValueError, match="invalid"):
            s.emit("chunk", step=1)
    spans = [(e["name"], e["depth"], e["parent"]) for e in seen
             if e["type"] == "span"]
    assert spans == [("inner", 1, "outer"), ("outer", 0, None)]
    assert s.metrics.compile_snapshot()["hits"] == 1
    assert s.metrics.counters() == {"compile_cache.hits": 1,
                                    "compile_cache.misses": 2}
    sink = obs.JsonlSink(str(tmp_path / "s.jsonl"), async_flush=False)
    sink.emit({"t": np.float32(0.5), "type": "span",
               "n": torch.tensor(3)})
    sink.close()
    assert json.loads(open(tmp_path / "s.jsonl").read()) == {
        "t": 0.5, "type": "span", "n": 3}


def test_profile_trace_writes_a_trace(tmp_path):
    with obs.profile_trace(None):
        pass
    with obs.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
