"""The step-phase marks of the port's telemetry (``repro_torch.obs.phases``)
and the span fields beside them.

Switch off (the default): a supervised run makes no timing event and no
profiler range, and its chunk events carry no ``phases``.  Switch on,
with a host-clock stand-in for the CUDA event (marks are made only on a
card, so the CPU tests swap the event class in): every chunk event names
the seven phases and passes the schema, the phases tile the marked
interval, the results are bitwise the switch-off run's, on the trial
batch and the partitioned runner alike; the profiler sees the spans and
phases as ranges; ``obs.report`` and the CLI print the split.  Span
events carry their start and parent."""

import contextlib
import json
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import (DistConfig, SimConfig, build_dcsr,
                              even_partition, simulate_distributed)
from repro_torch.core.connectome import synthetic_flywire
from repro_torch.exp import Background, Compose, PoissonDrive, run_trials
from repro_torch.launch import simulate as cli
from repro_torch.obs import phases, report, schema

K = 4
T = 10


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
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class HostEvent:
    """A host-clock stand-in for ``torch.cuda.Event``: every record's time
    is kept, in order, in ``HostEvent.log``, and ``made`` counts the
    events constructed."""

    log: list = []
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        HostEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()
        HostEvent.log.append(self.t)

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, later) -> float:
        return (later.t - self.t) * 1e3


class Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("made with the phase switch off")


@pytest.fixture
def host_events(monkeypatch):
    HostEvent.log, HostEvent.made = [], 0
    monkeypatch.setattr(phases, "event_class", lambda device: HostEvent)
    return HostEvent


@pytest.fixture(scope="module")
def net():
    return synthetic_flywire(n=400, target_synapses=6_000, seed=0)


def _stim(n):
    return Compose((PoissonDrive(idx=torch.arange(0, 40, dtype=torch.int32),
                                 rate_hz=300.0, target="g", weight=150.0),
                    Background(rate_hz=20.0)))


def _trials(c, engine="csr", **kw):
    cfg = SimConfig(engine=engine, fixed_point=True, quantize_bits=9,
                    poisson_to_v=False)
    return run_trials(c, cfg, T, seeds=[5, 6], stimulus=_stim(c.n),
                      chunk_steps=K, device="cpu", **kw)


def _dist(c):
    d = build_dcsr(c, even_partition(c, 3))
    return simulate_distributed(d, DistConfig(sim=SimConfig(),
                                              scheme="bitmap"),
                                T, device="cpu", chunk_steps=K)


def _bits(res) -> list:
    return [np.asarray(x) for x in (res.counts, res.dropped, *res.state)]


def _chunks(events):
    return [e for e in events if e["type"] == "chunk"]


def test_switch_off_makes_no_event_and_no_range(net, monkeypatch):
    monkeypatch.setattr(phases, "event_class", lambda device: Refused)
    monkeypatch.setattr(torch.cuda, "Event", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    events = []
    with obs.telemetry(events.append) as session:
        assert session.phases is False
        _trials(net)
    chunks = _chunks(events)
    assert len(chunks) == 3
    assert not any("phases" in c or "drain_s" in c for c in chunks)
    assert not any(k.startswith("step.")
                   for k in session.metrics.observations())


@pytest.mark.parametrize("runner", ["trials", "trials_fused", "partitioned"])
def test_switch_on_tiles_each_chunk(net, host_events, runner):
    def run():
        if runner == "partitioned":
            return _dist(net)
        return _trials(net, engine=("blocked_fused" if runner.endswith(
            "fused") else "csr"))

    with obs.telemetry(None):
        off = run()
    assert host_events.log == []
    events = []
    with obs.telemetry(events.append, validate=True) as s:
        s.phases = True
        on = run()
    for a, b in zip(_bits(off), _bits(on), strict=True):
        np.testing.assert_array_equal(a, b)
    chunks = _chunks(events)
    assert [c["steps"] for c in chunks] == [4, 4, 2]
    parts = 3 if runner == "partitioned" else 1
    at = 0
    for c in chunks:
        assert schema.validate_record(c) == []
        assert list(c["phases"]) == list(phases.PHASES)
        assert all(v >= 0 for v in c["phases"].values())
        assert 0 <= c["drain_s"] <= c["wall_s"]
        # the entry mark, six a step and partition, the closing mark
        n = 2 + 6 * parts * c["steps"]
        marked = host_events.log[at:at + n]
        at += n
        interval = marked[-1] - marked[0]
        assert sum(c["phases"].values()) == pytest.approx(interval,
                                                          abs=1e-8)
        assert interval <= c["wall_s"]
    assert at == len(host_events.log)
    # one set of events serves the run: the later chunks record them again
    assert host_events.made == 2 + 6 * parts * K
    seen = s.metrics.observations()
    assert {f"step.{p}" for p in phases.PHASES} <= set(seen)
    assert seen["step.deliver"]["count"] == len(chunks)


def test_switch_set_on_the_live_session(net, host_events):
    events = []
    with obs.telemetry(events.append) as session:
        _trials(net)
        session.phases = True
        _trials(net)
    chunks = _chunks(events)
    assert ["phases" in c for c in chunks] == [False] * 3 + [True] * 3


def test_the_profiler_sees_spans_and_phases(net, host_events):
    with obs.telemetry(None) as session:
        session.phases = True
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _trials(net)
    names = {e.key for e in prof.key_averages()}
    assert "chunk" in names
    assert {f"step.{p}" for p in phases.PHASES} <= names


def test_report_prints_the_phase_table(net, host_events, tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    with obs.telemetry(path) as session:
        session.phases = True
        _trials(net)
    assert report.main([path]) == 0
    text = capsys.readouterr().out
    assert f"step phases (device stream, {T} steps over 3 marked" in text
    for p in phases.PHASES:
        assert f"\n{p} " in text
    assert "host: enqueue " in text and " drain " in text
    plain = str(tmp_path / "plain.jsonl")
    with obs.telemetry(plain):
        _trials(net)
    assert report.main([plain]) == 0
    assert "step phases" not in capsys.readouterr().out


def test_spans_carry_start_and_parent():
    events = []
    with obs.telemetry(events.append, validate=True) as s:
        time.sleep(0.001)
        with obs.span("outer"):
            with obs.span("inner", what=1):
                pass
            with obs.span("inner"):
                pass
    spans = [e for e in events if e["type"] == "span"]
    assert [(e["name"], e["depth"], e["parent"]) for e in spans] == [
        ("inner", 1, "outer"), ("inner", 1, "outer"), ("outer", 0, None)]
    outer = spans[-1]
    assert 0 < outer["start"] <= spans[0]["start"] <= spans[1]["start"]
    assert spans[1]["start"] + spans[1]["wall_s"] <= (
        outer["start"] + outer["wall_s"] + 1e-6)
    assert all(schema.validate_record(e) == [] for e in spans)
    assert not any(k.startswith("phase.")
                   for k in s.metrics.observations())


def test_cli_sessions_turn_the_switch_on(host_events, monkeypatch, tmp_path,
                                         capsys):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))
    path = str(tmp_path / "run.jsonl")
    args = ["--scale", "smoke", "--engine", "csr", "--t-ms", "1",
            "--chunk-steps", "5", "--device", "cpu"]
    cli.main(args + ["--telemetry", path])
    out = capsys.readouterr().out
    assert "[simulate] step phases (device stream): " in out
    chunks = [json.loads(line) for line in open(path)]
    chunks = [c for c in chunks if c["type"] == "chunk"]
    assert chunks and all(list(c["phases"]) == list(phases.PHASES)
                          for c in chunks)
    cli.main(args + ["--profile", str(tmp_path / "prof")])
    assert "[simulate] step phases" in capsys.readouterr().out
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"chunk", "step.deliver"} <= names
    cli.main(args)
    assert "step phases" not in capsys.readouterr().out


def test_report_reads_admissions_and_batches():
    events = [{"t": 0.0, "type": "serve_admit", "rid": i, "queue_depth": 1}
              for i in range(3)]
    events += [{"t": 0.1, "type": "serve_batch", "size": s} for s in (2, 1)]
    events += [{"t": 0.2, "type": "serve_request_end", "rid": i,
                "status": "completed", "wall_s": 0.5} for i in range(3)]
    text = report.summarize(events)
    assert "admitted 3, 2 batch(es), mean 1.50 lanes" in text
