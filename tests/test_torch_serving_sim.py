"""The port's simulation server (repro_torch.serving.sim) and serving CLI
(repro_torch.launch.serve) against the JAX package's, bitwise.

One scripted workload goes through the reference ``SimServer`` and the
port's, each with its own fake clock, sleep and ``random.Random(0)``:
packed and solo requests, mixed signatures, priorities, shedding at the
hard queue limit, degradation past the soft watermark, a deadline cut at
a chunk boundary, a NaN-poisoned request quarantined after its second
health failure, and a crash-once hook retried with backoff; on csr in
float32 and blocked_fused in Q19.12, one threefry mode each.
Then the crash loop (isolated, then rejected), the drop-rate escalation
of one tier on a starved ``event`` budget, ``stats()``, and
``launch/serve.py::main`` in process.  Terminal states, reasons, retry
counters, the ``serve_*`` event stream (fake-clock timestamps included)
and every result (counts, records, LIF state, dropped, stats) must be
equal; each packed result is also the port's own solo ``simulate()``.
The network is tests/test_serving_sim.py's (n = 300, 6,000 synapses)."""

import contextlib
import io
import random
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core.engine as ref_engine
import repro.obs as ref_obs
from repro.core import CapacityConfig as RefCap
from repro.core import HealthConfig as RefHealth
from repro.core import SimConfig as RefSim
from repro.core import connectome as ref_conn
from repro.core.exchange import ExchangeFault as RefFault
from repro.core.health import BackoffPolicy as RefBackoff
from repro.exp import ProbeSpec as RefProbes
from repro.launch import serve as ref_serve_cli
from repro.serving import SimRequest as RefRequest
from repro.serving import SimServeConfig as RefServeConfig
from repro.serving import SimServer as RefServer
import repro_torch.core.engine as port_engine
import repro_torch.exp.trials as port_trials
from repro_torch import convert
from repro_torch import obs
from repro_torch.core import CapacityConfig, HealthConfig, SimConfig, simulate
from repro_torch.core.exchange import ExchangeFault
from repro_torch.core.health import BackoffPolicy
from repro_torch.exp import ProbeSpec, build_scenario
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import (COMPLETED, QUARANTINED, REJECTED, TERMINAL,
                                 SimRequest, SimServeConfig, SimServer)

N, SYN, T = 300, 6_000, 60
FX = dict(fixed_point=True, quantize_bits=9, poisson_to_v=False)

REF = SimpleNamespace(Sim=RefSim, Cap=RefCap, Health=RefHealth,
                      Server=RefServer, ServeConfig=RefServeConfig,
                      Request=RefRequest, Probes=RefProbes,
                      Backoff=RefBackoff, Fault=RefFault, obs=ref_obs)
PORT = SimpleNamespace(Sim=SimConfig, Cap=CapacityConfig, Health=HealthConfig,
                       Server=SimServer, ServeConfig=SimServeConfig,
                       Request=SimRequest, Probes=ProbeSpec,
                       Backoff=BackoffPolicy, Fault=ExchangeFault, obs=obs)


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
def fresh_compile_caches():
    """Empty both packages' compile-cache accounting before each test.
    With a telemetry session active the reference's ``InstrumentedJit``
    keeps its own executables, keyed without the threefry mode: one
    compiled under the other mode would be reused (ROADMAP, reference
    findings).  Emptying it also makes the hit and miss counts that
    ``stats()`` reports independent of the test order."""
    for call in (ref_engine._run_scan, ref_engine._run_scan_trials):
        call._cache.clear()
    for call in (port_engine._run_steps, port_trials._run_trial_steps):
        call._seen.clear()
    yield


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one intra-op thread (see tests/test_torch_event.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    rc = ref_conn.synthetic_flywire(n=N, target_synapses=SYN, seed=0)
    return rc, convert.connectome_from_jax(rc)


class FakeClock:
    """Advances 0.5 s a read; ``sleep`` advances it by the wait."""

    def __init__(self):
        self.t = 0.0
        self.waits: list[float] = []

    def __call__(self) -> float:
        self.t += 0.5
        return self.t

    def sleep(self, s: float) -> None:
        self.waits.append(s)
        self.t += s


def _hook(pkg, kind):
    if kind is None:
        return None
    fired = []

    def hook(start, stop):
        if kind == "always" or not fired:
            fired.append(start)
            raise pkg.Fault(f"injected at {start}")
    return hook


def _requests(pkg, specs):
    out = []
    for s in specs:
        s = dict(s)
        hook = _hook(pkg, s.pop("hook", None))
        solo = s.pop("solo", False)
        r = pkg.Request(probes=pkg.Probes(**s.pop("probes", {})),
                        fault_hook=hook, **s)
        r.solo = solo
        out.append(r)
    return out


def _serve(pkg, c, specs, cfg_kw, serve_kw, mode):
    """Run ``specs`` through ``pkg``'s server; returns (requests, server,
    clock, serve_* events without their wall timestamps)."""
    clock = FakeClock()
    events = []
    kw = {"device": "cpu", "partitionable": mode} if pkg is PORT else {}
    serve_kw = {"backoff": pkg.Backoff(base_s=0.25, factor=2.0, cap_s=2.0),
                **serve_kw}
    cfg_kw = dict(cfg_kw)
    if "capacity" in cfg_kw:
        cfg_kw["capacity"] = pkg.Cap(*cfg_kw["capacity"])
    if "health" in cfg_kw:
        cfg_kw["health"] = pkg.Health(**cfg_kw["health"])
    with pkg.obs.telemetry(events.append, validate=True):
        srv = pkg.Server(c, pkg.Sim(**cfg_kw), pkg.ServeConfig(**serve_kw),
                         clock=clock, sleep=clock.sleep,
                         rng=random.Random(0), **kw)
        reqs = _requests(pkg, specs)
        done = srv.run(reqs)
        stats = srv.stats()
    assert len(done) == len(reqs)
    events = [{k: v for k, v in e.items() if k != "t"} for e in events
              if e["type"].startswith("serve_")]
    return reqs, srv, clock, events, stats


def _host(x) -> np.ndarray:
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _result_fields(res) -> dict:
    out = {"counts": res.counts, "v": res.state.v, "g": res.state.g,
           "refrac": res.state.refrac, "dropped": res.dropped}
    out.update({f"rec_{k}": v for k, v in res.records.items()})
    out.update({f"stat_{k}": v for k, v in res.stats.items()})
    return {k: _host(v) for k, v in out.items()}


def _assert_same_fields(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].shape == got[k].shape, k
        np.testing.assert_array_equal(want[k], got[k].astype(want[k].dtype),
                                      err_msg=k)


def _outcome(r) -> tuple:
    return (r.rid, r.status, r.reason, type(r.error).__name__, r.attempts,
            r.health_failures, r.solo, r.degraded, r.latency_s)


def _assert_servers_equal(ref, port):
    (rr, rsrv, rclock, rev, rstats), (pr, psrv, pclock, pev, pstats) = \
        ref, port
    assert [_outcome(r) for r in pr] == [_outcome(r) for r in rr]
    assert pev == rev
    assert pclock.waits == rclock.waits
    assert {k: v for k, v in pstats.items() if k != "compile_cache"} == \
        {k: v for k, v in rstats.items() if k != "compile_cache"}
    for key in ("hits", "misses"):
        assert pstats["compile_cache"][key] == rstats["compile_cache"][key]
    for a, b in zip(rr, pr):
        assert (a.result is None) == (b.result is None)
        if a.result is not None:
            # blocked_fused's syn_events has no counterpart in the
            # reference (the solo runs hold it: _assert_solo)
            got = {k: v for k, v in _result_fields(b.result).items()
                   if k != "stat_syn_events"}
            _assert_same_fields(_result_fields(a.result), got)


def _assert_solo(pc, srv, reqs, cfg=None):
    """Each completed port request is bitwise the port's solo run."""
    for r in reqs:
        if r.status != COMPLETED:
            continue
        run_cfg = cfg or srv._cfg_for(srv._signature(r))
        stim = build_scenario(r.scenario, pc, srv.cfg, **r.params)
        solo = simulate(pc, run_cfg, r.t_steps, seed=r.seed, stimulus=stim,
                        probes=r.probes, device="cpu",
                        partitionable=srv.partitionable)
        _assert_same_fields(_result_fields(solo), _result_fields(r.result))


RASTER = dict(raster=True, pop_rate=True)
MIXED = [
    dict(scenario="sugar_feeding", t_steps=T, seed=3, probes=RASTER),
    dict(scenario="sugar_feeding", t_steps=T, seed=7, probes=RASTER,
         hook="once"),
    dict(scenario="sugar_feeding", t_steps=T, seed=11, probes=RASTER),
    dict(scenario="step_response", t_steps=T, seed=1, params={"amp": 1.0},
         probes=dict(pop_rate=True, drops=True)),
    dict(scenario="step_response", t_steps=T, seed=2,
         params={"amp": float("nan")}, probes=dict(pop_rate=True)),
    dict(scenario="sugar_feeding", t_steps=T, seed=5, probes=RASTER,
         deadline_s=4.0),
    dict(scenario="sugar_feeding", t_steps=T, seed=9, probes=RASTER,
         priority=1),
    dict(scenario="sugar_feeding", t_steps=T, seed=13, probes=RASTER,
         solo=True),
    dict(scenario="sugar_feeding", t_steps=T, seed=15),
    dict(scenario="sugar_feeding", t_steps=T, seed=17),
]
MIXED_SERVE = dict(max_queue=8, max_batch=3, chunk_steps=20,
                   degraded_chunk_steps=15, degrade_queue_depth=5)


@pytest.mark.parametrize("engine,fx,mode", [
    ("csr", False, True), ("blocked_fused", True, False)],
    ids=["csr-f32-part", "fused-q19_12-nopart"])
def test_mixed_workload_matches_reference(nets, engine, fx, mode):
    """Every terminal state, reason, counter, event and result of the
    mixed workload equals the reference's; packed results are solo
    runs."""
    rc, pc = nets
    cfg_kw = dict(engine=engine, health={}, **(FX if fx else {}))
    with prng_mode(mode):
        ref = _serve(REF, rc, MIXED, cfg_kw, MIXED_SERVE, mode)
    port = _serve(PORT, pc, MIXED, cfg_kw, MIXED_SERVE, mode)
    _assert_servers_equal(ref, port)
    reqs, srv = port[0], port[1]
    by_seed = {r.seed: r for r in reqs}
    assert [by_seed[s].reason for s in (15, 17)] == ["queue_full"] * 2
    if fx:
        # Q19.12 converts the NaN drive to 0 (XLA's saturating convert):
        # nothing to quarantine
        assert by_seed[2].status == COMPLETED
    else:
        assert by_seed[2].status == QUARANTINED
        assert by_seed[2].reason == "nonfinite"
        assert by_seed[2].health_failures == 2 and by_seed[2].solo
    assert by_seed[7].status == COMPLETED and by_seed[7].attempts == 1
    assert by_seed[5].reason == "deadline" and by_seed[5].degraded
    cut = [e["step"] for e in port[3] if e["type"] == "serve_deadline"]
    assert cut == [30]                    # at a chunk boundary, mid-run
    assert by_seed[9].degraded and by_seed[9].status == COMPLETED
    assert "raster" not in by_seed[9].result.records
    assert all(r.terminal for r in reqs)
    s = port[4]
    assert s["completed"] + s["rejected"] + s["quarantined"] == s["submitted"]
    assert s["batches"] > 3 and s["shed"] == 2 and s["degraded"] == 3
    _assert_solo(pc, srv, reqs)


def test_crash_loop_isolates_then_rejects(nets):
    """A persistent crasher is isolated at its first (attributed) crash,
    its batch-mate requeues free and completes, and it is rejected after
    ``max_retries``, as in the reference."""
    rc, pc = nets
    specs = [dict(scenario="sugar_feeding", t_steps=40, seed=0,
                  hook="always"),
             dict(scenario="sugar_feeding", t_steps=40, seed=1)]
    serve = dict(max_retries=2, chunk_steps=20)
    ref = _serve(REF, rc, specs, dict(engine="csr"), serve, True)
    port = _serve(PORT, pc, specs, dict(engine="csr"), serve, True)
    _assert_servers_equal(ref, port)
    crashy, buddy = port[0]
    assert crashy.status == REJECTED and crashy.reason == "crash"
    assert isinstance(crashy.error, ExchangeFault)
    assert crashy.attempts == 3 and crashy.solo
    assert buddy.status == COMPLETED and buddy.attempts == 0


@pytest.mark.parametrize("mode", [True, False], ids=["part", "nopart"])
def test_drop_rate_escalates_one_tier(nets, mode):
    """A starved ``event`` budget breaches ``max_drop_rate``: that tier's
    capacity escalates (twice the budgets each time) and its batch
    re-runs; the other tier keeps the base capacity.  The escalated
    result is bitwise the solo run at the final capacity."""
    rc, pc = nets
    specs = [dict(scenario="sugar_feeding", t_steps=T, seed=0),
             dict(scenario="sugar_feeding", t_steps=T, seed=1),
             dict(scenario="silent_baseline", t_steps=T, seed=2)]
    cfg_kw = dict(engine="event", capacity=(4, 16),
                  health=dict(max_drop_rate=0.0))
    serve = dict(max_batch=4, max_escalations=10, chunk_steps=20)
    with prng_mode(mode):
        ref = _serve(REF, rc, specs, cfg_kw, serve, mode)
    port = _serve(PORT, pc, specs, cfg_kw, serve, mode)
    _assert_servers_equal(ref, port)
    reqs, srv, s = port[0], port[1], port[4]
    assert all(r.status == COMPLETED for r in reqs)
    assert s["escalations"] >= 1 and s["escalated_tiers"] == 1
    sig = srv._signature(reqs[0])
    assert srv._capacity[sig].syn_budget > 16
    assert srv._signature(reqs[2]) not in srv._capacity
    assert int(reqs[0].result.dropped) == 0
    _assert_solo(pc, srv, reqs[:2])
    assert [e["reason"] for e in port[3] if e["type"] == "serve_retry"] == \
        ["drop_rate"] * s["escalations"]


def test_capacity_exhaustion_and_stats(nets):
    """Escalations exhausted: the batch is rejected with the breach
    attached; ``stats()`` equal to the reference's."""
    rc, pc = nets
    specs = [dict(scenario="sugar_feeding", t_steps=T, seed=0)]
    cfg_kw = dict(engine="event", capacity=(1, 2),
                  health=dict(max_drop_rate=0.0))
    serve = dict(max_escalations=1, chunk_steps=20)
    ref = _serve(REF, rc, specs, cfg_kw, serve, True)
    port = _serve(PORT, pc, specs, cfg_kw, serve, True)
    _assert_servers_equal(ref, port)
    r = port[0][0]
    assert r.status == REJECTED and r.reason == "capacity"
    assert r.error.kind == "drop_rate"
    assert port[4]["latency_p50_s"] is None and port[4]["escalations"] == 1


def test_server_needs_a_device_or_cuda(nets):
    _, pc = nets
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SimServer(pc, SimConfig())
    assert set(TERMINAL) == {COMPLETED, REJECTED, QUARANTINED}


_WALL = re.compile(r"\d+\.\d+s")


def _cli(main, argv, cache, monkeypatch) -> list[str]:
    monkeypatch.setenv("REPRO_CACHE", str(cache))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [_WALL.sub("<s>", line) for line in buf.getvalue().splitlines()
            if line.startswith("[serve]")]


def test_serve_cli_matches_reference(tmp_path, monkeypatch):
    """``main(argv)`` of both packages in process: the same [serve] lines
    apart from wall times, a quarantined poison request, a retried
    crash, and every request terminal."""
    argv = ["--n", "400", "--inject-fault", "--poison"]
    want = _cli(ref_serve_cli.main, argv, tmp_path / "ref", monkeypatch)
    tele = tmp_path / "serve.jsonl"
    got = _cli(serve_cli.main, argv + ["--device", "cpu", "--telemetry",
                                       str(tele)],
               tmp_path / "port", monkeypatch)
    assert got[:-1] == want
    assert got[-1].startswith("[serve] telemetry stream:")
    assert "quarantined (nonfinite) [SimulationHealthError]" in got[-4]
    assert "8 completed / 0 rejected / 1 quarantined of 9" in got[-3]
    from repro_torch.obs import check, report
    assert check.main([str(tele)]) == 0
    assert report.main([str(tele)]) == 0


def test_metrics_snapshot_matches_reference():
    """``observations`` and ``snapshot`` (the registry ``stats()`` reads
    its compile snapshot from) equal the reference's; the port keeps an
    observation's count and total, not the reference's min and max,
    which no module of the port reads."""
    want, got = ref_obs.MetricsRegistry(), obs.MetricsRegistry()
    for reg in (want, got):
        reg.inc("serving.batches")
        reg.inc("serving.retries", 2)
        reg.observe("phase.serve_batch", 0.5)
        reg.observe("phase.serve_batch", 0.25)
        reg.record_compile("engine.run_trials", "abc", 0.0, 0.0, None, None)

    def count_total(o):
        return {k: {"count": v["count"], "total": v["total"]}
                for k, v in o.items()}
    assert got.observations() == count_total(want.observations())
    ws, gs = want.snapshot(), got.snapshot()
    assert gs == dict(ws, observations=count_total(ws["observations"]))
    assert gs["observations"]["phase.serve_batch"] == {"count": 2,
                                                        "total": 0.75}
