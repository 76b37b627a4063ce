"""The program's step-phase switch (``repro_torch.obs.phases``) stays off in
every telemetry session the harness opens, traced or not: no session of
a run has it on, no chunk event carries ``phases``, and the metrics are
the ones the cell reports without it.  The marks' event class is swapped
for a host-clock stand-in, so that a switch turned on would mark the
CPU run too."""

import time

import pytest

from portbench import harness, spec
from portbench.tests.smoke import make_root

SEED = 2**31 + 7
CELL = spec.benchmark()["workloads"][0]["name"]


class HostEvent:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, later):
        return (later.t - self.t) * 1e3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"), t_steps=40)


@pytest.mark.parametrize("trace", [False, True])
def test_the_harness_leaves_the_phase_switch_off(root, monkeypatch, trace):
    from repro_torch import obs
    from repro_torch.obs import phases
    monkeypatch.setattr(phases, "event_class", lambda device: HostEvent)
    seen = []
    emit = obs.Telemetry.emit

    def spy(self, type_, **fields):
        seen.append((self.phases, type_, fields))
        return emit(self, type_, **fields)

    monkeypatch.setattr(obs.Telemetry, "emit", spy)
    out = harness.run(root, CELL, SEED, 1.0, trace, "cpu",
                      time.perf_counter())
    assert out["correct"]
    chunks = [f for _, kind, f in seen if kind == "chunk"]
    assert chunks and not any("phases" in f or "drain_s" in f
                              for f in chunks)
    assert not any(on for on, _, _ in seen)
    want = ({"boundary_ms"} if trace
            else {"bio_s_per_s", "chunk_ms_p95", "setup_s"})
    assert set(out["metrics"]) == want
