"""The least-work count on a hand-built network whose spikes are known:
every neuron is forced to spike whenever it can (background at p = 1), so
all spike at step 0 and again when their refractory countdown has run
out, and the spikes of step 0 are delivered at step ``delay_steps``."""

import numpy as np
import pytest

from portbench import network, spec, yardstick
from portbench.reference import sim as reference

EDGES = [(0, 1, 3), (0, 2, -2), (1, 3, 1), (4, 0, 300), (3, 4, 1)]
N, B = 5, 2


@pytest.fixture(scope="module")
def stats():
    pre, post, w = (np.array(x) for x in zip(*EDGES))
    net = network.from_edges(N, pre, post, w)
    model = spec.config(spec.ROOT, "flywire-q19")["model"]
    drive = [{"kind": "background", "rate_hz": 1e4}]   # rate * dt = 1
    res = reference.simulate(net, model, drive, [3, 4], 50, "cpu",
                             record=True)
    return res, reference.Model.of(model), len(EDGES)


def test_the_recorded_counts(stats):
    res, m, nnz = stats
    D, R = m.delay_steps, m.ref_steps          # 18, 22
    period = R + 1
    spike_steps = list(range(0, 50, period))
    s = res.stats
    assert np.flatnonzero(s["spikes"]).tolist() == spike_steps
    assert set(s["spikes"][spike_steps]) == {B * N}
    assert np.flatnonzero(s["syn_events"]).tolist() == [
        t + D for t in spike_steps if t + D < 50]
    assert set(s["syn_events"][np.flatnonzero(s["syn_events"])]) == {B * nnz}
    # every countdown moves every step; v and g never do (a forced spike
    # resets v to 0 = v0, and the deliveries land while refractory)
    assert set(s["refrac_changed"]) == {B * N}
    assert not s["v_changed"].any() and not s["g_changed"].any()
    assert set(s["draws"]) == {B * (3 + N)}
    assert np.array_equal(res.counts.numpy(), np.full((B, N), 3))


def test_least_work_of_a_stretch(stats):
    res, m, nnz = stats
    nbytes, ops = yardstick.least_work(res.stats, 0, 24)
    # 24 countdown changes a lane-neuron (read and written, 1 B), one
    # delivery of every synapse (27 bits), two spikes a lane-neuron (one
    # bit written and read)
    assert nbytes == 2 * 1 * B * N * 24 + 27 / 8 * B * nnz + 2 / 8 * 2 * B * N
    assert ops == yardstick.OPS_PER_DRAW * B * (3 + N) * 24 + B * nnz
    t, bound = yardstick.least_seconds(nbytes, ops)
    assert bound == "operations"
    assert t == ops / yardstick.PEAKS["ops_per_s"]


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(3.35e12, 0.0) == (1.0, "bytes")
    assert yardstick.least_seconds(0.0, 66.9e12) == (1.0, "operations")
