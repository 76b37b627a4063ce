"""The cortical microcircuit family (``families/pd14_lif.py``) at the CPU
tests' size: its cell runs through the harness to ``correct``, traced or
not; its lower-precision control fails; a program whose one synapse is a step
late fails the comparison; its least-work count on a 4-neuron network
whose spikes are known matches a hand count; and its generator keeps to
the published sizes."""

import time

import numpy as np
import pytest
import torch

from portbench import check, control, harness, spec
from portbench.reference import pd14
from portbench.tests.smoke import make_root

SEED = 2**31 + 1234
CELL = "pd14-bg8-b1024"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"), t_steps=60)


def _family(root):
    conf = spec.config(root, "pd14-q19")
    return spec.family(root, conf), conf


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_to_correct(root, trace):
    out = harness.run(root, CELL, SEED, 1.0, trace, "cpu",
                      time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["memory_peak_bytes"] == 0      # no card here
    assert all(v["value"] == 0 for v in out["checks"].values())
    want = ({"boundary_ms"} if trace
            else {"bio_s_per_s", "chunk_ms_p95", "setup_s"})
    assert set(out["metrics"]) == want


def test_the_control_fails(root):
    """The reference in Q23.8 in the program's place (the configuration is
    Q19.12)."""
    out = control.readings(root, CELL, [SEED], [SEED, SEED + 1], "cpu",
                           log=lambda s: None)
    assert all(v == 0 for v in out["program_max"].values())
    assert out["control_min"]["count_mismatch"] > 0
    assert out["control_min"]["state_mismatch"] > 0


def test_the_bfloat16_control_fails_in_float32(root):
    """The configuration in float32: the program still equals the
    reference, and the reference in bfloat16 does not."""
    fam, conf = _family(root)
    conf = {**conf, "model": {**conf["model"], "fixed_point": False}}
    traffic = spec.traffic(root, "bg8-b1024")
    net = fam.network(conf["network"], root + "/build/portbench")
    seeds = spec.lane_seeds(SEED, 2)
    ref = fam.reference(net, conf, traffic, seeds, 60, "cpu")
    got = fam.program(conf, traffic, net, "cpu")(60, seeds, 20,
                                                  lambda rec: None)
    nums, failed = check.compare([got], ref, fam.STATE)
    assert failed == 0 and not any(nums.values())
    ctl = fam.reference(net, conf, traffic, seeds, 60, "cpu", control=True)
    nums, _ = check.compare([(ctl.counts, ctl.dropped, ctl.state)], ref,
                            fam.STATE)
    assert nums["count_mismatch"] > 0 and nums["state_mismatch"] > 0


def test_one_synapse_a_step_late_fails(root):
    fam, conf = _family(root)
    traffic = spec.traffic(root, "bg8-b1024")
    net = fam.network(conf["network"], root + "/build/portbench")
    seeds = spec.lane_seeds(SEED, 2)
    ref = fam.reference(net, conf, traffic, seeds, 60, "cpu")
    fired = ref.counts.sum(0).numpy() > 0
    assert fired.any()
    src = int(np.argmax(fired * np.diff(net["out_indptr"])))  # a busy one
    k = int(net["out_indptr"][src])
    late = dict(net, out_delays=net["out_delays"].copy())
    assert late["out_delays"][k] < net["out_delays"].max()
    late["out_delays"][k] += 1
    got = fam.program(conf, traffic, late, "cpu")(60, seeds, 20,
                                                  lambda rec: None)
    fields: dict = {}
    nums, failed = check.compare([got], ref, fam.STATE, by_field=fields)
    assert failed == 1 and nums["state_mismatch"] > 0
    assert fields["pending"] > 0
    good = fam.program(conf, traffic, net, "cpu")(60, seeds, 20,
                                                  lambda rec: None)
    nums, failed = check.compare([good], ref, fam.STATE)
    assert failed == 0 and not any(nums.values())


# A 4-neuron network, one population, whose drive (a count of mean 64
# events a step, each 40 quanta) puts every neuron over a threshold 0.5 mV
# above rest on its first active step: all spike at step 0 and again each
# R + 1 = 21 steps, v resets to rest and g to 0 on the step they move, and
# every delivery (delays 1-5 steps) lands while its target is refractory.
SYNAPSES = [(0, 1, 1, 1), (0, 2, 2, 3), (1, 3, 1, 2), (2, 0, 3, 5),
            (3, 0, 1, 5), (3, 1, 2, 2)]       # (source, target, w, delay)
N, B, T = 4, 2, 50
# lane-neurons whose slot is read non-zero, by delay after a spike step:
# neuron 1 at +1; neurons 3 and 1 at +2; neuron 2 at +3; neuron 0 at +5
READ_AFTER = {1: 1, 2: 2, 3: 1, 5: 1}


@pytest.fixture(scope="module")
def known():
    src, tgt, w, d = (np.array(x) for x in zip(*SYNAPSES))
    net = {"n": N, "pop_bounds": np.array([0, N]),
           "out_indptr": np.concatenate([[0], np.cumsum(
               np.bincount(src, minlength=N))]),
           "out_indices": tgt.astype(np.int32),
           "out_weights": w.astype(np.int16),
           "out_delays": d.astype(np.int8)}
    conf = spec.config(spec.ROOT, "pd14-q19")
    conf = {**conf, "model": {**conf["model"], "v_th": -64.5},
            "drive": {**conf["drive"], "k_ext": [80000]}}
    drive = [{"kind": "poisson_count", "rate_hz": 8.0}]
    res = pd14.simulate(net, conf, drive, [3, 4], T, "cpu", record=True)
    return net, conf, res


def test_the_recorded_counts(known):
    _, conf, res = known
    R = round(conf["model"]["tau_ref"] / conf["model"]["dt"])    # 20
    spike_steps = list(range(0, T, R + 1))
    s = res.stats
    assert np.flatnonzero(s["spikes"]).tolist() == spike_steps
    assert set(s["spikes"][spike_steps]) == {B * N}
    assert np.flatnonzero(s["syn_events"]).tolist() == spike_steps
    assert set(s["syn_events"][spike_steps]) == {B * len(SYNAPSES)}
    want_read = np.zeros(T, np.int64)
    for t in spike_steps:
        for d, k in READ_AFTER.items():
            if t + d < T:
                want_read[t + d] = B * k
    assert np.array_equal(s["pending_read"], want_read)
    assert set(s["refrac_changed"]) == {B * N}
    assert not s["v_changed"].any() and not s["g_changed"].any()
    assert set(s["draws"]) == {B * (3 + N)}
    assert (s["drive_events"] >= B * N * 15).all()
    assert np.array_equal(res.counts.numpy(), np.full((B, N), 3))


def test_least_work_of_a_stretch(known):
    fam, _ = _family(spec.ROOT)
    _, _, res = known
    nbytes, ops = fam.least_work(res.stats, 0, 24)
    # 24 countdown changes a lane-neuron (1 B read and written); the
    # slots read non-zero after the spikes of steps 0 and 21 (at +1, +2,
    # +3, +5; and +1, +2), 4 B read and written; two deliveries of every
    # synapse, its 4-byte word read and 4 bytes added
    reads = B * (1 + 2 + 1 + 1) + B * (1 + 2)
    assert nbytes == (2 * 1 * B * N * 24 + 2 * 4 * reads
                      + 2 * 8 * B * len(SYNAPSES))
    assert ops == 70 * B * (3 + N) * 24 + 2 * B * len(SYNAPSES)


def test_the_program_agrees_on_the_known_network(known):
    net, conf, res = known
    fam, _ = _family(spec.ROOT)
    traffic = {"drive": [{"kind": "poisson_count", "rate_hz": 8.0}]}
    counts, dropped, state = fam.program(conf, traffic, net, "cpu")(
        T, [3, 4], 10, lambda rec: None)
    assert torch.equal(counts, res.counts)
    assert torch.equal(state[3], res.pending)


def test_the_generator_keeps_the_published_sizes():
    fam, conf = _family(spec.ROOT)
    N_, K = fam.sizes(conf["network"])
    assert int(N_.sum()) == 77169 and int(K.sum()) == 298_880_968
    N_, K = fam.sizes(fam.small(conf)["network"])
    assert int(N_.sum()) == 1544 and int(K.sum()) == 119_729


def test_the_small_network(tmp_path):
    fam, conf = _family(spec.ROOT)
    spec_ = fam.small(conf)["network"]
    net = fam.network(spec_, str(tmp_path))
    again = fam.network(spec_, str(tmp_path))      # from the cache
    N_, K = fam.sizes(spec_)
    bounds = net["pop_bounds"]
    assert net["n"] == 1544 and len(net["out_indices"]) == int(K.sum())
    for k in fam.ARRAYS:
        assert np.array_equal(net[k], again[k])
    tgt, src = net["out_indices"], np.repeat(
        np.arange(net["n"]), np.diff(net["out_indptr"]))
    pop_of = np.repeat(np.arange(8), np.diff(bounds))
    # each (target, source) pair of populations holds its K synapses
    pairs = np.zeros((8, 8), np.int64)
    np.add.at(pairs, (pop_of[tgt], pop_of[src]), 1)
    assert np.array_equal(pairs, K)
    # excitatory sources' weights positive, inhibitory negative; delays of
    # at least a step
    exc = np.isin(pop_of[src], [0, 2, 4, 6])
    w = net["out_weights"]
    assert (w[exc] > 0).all() and (w[~exc] < 0).all()
    assert net["out_delays"].min() >= 1
    assert abs(float(w[exc & ~((pop_of[tgt] == 0) & (pop_of[src] == 2))]
                     .mean()) - 39.91) < 0.5
