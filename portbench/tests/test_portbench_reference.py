"""The benchmark's plain reference against the program, on the CPU at
the tests' size (2,000 neurons, 60,000 synapses): every cell's
configuration and traffic, bitwise, through ``run_trials`` as the window
drives it; and the frozen copies (the network generator, the threefry
stream, the traffic's drive) against the program's originals."""

import numpy as np
import pytest
import torch

from portbench import network, spec
from portbench.reference import threefry
from portbench.tests.smoke import make_root

T = 120


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"), t_steps=T)


def flywire_lif():
    return spec.family(spec.ROOT, {"family": "flywire_lif"})


@pytest.mark.parametrize("n, syn, seed", [(500, 8_000, 0), (2000, 60_000, 3)])
def test_frozen_generator_is_the_programs(n, syn, seed):
    from repro_torch.core.connectome import synthetic_flywire
    ours = network.synthetic_flywire(n, syn, seed)
    theirs = synthetic_flywire(n=n, target_synapses=syn, seed=seed)
    assert ours["n"] == theirs.n
    for k in network.ARRAYS:
        np.testing.assert_array_equal(ours[k], getattr(theirs, k))


def test_network_cache_round_trip(tmp_path):
    sp = {"generator": "synthetic_flywire", "n_neurons": 300,
          "target_synapses": 3000, "seed": 1}
    made = network.load_network(sp, str(tmp_path))
    loaded = network.load_network(sp, str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == \
        ["flywire_300_3000_1.npz"]
    for k in network.ARRAYS:
        np.testing.assert_array_equal(made[k], loaded[k])


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_threefry_copy_is_the_programs(seed):
    from repro_torch import random as prng
    keys = torch.stack([threefry.key(seed), threefry.key(seed ^ 12345)])
    theirs = torch.stack([prng.PRNGKey(seed), prng.PRNGKey(seed ^ 12345)])
    assert torch.equal(keys, theirs)
    assert torch.equal(threefry.split(keys, 3), prng.split(theirs, 3))
    for p, size in ((0.015, 20), (0.02, 1001), (0.002, 4096)):
        assert torch.equal(threefry.bernoulli(keys, p, size),
                           prng.bernoulli(theirs, p, (size,)))


@pytest.mark.parametrize("name", sorted(
    {w["traffic"] for w in spec.benchmark()["workloads"]}))
def test_drive_is_the_named_scenario(name):
    """Each traffic file's drive builds what the program's scenario of the
    same name builds."""
    from repro_torch.exp import build_scenario
    traf = spec.traffic(spec.ROOT, name)
    conf = spec.config(spec.ROOT, "flywire-q19")
    fam = flywire_lif()
    cfg = fam.program_config(conf)

    class C:
        n = 2000
    ours = fam.program_stimulus(traf, C.n)
    theirs = build_scenario(traf["named"]["scenario"], C, cfg,
                            **traf["named"]["params"])
    assert [type(p) for p in ours.parts] == [type(p) for p in theirs.parts]
    for a, b in zip(ours.parts, theirs.parts):
        for f in ("rate_hz", "target", "weight"):
            assert getattr(a, f, None) == getattr(b, f, None)
        if getattr(a, "idx", None) is not None:
            assert torch.equal(a.idx, b.idx)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_reference_equals_the_program(root, cell):
    """Through the configuration's family: its program (``run_trials``
    as the window drives it) and its reference (``reference/sim.py``)."""
    bench = spec.benchmark(root)
    wl = spec.workload(bench, cell)
    conf, traf = spec.config(root, wl["config"]), spec.traffic(
        root, wl["traffic"])
    fam = spec.family(root, conf)
    net = fam.network(conf["network"], root + "/build/portbench")
    seeds = spec.lane_seeds(2**31 + 17, traf["lanes"])
    counts, dropped, state = fam.program(conf, traf, net, "cpu")(
        T, seeds, traf["chunk_steps"], lambda rec: None)
    ref = fam.reference(net, conf, traf, seeds, T, "cpu")
    assert int(ref.counts.sum()) > 0
    assert torch.equal(counts, ref.counts)
    assert torch.equal(dropped, ref.dropped)
    assert len(state) == len(ref.state) == len(fam.STATE) == 3
    for a, b in zip(state, ref.state):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_lane_seeds_fit_32_bits():
    seeds = spec.lane_seeds(2**31 + 123, 64)
    assert len(set(seeds)) == 64
    assert all(0 <= s < 2**31 for s in seeds)
    assert spec.lane_seeds(5, 4) == [20, 21, 22, 23]
