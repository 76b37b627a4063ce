"""A model family joins the benchmark as new files alone: a toy family
(its own generator, cache, program, reference and least-work count), its
configuration, a traffic mix and one ``BENCHMARK.json`` entry, run
through ``harness.run`` and ``control.readings`` on the CPU; a state
field of ``[B, n, 2]`` compared bit by bit; and a configuration that
names no family, or a missing one, refused."""

import json
import os
import shutil
import time

import pytest

from portbench import control, harness, spec
from portbench.tests.smoke import make_root

SEED = 2**31 + 41

# Integer leaky neurons on a random graph in which every neuron has ``k``
# targets (one from each of ``k`` permutations), driven by a Bernoulli
# draw a neuron a step from a torch generator of each lane's seed.  The
# program steps every lane at once; the reference steps one lane at a
# time in numpy.  Its state: v, and a [B, n, 2] field of the last step's
# input and spike.  ``{alter}`` is a statement run on the program's
# final state.
TOY = '''
"""A toy family of the tests."""
import os
import time

import numpy as np
import torch

from portbench import check

STATE = ("v", "last")


def dt_ms(conf):
    return conf["model"]["dt"]


def network(spec, cache_dir):
    path = os.path.join(cache_dir, "toy_{{n}}_{{k}}_{{seed}}.npz".format(
        **spec))
    if not os.path.exists(path):
        rng = np.random.default_rng(spec["seed"])
        dst = np.stack([rng.permutation(spec["n"])
                        for _ in range(spec["k"])], axis=1)
        w = rng.integers(1, 5, size=dst.shape)
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, n=spec["n"], dst=dst, w=w)
    with np.load(path) as z:
        return {{"n": int(z["n"]), "dst": z["dst"], "w": z["w"]}}


def _drive(gen, n, traffic):
    d = traffic["drive"]
    return (torch.rand(n, generator=gen) < d["p"]).to(torch.int32) \\
        * d["weight"]


def program(conf, traffic, net, device):
    m, n = conf["model"], net["n"]
    dst = torch.as_tensor(net["dst"]).reshape(-1)
    w = torch.as_tensor(net["w"], dtype=torch.int32)

    def run(t_steps, seeds, chunk_steps, sink):
        B = len(seeds)
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        v = torch.zeros((B, n), dtype=torch.int32)
        counts = torch.zeros((B, n), dtype=torch.int32)
        last = torch.zeros((B, n, 2), dtype=torch.int32)
        fired = torch.zeros((B, n), dtype=torch.int32)
        t0, s0 = time.perf_counter(), 0
        for t in range(t_steps):
            inp = torch.stack([_drive(g, n, traffic) for g in gens])
            inp.index_add_(1, dst, (fired[:, :, None] * w).reshape(B, -1))
            v = v - (v >> m["shift"]) + inp
            fired = (v > m["th"]).to(torch.int32)
            v = torch.where(fired > 0, 0, v)
            counts += fired
            last = torch.stack([inp, fired], dim=-1)
            if (t + 1) % chunk_steps == 0 or t + 1 == t_steps:
                now = time.perf_counter()
                sink({{"type": "chunk", "step": t + 1, "steps": t + 1 - s0,
                       "wall_s": now - t0}})
                t0, s0 = now, t + 1
        {alter}
        return counts, torch.zeros(B, dtype=torch.int32), (v, last)

    return run


def reference(net, conf, traffic, seeds, t_steps, device, *, record=False,
              control=False):
    """One lane at a time; ``control`` keeps v a bit coarser."""
    m, n, dst, w = conf["model"], net["n"], net["dst"], net["w"]
    spikes = np.zeros(t_steps, np.int64)
    events = np.zeros(t_steps, np.int64)
    out = []
    for s in seeds:
        gen = torch.Generator().manual_seed(s)
        v = np.zeros(n, np.int64)
        counts = np.zeros(n, np.int64)
        fired = np.zeros(n, bool)
        for t in range(t_steps):
            inp = _drive(gen, n, traffic).numpy().astype(np.int64)
            src = np.flatnonzero(fired)
            np.add.at(inp, dst[src].reshape(-1), w[src].reshape(-1))
            events[t] += dst[src].size
            v = v - (v >> m["shift"]) + inp
            if control:
                v = (v >> 1) << 1
            fired = v > m["th"]
            v[fired] = 0
            counts += fired
            spikes[t] += fired.sum()
        out.append((counts, v, np.stack([inp, fired], axis=-1)))

    def lanes(i):
        return torch.as_tensor(np.stack([o[i] for o in out]),
                               dtype=torch.int32)
    return check.Result(counts=lanes(0),
                        dropped=torch.zeros(len(seeds), dtype=torch.int32),
                        state=(lanes(1), lanes(2)),
                        stats={{"spikes": spikes, "events": events}}
                        if record else None)


def least_work(stats, start, stop, scale):
    ev = scale * float(stats["events"][start:stop].sum())
    sp = scale * float(stats["spikes"][start:stop].sum())
    return 8.0 * ev + sp / 8, ev


def small(conf):
    return conf
'''

CONF = {"name": "toy-a", "source": "https://example.org/toy",
        "family": "toy", "network": {"n": 300, "k": 4, "seed": 5},
        "model": {"dt": 0.5, "shift": 2, "th": 40},
        "assumed": ["a toy"], "reduced": []}
TRAFFIC = {"lanes": 3, "t_steps": 40, "chunk_steps": 10,
           "drive": {"p": 0.3, "weight": 20}}


def _write(path, obj):
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


def add_family(root, family, config, alter="pass"):
    """New files alone: the family, its configuration, the traffic mix
    ``toy-b3``; and in ``BENCHMARK.json`` a cell, listed by the per-layer
    metrics.  Returns the cell."""
    pb = os.path.join(root, "portbench")
    _write(os.path.join(pb, "families", family + ".py"),
           TOY.format(alter=alter))
    _write(os.path.join(pb, "configs", config + ".json"),
           {**CONF, "name": config, "family": family})
    _write(os.path.join(pb, "traffic", "toy-b3.json"), TRAFFIC)
    bench = spec.benchmark(root)
    cell = config + "-b3"
    bench["configs"].append({"name": config, "source": CONF["source"],
                             "file": f"portbench/configs/{config}.json",
                             "reduced": [], "why": "a toy family"})
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": "toy-b3", "chips": 1,
                               "why": "a toy family's cell"})
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return cell


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"), t_steps=40)


@pytest.fixture
def root(smoke, tmp_path):
    new = str(tmp_path / "root")
    shutil.copytree(smoke, new)
    return new


def run(root, cell, trace=False):
    return harness.run(root, cell, SEED, 1.0, trace, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_a_family_added_as_files_alone(root, trace):
    cell = add_family(root, "toy", "toy-a")
    out = run(root, cell, trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    want = ({"boundary_ms"} if trace
            else {"bio_s_per_s", "chunk_ms_p95", "setup_s"})
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    # the family's own generator and cache file
    assert os.listdir(os.path.join(root, "build", "portbench")) == [
        "toy_300_4_5.npz"]
    readings = control.readings(root, cell, [SEED], [SEED, SEED + 1], "cpu",
                                log=lambda s: None)
    assert all(v == 0 for v in readings["program_max"].values())
    assert readings["control_min"]["state_mismatch"] > 0


def test_the_toy_reference_spikes_and_its_program_agrees(root):
    """The toy is no empty case: its lanes spike, through the network."""
    add_family(root, "toy", "toy-a")
    conf = spec.config(root, "toy-a")
    fam = spec.family(root, conf)
    net = fam.network(conf["network"], os.path.join(root, "build", "pb"))
    ref = fam.reference(net, conf, TRAFFIC, [1, 2, 3], 40, "cpu",
                        record=True)
    assert int(ref.counts.sum()) > 0 and ref.stats["events"].sum() > 0
    got = fam.program(conf, TRAFFIC, net, "cpu")(40, [1, 2, 3], 10,
                                                  lambda rec: None)
    assert got[2][1].shape == (3, 300, 2)
    from portbench import check
    nums, failed = check.compare([got], ref, fam.STATE)
    assert failed == 0 and not any(nums.values())


def test_a_wider_state_field_is_compared_bit_by_bit(root):
    """The program altered in its ``[B, n, 2]`` field alone."""
    cell = add_family(root, "toy_altered", "toy-x",
                      alter="last = last.clone(); last[0, 7, 1] += 1")
    out = run(root, cell)
    assert not out["correct"]
    assert out["failed"] == out["attempted"] >= 1
    assert out["checks"]["state_mismatch"]["value"] == out["attempted"]
    assert out["checks"]["count_mismatch"]["value"] == 0


@pytest.mark.parametrize("entry", ["harness", "control"])
@pytest.mark.parametrize("family, message", [
    (None, "names no family"),
    ("no_such_family", "no_such_family"),
])
def test_a_configuration_without_its_family_is_refused(root, entry, family,
                                                       message):
    path = os.path.join(root, "portbench", "configs", "flywire-q19.json")
    with open(path) as f:
        conf = json.load(f)
    conf.pop("family")
    if family is not None:
        conf["family"] = family
    _write(path, conf)
    cell = "q19-storm-b32"
    with pytest.raises(ValueError, match=message):
        if entry == "harness":
            run(root, cell)
        else:
            control.readings(root, cell, [SEED], [], "cpu",
                             log=lambda s: None)
    assert not os.path.exists(os.path.join(root, "build"))  # before set-up
