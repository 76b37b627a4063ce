"""What the benchmark loads: a fresh interpreter imports every module of
``portbench``, every family file and the modules a run calls into, and
holds no JAX, no ``jaxlib``, no ``flax`` and nothing of the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``); each family's network and plain reference load nothing of the
program; nothing reads the JAX package's benchmark records."""

import os
import pkgutil
import subprocess
import sys

import pytest

import portbench
from portbench import spec

CHECK = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib
for name in {mods!r}:
    importlib.import_module(name)
{extra}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


FAMILIES = sorted(f[:-3] for f in os.listdir(
    os.path.join(spec.PACKAGE, "families")) if f.endswith(".py"))

# the family's network and reference at the tests' size, in every cell
# whose configuration names it, with and without the control
REFERENCE = """
from portbench import spec
seen = set()
for w in spec.benchmark()["workloads"]:
    conf = spec.config(spec.ROOT, w["config"])
    if conf["family"] != {name!r} or (w["config"], w["traffic"]) in seen:
        continue
    seen.add((w["config"], w["traffic"]))
    fam = spec.family(spec.ROOT, conf)
    conf = fam.small(conf)
    traf = spec.traffic(spec.ROOT, w["traffic"])
    net = fam.network(conf["network"], {cache!r})
    ref = fam.reference(net, conf, traf, [1, 2], 4, "cpu", record=True)
    fam.least_work(ref.stats, 0, 4, 1.0)
    fam.reference(net, conf, traf, [1, 2], 4, "cpu", control=True)
assert seen, "no cell's configuration names the family"
"""


def _modules(pkg_path, prefix):
    out = []
    for m in pkgutil.walk_packages([pkg_path], prefix):
        if ".tests" not in m.name and not m.name.endswith(".tests"):
            out.append(m.name)
    return out


def _loaded(mods, extra=""):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-c", CHECK.format(
            root=spec.ROOT, src=os.path.join(spec.ROOT, "src"), mods=mods,
            extra=extra)],
        capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules(os.path.dirname(portbench.__file__), "portbench.")
    assert "portbench.harness" in mods and "portbench.reference.sim" in mods
    # the modules harness.run imports when it runs
    mods += ["repro_torch.obs", "repro_torch.core", "repro_torch.exp",
             "repro_torch.exp.trials",
             "repro_torch.core.engines.blocked_fused",
             "repro_torch.kernels.spike_prop.ops"]
    tops = _loaded(mods, extra=(
        "from portbench import spec\n"
        "for m in spec.benchmark()['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        f"for f in {FAMILIES!r}:\n"
        "    spec.family(spec.ROOT, {'family': f})"))
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("name", FAMILIES)
def test_the_reference_loads_nothing_of_the_program(name, tmp_path):
    tops = _loaded(["portbench.reference.sim", "portbench.reference.threefry",
                    "portbench.network", "portbench.check",
                    "portbench.yardstick", "portbench.spec"],
                   extra=REFERENCE.format(name=name, cache=str(tmp_path)))
    assert "torch" in tops
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_nothing_reads_the_jax_packages_benchmarks():
    pkg = os.path.dirname(portbench.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and not dirpath.endswith("tests"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert "BENCH_" not in text and "benchmarks" not in text, f


def test_the_check_compares_whole_top_level_names():
    from portbench import harness
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["repro_torch", "repro.core.engine", "jax.numpy", "flax"]) == [
            "flax", "jax", "repro"]
