"""The port stands alone: repro_torch and chip_smoke.py import with JAX
blocked, mention neither JAX nor the JAX package, and never fall back to
the CPU on their own."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import jax
import pytest
import torch

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_with_jax_blocked():
    names = _modules()
    for name in ("repro_torch.kernels.spike_prop.kernel",
                 "repro_torch.kernels.lif.kernel",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.models.transformer",
                 "repro_torch.configs.qwen2_5_14b",
                 "repro_torch.obs.jit",
                 "repro_torch.serving.engine",
                 "repro_torch.core.compaction",
                 "repro_torch.core.engines.event",
                 "repro_torch.core.exchange.blocked",
                 "repro_torch.core.distributed",
                 "repro_torch.core.health",
                 "repro_torch.train.checkpoint",
                 "repro_torch.launch.simulate",
                 "repro_torch.launch.serve",
                 "repro_torch.serving.sim",
                 "repro_torch.core.exchange.faulty",
                 "repro_torch.obs.events",
                 "repro_torch.obs.schema",
                 "repro_torch.obs.trace",
                 "repro_torch.obs.profiler",
                 "repro_torch.obs.report",
                 "repro_torch.obs.check",
                 "repro_torch.core.engines.dense",
                 "repro_torch.core.engines.ell",
                 "repro_torch.core.engines.binned",
                 "repro_torch.optim.adamw",
                 "repro_torch.optim.compress",
                 "repro_torch.data.pipeline",
                 "repro_torch.train.train_step",
                 "repro_torch.train.fault",
                 "repro_torch.launch.train",
                 "repro_torch.configs.phi3_medium_14b",
                 "repro_torch.configs.command_r_35b",
                 "repro_torch.configs.gemma3_12b",
                 "repro_torch.configs.grok1_314b",
                 "repro_torch.configs.llama4_scout_17b_a16e",
                 "repro_torch.configs.shapes",
                 "repro_torch.models.rglru",
                 "repro_torch.models.rwkv6",
                 "repro_torch.configs.recurrentgemma_2b",
                 "repro_torch.configs.rwkv6_7b",
                 "repro_torch.configs.whisper_medium",
                 "repro_torch.configs.llava_next_34b",
                 "repro_torch.parallel",
                 "repro_torch.parallel.sharding",
                 "repro_torch.parallel.act",
                 "repro_torch.parallel.pipeline",
                 "repro_torch.launch.mesh",
                 "repro_torch.kernels.spike_prop.ref",
                 "repro_torch.launch.hlo",
                 "repro_torch.launch.build",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.roofline",
                 "repro_torch.launch.flywire_dryrun"):
        assert name in names, name
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "import chip_smoke\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and (m in ('jax', 'repro') or m.startswith(('jax.', 'jaxlib', "
            "'repro.')))]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b|"
    r"import\s+repro(\.|\s|$)|from\s+repro(\.|\s))", re.M)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_or_reference_imports_in_sources():
    seen = 0
    for path in _sources():
        with open(path) as fh:
            text = fh.read()
        assert not _FORBIDDEN.search(text), path
        assert "importlib.import_module(\"repro." not in text, path
        seen += 1
    assert seen > 20


def test_simulate_without_device_needs_cuda():
    from repro_torch.core import SimConfig, resolve_device, simulate
    from repro_torch.core.connectome import synthetic_flywire
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    c = synthetic_flywire(200, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(c, SimConfig(), 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        from repro_torch.core import build_synapses
        build_synapses(c, SimConfig())
    from repro_torch.launch import serve
    from repro_torch.serving import SimServer
    with pytest.raises(RuntimeError, match="CUDA"):
        SimServer(c, SimConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--n", "200"])
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticLM(vocab=50, seq=4, global_batch=2).batch_at(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_without_cuda_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
