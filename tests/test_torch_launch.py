"""The port's ``launch/`` cost tools (hlo, build, dryrun, roofline,
flywire_dryrun) against the JAX package's, on the CPU.

* ``model_flops`` and ``analytic_traffic`` of all ten configs x four
  cells equal to the reference's; ``analyse_record`` equal to the
  reference's on the records of ``tests/test_hlo_roofline.py`` when
  given the reference's constants.
* The counted dot FLOPs (:func:`repro_torch.launch.hlo.count` on meta
  tensors) equal to ``analyze_hlo`` of the reference's compiled program:
  the SMOKE prefill and decode step of every config, and the train step
  (2 microbatches, remat) of qwen2.5, grok-1, recurrentgemma and rwkv6,
  rwkv6 without remat too (ROADMAP finding 15: its WKV readout's
  backward and recomputation).
* The specs (batch, cache, logits, policy) and ``analytic_bytes`` of
  :func:`repro_torch.launch.build.build_step` equal to the reference's
  ``build_step`` on (2, 2) and (2, 2, 2) meshes of 8 XLA host devices (a
  subprocess); the link bytes of the sharded train step the payloads
  times the ring factors.
* The meta count equal to the same call's count on real CPU tensors
  (the recurrent scans run once under ``repeat`` on meta, unrolled on
  the CPU): FLOPs, bytes and launches exactly, the peak exactly without
  grad and within :data:`PEAK_RTOL` under grad.
* ``dryrun --all --smoke`` on both host meshes gives a record for every
  supported cell (the counterpart of ``tests/test_dryrun_smoke.py``).
* The FlyWire dry run at a small n: the partition array-equal to the
  reference's, the window's count the same on meta and on real arrays
  whatever the spikes.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_arch_names
from repro.configs import get_config as ref_config
from repro.configs import shapes as ref_shapes
from repro.core import CoreBudget as RefBudget
from repro.core import greedy_partition as ref_greedy
from repro.core import synthetic_flywire as ref_flywire
from repro.core.dcsr import build_dcsr as ref_dcsr
from repro.core.partition import caps_from_budget as ref_caps
from repro.core.partition import pad_to_uniform as ref_pad
from repro.launch import roofline as ref_roofline
from repro.launch.hlo import analyze_hlo
from repro.models import model as ref_model
from repro.models.param import split_tree
from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import init_train_state as ref_init_state
from repro_torch.configs import get_config
from repro_torch.configs.flywire import SMOKE as FW_SMOKE
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.core.capacity import CapacityConfig
from repro_torch.core.connectome import synthetic_flywire
from repro_torch.exp.stimulus import legacy_stimulus
from repro_torch.kernels.flash_attention.kernel import kept_pairs
from repro_torch.launch import build as B
from repro_torch.launch import dryrun, flywire_dryrun, hlo, roofline
from repro_torch.launch.mesh import mesh_layout
from repro_torch.models import decode_step, init_params, loss_fn, prefill
from repro_torch.models.model import _abstract_module
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train.train_step import init_train_state, make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = all_arch_names()
TRAIN_ARCHS = ["qwen2.5-14b", "grok-1-314b", "recurrentgemma-2b",
               "rwkv6-7b"]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: The counted peak under grad against the unrolled run's: a repeated
#: scan holds the other steps' retained bytes as one sum (read: 3.1% at
#: most, recurrentgemma over three 64-step chunks).
PEAK_RTOL = 0.05
#: The reference's constants (TPU v5e), passed in to compare the
#: arithmetic of analyse_record; nothing of the port states them.
REF_PEAKS = {"flops": 197e12, "hbm_bw": 819e9, "link_bw": 50e9}


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_count_once(monkeypatch):
    """The reference's ``count_params`` traces the model's init: once a
    config."""
    monkeypatch.setattr(ref_roofline, "count_params", functools.lru_cache(
        maxsize=None)(ref_roofline.count_params))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_traffic_match_reference(arch, ref_count_once):
    for cell in SHAPES:
        assert roofline.model_flops(arch, cell) == \
            ref_roofline.model_flops(arch, cell)
        for chips, meta in ((256, {"mesh": {"data": 16, "model": 16},
                                   "microbatches": 8}),
                            (512, {"mesh": {"pod": 2, "data": 16,
                                            "model": 16},
                                   "microbatches": 16}),
                            (4, {})):
            assert roofline.analytic_traffic(arch, cell, chips, meta) == \
                ref_roofline.analytic_traffic(arch, cell, chips, meta)


ROOF_RECORDS = [
    {"arch": "qwen2.5-14b", "cell": "train_4k", "mesh": "16x16",
     "n_devices": 256, "kind": "train",
     "meta": {"mesh": {"data": 16, "model": 16}, "microbatches": 8},
     "memory": {"peak_device_bytes": 8 * 2**30},
     "cost": {"flops_per_device": 6e14, "bytes_per_device": 3e11},
     "collectives": {"link_bytes": 2e9}},
    {"arch": "qwen2.5-14b", "cell": "decode_32k", "mesh": "16x16",
     "n_devices": 256, "kind": "decode",
     "meta": {"mesh": {"data": 16, "model": 16}},
     "memory": {"peak_device_bytes": 8 * 2**30},
     "cost": {"flops_per_device": 1e10, "bytes_per_device": 3e11},
     "collectives": {"link_bytes": 1e7}},
]


@pytest.mark.parametrize("rec", ROOF_RECORDS, ids=["train", "decode"])
def test_analyse_record_matches_reference(rec):
    want = ref_roofline.analyse_record(rec)
    got = roofline.analyse_record(rec, peaks=REF_PEAKS)
    for k in ("compute_s", "memory_s", "collective_s"):
        assert got["terms"][k] == want["terms"][k]
    assert got["terms"]["counted_bytes_bound_s"] == \
        want["terms"]["hlo_bytes_bound_s"]
    for k in ("dominant", "model_flops", "useful_ratio",
              "step_time_bound_s", "roofline_frac"):
        assert got[k] == want[k], k


def test_h100_peaks_follow_dtype_and_backend():
    rec = dict(ROOF_RECORDS[0], meta=dict(ROOF_RECORDS[0]["meta"],
                                          compute_dtype="float32",
                                          backend="gloo"))
    t = roofline.analyse_record(rec)["terms"]
    assert t["compute_s"] == 6e14 / 66.9e12
    assert t["collective_s"] == 2e9 / 64e9
    assert t["counted_bytes_bound_s"] == 3e11 / 3.35e12
    rec["meta"].update(compute_dtype="bfloat16", backend="nccl")
    t = roofline.analyse_record(rec)["terms"]
    assert t["compute_s"] == 6e14 / 989.4e12
    assert t["collective_s"] == 2e9 / 450e9


# ---------------------------------------------------------------------------
# dot FLOPs against analyze_hlo
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    cfg = ref_config(arch, smoke=True)
    vals, _ = split_tree(jax.eval_shape(
        functools.partial(ref_model._init, cfg=cfg), jax.random.PRNGKey(0)))
    return cfg, vals


def ref_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def port_count(fn, *args, grad=False, resident=()):
    with torch.set_grad_enabled(grad), \
            hlo.count("meta", resident=resident) as c:
        fn(*args)
    return c.cost


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_flops_match_analyze_hlo(arch):
    rcfg, vals = ref_params(arch)
    cfg = get_config(arch, smoke=True)
    module = _abstract_module(cfg)
    max_len = cfg.dec_max if cfg.is_encdec else 64
    rins = ref_shapes.input_specs(rcfg, "prefill_32k", smoke_scale=True)
    want = ref_flops(lambda p, b: ref_model.prefill(p, b, rcfg, max_len),
                     vals, rins["batch"])
    ins = input_specs(cfg, "prefill_32k", smoke_scale=True)
    got = port_count(lambda: prefill(module, ins["batch"], cfg, max_len))
    assert got.flops == want

    rins = ref_shapes.input_specs(rcfg, "decode_32k", smoke_scale=True)
    rcache = ref_shapes.cache_specs(rcfg, "decode_32k", smoke_scale=True)
    want = ref_flops(lambda p, c, t, pos: ref_model.decode_step(
        p, c, t, pos, rcfg), vals, rcache, rins["tokens"], rins["pos"])
    ins = input_specs(cfg, "decode_32k", smoke_scale=True)
    cache = B.cache_specs(cfg, "decode_32k", smoke_scale=True)
    got = port_count(lambda: decode_step(module, cache, ins["tokens"],
                                         ins["pos"], cfg))
    assert got.flops == want


@pytest.mark.parametrize("arch,remat", [(a, True) for a in TRAIN_ARCHS]
                         + [("rwkv6-7b", False)],
                         ids=TRAIN_ARCHS + ["rwkv6-7b-no_remat"])
def test_train_step_flops_match_analyze_hlo(arch, remat):
    rcfg, vals = ref_params(arch)
    rcfg = dataclasses.replace(rcfg, remat=remat)
    opt = RefAdamW(lr=ref_cosine(3e-4, 2000, 100_000))
    astate = jax.eval_shape(lambda ap: ref_init_state(ap, opt), vals)
    rbatch = ref_shapes.input_specs(rcfg, "train_4k",
                                    smoke_scale=True)["batch"]
    want = ref_flops(ref_make_train_step(rcfg, opt, microbatches=2),
                     astate, rbatch)

    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    module = _abstract_module(cfg)
    popt = AdamW(lr=cosine_schedule(3e-4, 2000, 100_000))
    state = init_train_state(module, popt)
    batch = input_specs(cfg, "train_4k", smoke_scale=True)["batch"]
    got = port_count(make_train_step(cfg, popt, microbatches=2), state,
                     batch, grad=True)
    assert got.flops == want


# ---------------------------------------------------------------------------
# meta against real CPU tensors; repeat against the unrolled loop
# ---------------------------------------------------------------------------


def _real(spec, vocab):
    rng = np.random.default_rng(0)
    if spec.dtype in (torch.int32, torch.int64):
        return torch.from_numpy(rng.integers(0, vocab, spec.shape)).to(
            spec.dtype)
    return torch.from_numpy(rng.standard_normal(spec.shape).astype(
        np.float32)).to(spec.dtype)


def _both(cfg, run):
    """``run(module, to_device)`` counted on meta and on real CPU
    tensors: the two costs."""
    out = {}
    for dev in ("meta", "cpu"):
        module = (_abstract_module(cfg) if dev == "meta"
                  else init_params(0, cfg, device="cpu"))

        def to(spec):
            return spec if dev == "meta" else _real(spec, cfg.vocab)
        out[dev] = run(module, to, dev)
    return out["meta"], out["cpu"]


RECURRENT = ["rwkv6-7b", "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_meta_prefill_count_equals_the_cpu_run(arch):
    """Without grad the repeated scan is the unrolled loop, peak too."""
    cfg = get_config(arch, smoke=True)
    specs = input_specs(cfg, "prefill_32k", smoke_scale=True)["batch"]

    def run(module, to, dev):
        batch = {k: to(v) for k, v in specs.items()}
        with torch.no_grad(), hlo.count(dev, resident=module) as c:
            prefill(module, batch, cfg, 64)
        assert ("scan", 64) in c.cost.trips or dev == "cpu"
        return c.cost
    meta, cpu = _both(cfg, run)
    assert (meta.flops, meta.bytes, meta.launches, meta.peak_bytes) == \
        (cpu.flops, cpu.bytes, cpu.launches, cpu.peak_bytes)
    assert cpu.trips == [] and meta.trips


def _close_peak(meta, cpu):
    assert (meta.flops, meta.bytes, meta.launches) == \
        (cpu.flops, cpu.bytes, cpu.launches)
    assert abs(meta.peak_bytes - cpu.peak_bytes) <= \
        PEAK_RTOL * cpu.peak_bytes


@pytest.mark.parametrize("arch", RECURRENT)
def test_meta_train_step_count_equals_the_cpu_run(arch):
    cfg = get_config(arch, smoke=True)
    specs = input_specs(cfg, "train_4k", smoke_scale=True)["batch"]

    def run(module, to, dev):
        opt = AdamW(lr=cosine_schedule(3e-4, 2000, 100_000))
        state = init_train_state(module, opt)
        step = make_train_step(cfg, opt, microbatches=2)
        batch = {k: to(v) for k, v in specs.items()}
        with hlo.count(dev, resident=(module, state.opt)) as c:
            step(state, batch)
        return c.cost
    _close_peak(*_both(cfg, run))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_meta_gradient_over_chunks_equals_the_cpu_run(arch, remat):
    """130 steps: two whole 64-step chunks and a ragged one under remat,
    one unchunked scan without."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    spec = torch.empty((2, 130), dtype=torch.int32, device="meta")

    def run(module, to, dev):
        batch = {"tokens": to(spec), "labels": to(spec)}
        with hlo.count(dev, resident=module) as c:
            loss = loss_fn(module, batch, cfg)
            torch.autograd.grad(loss, list(module.parameters()))
        return c.cost
    _close_peak(*_both(cfg, run))


# ---------------------------------------------------------------------------
# build_step against the reference's, in a subprocess with 8 host devices
# ---------------------------------------------------------------------------

BUILD_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax
    jax.config.update("jax_threefry_partitionable", True)
    from repro.configs import all_arch_names, get_config
    from repro.configs.shapes import SHAPES, cache_specs, cell_supported
    from repro.launch.build import analytic_bytes, build_step
    from repro.launch.mesh import make_host_mesh

    def js(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def keyed(avals, shardings):
        out = []
        for (path, a), s in zip(
                jax.tree_util.tree_flatten_with_path(avals)[0],
                jax.tree.leaves(shardings)):
            out.append([[getattr(k, "key", getattr(k, "idx", None))
                         for k in path], list(a.shape), js(s.spec)])
        return out

    res = {}
    for name, mesh in (("2x2", make_host_mesh(2, 2)),
                       ("2x2x2", make_host_mesh(2, 2, pod=2))):
        for arch in all_arch_names():
            for cell in SHAPES:
                if not cell_supported(get_config(arch), cell)[0]:
                    continue
                b = build_step(arch, cell, mesh, smoke=True,
                               microbatches=2)
                rec = {"policy": {k: js(v) for k, v in b.policy.items()},
                       "analytic": analytic_bytes(b)}
                if b.kind in ("train", "prefill"):
                    rec["batch"] = {k: js(s.spec) for k, s in
                                    b.in_shardings[1].items()}
                if b.kind == "prefill":
                    out = jax.eval_shape(b.fn, *b.in_avals)
                    rec["cache"] = keyed(out[1], b.out_shardings[1])
                    rec["logits"] = js(b.out_shardings[0].spec)
                if b.kind == "decode":
                    rec["cache"] = keyed(b.in_avals[1], b.in_shardings[1])
                    rec["batch"] = {"tokens": js(b.in_shardings[2].spec)}
                    rec["logits"] = js(b.out_shardings[0].spec)
                res[f"{name}|{arch}|{cell}"] = rec
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)
    print("BUILD_OK")
""")


@pytest.fixture(scope="module")
def ref_builds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("build") / "out.json")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", BUILD_SCRIPT, out],
                       capture_output=True, text=True, timeout=600,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _norm(spec) -> list:
    """A spec as JSON: 1-tuples as their axis, trailing Nones dropped."""
    out = [e[0] if isinstance(e, (list, tuple)) and len(e) == 1 else
           list(e) if isinstance(e, (list, tuple)) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def _port_cache_specs(cfg, specs) -> dict:
    """The port's per-layer cache specs keyed as the reference's leaves:
    (scan, j, key) / (tail, t, key) / (self|cross, key), one spec each
    (every layer of a stacked leaf must give the same)."""
    out = {}

    def put(key, spec):
        assert out.setdefault(key, _norm(spec)) == _norm(spec), key
    if cfg.is_encdec:
        for part in ("self", "cross"):
            for layer in specs[part]:
                for k, s in layer.items():
                    put((part, k), s)
        return out
    pat = len(cfg.block_pattern)
    n_scan = cfg.n_layers // pat * pat
    for i, layer in enumerate(specs):
        for k, s in layer.items():
            put(("scan", i % pat, k) if i < n_scan
                else ("tail", i - n_scan, k), s)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_build_specs_and_analytic_bytes_match_reference(ref_builds, mesh,
                                                        arch):
    layout = mesh_layout(*MESHES[mesh])
    cfg = get_config(arch, smoke=True)
    seen = 0
    for cell in SHAPES:
        key = f"{mesh}|{arch}|{cell}"
        if key not in ref_builds:
            continue
        seen += 1
        want = ref_builds[key]
        b = B.build_step(arch, cell, layout, smoke=True, microbatches=2)
        assert B.analytic_bytes(b, layout) == want["analytic"], cell
        assert {k: _norm(v) for k, v in b.policy.items()} == \
            {k: _norm(v) for k, v in want["policy"].items()}, cell
        batch = (b.in_shardings[1] if b.kind != "decode"
                 else {"tokens": b.in_shardings[2]})
        assert {k: _norm(v) for k, v in batch.items()} == \
            {k: _norm(v) for k, v in want["batch"].items()}, cell
        if b.kind == "train":
            continue
        assert _norm(b.out_shardings[0]) == _norm(want["logits"]), cell
        cache = (b.out_shardings[1] if b.kind == "prefill"
                 else b.in_shardings[1])
        ref = {}
        for path, _, spec in want["cache"]:
            spec = _norm(spec)
            # a stacked leaf's leading dim is the layers' (never sharded)
            ref[tuple(path)] = (_norm(spec[1:]) if path[0] in (
                "scan", "self", "cross") else spec)
        assert _port_cache_specs(cfg, cache) == ref, cell
    assert seen >= 3


def _gathered_link(spec, shape, itemsize, sizes) -> float:
    """The link bytes of ``parallel.sharding.gather`` of one leaf: each
    sharded dim all-gathered in turn, (g - 1) / g of the result."""
    cur = list(shape)
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        cur[i] //= np.prod([sizes[a] for a in axes if a])
    total = 0.0
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        g = int(np.prod([sizes[a] for a in axes]))
        cur[i] *= g
        if g > 1:
            total += (g - 1) / g * np.prod(cur) * itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_train_link_bytes_are_payloads_times_ring_factors(mesh):
    layout = mesh_layout(*MESHES[mesh])
    sizes = layout.sizes
    b = B.build_step("qwen2.5-14b", "train_4k", layout, smoke=True,
                     microbatches=2)
    cost = B.count_step(b)
    params, specs = b.in_avals[0], b.in_shardings[0]
    gathers = sum(_gathered_link(specs[k], p.shape, p.element_size(),
                                 sizes) for k, p in params.items())
    n_gathers = sum(sum(e is not None and np.prod(
        [sizes[a] for a in (e if isinstance(e, tuple) else (e,))]) > 1
        for e in specs[k]) for k in params)
    g = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
    # the gradients (float32) and the loss, all-reduced over the data axes
    reduces = 2 * (g - 1) / g * (4 * sum(p.numel() for p in params.values())
                                 + 4)
    assert cost.coll_count == {"all-gather": n_gathers,
                               "all-reduce": len(params) + 1}
    assert cost.coll_bytes["all-gather"] == pytest.approx(gathers,
                                                          rel=1e-12)
    assert cost.coll_bytes["all-reduce"] == pytest.approx(reduces,
                                                          rel=1e-12)
    assert cost.link_bytes == pytest.approx(gathers + reduces, rel=1e-12)


# ---------------------------------------------------------------------------
# dryrun --all --smoke
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
def test_dryrun_all_smoke_gives_a_record_for_every_cell(mesh, tmp_path):
    recs = dryrun.main(["--all", "--smoke", "--mesh", mesh, "--out",
                        str(tmp_path)])
    supported = [(a, c) for a, c, ok, _ in dryrun.iter_cells() if ok]
    done = [r for r in recs if "skipped" not in r]
    assert [(r["arch"], r["cell"]) for r in done] == supported
    assert len(os.listdir(tmp_path)) == len(supported)
    for r in done:
        assert r["cost"]["flops_per_device"] > 0, r["arch"]
        assert r["memory"]["peak_device_bytes"] >= \
            r["analytic_bytes"]["params"] > 0
        assert r["fits"] is True
        assert r["n_devices"] == int(np.prod([int(x) for x in
                                              mesh.split("x")]))
        assert (r["collectives"]["link_bytes"] > 0) == (r["kind"] ==
                                                        "train")
    rows = [roofline.analyse_record(r) for r in done]
    assert all(r["step_time_bound_s"] > 0 for r in rows)
    assert roofline.to_markdown(rows).count("\n") == len(rows) + 2


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "rwkv6-7b",
                                  "whisper-medium"])
def test_inference_mode_counts_as_no_grad(arch):
    """Under inference_mode composite ops (matmul) reach the dispatch
    mode whole; the counter decomposes them: the same count as under
    no_grad, where autograd decomposes them first (ServingEngine and
    chip_smoke.py serve under inference_mode)."""
    cfg = get_config(arch, smoke=True)
    module = _abstract_module(cfg)
    ins = input_specs(cfg, "prefill_32k", smoke_scale=True)["batch"]
    max_len = cfg.dec_max if cfg.is_encdec else 64
    got = {}
    for mode in (torch.no_grad, torch.inference_mode):
        with mode(), hlo.count() as c:
            prefill(module, ins, cfg, max_len)
        k = c.cost
        got[mode] = (k.flops, k.bytes, k.launches, k.peak_bytes)
    assert got[torch.no_grad] == got[torch.inference_mode]
    assert got[torch.no_grad][0] > 0


def test_flash_is_charged_once_a_layer_on_meta():
    cfg = dataclasses.replace(get_config("qwen2.5-14b", smoke=True),
                              attention_impl="pallas")
    module = _abstract_module(cfg)
    ins = input_specs(cfg, "prefill_32k", smoke_scale=True)["batch"]
    cost = port_count(lambda: prefill(module, ins, cfg, 64))
    chunked = port_count(lambda: prefill(
        module, ins, dataclasses.replace(cfg, attention_impl="chunked"),
        64))
    assert cost.kernels == {"flash_attention": cfg.n_layers}
    B_, S_ = ins["tokens"].shape
    pairs = kept_pairs(S_, S_, True, None)
    assert pairs == S_ * (S_ + 1) // 2
    assert cost.flops - 4 * B_ * cfg.n_heads * cfg.d_head * pairs \
        * cfg.n_layers == chunked.flops - 4 * B_ * cfg.n_heads \
        * cfg.d_head * S_ * S_ * cfg.n_layers


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (7, 7, True, None), (7, 9, False, None), (9, 9, True, 3),
    (64, 40, True, 16), (5, 5, False, 2)])
def test_kept_pairs_counts_the_kernels_mask(Sq, Skv, causal, window):
    i = np.arange(Sq)[:, None]
    j = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j >= i - window
    assert kept_pairs(Sq, Skv, causal, window) == int(keep.sum())


# ---------------------------------------------------------------------------
# flywire dry run
# ---------------------------------------------------------------------------

FW_N, FW_SYN, FW_CORES = 1_200, 24_000, 6


def test_flywire_partition_matches_reference():
    c = synthetic_flywire(FW_N, seed=0, target_synapses=FW_SYN)
    d = flywire_dryrun.partition(c, FW_CORES)
    rc = ref_flywire(FW_N, seed=0, target_synapses=FW_SYN)
    p = ref_greedy(rc, ref_caps(RefBudget.tpu_vmem(), "sar"), scheme="sar")
    rd = ref_dcsr(rc, ref_pad(p, FW_CORES, rc.n), quantize_bits=9)
    assert (d.n_parts, d.part_size, d.s_max) == \
        (rd.n_parts, rd.part_size, rd.s_max)
    for f in ("perm", "inv_perm", "syn_src", "syn_tgt_local", "syn_w",
              "cum_neurons"):
        np.testing.assert_array_equal(getattr(d, f), getattr(rd, f), f)


@pytest.mark.parametrize("scheme", ["event", "bitmap"])
def test_flywire_window_count_does_not_depend_on_the_spikes(scheme):
    c = synthetic_flywire(FW_N, seed=0, target_synapses=FW_SYN)
    d = flywire_dryrun.partition(c, FW_CORES)
    cap = CapacityConfig(spike_capacity=64, syn_budget=4096)
    sim = FW_SMOKE.sim
    costs = [flywire_dryrun.count_window(d, sim, scheme, 18, cap)]
    rng = np.random.default_rng(0)
    # no drive (the default: no sugar neurons), then sugar neurons driven
    # harder and harder: the same stimulus, other values
    for frac, rate, seed in ((0.0, 150.0, 0), (0.05, 150.0, 3),
                             (0.5, 5000.0, 1)):
        idx = rng.choice(FW_N, int(frac * FW_N), replace=False)
        stim = legacy_stimulus(dataclasses.replace(sim, poisson_rate_hz=rate),
                               FW_N, sugar_idx=idx, masked=True)
        costs.append(flywire_dryrun.count_window(
            d, sim, scheme, 18, cap, device="cpu", seed=seed,
            stimulus=stim))
    keys = [(k.flops, k.bytes, k.launches, k.peak_bytes, k.link_bytes,
             k.coll_count, res) for k, res in costs]
    assert all(k == keys[0] for k in keys), keys
    cost, resident = costs[0]
    assert cost.coll_count == {"all-gather": 18}
    assert resident > 0 and cost.peak_bytes > resident
    terms = flywire_dryrun.window_terms(cost, 18, sim.params.dt)
    assert terms["bound_s"] == max(terms["compute_s"], terms["memory_s"],
                                   terms["collective_s"]) > 0
