#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch`` with nvcc, holds each
kernel against its plain PyTorch version, runs ``simulate()`` on the full
synthetic FlyWire network (139,255 neurons, 15M synapses, the paper's
Q19.12 configuration with 9-bit weights, ``sugar_feeding``) through the
``blocked_fused`` and ``blocked`` engines, and checks the results bitwise
against the ``csr`` engine on the same card.  Every phase raises on
failure; nothing is caught.  The last lines are a JSON line of kernel
measurements, the card's name and power limit, and
``{"ok": true, "device": ...}``.

It imports PyTorch, numpy and the port (``src/repro_torch``), and nothing
of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
N_FULL = 139_255
SYN_FULL = 15_000_000
N_KERNEL_CHECK = 20_000
T_MAIN = 1_000
T_OTHER = 200
DEVICE = "cuda"


def phase(name: str):
    """Decorator: print the phase's seconds when it returns."""
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s",
                  flush=True)
            return out
        return run
    return deco


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def equal_all(a_list, b_list) -> bool:
    import torch
    return all(torch.equal(a, b) for a, b in zip(a_list, b_list))


@phase("environment")
def phase_env():
    import torch
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false")
    smi = nvidia_smi_line()
    print(f"card: {smi}  (devices: {torch.cuda.device_count()})", flush=True)
    # float32 products in the plain versions and the library yardstick must
    # be full float32: the sums are exact only without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


@phase("build")
def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.spike_prop import kernel as K
    t0 = time.perf_counter()
    secs = build.build(list(K.SOURCES.values()))
    for name in K.SOURCES:
        K._launcher(name)
    print(f"nvcc: {json.dumps({k: round(v, 3) for k, v in secs.items()})} "
          f"({time.perf_counter() - t0:.3f} s wall, flags "
          f"{' '.join(build.NVCC_FLAGS)})", flush=True)


def random_lif_rows(rng, n_tb, fixed_point, device, params):
    """LIF state rows spread over the interesting range: below and above
    threshold, some refractory."""
    import numpy as np
    import torch
    shape = (n_tb, 128)
    refrac = rng.integers(-1, params.ref_steps + 1, shape).astype(np.int32)
    if fixed_point:
        v = rng.integers(-2 * params.fx_v_th, 2 * params.fx_v_th, shape)
        g = rng.integers(-(1 << 24), 1 << 24, shape)
        v, g = v.astype(np.int32), g.astype(np.int32)
    else:
        v = rng.normal(3.0, 4.0, shape).astype(np.float32)
        g = rng.normal(0.0, 2.0, shape).astype(np.float32)
    to = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return to(v), to(g), to(refrac)


def stim_rows(rng, n_tb, fixed_point, device, params):
    import numpy as np
    import torch
    shape = (n_tb, 128)
    to = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    gstim = to((rng.integers(-3, 4, shape) * 60).astype(np.float32))
    if fixed_point:
        vin = to(rng.integers(-40, 41, shape).astype(np.int32))
    else:
        vin = to(rng.normal(0.0, 5.0, shape).astype(np.float32))
    force = to((rng.random(shape) < 0.05).astype(np.int32))
    return gstim, vin, force


@phase("kernels against plain (n = 20,000)")
def phase_kernel_check():
    """Both kernels against their plain versions at FlyWire density, in
    both precisions, at silent, ~1%, ~30% and all-spiking activity, with
    and without the stimulus channels.  Tolerance: 0 (bitwise)."""
    import numpy as np
    import torch
    from repro_torch.core.connectome import synthetic_flywire
    from repro_torch.core.compress import quantize_weights
    from repro_torch.core.neuron import FLYWIRE_LIF
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.spike_prop.ops import (build_blocked,
                                                    pad_spike_blocks)
    dev = torch.device(DEVICE)
    c = synthetic_flywire(N_KERNEL_CHECK, seed=1)
    rng = np.random.default_rng(1)
    worst = {"spike_deliver": 0.0, "fused_deliver_lif": 0.0}
    n_checks = 0
    for quantized in (True, False):
        bs = build_blocked(
            c, quantize_weights(c.in_weights) if quantized else None, dev)
        for frac in (0.0, 0.01, 0.3, 1.0):
            spikes = torch.from_numpy(rng.random(c.n) < frac).to(dev)
            spk, nspk = pad_spike_blocks(spikes, bs.n, bs.n_sb)
            a = K.spike_deliver_tiles(bs.blk_id, bs.weights, spk, nspk)
            b = K.spike_deliver_plain(bs.blk_id, bs.weights, spk, nspk)
            torch.cuda.synchronize()
            err = max_abs_err(a, b)
            worst["spike_deliver"] = max(worst["spike_deliver"], err)
            check(torch.equal(a, b), f"spike_deliver != plain at activity "
                  f"{frac}, quantized={quantized}: max |err| {err}")
            n_checks += 1
            for fx in (True, False):
                v, g, refrac = random_lif_rows(rng, bs.n_tb, fx, dev,
                                               FLYWIRE_LIF)
                gstim, vin, force = stim_rows(rng, bs.n_tb, fx, dev,
                                              FLYWIRE_LIF)
                for chans in ((None, None, None), (gstim, None, None),
                              (None, vin, None), (None, None, force),
                              (gstim, vin, force)):
                    kw = dict(params=FLYWIRE_LIF, fixed_point=fx)
                    a = K.fused_deliver_lif(bs.blk_id, bs.weights, spk, v, g,
                                            refrac, *chans, **kw)
                    b = K.fused_deliver_lif_plain(bs.blk_id, bs.weights, spk,
                                                  v, g, refrac, *chans, **kw)
                    torch.cuda.synchronize()
                    err = max(max_abs_err(x, y) for x, y in zip(a, b))
                    worst["fused_deliver_lif"] = max(
                        worst["fused_deliver_lif"], err)
                    have = [x is not None for x in chans]
                    check(equal_all(a, b), f"fused_deliver_lif != plain at "
                          f"activity {frac}, fixed_point={fx}, channels "
                          f"{have}, quantized={quantized}: max |err| {err}")
                    n_checks += 1
        del bs
    torch.cuda.empty_cache()
    print(f"kernel checks: {n_checks} comparisons, all bitwise equal; worst "
          f"|err| {json.dumps(worst)}", flush=True)
    return worst


def run_engine(c, cfg, t_steps, stim, syn, probes, label):
    """One simulate() run with the launch counts zeroed just before and
    read just after; returns (result, ms per step, launches)."""
    import torch
    from repro_torch.core import simulate
    from repro_torch.kernels.spike_prop import kernel as K
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = simulate(c, cfg, t_steps, seed=0, syn=syn, stimulus=stim,
                   probes=probes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / t_steps
    launches = dict(K.LAUNCHES)
    print(f"{label}: {ms:.4f} ms/step over {t_steps} steps, "
          f"{int(res.counts.sum())} spikes, launches {launches}", flush=True)
    return res, ms, launches


def same_result(a, b) -> bool:
    import torch
    return (torch.equal(a.counts, b.counts) and torch.equal(a.dropped,
                                                            b.dropped)
            and all(torch.equal(x, y) for x, y in zip(a.state, b.state)))


def tile_traffic(blk_id, n_sb, raster, delay):
    """Per step: live tiles and (target block, spiking source) pairs the
    kernels read, from the run's raster (step t delivers the spikes of
    step t - delay)."""
    import torch
    refs = torch.bincount(blk_id.reshape(-1).long(), minlength=n_sb + 1)
    refs[n_sb] = 0                      # pad slots
    T, n = raster.shape
    delayed = torch.zeros_like(raster)
    delayed[delay:] = raster[:T - delay]
    pad = torch.zeros((T, n_sb * 128), dtype=torch.bool,
                      device=raster.device)
    pad[:, :n] = delayed
    live_blocks = pad.reshape(T, n_sb, 128).any(dim=2)
    live_tiles = (live_blocks.long() * refs[:n_sb]).sum(dim=1)
    cols = (pad.reshape(T, n_sb, 128).sum(dim=2).long()
            * refs[:n_sb]).sum(dim=1)
    return live_tiles, cols


@phase("main path at full size (blocked_fused vs csr, Q19.12)")
def phase_main(c, cfg, stim):
    import torch
    from repro_torch.core import build_synapses
    from repro_torch.exp import ProbeSpec
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    syn = build_synapses(c, cfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    gb = syn.weights.numel() * syn.weights.element_size() / 1e9
    print(f"tile store: n_tb={syn.blk_id.shape[0]} E={syn.blk_id.shape[1]} "
          f"tiles={syn.tiles_stored} occupancy={syn.occupancy:.6f} "
          f"int16 {gb:.3f} GB, built in {t_build:.3f} s", flush=True)
    probes = ProbeSpec(raster=True)
    fused, ms_fused, launches = run_engine(c, cfg, T_MAIN, stim, syn, probes,
                                           "blocked_fused Q19.12")
    check(launches["fused_deliver_lif"] == T_MAIN,
          f"fused kernel launched {launches['fused_deliver_lif']} times in "
          f"{T_MAIN} steps")
    peak = torch.cuda.max_memory_allocated() / 1e9
    csr_cfg = dataclasses.replace(cfg, engine="csr")
    csr_syn = build_synapses(c, csr_cfg)
    ref, ms_csr, _ = run_engine(c, csr_cfg, T_MAIN, stim, csr_syn, probes,
                                "csr Q19.12")
    check(same_result(fused, ref), "blocked_fused != csr (counts, state or "
          "dropped) at full size")
    check(torch.equal(fused.raster, ref.raster), "raster differs from csr")
    live, cols = tile_traffic(syn.blk_id, syn.n_sb, fused.raster,
                              cfg.params.delay_steps)
    print(f"main path: blocked_fused {ms_fused:.4f} ms/step "
          f"({1e3 / ms_fused:.1f} steps/s), csr {ms_csr:.4f} ms/step; "
          f"bitwise equal; total spikes {int(fused.counts.sum())}; live "
          f"tiles/step mean {float(live.double().mean()):.1f} max "
          f"{int(live.max())}; spiking columns read/step mean "
          f"{float(cols.double().mean()):.1f}; peak device memory "
          f"{peak:.3f} GB", flush=True)
    return syn, fused, ms_fused, ms_csr, launches


@phase("trace of the main path (torch.profiler)")
def phase_trace(c, cfg, stim, syn, steps: int = 50):
    """Device time per step, kernels per step and the device's busy share
    over a short blocked_fused window, from the profiler's CUDA events."""
    import collections

    import torch
    from repro_torch.core import simulate
    from repro_torch.exp import ProbeSpec
    simulate(c, cfg, 5, seed=1, syn=syn, stimulus=stim, probes=ProbeSpec())
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        simulate(c, cfg, steps, seed=1, syn=syn, stimulus=stim,
                 probes=ProbeSpec())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = collections.defaultdict(float)
    n_dev = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
            n_dev += 1
    if not n_dev:
        print("trace: the profiler recorded no device events; device time "
              "not measured", flush=True)
        return None
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"trace over {steps} steps: wall {wall_ms / steps:.4f} ms/step "
          f"(profiled), device busy {dev_ms / steps:.4f} ms/step "
          f"({100 * dev_ms / wall_ms:.2f}% busy), {n_dev / steps:.1f} device "
          f"ops/step; top: " + "; ".join(
              f"{name[:60]} {ms / steps:.4f} ms/step" for name, ms in top),
          flush=True)
    return dev_ms / wall_ms


@phase("other engine and precision at full size")
def phase_other(c, cfg, stim, syn):
    import torch
    from repro_torch.core import build_synapses
    from repro_torch.exp import ProbeSpec
    probes = ProbeSpec()
    csr_syn = build_synapses(c, dataclasses.replace(cfg, engine="csr"))
    blocked, _, launches = run_engine(
        c, dataclasses.replace(cfg, engine="blocked"), T_OTHER, stim, syn,
        probes, "blocked Q19.12")
    check(launches["spike_deliver"] == T_OTHER,
          f"delivery kernel launched {launches['spike_deliver']} times")
    ref, _, _ = run_engine(c, dataclasses.replace(cfg, engine="csr"),
                           T_OTHER, stim, csr_syn, probes, "csr Q19.12")
    check(same_result(blocked, ref), "blocked != csr at full size")
    f32_cfg = dataclasses.replace(cfg, fixed_point=False)
    fused, _, launches32 = run_engine(c, f32_cfg, T_OTHER, stim, syn, probes,
                                      "blocked_fused f32")
    check(launches32["fused_deliver_lif"] == T_OTHER, "fused f32 launches")
    ref32, _, _ = run_engine(c, dataclasses.replace(f32_cfg, engine="csr"),
                             T_OTHER, stim, csr_syn, probes, "csr f32")
    check(same_result(fused, ref32), "blocked_fused f32 != csr f32")
    del csr_syn
    torch.cuda.empty_cache()
    return launches


def sparse_matrix(c, cfg, device):
    import numpy as np
    import torch
    from repro_torch.core.engines.base import quantized_in_weights
    w = quantized_in_weights(c, cfg).astype(np.float32)
    return torch.sparse_csr_tensor(
        torch.from_numpy(c.in_indptr.astype(np.int64)),
        torch.from_numpy(c.in_indices.astype(np.int64)),
        torch.from_numpy(w), size=(c.n, c.n)).to(device)


@phase("yardstick at the main path's shapes")
def phase_yardstick(c, cfg, syn, fused_res, smi):
    """Each kernel on the main path's tensors (the state after the run and
    the spikes it delivers next), against its plain version, timed; the
    bound is the bytes the call must move over the HBM rate."""
    import torch
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
    dev = torch.device(DEVICE)
    p, fx = cfg.params, cfg.fixed_point
    raster = fused_res.raster
    # the step with the most spikes among the last ones, delivered
    spikes = raster[-p.delay_steps:][raster[-p.delay_steps:].sum(1).argmax()]
    spk, nspk = pad_spike_blocks(spikes, syn.n, syn.n_sb)
    n_tb, E = syn.blk_id.shape
    rows = n_tb * 128

    def rowblk(x):
        out = torch.zeros(rows, dtype=x.dtype, device=dev)
        out[:syn.n] = x
        return out.reshape(n_tb, 128)
    st = fused_res.state
    v, g, refrac = rowblk(st.v), rowblk(st.g), rowblk(st.refrac)
    refs = torch.bincount(syn.blk_id.reshape(-1).long(),
                          minlength=syn.n_sb + 1)[:syn.n_sb]
    cols = int((spk[:syn.n_sb].sum(1).long() * refs).sum())
    live_tiles = int(((nspk[:syn.n_sb] > 0).long() * refs).sum())
    base = syn.blk_id.numel() * 4 + spk.numel() * 4 + cols * 128 * 2
    deliver_bytes = base + nspk.numel() * 4 + rows * 4
    fused_bytes = base + rows * 4 * 3 + rows * 4 * 4

    kw = dict(params=p, fixed_point=fx)
    a = K.spike_deliver_tiles(syn.blk_id, syn.weights, spk, nspk)
    b = K.spike_deliver_plain(syn.blk_id, syn.weights, spk, nspk)
    torch.cuda.synchronize()
    err_d = max_abs_err(a, b)
    check(torch.equal(a, b), f"spike_deliver != plain at full size ({err_d})")
    fa = K.fused_deliver_lif(syn.blk_id, syn.weights, spk, v, g, refrac, **kw)
    fb = K.fused_deliver_lif_plain(syn.blk_id, syn.weights, spk, v, g,
                                   refrac, **kw)
    torch.cuda.synchronize()
    err_f = max(max_abs_err(x, y) for x, y in zip(fa, fb))
    check(equal_all(fa, fb), f"fused_deliver_lif != plain at full size "
          f"({err_f})")

    A = sparse_matrix(c, cfg, dev)
    s_col = spikes.to(torch.float32)[:, None]
    lib = (A @ s_col).reshape(-1)
    check(torch.equal(lib, a.reshape(-1)[:syn.n]),
          "torch.sparse CSR product != delivery kernel")
    ms_d = cuda_ms(lambda: K.spike_deliver_tiles(syn.blk_id, syn.weights,
                                                 spk, nspk), 50)
    ms_f = cuda_ms(lambda: K.fused_deliver_lif(syn.blk_id, syn.weights, spk,
                                               v, g, refrac, **kw), 50)
    plain_d = cuda_ms(lambda: K.spike_deliver_plain(syn.blk_id, syn.weights,
                                                    spk, nspk), 2, warmup=1)
    plain_f = cuda_ms(lambda: K.fused_deliver_lif_plain(
        syn.blk_id, syn.weights, spk, v, g, refrac, **kw), 2, warmup=1)
    lib_ms = cuda_ms(lambda: A @ s_col, 50)
    bound_d = deliver_bytes / HBM_BYTES_PER_S * 1e3
    bound_f = fused_bytes / HBM_BYTES_PER_S * 1e3
    print(f"yardstick input: {int(spikes.sum())} spikes delivered, "
          f"{live_tiles} live tiles, {cols} spiking columns read; card "
          f"{smi}", flush=True)
    print(f"spike_deliver: {ms_d:.5f} ms/call, plain {plain_d:.3f} ms, "
          f"torch.sparse CSR mv {lib_ms:.5f} ms, bound {bound_d:.5f} ms "
          f"({deliver_bytes} B)", flush=True)
    print(f"fused_deliver_lif: {ms_f:.5f} ms/call, plain {plain_f:.3f} ms, "
          f"bound {bound_f:.5f} ms ({fused_bytes} B)", flush=True)
    del A
    return {"spike_deliver": (ms_d, plain_d, bound_d, lib_ms, err_d),
            "fused_deliver_lif": (ms_f, plain_f, bound_f, None, err_f)}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit("chip_smoke.py: no src/repro_torch beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, src)
    t_all = time.perf_counter()
    smi = phase_env()
    phase_build()
    check_err = phase_kernel_check()

    from repro_torch.configs.flywire import CONFIG
    from repro_torch.core.connectome import synthetic_flywire
    from repro_torch.exp import build_scenario
    from repro_torch.kernels.spike_prop.kernel import SOURCES
    t0 = time.perf_counter()
    c = synthetic_flywire(N_FULL, target_synapses=SYN_FULL, seed=0)
    print(f"[phase] connectome: {time.perf_counter() - t0:.3f} s "
          f"(n={c.n}, synapses={c.nnz}, max fan-in {int(c.fan_in.max())})",
          flush=True)
    cfg = dataclasses.replace(CONFIG.sim, engine="blocked_fused")
    stim = build_scenario("sugar_feeding", c, cfg, n_sugar=CONFIG.n_sugar,
                          rate_hz=CONFIG.sugar_rate_hz)
    syn, fused, ms_fused, ms_csr, main_launches = phase_main(c, cfg, stim)
    phase_trace(c, cfg, stim, syn)
    other_launches = phase_other(c, cfg, stim, syn)
    yard = phase_yardstick(c, cfg, syn, fused, smi)

    rel = lambda p: os.path.relpath(p, here)  # noqa: E731
    replaces = {
        "spike_deliver": "src/repro/kernels/spike_prop/kernel.py:78",
        "fused_deliver_lif": "src/repro/kernels/spike_prop/kernel.py:196"}
    launches = {"spike_deliver": other_launches["spike_deliver"],
                "fused_deliver_lif": main_launches["fused_deliver_lif"]}
    kernels = []
    for name in ("spike_deliver", "fused_deliver_lif"):
        ms, plain_ms, bound_ms, lib_ms, err = yard[name]
        kernels.append({
            "name": name, "route": "cuda", "source": rel(SOURCES[name]),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(err, check_err[name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "held_against_plain": True})
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched")
    print(f"total {time.perf_counter() - t_all:.3f} s; main path "
          f"blocked_fused {ms_fused:.4f} ms/step, csr {ms_csr:.4f} ms/step",
          flush=True)
    import torch
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
