#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch`` with nvcc and holds each
kernel against its plain PyTorch version, then drives three paths:

* ``simulate()`` on the full synthetic FlyWire network (139,255 neurons,
  15M synapses, the paper's Q19.12 configuration with 9-bit weights,
  ``sugar_feeding``) through the ``blocked_fused`` and ``blocked``
  engines, checked bitwise against the ``csr`` engine on the same card;
* the LIF kernels' entry points (``kernels.lif.lif_update`` and
  ``lif_update_fx``) for 1,000 steps at FlyWire size, checked bitwise
  against their plain versions;
* ``ServingEngine`` on the full published qwen2.5-14b (48 layers, 14.8B
  float32 parameters, random weights from a seed) with
  ``attention_impl="pallas"``, the flash attention kernel, answering 8
  requests; its tokens are held against a plain-attention run of the same
  weights.

Both delivery kernels are also timed on the full FlyWire store with
0.1%, 1% and every neuron spiking.  Every phase raises on failure;
nothing is caught.  The last lines are a JSON line of those activity
cases, a JSON line of kernel measurements, the card's name and power
limit, and ``{"ok": true, "device": ...}``.

It imports PyTorch, numpy and the port (``src/repro_torch``), and nothing
of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM float32 without tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
N_FULL = 139_255
SYN_FULL = 15_000_000
N_KERNEL_CHECK = 20_000
T_MAIN = 1_000
T_OTHER = 200
T_LIF = 1_000
ACTIVITY = (0.001, 0.01, 1.0)   # fractions of the neurons spiking a step
# 9 resident blocks of 128 threads an SM: 65,536 / (9 x 128) registers a
# thread, rounded down to the allocation's multiple of 8; 19,216 B of
# shared memory a block, which cuobjdump reports with the 1 KB the card
# reserves for each block
MAX_REGS, MAX_SHARED = 56, 19_216 + 1_024
LM_REQUESTS = 8
LM_PROMPT = (256, 1536)        # prompt lengths drawn in this range
LM_NEW = 16
LM_SLOTS, LM_MAX_LEN = 4, 2048
FLASH_ATOL = 2e-4              # the JAX package's tolerance for its kernel
# Two float32 runs whose attention sums in other orders may pick another
# token where the top two logits (magnitude ~1) are this close: about a
# hundred times the logit difference the two impls show on one prefill.
LOGIT_TOL = 1e-3
LM_SEED = 0
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


def device_profile(fn, reps: int = 1):
    """Run ``fn`` ``reps`` times under torch.profiler (after one warm-up
    call); returns (wall ms per call, {kernel name: (device ms per call,
    launches per call)}), or None for the kernels when the profiler
    recorded no device events."""
    import collections

    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    ms: dict = collections.defaultdict(float)
    count: dict = collections.defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] += (e.time_range.end - e.time_range.start) / 1e3
            count[e.name] += 1
    if not ms:
        return wall_ms, None
    return wall_ms, {k: (ms[k] / reps, count[k] / reps) for k in ms}


def kernel_device_ms(fn, reps: int, match: str, tries: int = 3) -> float:
    """Mean device milliseconds per launch of the kernel whose name
    contains ``match`` (at most one launch per call of ``fn``), from the
    profiler over ``reps`` calls.  The profiler may drop some of a
    session's device records, so the mean is over the launches it
    recorded; a session that recorded none is repeated, ``tries`` times
    at most."""
    for _ in range(tries):
        _, kernels = device_profile(fn, reps)
        hits = [v for k, v in (kernels or {}).items() if match in k]
        check(len(hits) <= 1, f"more than one kernel matches {match}: {hits}")
        if hits and hits[0][1] > 0:
            break
    check(bool(hits), f"the profiler recorded no {match} launch in {tries} "
          f"sessions of {reps} calls")
    ms_per_call, launches_per_call = hits[0]
    check(launches_per_call <= 1, f"{match}: {launches_per_call} launches "
          f"per call, expected one")
    print(f"{match}: the profiler recorded {round(launches_per_call * reps)} "
          f"of {reps} launches", flush=True)
    return ms_per_call / launches_per_call


def print_breakdown(label: str, wall_ms: float, kernels, top: int = 8):
    """Device busy share and the top kernels by device time."""
    if kernels is None:
        print(f"{label}: wall {wall_ms:.3f} ms; the profiler recorded no "
              f"device events; device time not measured", flush=True)
        return
    busy = sum(ms for ms, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    print(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.2f}%), {launches:.0f} launches; top: "
          + "; ".join(f"{name[:70]} {ms:.3f} ms x{n:.0f}"
                      for name, (ms, n) in ranked), flush=True)


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


def kernel_modules():
    """The kernel modules of the port, each with SOURCES, LAUNCHES and
    reset_launches()."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.lif import kernel as LK
    from repro_torch.kernels.spike_prop import kernel as K
    return K, LK, FK


def reset_all_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


@phase("build")
def phase_build():
    from repro_torch.kernels import build
    sources = sorted({src for mod in kernel_modules()
                      for src in mod.SOURCES.values()})
    t0 = time.perf_counter()
    secs = build.build(sources)
    for src in sources:
        build.load(src)
    print(f"nvcc: {json.dumps({k: round(v, 3) for k, v in secs.items()})} "
          f"({time.perf_counter() - t0:.3f} s wall, flags "
          f"{' '.join(build.NVCC_FLAGS)})", flush=True)
    # the flash kernel's products must run on the tensor cores in TF32
    from repro_torch.kernels.flash_attention import kernel as FK
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", build.library_path(FK.SOURCE)], check=True,
        capture_output=True, text=True, timeout=300).stdout
    hmma = [ln.strip() for ln in sass.splitlines()
            if "HMMA" in ln and "TF32" in ln]
    check(bool(hmma), "no TF32 HMMA instruction in the flash kernel's SASS")
    print(f"flash kernel SASS: {len(hmma)} TF32 HMMA instructions, e.g. "
          f"{hmma[0]}", flush=True)
    # the delivery kernels must keep 9 blocks an SM resident: all 1,088
    # target blocks of FlyWire in one wave
    from repro_torch.kernels.spike_prop import kernel as K
    for name, src in K.SOURCES.items():
        res = subprocess.run(
            [cuobjdump, "-res-usage", build.library_path(src)], check=True,
            capture_output=True, text=True, timeout=300).stdout
        use = [(int(r), int(s)) for r, s in re.findall(
            r"REG:(\d+) STACK:\d+ SHARED:(\d+)", res)]
        check(bool(use), f"no resource usage for {name}:\n{res}")
        print(f"{name}: registers, shared memory per instantiation {use}",
              flush=True)
        check(all(r <= MAX_REGS and s <= MAX_SHARED for r, s in use),
              f"{name} uses more than {MAX_REGS} registers a thread or "
              f"{MAX_SHARED} B of shared memory a block: {use}")


def with_subnormals(rng, x):
    """``x`` with about an eighth of its values replaced by float32
    subnormals and another eighth by normals within 4x of the smallest,
    which the LIF step's float32 operations flush or turn subnormal."""
    import numpy as np
    tiny = float(np.finfo(np.float32).tiny)
    pick = rng.integers(0, 8, x.shape)
    x = np.where(pick == 0, rng.uniform(-1, 1, x.shape) * tiny, x)
    x = np.where(pick == 1, rng.uniform(-4, 4, x.shape) * tiny, x)
    return x.astype(np.float32)


def random_lif_rows(rng, n_tb, fixed_point, device, params):
    """LIF state rows spread over the interesting range: below and above
    threshold, some refractory, in float32 some subnormal."""
    import numpy as np
    import torch
    shape = (n_tb, 128)
    refrac = rng.integers(-1, params.ref_steps + 1, shape).astype(np.int32)
    if fixed_point:
        v = rng.integers(-2 * params.fx_v_th, 2 * params.fx_v_th, shape)
        g = rng.integers(-(1 << 24), 1 << 24, shape)
        v, g = v.astype(np.int32), g.astype(np.int32)
    else:
        v = with_subnormals(rng, rng.normal(3.0, 4.0, shape))
        g = with_subnormals(rng, rng.normal(0.0, 2.0, shape))
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
        vin = to(with_subnormals(rng, rng.normal(0.0, 5.0, shape)))
    force = to((rng.random(shape) < 0.05).astype(np.int32))
    return gstim, vin, force


def missing_tile_store(dev):
    """A small store in which target block 1 (of 3) has no tile at all and
    block 0 has none from source block 2: a live source block that some
    target blocks hold no tile for."""
    import numpy as np
    from repro_torch.kernels.spike_prop.ops import tile_coo
    rng = np.random.default_rng(5)
    tgt = np.concatenate([rng.integers(0, 128, 500),
                          rng.integers(256, 384, 500)])
    src = np.concatenate([rng.integers(0, 256, 500),
                          rng.integers(0, 384, 500)])
    w = rng.integers(-256, 256, 1000).astype(np.float32)
    return tile_coo(tgt, src, w, 3, 3, dev)


def straddle_spikes(rng, n):
    """One to three spiking neurons in every source block: live tiles of
    1-3 spiking columns each, whose rows fill the kernels' 32-row staging
    units only together, so a unit spans several tiles."""
    import numpy as np
    s = np.zeros(n, bool)
    for lo in range(0, n, 128):
        block = np.arange(lo, min(n, lo + 128))
        s[rng.choice(block, min(len(block), rng.integers(1, 4)),
                     replace=False)] = True
    return s


@phase("kernels against plain (n = 20,000)")
def phase_kernel_check():
    """Both kernels against their plain versions at FlyWire density, in
    both precisions, at silent, ~1%, ~30% and all-spiking activity, with
    exactly one live source block, with 1-3 spiking columns in every
    source block (staging units that straddle tiles), with and without
    the stimulus channels, float32 state and drive partly subnormal; and
    on a store where a live source block has no tile in some target
    blocks.  Tolerance: 0 (bitwise)."""
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

    def deliver_case(blk_id, weights, spk, nspk, what):
        nonlocal n_checks
        a = K.spike_deliver_tiles(blk_id, weights, spk, nspk)
        b = K.spike_deliver_plain(blk_id, weights, spk, nspk)
        torch.cuda.synchronize()
        err = max_abs_err(a, b)
        worst["spike_deliver"] = max(worst["spike_deliver"], err)
        check(torch.equal(a, b), f"spike_deliver != plain at {what}: max "
              f"|err| {err}")
        n_checks += 1

    def fused_cases(blk_id, weights, n_tb, spk, nspk, what):
        nonlocal n_checks
        for fx in (True, False):
            v, g, refrac = random_lif_rows(rng, n_tb, fx, dev, FLYWIRE_LIF)
            gstim, vin, force = stim_rows(rng, n_tb, fx, dev, FLYWIRE_LIF)
            for chans in ((None, None, None), (gstim, None, None),
                          (None, vin, None), (None, None, force),
                          (gstim, vin, force)):
                kw = dict(params=FLYWIRE_LIF, fixed_point=fx)
                a = K.fused_deliver_lif(blk_id, weights, spk, nspk, v, g,
                                        refrac, *chans, **kw)
                b = K.fused_deliver_lif_plain(blk_id, weights, spk, nspk, v,
                                              g, refrac, *chans, **kw)
                torch.cuda.synchronize()
                err = max(max_abs_err(x, y) for x, y in zip(a, b))
                worst["fused_deliver_lif"] = max(worst["fused_deliver_lif"],
                                                 err)
                have = [x is not None for x in chans]
                check(equal_all(a, b), f"fused_deliver_lif != plain at "
                      f"{what}, fixed_point={fx}, channels {have}: max "
                      f"|err| {err}")
                n_checks += 1

    for quantized in (True, False):
        bs = build_blocked(
            c, quantize_weights(c.in_weights) if quantized else None, dev)
        one = np.zeros(c.n, bool)
        one[rng.choice(np.arange(128, 256), 5, replace=False)] = True
        for frac in (0.0, 0.01, 0.3, 1.0, "one block", "straddling units"):
            if frac == "one block":
                s = one
            elif frac == "straddling units":
                s = straddle_spikes(rng, c.n)
            else:
                s = rng.random(c.n) < frac
            spikes = torch.from_numpy(s).to(dev)
            spk, nspk = pad_spike_blocks(spikes, bs.n, bs.n_sb)
            if frac == "one block":
                check(int((nspk > 0).sum()) == 1, "one live source block")
            if frac == "straddling units":
                # tile rows each target block reads
                rows = nspk[bs.blk_id.long()].sum(dim=1)
                check(int(rows.min()) >= 3 * 32 and int(nspk.max()) <= 3,
                      f"the straddling case reads {int(rows.min())} rows "
                      f"in some target block, or a tile has > 3 columns")
            what = f"activity {frac}, quantized={quantized}"
            deliver_case(bs.blk_id, bs.weights, spk, nspk, what)
            fused_cases(bs.blk_id, bs.weights, bs.n_tb, spk, nspk, what)
        del bs
    blk_id, weights = missing_tile_store(dev)
    check(bool((blk_id[1] == 3).all()) and not bool((blk_id[0] == 2).any()),
          "the store lacks the tiles it should")
    s = torch.zeros(384, dtype=torch.bool, device=dev)
    s[[260, 300, 383]] = True       # source block 2 only
    spk, nspk = pad_spike_blocks(s, 384, 3)
    what = "a live block missing from two target blocks"
    deliver_case(blk_id, weights, spk, nspk, what)
    fused_cases(blk_id, weights, 3, spk, nspk, what)
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
def phase_trace(c, cfg, stim, syn, steps: int = 20):
    """Device time per step, kernels per step and the device's busy share
    over a short window of the blocked_fused and blocked engines, from the
    profiler's CUDA events (the host clock cannot resolve a kernel's
    change of ~0.1 ms a step)."""
    from repro_torch.core import simulate
    from repro_torch.exp import ProbeSpec
    for engine in ("blocked_fused", "blocked"):
        run_cfg = dataclasses.replace(cfg, engine=engine)
        wall_ms, kernels = device_profile(lambda: simulate(
            c, run_cfg, steps, seed=1, syn=syn, stimulus=stim,
            probes=ProbeSpec()))
        per_step = None if kernels is None else {
            k: (ms / steps, n / steps) for k, (ms, n) in kernels.items()}
        print_breakdown(f"{engine} trace over {steps} steps, per step",
                        wall_ms / steps, per_step, top=6)


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


def delivery_bytes(syn, refs, spk, nspk, state_bytes):
    """The spiking columns read, and the bytes a delivery call must move
    for these spikes: nspk, the live source blocks' spike entries, the slot
    of every (live source block, target block) pair (4 B each, what a slot
    index would hold; the kernel's binary search reads more, a 32-byte
    sector a probe), one 256-byte int16 tile row for every spiking column
    of a stored tile, and `state_bytes` of state in and out.  `refs[b]` is
    the number of target blocks that hold a tile of source block b."""
    n_tb = syn.blk_id.shape[0]
    n_live = int((nspk[:syn.n_sb] > 0).sum())
    cols = int((spk[:syn.n_sb].sum(1).long() * refs).sum())
    nbytes = (nspk.numel() * 4 + n_live * 128 * 4 + n_live * n_tb * 4
              + cols * 128 * 2 + state_bytes)
    return cols, nbytes


@phase("yardstick at the main path's shapes")
def phase_yardstick(c, cfg, syn, fused_res, smi):
    """Each kernel on the main path's tensors (the state after the run and
    the spikes it delivers next), against its plain version, timed; the
    bound is the bytes the call must move for this step's spikes
    (`delivery_bytes`) over the HBM rate.  Then both kernels across the
    activity range (`ACTIVITY`, `activity_case`)."""
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
    live_tiles = int(((nspk[:syn.n_sb] > 0).long() * refs).sum())
    cols, deliver_bytes = delivery_bytes(syn, refs, spk, nspk, rows * 4)
    _, fused_bytes = delivery_bytes(syn, refs, spk, nspk, rows * 4 * 7)

    kw = dict(params=p, fixed_point=fx)
    a = K.spike_deliver_tiles(syn.blk_id, syn.weights, spk, nspk)
    b = K.spike_deliver_plain(syn.blk_id, syn.weights, spk, nspk)
    torch.cuda.synchronize()
    err_d = max_abs_err(a, b)
    check(torch.equal(a, b), f"spike_deliver != plain at full size ({err_d})")
    fa = K.fused_deliver_lif(syn.blk_id, syn.weights, spk, nspk, v, g,
                             refrac, **kw)
    fb = K.fused_deliver_lif_plain(syn.blk_id, syn.weights, spk, nspk, v, g,
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
    deliver = lambda: K.spike_deliver_tiles(  # noqa: E731
        syn.blk_id, syn.weights, spk, nspk)
    fused = lambda: K.fused_deliver_lif(  # noqa: E731
        syn.blk_id, syn.weights, spk, nspk, v, g, refrac, **kw)
    # a call of either wrapper costs more host time than its kernel takes
    # at this activity, so back-to-back calls timed by CUDA events measure
    # the host: the kernels' own time is the profiler's device time
    call_d, call_f = cuda_ms(deliver, 50), cuda_ms(fused, 50)
    ms_d = kernel_device_ms(deliver, 200, "spike_deliver_kernel")
    ms_f = kernel_device_ms(fused, 200, "fused_deliver_lif_kernel")
    plain_d = cuda_ms(lambda: K.spike_deliver_plain(syn.blk_id, syn.weights,
                                                    spk, nspk), 2, warmup=1)
    plain_f = cuda_ms(lambda: K.fused_deliver_lif_plain(
        syn.blk_id, syn.weights, spk, nspk, v, g, refrac, **kw), 2, warmup=1)
    lib_ms = cuda_ms(lambda: A @ s_col, 50)
    bound_d = deliver_bytes / HBM_BYTES_PER_S * 1e3
    bound_f = fused_bytes / HBM_BYTES_PER_S * 1e3
    print(f"yardstick input: {int(spikes.sum())} spikes delivered, "
          f"{live_tiles} live tiles, {cols} spiking columns read; card "
          f"{smi}", flush=True)
    print(f"spike_deliver: {ms_d:.5f} ms/launch (device time, profiler), "
          f"wrapper {call_d:.5f} ms/call back to back (CUDA events), plain "
          f"{plain_d:.3f} ms, torch.sparse CSR mv {lib_ms:.5f} ms, bound "
          f"{bound_d:.5f} ms ({deliver_bytes} B)", flush=True)
    print(f"fused_deliver_lif: {ms_f:.5f} ms/launch (device time, "
          f"profiler), wrapper {call_f:.5f} ms/call back to back (CUDA "
          f"events), plain {plain_f:.3f} ms, bound {bound_f:.5f} ms "
          f"({fused_bytes} B)", flush=True)
    del A
    activity = [row for frac in ACTIVITY for row in activity_case(
        syn, refs, frac, (v, g, refrac), kw, smi)]
    return ({"spike_deliver": (ms_d, plain_d, bound_d, lib_ms, err_d),
             "fused_deliver_lif": (ms_f, plain_f, bound_f, None, err_f)},
            activity)


def timed(fn, match: str) -> tuple[float, str]:
    """Milliseconds per call of ``fn``'s one kernel launch, and how they
    were taken: CUDA events over 5 back-to-back calls where a call takes
    0.2 ms or more; below that a wrapper call's host time (~0.05-0.09 ms)
    would weigh in, and the profiler's device time over 200 calls is
    taken instead."""
    ms = cuda_ms(fn, 5, warmup=1)
    if ms >= 0.2:
        return ms, "CUDA events, 5 calls"
    return kernel_device_ms(fn, 200, match), "profiler device time"


def activity_case(syn, refs, frac, state, kw, smi):
    """Both delivery kernels on the full store with a fraction ``frac`` of
    the neurons spiking (Bernoulli draws from numpy seed 0; 1.0 is every
    neuron): each bitwise against its plain version once, then timed
    beside its byte bound (`delivery_bytes`, counted for these spikes)."""
    import numpy as np
    import torch
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
    s = np.random.default_rng(0).random(syn.n) < frac
    spk, nspk = pad_spike_blocks(torch.from_numpy(s).to(DEVICE), syn.n,
                                 syn.n_sb)
    store = (syn.blk_id, syn.weights, spk, nspk)
    rows = state[0].numel()
    cases = {
        "spike_deliver": (lambda: (K.spike_deliver_tiles(*store),),
                          lambda: (K.spike_deliver_plain(*store),), rows * 4),
        "fused_deliver_lif": (
            lambda: K.fused_deliver_lif(*store, *state, **kw),
            lambda: K.fused_deliver_lif_plain(*store, *state, **kw),
            rows * 4 * 7)}
    out = []
    for name, (fn, plain, state_bytes) in cases.items():
        a, b = fn(), plain()
        torch.cuda.synchronize()
        err = max(max_abs_err(x, y) for x, y in zip(a, b))
        check(equal_all(a, b), f"{name} != plain with {frac:.1%} of the "
              f"neurons spiking on the full store: max |err| {err}")
        del a, b
        ms, how = timed(fn, f"{name}_kernel")
        cols, nbytes = delivery_bytes(syn, refs, spk, nspk, state_bytes)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{name} with {frac:.1%} spiking ({int(s.sum())} neurons, "
              f"{int((nspk[:syn.n_sb] > 0).sum())} live source blocks, "
              f"{cols} spiking columns of stored tiles): {ms:.5f} ms/call "
              f"({how}), bound {bound:.5f} ms ({nbytes} B), "
              f"{ms / bound:.2f}x the bound; bitwise equal to plain; card "
              f"{smi}", flush=True)
        out.append({"kernel": name, "spiking": frac, "ms": ms,
                    "timed_by": how, "bound_ms": bound, "max_abs_err": err})
    return out


@phase("LIF kernels against plain (n = 139,255)")
def phase_lif_check():
    """Both LIF kernels against their plain versions at FlyWire size, on
    inputs spread over the interesting range (float32 partly subnormal,
    Q19.12 wide enough to wrap).  Tolerance: 0 (bitwise)."""
    import numpy as np
    import torch
    from repro_torch.core.neuron import FLYWIRE_LIF as P
    from repro_torch.kernels.lif import kernel as LK
    rng = np.random.default_rng(2)
    n = N_FULL
    to = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    worst = {}
    for fx in (False, True):
        refrac = to(rng.integers(-1, P.ref_steps + 1, n).astype(np.int32))
        force = to((rng.random(n) < 0.05).astype(np.int32))
        if fx:
            v = to(rng.integers(-2 * P.fx_v_th, 2 * P.fx_v_th, n
                                ).astype(np.int32))
            g = to(rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32))
            g_in = to(rng.integers(-(1 << 19), 1 << 19, n).astype(np.int32))
            v_in = to(rng.integers(-40, 41, n).astype(np.int32))
            fn, plain, name = LK.lif_update_fx32, LK.lif_update_fx_ref, \
                "lif_update_fx32"
        else:
            v, g, g_in, v_in = (to(with_subnormals(
                rng, rng.normal(0.0, 3.0, n))) for _ in range(4))
            fn, plain, name = LK.lif_update_f32, LK.lif_update_ref, \
                "lif_update_f32"
        args = (v, g, refrac, g_in, v_in, force)
        a, b = fn(*args, params=P), plain(*args, params=P)
        torch.cuda.synchronize()
        worst[name] = max(max_abs_err(x, y) for x, y in zip(a, b))
        check(equal_all(a, b), f"{name} != plain at n = {n}: max |err| "
              f"{worst[name]}")
        if not fx:
            flushed = int(((a[1] == 0) & (a[3] == 0) & (g != 0)).sum())
            check(flushed > 0, "no float32 value was flushed")
            print(f"lif_update_f32: {flushed} g values flushed to zero, "
                  f"bitwise equal to plain", flush=True)
    print(f"LIF kernel checks: both precisions bitwise equal at n = {n}",
          flush=True)
    return worst


FLASH_CASES = [  # B, H, Hkv, S, D, causal, window
    (1, 2, 2, 256, 64, True, None), (2, 4, 2, 128, 64, True, None),
    (1, 2, 1, 200, 32, True, None), (1, 2, 2, 256, 64, False, None),
    (1, 2, 2, 512, 64, True, 128), (1, 4, 4, 384, 128, True, 96),
    (1, 4, 2, 2048, 256, True, 1024),          # gemma3's d_head and window
    (1, 40, 8, 1024, 128, True, None),         # qwen2.5-14b prefill shapes
    (1, 40, 8, 1536, 128, True, None),
]


def flash_inputs(B, H, Hkv, S, D, seed):
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return (torch.randn(B, H, S, D, device=DEVICE, generator=g),
            torch.randn(B, Hkv, S, D, device=DEVICE, generator=g),
            torch.randn(B, Hkv, S, D, device=DEVICE, generator=g))


@phase("flash attention kernel against attention_ref")
def phase_flash_check():
    """The kernel against the materialized oracle and its plain version
    at the sweep of tests/test_kernels.py, d_head 256 with a 1,024 window
    and the qwen2.5-14b shapes.  Tolerance: atol 2e-4 (float32 sums in
    another order)."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    worst = 0.0
    for i, (B, H, Hkv, S, D, causal, window) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(B, H, Hkv, S, D, i)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        plain = FK.flash_attention_plain(q, k, v, scale=D ** -0.5,
                                         causal=causal, window=window)
        torch.cuda.synchronize()
        err = max(max_abs_err(out, ref), max_abs_err(out, plain))
        worst = max(worst, err)
        check(err <= FLASH_ATOL, f"flash attention off by {err} at "
              f"{(B, H, Hkv, S, D, causal, window)}")
        del q, k, v, out, ref, plain
    torch.cuda.empty_cache()
    print(f"flash kernel checks: {len(FLASH_CASES)} cases within "
          f"{FLASH_ATOL}; worst |err| {worst:.3e}", flush=True)
    return worst


@phase("LIF entry points, 1,000 steps at n = 139,255")
def phase_lif_path(smi):
    """The LIF kernels' main path: their entry points (lif_update,
    lif_update_fx) for T_LIF steps on a FlyWire-sized population with a
    sparse integer drive, counts zeroed just before and read just after;
    the final state and every step's spikes bitwise against the plain
    versions run on the same inputs.  Then each kernel timed at that
    shape against its plain version and its byte bound."""
    import torch
    from repro_torch.core.neuron import FLYWIRE_LIF as P, LIFState
    from repro_torch.kernels.lif import kernel as LK
    from repro_torch.kernels.lif import lif_update, lif_update_fx
    n = N_FULL
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    drive = torch.randint(-3, 8, (T_LIF, n), generator=gen,
                          device=DEVICE, dtype=torch.int8)
    drive *= (torch.rand((T_LIF, n), generator=gen, device=DEVICE)
              < 0.002).to(torch.int8)
    out, ms_step = {}, {}
    for fx in (False, True):
        v0 = (torch.randn(n, generator=gen, device=DEVICE) * 5.0)
        g0 = torch.rand(n, generator=gen, device=DEVICE) * 3.0
        if fx:
            state = LIFState(v=(v0 * 4096 / P.w_scale).to(torch.int32),
                             g=(g0 * 4096 / P.w_scale).to(torch.int32),
                             refrac=torch.zeros(n, dtype=torch.int32,
                                                device=DEVICE))
            step, name = lif_update_fx, "lif_update_fx32"
            g_in = lambda t: drive[t].to(torch.int32)  # noqa: E731
        else:
            # a third start within 1,000 quiet steps of the subnormals
            g0 = torch.where(torch.arange(n, device=DEVICE) % 3 == 0,
                             g0 * 1e-35, g0)
            state = LIFState(v=v0, g=g0, refrac=torch.zeros(
                n, dtype=torch.int32, device=DEVICE))
            step, name = lif_update, "lif_update_f32"
            g_in = lambda t: drive[t].float() * P.w_scale  # noqa: E731
        plain = LK.lif_update_fx_ref if fx else LK.lif_update_ref
        ref = LIFState(*(x.clone() for x in state))
        zeros = torch.zeros_like(state.v)
        zi = torch.zeros(n, dtype=torch.int32, device=DEVICE)
        spikes_ref = torch.zeros(n, dtype=torch.int64, device=DEVICE)
        for t in range(T_LIF):
            v, g, r, s = plain(*ref, g_in(t), zeros, zi, params=P)
            ref = LIFState(v, g, r)
            spikes_ref += s
        torch.cuda.synchronize()
        spikes = torch.zeros(n, dtype=torch.int64, device=DEVICE)
        reset_all_launches()
        t0 = time.perf_counter()
        for t in range(T_LIF):
            state, s = step(state, g_in(t), P)
            spikes += s
        torch.cuda.synchronize()
        ms_step[name] = (time.perf_counter() - t0) * 1e3 / T_LIF
        launches = dict(LK.LAUNCHES)
        check(launches[name] == T_LIF, f"{name} launched {launches[name]} "
              f"times in {T_LIF} steps")
        check(equal_all(state, ref) and torch.equal(spikes, spikes_ref),
              f"{name}: {T_LIF}-step trajectory != plain")
        zero_g = int((state.g == 0).sum())
        print(f"{name}: {T_LIF} steps, {ms_step[name]:.4f} ms/step, "
              f"{int(spikes.sum())} spikes, {zero_g} neurons at g == 0, "
              f"launches {launches}; bitwise equal to plain", flush=True)
        args = (*state, g_in(0), zeros, zi)
        kern = LK.lif_update_fx32 if fx else LK.lif_update_f32
        call_ms = cuda_ms(lambda: kern(*args, params=P), 200)
        ms = kernel_device_ms(lambda: kern(*args, params=P), 200,
                              "lif_fx_kernel" if fx else "lif_f32_kernel")
        plain_ms = cuda_ms(lambda: plain(*args, params=P), 20)
        bound = n * 40 / HBM_BYTES_PER_S * 1e3
        out[name] = (ms, plain_ms, bound, None, 0.0, launches[name])
        print(f"{name}: kernel {ms:.5f} ms/launch (device time, profiler), "
              f"wrapper {call_ms:.5f} ms/call back to back (CUDA events), "
              f"plain {plain_ms:.5f} ms, bound {bound:.5f} ms ({n * 40} B); "
              f"card {smi}", flush=True)
    del drive
    torch.cuda.empty_cache()
    return out, ms_step


def causal_pairs(S: int, window) -> int:
    """(query, key) pairs a causal [window] mask keeps at length S."""
    import numpy as np
    i = np.arange(S)
    lo = np.zeros(S, np.int64) if window is None else np.maximum(
        0, i - window)
    return int((i - lo + 1).sum())


@phase("flash attention yardstick at the prefill's shapes")
def phase_flash_yardstick(smi, S=1024):
    """The kernel at a 1,024-token qwen2.5-14b prefill (H 40, Hkv 8, D
    128, causal): CUDA events, the plain version, the library call
    (scaled_dot_product_attention in float32, a yardstick the port never
    calls), and two flop bounds: the kernel's own work, three TF32
    products per float32 product at the TF32 tensor-core rate (the bound
    it reports), and the same flops as float32 FMAs on the CUDA cores."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    B, H, Hkv, D = 1, 40, 8, 128
    q, k, v = flash_inputs(B, H, Hkv, S, D, 99)
    out = flash_attention(q, k, v, causal=True)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    torch.cuda.synchronize()
    check(max_abs_err(out, lib) <= FLASH_ATOL, "flash != library call")
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    # the bare wrapper: one allocation and one launch per call, so at this
    # length CUDA events time the kernel itself
    dev_ms = cuda_ms(lambda: FK.flash_attention_gqa(
        q, k, v, scale=D ** -0.5, causal=True, window=None), 20)
    plain_ms = cuda_ms(lambda: FK.flash_attention_plain(
        q, k, v, scale=D ** -0.5, causal=True, window=None), 5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    flops = 4 * D * B * H * causal_pairs(S, None)
    nbytes = 4 * (2 * B * H * S * D + 2 * B * Hkv * S * D)
    bound = max(3 * flops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_f32 = max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"flash_attention at S={S}: {ms:.5f} ms/call (CUDA events; "
          f"bare kernel wrapper {dev_ms:.5f} ms, CUDA events), "
          f"{flops / ms / 1e9:.2f} TFLOP/s float32-equivalent "
          f"({3 * flops / ms / 1e9:.2f} TFLOP/s of TF32 products), plain "
          f"{plain_ms:.5f} ms, scaled_dot_product_attention {lib_ms:.5f} "
          f"ms; bound {bound:.5f} ms (3xTF32: {3 * flops} TF32 flop at "
          f"495 TFLOP/s), float32 CUDA-core bound {bound_f32:.5f} ms "
          f"({flops} flop at 67 TFLOP/s; {nbytes} B); card {smi}",
          flush=True)
    del q, k, v, out, lib
    torch.cuda.empty_cache()
    return ms, plain_ms, bound, lib_ms


def lm_requests(vocab: int):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(s)),
                    max_new=LM_NEW) for i, s in enumerate(lens)]


def serve(params, cfg, label):
    """One ServingEngine run of the LM requests; returns (tokens by rid,
    stats, seconds, launches)."""
    import torch
    from repro_torch.serving import ServeConfig, ServingEngine
    eng = ServingEngine(params, cfg, ServeConfig(batch_slots=LM_SLOTS,
                                                 max_len=LM_MAX_LEN))
    reqs = lm_requests(cfg.vocab)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {m.__name__.split(".")[-2]: dict(m.LAUNCHES)
                for m in kernel_modules()}
    stats = eng.stats()
    check(len(done) == LM_REQUESTS and all(
        r.done and not r.truncated and len(r.out) == LM_NEW for r in done),
        f"{label}: not every request was answered in full")
    n_tok = sum(len(r.out) for r in done)
    print(f"{label}: {len(done)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), {n_tok} tokens in "
          f"{secs:.3f} s ({n_tok / secs:.2f} tokens/s); stats "
          f"{json.dumps(stats)}; launches {launches}", flush=True)
    del eng
    torch.cuda.empty_cache()
    return {r.rid: r.out for r in done}, stats, secs, launches


def top2_gap(params, cfg, tokens) -> float:
    """Gap between the two largest next-token logits after ``tokens``."""
    import numpy as np
    import torch
    from repro_torch.models import prefill
    t = torch.from_numpy(np.asarray(tokens, dtype=np.int64))[None].to(DEVICE)
    logits, _ = prefill(params, {"tokens": t}, cfg, len(tokens))
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


@phase("qwen2.5-14b serving through the flash kernel")
def phase_lm(smi):
    """The LM path at the full published width and depth: init, serve the
    requests with attention_impl="pallas" (launch counts zeroed just
    before, read just after: one flash launch per layer per prefill),
    then the same weights with the plain "chunked" attention; tokens must
    agree, or differ only after a near-tie (top-2 gap <= LOGIT_TOL)."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch.configs import qwen2_5_14b
    from repro_torch.models import count_params, decode_step, init_params
    from repro_torch.models import init_cache, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dc.replace(qwen2_5_14b.CONFIG, attention_impl="pallas")
    plain_cfg = dc.replace(cfg, attention_impl="chunked")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(LM_SEED, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == count_params(cfg), "parameter count")
    print(f"{cfg.name}: {n_params} float32 parameters "
          f"({n_params * 4 / 1e9:.3f} GB) drawn in "
          f"{time.perf_counter() - t0:.3f} s; {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}", flush=True)

    with torch.inference_mode():
        toks, stats, secs, launches = serve(params, cfg, "serve (flash)")
        n_flash = launches["flash_attention"]["flash_attention"]
        check(n_flash == cfg.n_layers * stats["admitted"],
              f"flash kernel launched {n_flash} times for "
              f"{stats['admitted']} prefills of {cfg.n_layers} layers")
        peak = torch.cuda.max_memory_allocated() / 1e9
        plain_toks, plain_stats, plain_secs, _ = serve(params, plain_cfg,
                                                       "serve (plain)")
        reqs = {r.rid: r for r in lm_requests(cfg.vocab)}
        # the logits of one prefill under both impls
        r0 = reqs[0]
        t = torch.from_numpy(r0.prompt.astype(np.int64))[None].to(DEVICE)
        la, _ = prefill(params, {"tokens": t}, cfg, len(r0.prompt))
        lb, _ = prefill(params, {"tokens": t}, plain_cfg, len(r0.prompt))
        d_logit = max_abs_err(la, lb)
        check(d_logit <= LOGIT_TOL, f"prefill logits differ by {d_logit}")
        differing = 0
        for rid, out in toks.items():
            ref = plain_toks[rid]
            if out == ref:
                continue
            differing += 1
            j = next(i for i, (x, y) in enumerate(zip(out, ref)) if x != y)
            gap = top2_gap(params, plain_cfg,
                           list(reqs[rid].prompt) + out[:j])
            print(f"request {rid}: tokens differ from step {j} on; top-2 "
                  f"logit gap there {gap:.3e}", flush=True)
            check(gap <= LOGIT_TOL, f"request {rid}: token {j} differs "
                  f"with a top-2 gap of {gap} > {LOGIT_TOL}")
        # one prefill (the longest prompt) and one 4-slot decode step at
        # the run's shapes, profiled: where the time goes
        longest = max(reqs.values(), key=lambda r: len(r.prompt))
        S = len(longest.prompt)
        t = torch.from_numpy(longest.prompt.astype(np.int64))[None].to(
            DEVICE)
        prefill_ms, pk = device_profile(
            lambda: prefill(params, {"tokens": t}, cfg, LM_MAX_LEN))
        print_breakdown(f"prefill of {S} tokens", prefill_ms, pk)
        cache = init_cache(cfg, LM_SLOTS, LM_MAX_LEN)
        tok4 = torch.zeros(LM_SLOTS, dtype=torch.int64, device=DEVICE)
        pos4 = torch.full((LM_SLOTS,), S, dtype=torch.int32, device=DEVICE)
        decode_ms, dk = device_profile(
            lambda: decode_step(params, cache, tok4, pos4, cfg), 3)
        print_breakdown(f"decode step of {LM_SLOTS} slots", decode_ms, dk)
        print(f"decode bound: {n_params * 4 / 1e9:.3f} GB of weights at "
              f"3.35 TB/s = {n_params * 4 / HBM_BYTES_PER_S * 1e3:.3f} ms",
              flush=True)
        del cache
    print(f"qwen2.5-14b serving: flash run {secs:.3f} s, plain run "
          f"{plain_secs:.3f} s, {differing} of {len(toks)} requests differ "
          f"in tokens; prefill logits |diff| {d_logit:.3e}; one prefill of "
          f"{S} tokens {prefill_ms:.3f} ms; one decode step of "
          f"{LM_SLOTS} slots {decode_ms:.3f} ms (profiled); peak device memory "
          f"{peak:.3f} GB; stats equal {stats == plain_stats}; card {smi}",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return n_flash


def flywire_section(smi):
    """The simulate() phases at full FlyWire size; returns the kernel
    numbers of the two spike_prop kernels and frees the card."""
    import gc

    import torch
    from repro_torch.configs.flywire import CONFIG
    from repro_torch.core.connectome import synthetic_flywire
    from repro_torch.exp import build_scenario
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
    yard, activity = phase_yardstick(c, cfg, syn, fused, smi)
    launches = {"spike_deliver": other_launches["spike_deliver"],
                "fused_deliver_lif": main_launches["fused_deliver_lif"]}
    del syn, fused, stim, c
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.3f} GB still allocated after the FlyWire "
          f"phases")
    print(f"FlyWire phases: blocked_fused {ms_fused:.4f} ms/step, csr "
          f"{ms_csr:.4f} ms/step; {left:.3f} GB left allocated", flush=True)
    return yard, activity, launches



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
    check_err.update(phase_lif_check())
    check_err["flash_attention"] = phase_flash_check()

    yard, activity, launches = flywire_section(smi)
    lif_yard, lif_ms_step = phase_lif_path(smi)
    for name, (ms, plain_ms, bound, lib_ms, err, n) in lif_yard.items():
        yard[name] = (ms, plain_ms, bound, lib_ms, err)
        launches[name] = n
    launches["flash_attention"] = phase_lm(smi)
    yard["flash_attention"] = (*phase_flash_yardstick(smi), 0.0)

    K, LK, FK = kernel_modules()
    rel = lambda p: os.path.relpath(p, here)  # noqa: E731
    sources = {**K.SOURCES, **LK.SOURCES, **FK.SOURCES}
    replaces = {
        "spike_deliver": "src/repro/kernels/spike_prop/kernel.py:78",
        "fused_deliver_lif": "src/repro/kernels/spike_prop/kernel.py:196",
        "lif_update_f32": "src/repro/kernels/lif/kernel.py:103",
        "lif_update_fx32": "src/repro/kernels/lif/kernel.py:115",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85"}
    kernels = []
    for name in replaces:
        ms, plain_ms, bound_ms, lib_ms, err = yard[name]
        kernels.append({
            "name": name, "route": "cuda", "source": rel(sources[name]),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(err, check_err[name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if name == "flash_attention"
            else "bytes",
            "library_ms": lib_ms, "held_against_plain": True})
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched")
    print(f"total {time.perf_counter() - t_all:.3f} s; LIF entry points "
          f"{json.dumps({k: round(v, 5) for k, v in lif_ms_step.items()})} "
          f"ms/step", flush=True)
    import torch
    print(json.dumps({"activity": activity}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
