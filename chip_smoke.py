#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch`` with nvcc and holds each
kernel against its plain PyTorch version, then drives these paths:

* ``simulate()`` on the full synthetic FlyWire network (139,255 neurons,
  15M synapses, the paper's Q19.12 configuration with 9-bit weights,
  ``sugar_feeding``) through the ``blocked_fused`` and ``blocked``
  engines and ``CONFIG.sim`` as it is (the ``event`` engine), checked
  bitwise against the ``csr`` engine on the same card;
* ``run_trials()``, the paper's 10-trial statistic, on the same network
  and stimulus: seeds 0..9 as one batch of 10 lanes through the
  ``blocked_fused``, ``blocked`` and ``csr`` engines and ``CONFIG.sim``,
  bitwise equal to each other and lane by lane to ``simulate()`` of each
  seed, their mean rates at ``core.validate.parity`` rmse 0; timed and
  profiled at B = 10 beside B = 1;
* ``simulate_distributed()`` on the same network cut into 12 partitions
  as the JAX package's CLI cuts it, emulated on the card, through the
  ``bitmap``, ``event`` and ``blocked`` exchange schemes (the last also
  with the fused kernel), checked bitwise against each other, with every
  partition's kernel output held against its plain version; and
  ``run_dist_trials()`` of 3 seeds through the same four, bitwise equal
  to each other and (``bitmap``) to ``simulate_distributed()`` per seed;
* the exact engines on the same network and stimulus, after the
  monolithic store is freed: ``binned`` (1,000 steps), ``ell`` at the
  uncapped width and ``dense`` (100 steps, W [n, n] = 77.57 GB built on
  the card) bitwise equal to ``csr``, ``ell`` at the default cap beside
  it, ``run_trials`` of 10 seeds through ``binned`` and ``dense`` lane by
  lane equal to ``simulate()``;
* the multi-process path: the P = 12 partitioning as 12 processes on the
  card (``torchrun``, ``gloo``), this script's ``--mp-worker`` mode being
  one rank: each scheme bitwise equal to its emulated run, trials,
  a killed and resumed chunked run, each rank's kernels held against
  their plain versions on its own slab; and one ``nccl`` rank at P = 1
  equal to ``simulate()``;
* on the same network, every scenario of the catalog through
  ``blocked_fused`` against ``csr`` (``background_storm``, ~2% of the
  neurons spiking a step, profiled, both delivery kernels timed at its
  spikes), and the main path in chunks, with telemetry and with
  checkpoints, bitwise equal to one run;
* the simulation CLI, ``python -m repro_torch.launch.simulate --scale
  full``, as a program (one run, a run killed after two chunks and its
  resume, a ``csr`` run: one digest; its telemetry stream checked and
  reported) and in process through ``main(argv)`` (a kill and resume
  with background checkpoint writes, the ``blocked`` engine, and the
  partitioned CLI at P = 12 unchunked and killed and resumed: one digest
  each; and the same P = 12 flags without ``--emulate`` under
  ``torchrun``, 12 ranks, the same digest), with the delivery kernels'
  launches counted;
* simulation serving on the same network: a ``SimServer`` packing
  ``sugar_feeding`` and ``step_response`` requests four to a batch onto
  the lane axis (``blocked_fused``, and a shorter server on ``blocked``),
  a crash retried, every result bitwise its ``run_trials`` lane and a
  solo ``simulate()``, each kernel launched once a step a batch; an
  ``event`` tier starved of capacity under ``background_storm``, which
  escalates and completes bitwise equal to a solo run at the final
  capacity; at P = 12, ``run_resilient`` recovering an injected
  partition failure of the ``faulty`` scheme (inner ``blocked``, the
  fused kernel) bitwise equal to the clean run, and dropped payloads
  counted; and the serving CLI, ``python -m repro_torch.launch.serve``,
  as a program with a crash-injected and a poisoned request;
* the LIF kernels' entry points (``kernels.lif.lif_update`` and
  ``lif_update_fx``) for 1,000 steps at FlyWire size, checked bitwise
  against their plain versions;
* ``ServingEngine`` on the full published qwen2.5-14b (48 layers, 14.8B
  float32 parameters, random weights from a seed) with
  ``attention_impl="pallas"``, the flash attention kernel, answering 8
  requests; its tokens are held against a plain-attention run of the same
  weights;
* the dense family completed and the MoE family, each at its full
  published width cut in depth: phi3-medium-14b (4 layers),
  command-r-35b (4), gemma3-12b (6: five 1,024-window local layers at
  d_head 256 and one global), grok-1-314b (2: 8 experts, top-2) and
  llama4-scout-17b-a16e (4: 16 experts, top-1, a shared expert), the MoE
  configs at their capacity factor 1.25, served through ``ServingEngine``
  with the flash kernel (one launch a layer a prefill) and with chunked
  attention: the same tokens, or a difference only after a near-tie of
  the next token or of an MoE routing decision; a prefill and a decode
  step profiled each;
* LM training (``repro_torch.train``) at qwen2.5-14b's full width, cut to
  4 layers (2.658B float32 parameters, chunked attention, remat, no
  TF32): 10 AdamW steps of 4 x 512 synthetic tokens, whose loss must
  fall; 4 microbatches against one batch; ``run_with_recovery`` from a
  checkpoint at step 5 after a failure injected at step 7, bitwise equal
  to the uninterrupted run; 2 steps profiled; the trained weights served
  through ``ServingEngine`` with the flash kernel and with chunked
  attention (the same tokens); and ``python -m repro_torch.launch.train
  --smoke`` as a program, recovering from ``--fail-at 30``;
* the same training run with ``compute_dtype=torch.bfloat16`` (float32
  masters and moments): 10 steps whose loss must fall and stay within
  ``BF16_LOSS_ATOL`` of the float32 run's, timed and profiled;
* ``repro_torch.parallel`` at phi3-medium-14b's full width, as ``gloo``
  ranks on the one card (``torchrun``; this script's ``--par-worker``
  mode is one rank): the sharded train step at 2 layers on a (data 1,
  model 2) mesh, bitwise the same 2 steps run unsharded, and on a
  (data 2, model 1) mesh at the microbatch tolerance; the GPipe schedule
  over 4 ranks, one full-width block a stage through the flash kernel,
  bitwise the blocks in sequence (36 and 24 flash launches);
  ``compressed_psum`` of a full-size ``w_up`` gradient on (pod 2, data
  2), bitwise the reduction in one process; and the training CLI's mesh
  path (``--smoke --data 2 --model 1`` under ``torchrun``) printing the
  unsharded run's lines.

The ``delay_event`` engine (per-synapse delays into a ring of pending
input) runs the benchmark's microcircuit cell as it is
(``portbench``'s ``pd14-q19`` configuration and ``bg8-b1024`` traffic:
77,169 neurons, 298.9M synapses, 58 ring slots, 1,024 lanes): the cell's
2,000 steps of ``run_trials`` from rest, each of its two kernels launched
once a step; then one more step from that run's final state, bitwise its
plain version (``kernels/delay_event/ref.py``) on the same card, each
kernel timed against its least bytes and the plain step beside them.

The port's cost tools (``repro_torch.launch``) are held against the
card: qwen2.5-14b's prefill and 4-slot decode step are counted on meta
tensors (``launch.hlo.count``) beside the same calls on the card, whose
time must be at least the counted bound, whose flash launches must be
the counted ones (48 a prefill) and whose ``max_memory_allocated`` rise
must be the counted peak's within PEAK_RTOL (a roofline table of the two
calls is printed); and ``launch.flywire_dryrun`` counts one rank's
window at P = 12 beside the emulated run's launches, and at 256 and 512
ranks.

The flash kernel is also timed at gemma3-12b's local layers (D 256,
window 1,024, S 1,024 and 2,048) beside its plain version and
``scaled_dot_product_attention``.

Both delivery kernels are also timed on the full FlyWire store with
0.1%, 1% and every neuron spiking, beside the ``torch.sparse`` CSR
product of the same spikes, and with B = 10 lanes of spikes in one
launch (the trials run's, and 0.1% and 1% per lane) beside the CSR
product with the dense [n, 10] spike matrix.  Every phase raises on
failure; nothing is caught.  The last lines are a JSON line of the
supervision and scenario numbers, a JSON line of the serving and
resilience numbers, a JSON line of the exact engines' and the 12-rank
path's numbers, a JSON line of the training numbers (float32 and
bfloat16), a JSON line of the parallel phase's numbers, a JSON line of
the LM families' numbers, the roofline table and a JSON line
of the cost tools' numbers, a JSON line of
those activity cases
(``background_storm``'s spikes among them), a JSON line of kernel
measurements, the card's name and power limit, and ``{"ok": true,
"device": ...}``.

It imports PyTorch, numpy and the port (``src/repro_torch``), and nothing
of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM float32 without tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12       # H100 SXM bfloat16 tensor cores, dense
PD14_CONFIG, PD14_TRAFFIC = "pd14-q19", "bg8-b1024"   # portbench's cell
PD14_SEED = 2**31 + 30
THREEFRY_OPS = 70              # a threefry-2x32 block, and the rate of any
OPS_PER_S = 66.9e12            # one operation, as portbench/yardstick.py
N_FULL = 139_255
SYN_FULL = 15_000_000
N_KERNEL_CHECK = 20_000
T_MAIN = 1_000
T_OTHER = 200
T_LIF = 1_000
P_DIST = 12                     # the paper's chip count, emulated on one card
T_DIST = 50                     # cut from 200 for the parallel phase
T_DIST_F32 = 25
T_DIST_TRACE = 10
T_TRIALS = 150                  # cut from 300 to keep the whole run
                                # under ~1,050 s (PERF.md section 4)
TRIAL_SEEDS = 10                # the reference's default: the paper's trials
T_TRIALS_TRACE = 20
# run_trials engines; "event" is CONFIG.sim as it is
TRIAL_ENGINES = ("blocked_fused", "blocked", "csr", "event")
DIST_TRIAL_SEEDS = 3
T_DIST_TRIALS = 50
TRIAL_ACTIVITY = (0.001, 0.01)  # per lane, each lane its own draws
# label: (exchange scheme, sim engine); "blocked_fused" is the blocked
# scheme with the fused kernel
DIST_RUNS = {"bitmap": ("bitmap", None), "event": ("event", None),
             "blocked": ("blocked", None),
             "blocked_fused": ("blocked", "blocked_fused")}
ACTIVITY = (0.001, 0.01, 1.0)   # fractions of the neurons spiking a step
T_EXACT = 1_000                 # binned against csr
T_EXACT_SHORT = 100             # ell uncapped and at the default cap, dense
T_EXACT_TRIALS = 100            # run_trials through binned and dense
EXACT_TRIAL_SEEDS = 10
T_EXACT_TRACE = 20              # profiled steps of each exact engine
MP_CHUNK = 20                   # the 12-rank chunked run, killed after 2
T_MP_NCCL = 200                 # one nccl rank, P = 1, step_response
MP_TIMEOUT = 600                # seconds for a torchrun of 12 ranks
T_SUPERVISE = 150               # chunked / telemetry / checkpoint runs
SUPERVISE_CHUNK = 75
SUPERVISE_REPS = 2              # one chunk and chunked, alternated
T_SUPERVISE_TRACE = 100         # profiled in one chunk and in chunks of
SUPERVISE_TRACE_CHUNK = 25      # this many steps
T_SCENARIO = 200                # each of the seven scenarios
T_STORM_TRACE = 20
CLI_SCALE = "full"              # the CLI's --scale: full FlyWire
CLI_T_MS = 50.0                 # the CLI's full-size run: 500 steps
CLI_CHUNK = 125
CLI_DIST_T_MS = 5.0             # the partitioned CLI: 50 steps at P = 12
CLI_DIST_CHUNK = 20
T_SERVE = 200                   # the server's requests (sugar / step mix)
SERVE_CHUNK = 50
SERVE_BATCH = 4
SERVE_SEEDS = 8
T_SERVE_OTHER = 100             # the blocked server and the escalation tier
T_SERVE_TRACE = 100             # a profiled batch in chunks of
SERVE_TRACE_CHUNK = 25          # this many steps
SERVE_ESCALATIONS = 5           # the event tier's budget of escalations
RESILIENT_CHUNK = 25            # run_resilient over faulty at P = 12
RESILIENT_FAIL_AT = 30          # inside the second chunk
T_PAYLOAD_DROP = 50
SERVE_CLI_REQUESTS = 8
# 9 resident blocks of 128 threads an SM: 65,536 / (9 x 128) registers a
# thread, rounded down to the allocation's multiple of 8; 19,216 B of
# shared memory a block, which cuobjdump reports with the 1 KB the card
# reserves for each block
MAX_REGS, MAX_SHARED = 56, 19_216 + 1_024
LM_REQUESTS = 8
LM_PROMPT = (256, 1536)        # prompt lengths drawn in this range
LM_NEW = 16
LM_SLOTS, LM_MAX_LEN = 4, 2048
# the prefill and the decode step counted on meta beside the card: CUDA
# event calls timed, and the counted peak's rise over the resident bytes
# against max_memory_allocated()'s (the tolerance PERF.md section 6 states)
LM_COUNT_REPS = (2, 10)
PEAK_RTOL, PEAK_ATOL_BYTES = 0.10, 128 << 20
# the FlyWire dry run: one rank's window of the event scheme counted at
# P = 12, beside the emulated run's launches, then at these rank counts
# (512 too would add ~7 s: PERF.md section 4)
DRY_STEPS, DRY_CORES = 18, (256,)
FLASH_ATOL = 2e-4              # the JAX package's tolerance for its kernel
# Two float32 runs whose attention sums in other orders may pick another
# token where the top two logits (magnitude ~1) are this close: about a
# hundred times the logit difference the two impls show on one prefill.
LOGIT_TOL = 1e-3
LM_SEED = 0
TRAIN_LAYERS = 4               # the depth cut: 2.658B parameters, 42.5 GB
TRAIN_BATCH, TRAIN_SEQ = 4, 512  # with gradients and AdamW moments
T_TRAIN = 10                   # AdamW steps of the full-width run
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
TRAIN_CKPT_AT, TRAIN_FAIL_AT = 5, 7
TRAIN_PROFILE_STEPS = 2
MB_LOSS_RTOL, MB_PARAM_ATOL = 1e-4, 2e-3  # tests/test_train.py's tolerance
TRAIN_CLI = ["--arch", "qwen2.5-14b", "--smoke", "--steps", "60",
             "--ckpt-every", "20", "--fail-at", "30"]
# the dense family completed and the MoE family, each at its full
# published width with depth the one cut: (config module, layers kept)
LM_FAMILIES = [("phi3_medium_14b", 4), ("command_r_35b", 4),
               ("gemma3_12b", 6),            # one whole 5:1 pattern
               ("grok1_314b", 2),            # 19.3 GB of experts a layer
               ("llama4_scout_17b_a16e", 4),
               # the recurrent and VLM families: recurrentgemma at
               # full depth (11.6 GB), rwkv6 4 of 32 layers (its WKV loop
               # issues ~6 launches a token and layer), llava 4 of 60
               ("recurrentgemma_2b", 26), ("rwkv6_7b", 4),
               ("llava_next_34b", 4)]
# whisper-medium (24 encoder + 24 decoder layers, 3.3 GB): a batch of
# seeded frames and prompts through prefill, then greedy decode steps
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 4, 32, 16
# an MoE routing decision whose top-k router-logit margin is this close
# counts as a near-tie, as LOGIT_TOL does for the next token
ROUTE_TOL = 1e-3
# the bfloat16 compute_dtype training run's losses against the float32
# run's of the same weights and batches, step by step
BF16_LOSS_ATOL = 0.05
# the parallel phase, at phi3-medium-14b's full width: sharded training
# over 2 gloo ranks on the card (2 of 40 layers: 1.709B parameters), the
# GPipe schedule over 4 ranks (one full-width block a stage), and
# compressed_psum on one full-size gradient leaf (w_up) over the same 4
PAR_LAYERS = 2
PAR_BATCH, PAR_SEQ, PAR_STEPS = 4, 512, 2
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 6, 512
# (2, 1) against the unsharded run, leaf by leaf: the distance's norm
# over the unsharded run's motion from the initial weights, and over
# each moment's own norm (PERF.md section 6, PR 23)
PAR_DP_PARAM_RTOL, PAR_DP_MOMENT_RTOL = 1e-2, 1e-3
PAR_CLI = ["--smoke", "--steps", "20", "--log-every", "1"]
PAR_TIMEOUT = 900               # seconds for a torchrun of the phase
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


def device_profile(fn, reps: int = 1, host: bool = True):
    """Run ``fn`` ``reps`` times under torch.profiler (after one warm-up
    call); returns (wall ms per call, {kernel name: (device ms per call,
    launches per call)}), or None for the kernels when the profiler
    recorded no device events.  ``host=False`` records the device's
    activity only: a call of tens of thousands of launches (the
    recurrent prefills) then takes seconds less to collect, and the host
    ops' recording does not slow the wall clock."""
    import collections

    import torch
    fn()
    torch.cuda.synchronize()
    acts = []
    if host or DEVICE != "cuda":
        acts.append(torch.profiler.ProfilerActivity.CPU)
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
    from repro_torch.kernels.threefry import kernel as TFK
    return K, LK, FK, TFK


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
    from repro_torch.kernels.threefry import kernel as TFK
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    res = simulate(c, cfg, t_steps, seed=0, syn=syn, stimulus=stim,
                   probes=probes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / t_steps
    launches = {**K.LAUNCHES, **TFK.LAUNCHES}
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
    # each step splits the keys and draws the sugar drive: one threefry
    # launch apiece
    check(launches["threefry_split"] == T_MAIN
          and launches["threefry_bernoulli"] == T_MAIN
          and launches["threefry_bits"] == 0,
          f"threefry launches {launches}, expected {T_MAIN} splits and "
          f"{T_MAIN} draws")
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
    return syn, fused, ref, ms_fused, ms_csr, launches


@phase("the paper's configuration as it is (CONFIG.sim, engine event)")
def phase_event_config(c, stim, ref):
    """``CONFIG.sim`` unmodified (the ``event`` engine, Q19.12, 9-bit
    weights) for T_MAIN steps of the main path's stimulus and seed; counts,
    state, dropped and raster bitwise equal to the main path's csr run,
    with nothing dropped."""
    import torch
    from repro_torch.configs.flywire import CONFIG
    from repro_torch.core import build_synapses
    from repro_torch.exp import ProbeSpec
    check(CONFIG.sim.engine == "event", "CONFIG.sim names another engine")
    t0 = time.perf_counter()
    syn = build_synapses(c, CONFIG.sim)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    res, ms, _ = run_engine(c, CONFIG.sim, T_MAIN, stim, syn,
                            ProbeSpec(raster=True), "CONFIG.sim (event) Q19.12")
    check(same_result(res, ref), "CONFIG.sim (event) != csr (counts, state or "
          "dropped) at full size")
    check(torch.equal(res.raster, ref.raster), "event raster differs from csr")
    check(int(res.dropped) == 0, f"the event engine dropped {int(res.dropped)} "
          f"synapse events")
    print(f"CONFIG.sim as it is: event engine {ms:.4f} ms/step over {T_MAIN} "
          f"steps (state built in {t_build:.3f} s; capacity "
          f"{CONFIG.sim.capacity}); bitwise equal to csr, dropped 0",
          flush=True)
    return ms


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


def delivery_bytes(blk_id, n_sb, refs, spk, nspk, state_bytes):
    """The spiking columns read, and the bytes a delivery call on the
    store with rows ``blk_id`` [n_tb, E] must move for these spikes: nspk,
    the live source blocks' spike entries, the slot of every (live source
    block, target block) pair (4 B each, what a slot index would hold; the
    kernel's binary search reads more, a 32-byte sector a probe), one
    256-byte int16 tile row for every spiking column of a stored tile, and
    `state_bytes` of state in and out.  `refs[b]` is the number of target
    blocks that hold a tile of source block b."""
    n_tb = blk_id.shape[0]
    n_live = int((nspk[:n_sb] > 0).sum())
    cols = int((spk[:n_sb].sum(1).long() * refs).sum())
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
    cols, deliver_bytes = delivery_bytes(syn.blk_id, syn.n_sb, refs, spk,
                                         nspk, rows * 4)
    _, fused_bytes = delivery_bytes(syn.blk_id, syn.n_sb, refs, spk, nspk,
                                    rows * 4 * 7)

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
    activity = [row for frac in ACTIVITY for row in activity_case(
        syn, refs, frac, (v, g, refrac), kw, smi, A)]
    del A
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


def activity_case(syn, refs, frac, state, kw, smi, A, s=None, case=None):
    """Both delivery kernels on the full store with a fraction ``frac`` of
    the neurons spiking (Bernoulli draws from numpy seed 0; 1.0 is every
    neuron), or with the given spikes ``s`` of a run (``case`` names it):
    each bitwise against its plain version once, then timed beside its
    byte bound (`delivery_bytes`, counted for these spikes);
    `spike_deliver` also beside the library call on the same spikes, the
    torch.sparse CSR product ``A @ s`` (CUDA events, 5 calls; its result
    must equal the kernel's)."""
    import numpy as np
    import torch
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
    if s is None:
        s = np.random.default_rng(0).random(syn.n) < frac
    else:
        frac = float(s.mean())
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
              f"neurons spiking ({case}) on the full store: max |err| {err}")
        del a, b
        ms, how = timed(fn, f"{name}_kernel")
        cols, nbytes = delivery_bytes(syn.blk_id, syn.n_sb, refs, spk, nspk,
                                      state_bytes)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        lib_ms, lib_note = None, ""
        if name == "spike_deliver":
            s_col = torch.from_numpy(s).to(DEVICE).to(torch.float32)[:, None]
            lib = (A @ s_col).reshape(-1)
            out_k = K.spike_deliver_tiles(*store).reshape(-1)[:syn.n]
            check(torch.equal(lib, out_k), f"torch.sparse CSR product != "
                  f"delivery kernel with {frac:.1%} spiking")
            lib_ms = cuda_ms(lambda: A @ s_col, 5, warmup=1)
            lib_note = (f"; torch.sparse CSR mv {lib_ms:.5f} ms (CUDA "
                        f"events), the kernel {lib_ms / ms:.2f}x as fast")
            del lib, out_k
        what = f"{frac:.1%} spiking" + (f", {case}" if case else "")
        print(f"{name} with {what} ({int(s.sum())} neurons, "
              f"{int((nspk[:syn.n_sb] > 0).sum())} live source blocks, "
              f"{cols} spiking columns of stored tiles): {ms:.5f} ms/call "
              f"({how}), bound {bound:.5f} ms ({nbytes} B), "
              f"{ms / bound:.2f}x the bound{lib_note}; bitwise equal to "
              f"plain; card {smi}", flush=True)
        out.append({"kernel": name, "spiking": frac, "case": case, "ms": ms,
                    "timed_by": how, "bound_ms": bound, "library_ms": lib_ms,
                    "max_abs_err": err})
    return out


def trial_run(c, cfg, t_steps, seeds, stim, syn, probes, label):
    """One run_trials() run with the launch counts zeroed just before and
    read just after; returns (result, ms per step, launches)."""
    import torch
    from repro_torch.exp import run_trials
    from repro_torch.kernels.spike_prop import kernel as K
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = run_trials(c, cfg, t_steps, seeds=seeds, syn=syn, stimulus=stim,
                     probes=probes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / t_steps
    launches = dict(K.LAUNCHES)
    print(f"{label}: {ms:.4f} ms/step over {t_steps} steps of "
          f"{len(res.seeds)} lanes ({ms / len(res.seeds):.4f} ms per "
          f"trial-step), spikes per lane "
          f"{res.counts.sum(dim=1).tolist()}, dropped "
          f"{res.dropped.tolist()}, launches {launches}", flush=True)
    return res, ms, launches


def same_trials(a, b) -> bool:
    import torch
    return (torch.equal(a.counts, b.counts)
            and torch.equal(a.dropped, b.dropped)
            and all(torch.equal(x, y) for x, y in zip(a.state, b.state)))


@phase("trials, B = 10, full FlyWire (Q19.12)")
def phase_trials(c, cfg, stim, syn, smi):
    """The paper's 10-trial statistic: ``run_trials`` with seeds 0..9 for
    T_TRIALS steps through each of TRIAL_ENGINES (``event`` is
    ``CONFIG.sim`` as it is); counts, LIF state and ``dropped`` bitwise
    equal across the engines and, lane by lane, to ``simulate()`` of each
    seed on ``blocked_fused``; ``core/validate.parity`` of the
    ``blocked_fused`` and ``csr`` mean rates must read rmse 0 and no
    non-finite rate.  Each blocked engine launches its kernel once a step
    for all ten lanes.  Then ms/step (host clock) and device busy time a
    step (profiler, T_TRIALS_TRACE steps) at B = 10 beside B = 1."""
    import torch
    from repro_torch.configs.flywire import CONFIG
    from repro_torch.core import build_synapses, simulate
    from repro_torch.core.validate import parity
    from repro_torch.exp import ProbeSpec, run_trials
    from repro_torch.kernels.spike_prop import kernel as K
    T, p = T_TRIALS, cfg.params
    runs = {}
    for engine in TRIAL_ENGINES:
        run_cfg = (CONFIG.sim if engine == "event"
                   else dataclasses.replace(cfg, engine=engine))
        s = syn if engine.startswith("blocked") else build_synapses(c,
                                                                    run_cfg)
        probes = ProbeSpec(raster=engine == "blocked_fused")
        runs[engine] = trial_run(c, run_cfg, T, TRIAL_SEEDS, stim, s, probes,
                                 f"run_trials {engine} Q19.12")
        del s
        want = {"spike_deliver": T if engine == "blocked" else 0,
                "fused_deliver_lif": T if engine == "blocked_fused" else 0}
        check(runs[engine][2] == want, f"run_trials {engine}: launches "
              f"{runs[engine][2]}, expected {want}: one a step for all "
              f"{TRIAL_SEEDS} lanes")
    torch.cuda.empty_cache()
    fused = runs["blocked_fused"][0]
    check(all(int(x) > 0 for x in fused.counts.sum(dim=1)),
          "a lane never spiked")
    check(not torch.equal(fused.counts[0], fused.counts[1]),
          "lanes 0 and 1 are the same trial")
    for engine, (res, _, _) in runs.items():
        check(same_trials(res, fused), f"run_trials {engine} != "
              f"blocked_fused (counts, state or dropped)")
    check(int(fused.dropped.sum()) == 0, "the trials dropped synapse events")
    single_ms = []
    for b, seed in enumerate(fused.seeds):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        one = simulate(c, cfg, T, seed=seed, syn=syn, stimulus=stim,
                       probes=ProbeSpec())
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3 / T)
        check(K.LAUNCHES["fused_deliver_lif"] == T, "simulate() launches")
        check(torch.equal(one.counts, fused.counts[b])
              and torch.equal(one.dropped, fused.dropped[b])
              and all(torch.equal(x, y[b]) for x, y in zip(one.state,
                                                           fused.state)),
              f"run_trials lane {b} != simulate(seed={seed})")
    stats = parity(fused.mean_rates_hz(T, p.dt),
                   runs["csr"][0].mean_rates_hz(T, p.dt))
    print(f"parity(blocked_fused, csr) over {TRIAL_SEEDS} trials: "
          f"{stats.summary()}", flush=True)
    check(stats.rmse_hz == 0 and stats.n_nonfinite == 0,
          f"parity of blocked_fused and csr: {stats}")
    ms_b10 = runs["blocked_fused"][1]
    ms_b1 = sum(single_ms) / len(single_ms)
    prof = {}
    for label, fn in (
            ("B = 10", lambda: run_trials(c, cfg, T_TRIALS_TRACE,
                                          seeds=TRIAL_SEEDS, syn=syn,
                                          stimulus=stim,
                                          probes=ProbeSpec())),
            ("B = 1", lambda: simulate(c, cfg, T_TRIALS_TRACE, seed=0,
                                       syn=syn, stimulus=stim,
                                       probes=ProbeSpec()))):
        wall_ms, kernels = device_profile(fn)
        per_step = None if kernels is None else {
            k: (v / T_TRIALS_TRACE, n / T_TRIALS_TRACE)
            for k, (v, n) in kernels.items()}
        print_breakdown(f"blocked_fused {label}, trace over "
                        f"{T_TRIALS_TRACE} steps, per step",
                        wall_ms / T_TRIALS_TRACE, per_step, top=6)
        prof[label] = (None if per_step is None else
                       (sum(v for v, _ in per_step.values()),
                        sum(n for _, n in per_step.values())),
                       wall_ms / T_TRIALS_TRACE)
    busy = {k: ("not measured" if v[0] is None else
                f"{v[0][0]:.4f} ms over {v[0][1]:.0f} device ops")
            for k, v in prof.items()}
    print(f"trials: B = 10 {ms_b10:.4f} ms/step = {ms_b10 / TRIAL_SEEDS:.4f} "
          f"ms per trial-step; B = 1 (simulate, mean of {len(single_ms)} "
          f"seeds) {ms_b1:.4f} ms/step (min {min(single_ms):.4f}, max "
          f"{max(single_ms):.4f}); trial throughput "
          f"{ms_b1 * TRIAL_SEEDS / ms_b10:.2f}x the single run's; device "
          f"busy a step: {json.dumps(busy)}; csr {runs['csr'][1]:.4f}, "
          f"blocked {runs['blocked'][1]:.4f}, CONFIG.sim (event) "
          f"{runs['event'][1]:.4f} ms/step at B = 10; all bitwise equal, "
          f"each lane to simulate(); card {smi}", flush=True)
    launches = {"spike_deliver": runs["blocked"][2]["spike_deliver"],
                "fused_deliver_lif": runs["blocked_fused"][2][
                    "fused_deliver_lif"]}
    del runs
    return fused, launches


def lane_bytes(blk_id, n_sb, refs, spk, nspk, state_bytes):
    """For B lanes' spikes (``spk`` [B, n_sb+1, 128], ``nspk`` [B,
    n_sb+1]) on the store with rows ``blk_id``: (rows of the union, the
    bound's bytes, the per-lane design's bytes).  The bound counts what a
    call must move for these spikes, each byte once over the lanes: every
    lane's nspk and its live blocks' spike entries, the slot of every
    (source block live in any lane, target block) pair, one 256-byte tile
    row for every (target block, source neuron spiking in any lane) pair
    with a stored tile, and ``state_bytes`` of all lanes' state in and
    out.  The per-lane design (the kernels of this port) moves each
    lane's own `delivery_bytes`: a row once for every lane that spikes
    its source."""
    B, n_tb = spk.shape[0], blk_id.shape[0]
    any_spk = (spk[:, :n_sb] != 0).any(dim=0)                # [n_sb, 128]
    union_cols = int((any_spk.sum(dim=1).long() * refs).sum())
    live_any = int(any_spk.any(dim=1).sum())
    n_live = int((nspk[:, :n_sb] > 0).sum())
    union = (nspk.numel() * 4 + n_live * 128 * 4 + live_any * n_tb * 4
             + union_cols * 256 + state_bytes)
    per_lane = sum(delivery_bytes(blk_id, n_sb, refs, spk[b], nspk[b],
                                  state_bytes // B)[1] for b in range(B))
    return union_cols, union, per_lane


@phase("kernel yardstick at B = 10 lanes")
def phase_trials_yardstick(c, cfg, syn, trials, smi):
    """Both delivery kernels on the full store with B = 10 lanes of
    spikes, one launch each: the spikes each lane of the trials run
    delivers next (its busiest of the last delay steps; the fused kernel
    on the run's final state), and 0.1% and 1% of the neurons spiking,
    each lane its own Bernoulli draws (numpy seed 1).  Each bitwise
    against its plain version; then timed (`timed`) beside the plain
    version, the union bound (`lane_bytes`, at 3.35 TB/s), the bytes the
    per-lane design moves, and for `spike_deliver` the one library call
    of the same function, ``torch.sparse`` CSR x the dense [n, 10] spike
    matrix (CUDA events, 5 calls; its result must equal the kernel's)."""
    import numpy as np
    import torch
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
    p, B = cfg.params, TRIAL_SEEDS
    n_tb, n = syn.blk_id.shape[0], syn.n
    raster = trials.records["raster"][:, -p.delay_steps:]   # [B, D, n]
    busiest = raster.sum(dim=2).argmax(dim=1)
    run_spikes = raster[torch.arange(B, device=raster.device), busiest]
    rows = n_tb * 128

    def rowblk(x):
        out = torch.zeros((B, rows), dtype=x.dtype, device=x.device)
        out[:, :n] = x
        return out.reshape(B, n_tb, 128)
    state = tuple(rowblk(x) for x in trials.state)
    kw = dict(params=p, fixed_point=cfg.fixed_point)
    refs = torch.bincount(syn.blk_id.reshape(-1).long(),
                          minlength=syn.n_sb + 1)[:syn.n_sb]
    A = sparse_matrix(c, cfg, DEVICE)
    rng = np.random.default_rng(1)
    cases = [("run", run_spikes)] + [
        (frac, torch.from_numpy(rng.random((B, n)) < frac).to(DEVICE))
        for frac in TRIAL_ACTIVITY]
    out = {"spike_deliver": [], "fused_deliver_lif": []}
    for what, spikes in cases:
        spk, nspk = pad_spike_blocks(spikes, n, syn.n_sb)
        store = (syn.blk_id, syn.weights, spk, nspk)
        S = spikes.to(torch.float32).T.contiguous()            # [n, B]
        for name, fn, plain, state_bytes in (
                ("spike_deliver", lambda: (K.spike_deliver_tiles(*store),),
                 lambda: (K.spike_deliver_plain(*store),), B * rows * 4),
                ("fused_deliver_lif",
                 lambda: K.fused_deliver_lif(*store, *state, **kw),
                 lambda: K.fused_deliver_lif_plain(*store, *state, **kw),
                 B * rows * 4 * 7)):
            a, b = fn(), plain()
            torch.cuda.synchronize()
            err = max(max_abs_err(x, y) for x, y in zip(a, b))
            check(equal_all(a, b), f"{name} != plain at B = {B}, spikes "
                  f"{what}: max |err| {err}")
            lib_ms = None
            if name == "spike_deliver":
                check(torch.equal((A @ S).T, a[0].reshape(B, -1)[:, :n]),
                      f"torch.sparse CSR x dense != delivery kernel at B = "
                      f"{B}, spikes {what}")
                lib_ms = cuda_ms(lambda: A @ S, 5, warmup=1)
            del a, b
            ms, how = timed(fn, f"{name}_kernel")
            # one call (~1.65 s at B = 10) after the checked one
            plain_ms = cuda_ms(plain, 1, warmup=0)
            cols, union, per_lane = lane_bytes(syn.blk_id, syn.n_sb, refs,
                                               spk, nspk, state_bytes)
            bound = union / HBM_BYTES_PER_S * 1e3
            per_lane_ms = per_lane / HBM_BYTES_PER_S * 1e3
            lib_note = ("" if lib_ms is None else
                        f", torch.sparse CSR x dense [n, {B}] {lib_ms:.5f} "
                        f"ms (CUDA events)")
            print(f"{name} at B = {B}, spikes {what} "
                  f"({spikes.sum(dim=1).tolist()} a lane, {cols} union "
                  f"rows): {ms:.5f} ms/call ({how}), plain {plain_ms:.3f} "
                  f"ms, union bound {bound:.5f} ms ({union} B), per-lane "
                  f"design {per_lane_ms:.5f} ms ({per_lane} B, "
                  f"{per_lane / union:.2f}x the union), {ms / bound:.2f}x "
                  f"the bound{lib_note}; bitwise equal to plain; card {smi}",
                  flush=True)
            out[name].append({"spiking": what, "ms": ms, "timed_by": how,
                              "plain_ms": plain_ms, "bound_ms": bound,
                              "per_lane_bound_ms": per_lane_ms,
                              "library_ms": lib_ms, "max_abs_err": err})
    del A
    torch.cuda.empty_cache()
    return out


def served_equal(res, ref, b=None) -> bool:
    """A served request's SimResult bitwise against a solo run (``b``
    None) or lane ``b`` of a run_trials result: counts, every record, the
    LIF state and ``dropped``."""
    import torch

    def lane(x):
        return x if b is None else x[b]
    return (torch.equal(res.counts, lane(ref.counts))
            and torch.equal(res.dropped, lane(ref.dropped))
            and all(torch.equal(x, lane(y))
                    for x, y in zip(res.state, ref.state))
            and sorted(res.records) == sorted(ref.records)
            and all(torch.equal(v, lane(ref.records[k]))
                    for k, v in res.records.items()))


def serve_timed(server, reqs):
    """Drain ``reqs`` through ``server`` with the launch counts zeroed
    just before and read just after, under a telemetry session whose
    ``serve_batch`` events and spans give each batch's lanes, requested
    steps and wall time (the boundary's read of the lane counters
    synchronizes the device, so a span ends after its batch's last
    step; a batch cut by a crash or a breach ran fewer steps).  Returns
    (requests, launches, [(lanes, steps, wall ms)], stats, the
    ``serve_retry`` events)."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels.spike_prop import kernel as K
    events = []
    torch.cuda.synchronize()
    K.reset_launches()
    with obs.telemetry(events.append):
        done = server.run(reqs)
        torch.cuda.synchronize()
        stats = server.stats()
    launches = dict(K.LAUNCHES)
    heads = [e for e in events if e["type"] == "serve_batch"]
    spans = [e for e in events
             if e["type"] == "span" and e["name"] == "serve_batch"]
    check(len(heads) == len(spans) == stats["batches"],
          f"{len(heads)} batches, {len(spans)} spans")
    batches = [(h["size"], h["t_steps"], s["wall_s"] * 1e3)
               for h, s in zip(heads, spans)]
    retries = [e for e in events if e["type"] == "serve_retry"]
    return done, launches, batches, stats, retries


@phase("simulation serving at full size (SimServer, Q19.12)")
def phase_serving(c, cfg, syn, smi):
    """A SimServer on ``cfg`` (``blocked_fused``, Q19.12) with
    ``HealthConfig()``, batches of SERVE_BATCH lanes in chunks of
    SERVE_CHUNK steps: SERVE_SEEDS requests of T_SERVE steps alternating
    ``sugar_feeding`` and ``step_response`` (seeds 0..7), and one more
    ``sugar_feeding`` request whose hook crashes at its second chunk.
    Every request ends terminal; the crashed one is retried and
    completes; each completed request is bitwise its lane of one
    ``run_trials`` of its signature's seeds, and one request a signature
    (the retried one among them) bitwise a solo ``simulate()`` (the
    ``step_response`` one, which drives the fused kernel's Q19.12
    ``gstim`` channel, also on ``csr``); the
    fused kernel launches once a step a batch, not once a lane.  Then a
    shorter server on ``blocked`` (``spike_deliver`` counted the same
    way), equal to ``run_trials`` on ``blocked_fused``; a profiled
    served batch against ``run_trials`` (device calls a boundary); and
    an ``event`` tier (``CONFIG.sim``) starved of capacity on
    ``background_storm``, which escalates and completes bitwise equal to
    a solo run at the final capacity."""
    import torch
    from repro_torch.configs.flywire import CONFIG
    from repro_torch.core import simulate
    from repro_torch.core.capacity import escalate_capacity
    from repro_torch.core.exchange import ExchangeFault
    from repro_torch.core.health import HealthConfig
    from repro_torch.exp import ProbeSpec, build_scenario, run_trials
    from repro_torch.serving import (COMPLETED, SimRequest, SimServeConfig,
                                     SimServer)
    torch.cuda.reset_peak_memory_stats()
    T = T_SERVE
    probes = {"sugar_feeding": ProbeSpec(raster=True, pop_rate=True),
              "step_response": ProbeSpec(pop_rate=True, drops=True)}
    # the sugar requests ask for the paper's population and rate, as the
    # main path's stimulus does
    params = {"sugar_feeding": {"n_sugar": CONFIG.n_sugar,
                                "rate_hz": CONFIG.sugar_rate_hz},
              "step_response": {}}
    scenario = ["sugar_feeding", "step_response"]
    fired = []

    def crash_at_second_chunk(start, stop):
        if start == SERVE_CHUNK and not fired:
            fired.append(start)
            raise ExchangeFault(f"injected crash at step {start}")

    def request(name, seed, t_steps, **kw):
        return SimRequest(scenario=name, t_steps=t_steps, seed=seed,
                          params=params[name], probes=probes[name], **kw)

    reqs = [request(scenario[i % 2], i, T) for i in range(SERVE_SEEDS)]
    reqs.append(request("sugar_feeding", SERVE_SEEDS, T,
                        fault_hook=crash_at_second_chunk))
    serve = SimServeConfig(max_batch=SERVE_BATCH, chunk_steps=SERVE_CHUNK,
                           health=HealthConfig())
    server = SimServer(c, cfg, serve, syn=syn, device=DEVICE)
    t0 = time.perf_counter()
    done, launches, batches, stats, _ = serve_timed(server, reqs)
    wall = time.perf_counter() - t0
    crashed = reqs[-1]
    check(all(r.terminal for r in done) and len(done) == len(reqs),
          "a request did not end terminal")
    check(all(r.status == COMPLETED for r in done),
          f"statuses {[(r.rid, r.status, r.reason) for r in done]}")
    check(crashed.attempts == 1 and stats["retries"] == 1,
          f"the crashed request: attempts {crashed.attempts}, retries "
          f"{stats['retries']}")
    # two full batches of T steps, the crasher's first chunk, its retry
    steps = 3 * T + SERVE_CHUNK
    check(launches == {"spike_deliver": 0, "fused_deliver_lif": steps},
          f"served launches {launches}, expected {steps} fused: one a step "
          f"a batch")
    check(stats["batches"] == 4, f"{stats['batches']} batches, expected 4")

    # every lane against run_trials of its signature, one request per
    # signature against simulate()
    trial_ms = {}
    for name in scenario:
        group = [r for r in reqs[:SERVE_SEEDS] if r.scenario == name]
        s_stim = build_scenario(name, c, server.cfg, **params[name])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trials = run_trials(c, server.cfg, T, seeds=[r.seed for r in group],
                            syn=syn, stimulus=s_stim, probes=probes[name])
        torch.cuda.synchronize()
        trial_ms[name] = (time.perf_counter() - t0) * 1e3 / T
        for b, r in enumerate(group):
            check(served_equal(r.result, trials, b),
                  f"served {name} seed {r.seed} != run_trials lane {b}")
        if name == "sugar_feeding":     # step_response draws nothing
            check(not torch.equal(trials.counts[0], trials.counts[1]),
                  f"{name}: lanes 0 and 1 are the same trial")
        one = crashed if name == "sugar_feeding" else group[0]
        solo = simulate(c, server.cfg, T, seed=one.seed, syn=syn,
                        stimulus=s_stim, probes=probes[name])
        check(served_equal(one.result, solo),
              f"served {name} seed {one.seed} != simulate()")
        if name == "step_response":
            # the step drives the fused kernel's Q19.12 gstim channel:
            # the packed lane against csr, which converts on its own
            solo = simulate(c, dataclasses.replace(server.cfg, engine="csr"),
                            T, seed=one.seed, stimulus=s_stim,
                            probes=probes[name])
            check(served_equal(one.result, solo),
                  f"served {name} seed {one.seed} != simulate() on csr")
        del trials, solo
    spikes = {r.seed: int(r.result.counts.sum()) for r in done}
    # the full batches ran all their steps; the crasher's first ran one
    # chunk
    full = [ms / t for lanes, t, ms in batches if lanes == SERVE_BATCH]
    print(f"served {len(done)} requests of {T} steps in {wall:.3f} s: "
          f"batches (lanes, steps, wall ms) "
          f"{[(n, t, round(ms, 3)) for n, t, ms in batches]}, the full ones "
          f"{[round(ms, 4) for ms in full]} ms/step; run_trials "
          f"at B = {SERVE_BATCH}: "
          f"{json.dumps({k: round(v, 4) for k, v in trial_ms.items()})} "
          f"ms/step; latency p50 {stats['latency_p50_s']:.3f} s, p99 "
          f"{stats['latency_p99_s']:.3f} s; spikes {json.dumps(spikes)}; "
          f"launches {launches}; all bitwise equal to run_trials lanes and "
          f"simulate(); card {smi}", flush=True)
    del done

    # the blocked engine: the same tile store, spike_deliver once a step
    To = T_SERVE_OTHER
    blocked = SimServer(c, dataclasses.replace(cfg, engine="blocked"), serve,
                        syn=syn, device=DEVICE)
    reqs_b = [request("sugar_feeding", s, To) for s in range(SERVE_BATCH)]
    done_b, launches_b, batches_b, _, _ = serve_timed(blocked, reqs_b)
    sugar = build_scenario("sugar_feeding", c, server.cfg,
                           **params["sugar_feeding"])
    fused_trials = run_trials(c, server.cfg, To, seeds=SERVE_BATCH, syn=syn,
                              stimulus=sugar, probes=probes["sugar_feeding"])
    check(launches_b == {"spike_deliver": To, "fused_deliver_lif": 0}
          and len(batches_b) == 1,
          f"blocked server launches {launches_b}, expected {To} "
          f"spike_deliver in one batch; batches {batches_b}")
    for b, r in enumerate(done_b):
        check(r.status == COMPLETED and served_equal(r.result, fused_trials,
                                                     b),
              f"blocked server seed {r.seed} != blocked_fused run_trials")
    del done_b, fused_trials, blocked

    # device calls a boundary: a served batch (chunks of
    # SERVE_TRACE_CHUNK, the lanes' counters read at each boundary)
    # against run_trials of the same lanes in one chunk
    Tp, Kp = T_SERVE_TRACE, SERVE_TRACE_CHUNK
    trace_serve = SimServeConfig(max_batch=SERVE_BATCH, chunk_steps=Kp,
                                 health=HealthConfig())

    def served():
        SimServer(c, cfg, trace_serve, syn=syn, device=DEVICE).run(
            [request("sugar_feeding", s, Tp) for s in range(SERVE_BATCH)])

    def trials_run():
        run_trials(c, server.cfg, Tp, seeds=SERVE_BATCH, syn=syn,
                   stimulus=sugar, probes=probes["sugar_feeding"])
    issued = {}
    for label, fn in (("served", served), ("run_trials", trials_run)):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        busy = sum(e.time_range.end - e.time_range.start for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        issued[label] = {
            "issued": sum(1 for e in events if re.match(
                r"cu(da)?(Launch|Memcpy|Memset)", e.name)),
            "wall_ms_per_step": wall_ms / Tp, "busy_ms_per_step": busy / Tp}
    boundaries = Tp // Kp + 1          # the read at step 0 and each chunk's
    per_boundary = ((issued["served"]["issued"]
                     - issued["run_trials"]["issued"]) / boundaries)
    print(f"served batch of {SERVE_BATCH} lanes over {Tp} steps in chunks "
          f"of {Kp} against run_trials in one chunk: "
          f"{json.dumps(issued)}; {per_boundary:.2f} device calls a "
          f"boundary ({boundaries} reads of the lane counters)", flush=True)

    # the escalation tier: CONFIG.sim (event) with its default budgets on
    # background_storm, where max_drop_rate = 0 is breached
    storm_probes = ProbeSpec(pop_rate=True, drops=True)
    esc_cfg = dataclasses.replace(CONFIG.sim,
                                  health=HealthConfig(max_drop_rate=0.0))
    tier = SimServer(c, esc_cfg, SimServeConfig(
        max_batch=SERVE_BATCH, chunk_steps=SERVE_CHUNK,
        max_escalations=SERVE_ESCALATIONS), device=DEVICE)
    reqs_e = [SimRequest(scenario="background_storm", t_steps=To, seed=s,
                         probes=storm_probes) for s in range(2)]
    t0 = time.perf_counter()
    done_e, _, batches_e, stats_e, retries_e = serve_timed(
        tier, reqs_e)
    esc_s = time.perf_counter() - t0
    check(all(r.status == COMPLETED for r in done_e),
          f"escalation tier: {[(r.status, r.reason) for r in done_e]}")
    check(stats_e["escalations"] >= 1 and stats_e["escalated_tiers"] == 1
          and len(batches_e) == stats_e["escalations"] + 1,
          f"escalation tier stats {stats_e}")
    # the tier's final capacity: one escalate_capacity per drop-rate
    # retry the server announced
    bumps = [e["attempt"] for e in retries_e if e["reason"] == "drop_rate"]
    check(bumps == list(range(1, stats_e["escalations"] + 1)),
          f"drop-rate retries {retries_e}, escalations "
          f"{stats_e['escalations']}")
    final = CONFIG.sim.capacity
    for _ in bumps:
        final = escalate_capacity(final)
    storm = build_scenario("background_storm", c, esc_cfg)
    for r in done_e:
        solo = simulate(c, dataclasses.replace(tier.cfg, capacity=final), To,
                        seed=r.seed, stimulus=storm, probes=storm_probes)
        check(int(solo.dropped) == 0 and served_equal(r.result, solo),
              f"escalated storm seed {r.seed} != simulate() at {final}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80.0, f"peak device memory {peak:.3f} GB")
    storm_spikes = [int(r.result.counts.sum()) // To for r in done_e]
    print(f"escalation tier (event, background_storm, {To} steps, 2 lanes): "
          f"{stats_e['escalations']} escalations from "
          f"{CONFIG.sim.capacity} to {final} in {esc_s:.3f} s, attempts "
          f"(lanes, steps, wall ms) "
          f"{[(n, t, round(ms, 3)) for n, t, ms in batches_e]}, the last "
          f"{batches_e[-1][2] / To:.4f} ms/step, spikes a "
          f"step per lane {storm_spikes}; bitwise equal to simulate() at "
          f"the final capacity; peak device memory {peak:.3f} GB; card "
          f"{smi}", flush=True)
    return {"batch_ms_per_step": full, "batches": batches,
            "run_trials_ms_per_step": trial_ms,
            "latency_p50_s": stats["latency_p50_s"],
            "latency_p99_s": stats["latency_p99_s"], "wall_s": wall,
            "boundary_trace": issued,
            "device_calls_per_boundary": per_boundary,
            "escalations": stats_e["escalations"],
            "escalated_capacity": dataclasses.asdict(final),
            "escalation_s": esc_s, "peak_gb": peak,
            "launches": {"fused_deliver_lif": launches["fused_deliver_lif"],
                         "spike_deliver": launches_b["spike_deliver"]}}


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
    (1, 16, 16, 1500, 64, False, None),        # whisper's encoder
    (1, 10, 1, 1024, 256, True, 2048),         # recurrentgemma's local
    (1, 10, 1, 2048, 256, True, 2048),         # layers (10:1 GQA)
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
    at the sweep of tests/test_kernels.py, d_head 256 with a 1,024 window,
    whisper's non-causal encoder (D 64, 1,500 frames), recurrentgemma's
    local layers (one kv head for 10, D 256, window 2,048) and the
    qwen2.5-14b shapes.  Tolerance: atol 2e-4 (float32 sums in
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


@phase("the threefry kernel at the step loop's shapes")
def phase_threefry(smi):
    """The threefry kernel at the shapes the step loop draws: the key
    split of 32 and 1,024 lanes, storm's and sweep's background over
    FlyWire's n on 32 lanes (p 0.02, 0.002), the sugar drive's 20 draws
    on 1,024 and 32 lanes (p 0.015), and storm's background in threefry's
    original mode.  The keys are the carry's strided view of the last
    split, as the step passes them.  Each case bitwise the int64 chain
    (``threefry/ref.py``) on the same keys, then the kernel's device time
    (profiler), the chain's device time (profiler) and stream time (CUDA
    events), against the larger of THREEFRY_OPS operations a block at
    OPS_PER_S and the output's bytes at HBM_BYTES_PER_S.  No PyTorch call
    computes threefry: ``library_ms`` is null."""
    import numpy as np
    import torch
    from repro_torch.kernels.threefry import kernel as TFK
    from repro_torch.kernels.threefry import ref as TFR
    # label: (wrapper, lanes, num or draws a lane, p, partitionable)
    cases = {"split_b32": ("threefry_split", 32, 3, None, True),
             "split_b1024": ("threefry_split", 1024, 3, None, True),
             "storm": ("threefry_bernoulli", 32, N_FULL, 0.02, True),
             "sweep": ("threefry_bernoulli", 32, N_FULL, 0.002, True),
             "sugar_b1024": ("threefry_bernoulli", 1024, 20, 0.015, True),
             "sugar_b32": ("threefry_bernoulli", 32, 20, 0.015, True),
             "storm_original": ("threefry_bernoulli", 32, N_FULL, 0.02,
                                False)}
    out = {}
    for i, (label, (name, lanes, size, p, mode)) in enumerate(cases.items()):
        words = np.random.default_rng(i).integers(0, 2**32, (lanes, 2))
        carry = TFR.split_ref(torch.from_numpy(words.astype(np.int64)).to(
            DEVICE), 3, mode)
        key = carry[..., 0, :]
        check(not key.is_contiguous(), f"{label}: the key is not strided")
        if name == "threefry_split":
            kern = lambda: TFK.threefry_split(key, size, mode)  # noqa: E731
            plain = lambda: TFR.split_ref(key, size, mode)  # noqa: E731
        else:
            pf = float(np.float32(p))
            kern = lambda: TFK.threefry_bernoulli(  # noqa: E731
                key, pf, size, mode)
            plain = lambda: TFR.bernoulli_ref(  # noqa: E731
                key, pf, size, mode)
        TFK.reset_launches()
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(TFK.LAUNCHES[name] == 1, f"{label}: {TFK.LAUNCHES}")
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"{label}: {name} != the int64 chain")
        match = ("original" if not mode else "partitionable_words"
                 if name == "threefry_split" else "partitionable_draws")
        ms = kernel_device_ms(kern, 200, match)
        _, chain = device_profile(plain, 20)
        plain_ms = None if chain is None else sum(v for v, _ in
                                                  chain.values())
        plain_stream_ms = cuda_ms(plain, 20)
        t_ops = lanes * size * THREEFRY_OPS / OPS_PER_S * 1e3
        t_bytes = got.numel() * got.element_size() / HBM_BYTES_PER_S * 1e3
        out[label] = {
            "wrapper": name, "shape": [lanes, size], "p": p,
            "partitionable": mode, "ms": ms, "plain_ms": plain_ms,
            "plain_stream_ms": plain_stream_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}
        print(f"{label}: {name} [{lanes}, {size}] p {p} "
              f"{'partitionable' if mode else 'original'}: kernel "
              f"{ms:.5f} ms/launch, chain {plain_ms} ms device "
              f"({plain_stream_ms:.5f} ms stream), bound "
              f"{max(t_ops, t_bytes):.7f} ms ({out[label]['bound_by']}); "
              f"bitwise the chain; card {smi}", flush=True)
        del carry, key, got, want
    torch.cuda.empty_cache()
    return out


@phase("delay_event at the microcircuit cell's shapes")
def phase_delay_event(smi):
    """The cell ``pd14-bg8-b1024``'s network, configuration and stimulus
    through portbench's ``pd14_lif`` family (the network generated into
    ``build/portbench/`` on first use): ``run_trials`` of the cell's lanes
    and steps in its chunks on the card, ``LAUNCHES`` counted around it;
    then the step after its last, its drive drawn from fresh keys, through
    ``delay_step`` and through the plain ``delay_step_ref`` from the same
    ring and state: the LIF state, the spikes, the ring and both counters
    bitwise equal.  Each kernel's device time (profiler; the ring restored
    from a copy before each call) against its least bytes at
    HBM_BYTES_PER_S: 8 bytes a synapse event for ``delay_deliver`` (its
    4-byte word read, 4 bytes added), 41 bytes a lane-neuron for
    ``pending_lif`` (v, g and the countdown read and written, the slot
    read and zeroed, the drive's word read, the spike written); the plain
    step's device time by CUDA events.  Frees everything it made."""
    import numpy as np
    import torch
    from portbench import spec
    from repro_torch import random as prng
    from repro_torch.core import build_synapses, from_fanout
    from repro_torch.core.neuron import LIFState
    from repro_torch.exp import n_split, run_trials
    from repro_torch.kernels.delay_event import kernel as DK
    from repro_torch.kernels.delay_event.ref import delay_step_ref
    here = os.path.dirname(os.path.abspath(__file__))
    conf = spec.config(here, PD14_CONFIG)
    fam = spec.family(here, conf)
    traf = spec.traffic(here, PD14_TRAFFIC)
    B, T, K = traf["lanes"], traf["t_steps"], traf["chunk_steps"]
    t0 = time.perf_counter()
    net = fam.network(conf["network"], os.path.join(here, "build",
                                                    "portbench"))
    c = from_fanout(net["n"], net["out_indptr"], net["out_indices"],
                    net["out_weights"], net["out_delays"])
    stim = fam.program_stimulus(conf, traf, net).to(DEVICE)
    del net
    cfg = fam.program_config(conf)
    syn = build_synapses(c, cfg, DEVICE)
    print(f"pd14: {c.n} neurons, {c.nnz} synapses, D {syn.depth}, "
          f"{B} lanes; set-up {time.perf_counter() - t0:.1f} s", flush=True)
    DK.reset_launches()
    t0 = time.perf_counter()
    res = run_trials(c, cfg, T, seeds=spec.lane_seeds(PD14_SEED, B),
                     syn=syn, stimulus=stim, chunk_steps=K, device=DEVICE)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(DK.LAUNCHES)
    check(launches == {"pending_lif": T, "delay_deliver": T},
          f"delay_event launches {launches} in {T} steps")
    spikes_run = int(res.counts.sum())
    check(spikes_run > 0, "the microcircuit never spiked")
    print(f"pd14 run_trials: {T} steps x {B} lanes in {run_s:.3f} s, "
          f"{spikes_run / (B * T):.3f} spikes a lane-step; launches "
          f"{launches}", flush=True)
    v, g, refrac, ring = res.state
    pending = ring.movedim(-1, 0)                       # [D, B, n], no copy
    check(pending.is_contiguous(), "the ring came back as a copy")
    del res
    lif = LIFState(v=v, g=g, refrac=refrac)
    ptr = T % syn.depth
    keys = prng.split(prng.split(prng.PRNGKey(T), B).to(DEVICE),
                      n_split(stim))
    _, drive = stim.step(stim.init_state(c.n), keys[..., 1:, :], T, c.n,
                         cfg.params)
    saved = pending.clone()
    got = DK.delay_step(syn, pending, ptr, lif, drive, cfg.params,
                        cfg.fixed_point)
    want_ring = saved.clone()
    want = delay_step_ref(syn.indptr, syn.words, syn.tgt_bits, syn.w_bits,
                          want_ring, ptr, lif, drive, cfg.params,
                          cfg.fixed_point)
    torch.cuda.synchronize()
    check(equal_all(list(got[0]), list(want[0])), "delay_step's LIF state "
          "!= the plain version's")
    check(torch.equal(got[1], want[1]), "delay_step's spikes != plain")
    check(torch.equal(pending, want_ring), "delay_step's ring != plain")
    stats = {}
    for k in ("syn_events", "drive_events"):
        check(torch.equal(got[2][k], want[2][k]), f"{k} != plain")
        stats[k] = int(want[2][k].sum())
    spikes = int(want[1].sum())
    del got, want, want_ring
    print(f"pd14 step {T}: {spikes} spikes, {stats['syn_events']} synapse "
          f"events, {stats['drive_events']} drive events; bitwise the "
          f"plain version", flush=True)

    def step():
        pending.copy_(saved)
        DK.delay_step(syn, pending, ptr, lif, drive, cfg.params,
                      cfg.fixed_point)
    ms = {name: kernel_device_ms(step, 10, name)
          for name in ("pending_lif", "delay_deliver")}
    plain = []
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        pending.copy_(saved)
        torch.cuda.synchronize()
        a.record()
        delay_step_ref(syn.indptr, syn.words, syn.tgt_bits, syn.w_bits,
                       pending, ptr, lif, drive, cfg.params, cfg.fixed_point)
        b.record()
        torch.cuda.synchronize()
        plain.append(a.elapsed_time(b))
    plain_ms = float(np.median(plain))
    lane_neurons = B * c.n
    bounds = {"pending_lif": lane_neurons * 41 / HBM_BYTES_PER_S * 1e3,
              "delay_deliver": 8 * stats["syn_events"] / HBM_BYTES_PER_S
              * 1e3}
    out = {}
    for name in ("pending_lif", "delay_deliver"):
        out[name] = {"ms": ms[name], "plain_ms": plain_ms,
                     "bound_ms": bounds[name], "bound_by": "bytes",
                     "library_ms": None, "launches": launches[name],
                     "shape": [B, c.n, syn.depth], "spikes": spikes,
                     **stats}
        print(f"{name}: {ms[name]:.5f} ms/launch at the cell's step "
              f"{T} ({B} lanes, {spikes} spikes, {stats['syn_events']} "
              f"events), bound {bounds[name]:.5f} ms (bytes), the plain "
              f"step {plain_ms:.3f} ms; card {smi}", flush=True)
    del pending, saved, ring, lif, v, g, refrac, drive, syn, stim, c
    torch.cuda.empty_cache()
    return out


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


def flash_yardstick(smi, H, Hkv, S, D, window, label, seed, causal=True):
    """The kernel at one shape (B 1; causal unless told): CUDA events, the
    plain
    version, the library call (scaled_dot_product_attention in float32,
    with the window as a boolean mask; a yardstick the port never calls),
    and two flop bounds over the pairs the mask keeps: three TF32
    products per float32 product at the TF32 tensor-core rate (the bound
    it reports), and the same flops as float32 FMAs on the CUDA cores.
    The kernel is held against its plain version (FLASH_ATOL)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    B = 1
    q, k, v = flash_inputs(B, H, Hkv, S, D, seed)
    mask = None
    if window is not None:
        i = torch.arange(S, device=DEVICE)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window
                                             - 1)
    kw = dict(scale=D ** -0.5, causal=causal, window=window)

    def library():
        if mask is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    out = flash_attention(q, k, v, causal=causal, window=window)
    plain = FK.flash_attention_plain(q, k, v, **kw)
    lib = library()
    torch.cuda.synchronize()
    err = max_abs_err(out, plain)
    check(err <= FLASH_ATOL, f"{label}: flash != plain by {err}")
    check(max_abs_err(out, lib) <= FLASH_ATOL, f"{label}: flash != library")
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal,
                                         window=window), 20)
    # the bare wrapper: one allocation and one launch per call, so at this
    # length CUDA events time the kernel itself
    dev_ms = cuda_ms(lambda: FK.flash_attention_gqa(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: FK.flash_attention_plain(q, k, v, **kw), 5)
    lib_ms = cuda_ms(library, 20)
    flops = 4 * D * B * H * FK.kept_pairs(S, S, causal, window)
    nbytes = 4 * (2 * B * H * S * D + 2 * B * Hkv * S * D)
    bound = max(3 * flops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_f32 = max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"flash_attention, {label} (H {H}, Hkv {Hkv}, S {S}, D {D}, "
          f"window {window}, causal {causal}): {ms:.5f} ms/call (CUDA events; bare "
          f"kernel wrapper {dev_ms:.5f} ms, CUDA events), "
          f"{flops / ms / 1e9:.2f} TFLOP/s float32-equivalent "
          f"({3 * flops / ms / 1e9:.2f} TFLOP/s of TF32 products), plain "
          f"{plain_ms:.5f} ms, scaled_dot_product_attention {lib_ms:.5f} "
          f"ms; bound {bound:.5f} ms (3xTF32: {3 * flops} TF32 flop at "
          f"495 TFLOP/s), float32 CUDA-core bound {bound_f32:.5f} ms "
          f"({flops} flop at 67 TFLOP/s; {nbytes} B); |out - plain| "
          f"{err:.3e}; card {smi}", flush=True)
    del q, k, v, out, lib, plain
    torch.cuda.empty_cache()
    return ms, plain_ms, bound, lib_ms, err


@phase("flash attention yardstick at the prefill's shapes")
def phase_flash_yardstick(smi, S=1024):
    """The kernel at a 1,024-token qwen2.5-14b prefill (H 40, Hkv 8, D
    128, causal), then at gemma3-12b's local layers (H 16, Hkv 8, D 256,
    window 1,024) at S = 1,024 and at 2,048, where the window masks, at
    whisper-medium's encoder (H 16, D 64, 1,500 frames, not causal) and
    at recurrentgemma-2b's local layers (H 10, Hkv 1, D 256, window
    2,048) at S = 1,024 and 2,048.  Returns the qwen case's numbers and
    {label: numbers} of the others."""
    qwen = flash_yardstick(smi, 40, 8, S, 128, None, "qwen2.5-14b", 99)
    cases = {f"d256_window1024_S{s}": flash_yardstick(
        smi, 16, 8, s, 256, 1024, f"gemma3-12b local at S = {s}", 98)
        for s in (1024, 2048)}
    cases["d64_noncausal_S1500"] = flash_yardstick(
        smi, 16, 16, 1500, 64, None, "whisper-medium encoder", 97,
        causal=False)
    for s in (1024, 2048):
        cases[f"d256_hkv1_window2048_S{s}"] = flash_yardstick(
            smi, 10, 1, s, 256, 2048, f"recurrentgemma-2b local at S = {s}",
            96)
    return qwen[:4], cases


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


class RouteLog:
    """Records every MoE layer call of a serving run: the requests its
    batch rows belong to, and each token's top-k choices and margin (the
    k-th router logit minus the (k+1)-th).  ``install`` wraps the
    transformer's moe_apply and an engine's admission and decode step."""

    def __init__(self):
        self.rows, self.calls = None, []

    def install(self, eng):
        import torch

        import repro_torch.models.transformer as tfm
        from repro_torch.models import layers as L
        real = tfm.moe_apply
        add, step = eng.add_request, eng.step

        def moe_apply(p, h, *, top_k, capacity_factor, act):
            logits = (h @ p["router"]).float()
            top = torch.sort(logits, dim=-1, descending=True).values
            margin = top[..., top_k - 1] - top[..., top_k]
            choices = L.stable_top_k(logits.softmax(-1), top_k)[1]
            self.calls.append((self.rows, choices.cpu(), margin.cpu()))
            return real(p, h, top_k=top_k, capacity_factor=capacity_factor,
                        act=act)

        def add_request(req):
            self.rows = [req.rid]
            return add(req)

        def decode_step():
            self.rows = [None if r is None else r.rid for r in eng.live]
            return step()
        tfm.moe_apply = moe_apply
        eng.add_request, eng.step = add_request, decode_step
        return lambda: setattr(tfm, "moe_apply", real)


def first_route_flip(log_a, log_b, rid):
    """The first MoE decision of request ``rid`` (in execution order) that
    the two runs route differently: (call, position, margin), the margin
    the smaller of the two runs', or None when they route alike."""
    check(len(log_a.calls) == len(log_b.calls),
          "the two runs made different MoE calls")
    for i, ((rows, ca, ma), (rows_b, cb, mb)) in enumerate(
            zip(log_a.calls, log_b.calls)):
        check(rows == rows_b, "the two runs batched different requests")
        for r, owner in enumerate(rows):
            if owner != rid:
                continue
            diff = (ca[r] != cb[r]).any(-1).nonzero().flatten()
            if len(diff):
                s = int(diff[0])
                return i, s, float(min(ma[r, s], mb[r, s]))
    return None


def serve_logged(params, cfg):
    """The LM requests through a ServingEngine whose MoE calls are
    recorded; returns (tokens by rid, the RouteLog)."""
    from repro_torch.serving import ServeConfig, ServingEngine
    eng = ServingEngine(params, cfg, ServeConfig(batch_slots=LM_SLOTS,
                                                 max_len=LM_MAX_LEN))
    log = RouteLog()
    restore = log.install(eng)
    try:
        done = eng.run(lm_requests(cfg.vocab))
    finally:
        restore()
    return {r.rid: r.out for r in done}, log


def compare_served(params, cfg, plain_cfg, toks, plain_toks):
    """The flash run's tokens against the plain run's: equal, or apart
    only after a near-tie: of the next token (top-2 gap <= LOGIT_TOL) or,
    for an MoE config, of the first MoE decision that the two runs route
    differently for the request (both runs served again, recorded; its
    top-k margin <= ROUTE_TOL).  Every such case is printed.  Also the
    logits of one prefill under both impls, which must agree within
    LOGIT_TOL.  Returns (their largest difference, the requests that
    differ, the routing near-ties)."""
    import numpy as np
    import torch
    from repro_torch.models import prefill
    reqs = {r.rid: r for r in lm_requests(cfg.vocab)}
    r0 = reqs[0]
    t = torch.from_numpy(r0.prompt.astype(np.int64))[None].to(DEVICE)
    la, _ = prefill(params, {"tokens": t}, cfg, len(r0.prompt))
    lb, _ = prefill(params, {"tokens": t}, plain_cfg, len(r0.prompt))
    d_logit = max_abs_err(la, lb)
    check(d_logit <= LOGIT_TOL, f"prefill logits differ by {d_logit}")
    differ = [rid for rid, out in toks.items() if out != plain_toks[rid]]
    ties = []
    if differ and cfg.n_experts:
        again, log_a = serve_logged(params, cfg)
        again_plain, log_b = serve_logged(params, plain_cfg)
        check(again == toks and again_plain == plain_toks,
              "a served run is not deterministic")
    for rid in differ:
        out, ref = toks[rid], plain_toks[rid]
        j = next(i for i, (x, y) in enumerate(zip(out, ref)) if x != y)
        flip = (first_route_flip(log_a, log_b, rid) if cfg.n_experts
                else None)
        if flip is not None:
            call, pos, margin = flip
            print(f"request {rid}: tokens differ from step {j} on; first "
                  f"routing difference at MoE call {call}, position {pos}, "
                  f"top-k router-logit margin {margin:.3e}", flush=True)
            check(margin <= ROUTE_TOL, f"request {rid}: a routing decision "
                  f"flipped at a margin of {margin} > {ROUTE_TOL}")
            ties.append({"rid": rid, "step": j, "call": call,
                         "position": pos, "margin": margin})
            continue
        gap = top2_gap(params, plain_cfg, list(reqs[rid].prompt) + out[:j])
        print(f"request {rid}: tokens differ from step {j} on; top-2 "
              f"logit gap there {gap:.3e}", flush=True)
        check(gap <= LOGIT_TOL, f"request {rid}: token {j} differs "
              f"with a top-2 gap of {gap} > {LOGIT_TOL}")
    return d_logit, len(differ), ties


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
    from repro_torch.models.model import _abstract_module
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
        d_logit, differing, _ = compare_served(params, cfg, plain_cfg, toks,
                                               plain_toks)
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
        # the same two calls counted on meta (repro_torch.launch.hlo)
        meta = _abstract_module(cfg)
        t_m = torch.empty((1, S), dtype=torch.int64, device="meta")
        cache_m = init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device="meta")
        tok_m = torch.empty(LM_SLOTS, dtype=torch.int64, device="meta")
        pos_m = torch.empty(LM_SLOTS, dtype=torch.int32, device="meta")
        roof = [counted_beside_card(
            f"qwen2.5-14b prefill of {S} tokens", cfg,
            lambda: prefill(meta, {"tokens": t_m}, cfg, LM_MAX_LEN),
            (meta, t_m),
            lambda: prefill(params, {"tokens": t}, cfg, LM_MAX_LEN),
            LM_COUNT_REPS[0], smi, flash_want=cfg.n_layers),
            counted_beside_card(
            f"qwen2.5-14b decode step of {LM_SLOTS} slots", cfg,
            lambda: decode_step(meta, cache_m, tok_m, pos_m, cfg),
            (meta, cache_m, tok_m, pos_m),
            lambda: decode_step(params, cache, tok4, pos4, cfg),
            LM_COUNT_REPS[1], smi, flash_want=0)]
        del cache, meta, cache_m
    print(f"qwen2.5-14b serving: flash run {secs:.3f} s, plain run "
          f"{plain_secs:.3f} s, {differing} of {len(toks)} requests differ "
          f"in tokens; prefill logits |diff| {d_logit:.3e}; one prefill of "
          f"{S} tokens {prefill_ms:.3f} ms; one decode step of "
          f"{LM_SLOTS} slots {decode_ms:.3f} ms (profiled); peak device memory "
          f"{peak:.3f} GB; stats equal {stats == plain_stats}; card {smi}",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return n_flash, roof


def counted_beside_card(label, cfg, meta_fn, resident, cuda_fn, reps, smi,
                        flash_want=None):
    """One call counted on meta tensors (repro_torch.launch.hlo.count,
    ``resident`` live throughout) and run on the card: its time by CUDA
    events over ``reps`` calls, its flash launches by the wrapper's count
    and its peak by torch.cuda.max_memory_allocated() over one call.
    Gates: the counted bound (FLOPs at the compute dtype's peak, bytes at
    the HBM rate; repro_torch.launch.roofline.H100) is at most the
    measured time; the counted flash launches are the measured ones (and
    ``flash_want``); the counted peak's rise over the resident bytes is
    the measured rise within PEAK_RTOL or PEAK_ATOL_BYTES.  Returns the
    roofline row."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import hlo
    from repro_torch.launch.roofline import H100
    t0 = time.perf_counter()
    with torch.inference_mode(), hlo.count("meta", resident=resident) as c:
        resident_bytes = c.live
        meta_fn()
    count_s = time.perf_counter() - t0
    cost = c.cost
    counted_rise = cost.peak_bytes - resident_bytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    base_req = torch.cuda.memory_stats().get("requested_bytes.all.current",
                                             0)
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    cuda_fn()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    req_rise = torch.cuda.memory_stats().get("requested_bytes.all.peak",
                                             0) - base_req
    n_flash = FK.LAUNCHES["flash_attention"]
    ms = cuda_ms(cuda_fn, reps, warmup=1)
    dtype = str(cfg.compute_dtype or cfg.param_dtype).replace("torch.", "")
    t_ops = cost.flops / H100["flops"][dtype] * 1e3
    t_bytes = cost.bytes / H100["hbm_bw"] * 1e3
    bound_ms = max(t_ops, t_bytes)
    counted_flash = cost.kernels.get("flash_attention", 0)
    print(f"{label}: counted on meta in {count_s:.3f} s: {cost.flops:.6e} "
          f"FLOPs, {cost.bytes:.6e} B, {cost.launches} launches "
          f"({counted_flash} flash), peak {cost.peak_bytes} B ({counted_rise} "
          f"B over the {resident_bytes} B resident); on the card "
          f"{ms:.3f} ms (CUDA events, {reps} calls), {n_flash} flash "
          f"launches, max_memory_allocated rise {rise} B (requested "
          f"{req_rise} B); bound {bound_ms:.3f} ms by "
          f"{'operations' if t_ops >= t_bytes else 'bytes'} "
          f"({100 * bound_ms / ms:.2f}% of the measured); card {smi}",
          flush=True)
    check(bound_ms <= ms, f"{label}: counted bound {bound_ms:.3f} ms above "
          f"the measured {ms:.3f} ms")
    check(counted_flash == n_flash and (flash_want is None
                                        or n_flash == flash_want),
          f"{label}: {counted_flash} flash launches counted, {n_flash} "
          f"measured, {flash_want} expected")
    check(abs(counted_rise - rise) <= max(PEAK_RTOL * rise, PEAK_ATOL_BYTES),
          f"{label}: counted peak rise {counted_rise} B against the "
          f"measured {rise} B")
    return {"call": label, "flops": cost.flops, "bytes": cost.bytes,
            "launches": cost.launches, "flash_launches": n_flash,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ms": ms, "share": bound_ms / ms, "count_s": count_s,
            "peak_rise_counted": counted_rise, "peak_rise_measured": rise,
            "peak_rise_requested": req_rise}


def print_roofline(rows, smi) -> None:
    print("roofline of the counted calls (bound: the larger of the counted "
          f"FLOPs at the dtype's peak and bytes at 3.35 TB/s; card {smi}):",
          flush=True)
    print("| call | FLOPs | bytes | launches | bound ms | by | measured ms "
          "| share |", flush=True)
    for r in rows:
        print(f"| {r['call']} | {r['flops']:.4e} | {r['bytes']:.4e} | "
              f"{r['launches']} | {r['bound_ms']:.3f} | {r['bound_by']} | "
              f"{r['ms']:.3f} | {100 * r['share']:.2f}% |", flush=True)


def attention_layers(cfg) -> int:
    """Layers of kind "attn" or "local": one flash launch each a prefill
    (RG-LRU and RWKV layers launch none)."""
    from repro_torch.models.transformer import layer_kinds
    return sum(k in ("attn", "local") for k in layer_kinds(cfg))


def patch_prefill(params, cfg, plain_cfg):
    """One llava prefill with its n_patches seeded patch embeddings
    before the first request's prompt, through flash (launches counted
    from 0: one a layer) and chunked attention; the logits finite and
    within LOGIT_TOL.  Returns (launches, |diff|, tokens, ms)."""
    import numpy as np
    import torch
    from repro_torch.models import prefill
    g = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
    patches = torch.randn(1, cfg.n_patches, cfg.d_model, generator=g,
                          device=DEVICE)
    prompt = lm_requests(cfg.vocab)[0].prompt
    t = torch.from_numpy(prompt.astype(np.int64))[None].to(DEVICE)
    batch = {"tokens": t, "patches": patches}
    S = cfg.n_patches + t.shape[1]
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    la, _ = prefill(params, batch, cfg, S)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    from repro_torch.kernels.flash_attention import kernel as FK
    n = FK.LAUNCHES["flash_attention"]
    lb, _ = prefill(params, batch, plain_cfg, S)
    d = max_abs_err(la, lb)
    check(bool(torch.isfinite(la).all()), f"{cfg.name}: patch prefill "
          "logits not finite")
    check(d <= LOGIT_TOL, f"{cfg.name}: patch prefill logits differ by {d}")
    check(n == attention_layers(cfg), f"{cfg.name}: flash launched {n} "
          f"times in a patch prefill of {cfg.n_layers} layers")
    print(f"{cfg.name}: a prefill of {cfg.n_patches} patches + "
          f"{t.shape[1]} tokens ({S}) in {ms:.3f} ms, {n} flash launches, "
          f"logits |flash - chunked| {d:.3e}", flush=True)
    return n, d, S, ms


@phase("the LM families at full width (dense, MoE, recurrent, VLM)")
def phase_lm_families(smi):
    """Each config of LM_FAMILIES at its full published width, depth the
    one cut, float32 weights from init_params(LM_SEED): serve the LM
    requests through ServingEngine with attention_impl="pallas" (launch
    counts zeroed just before, read just after: one flash launch per
    attention layer per prefill, none for RG-LRU and RWKV layers;
    gemma3's five local layers run the kernel with its 1,024 window at
    D = 256, recurrentgemma's local layers with one kv head for 10 and a
    2,048 window), then with "chunked"; the tokens agree or differ only
    after a near-tie (compare_served, which for the MoE configs also
    counts a routing near-tie).  llava also runs one prefill with its
    patch embeddings (patch_prefill).  One prefill of the longest prompt
    and one 4-slot decode step are profiled; peak device memory.  Returns
    {config: flash launches} and the numbers."""
    import dataclasses as dc
    import importlib

    import numpy as np
    import torch
    from repro_torch.models import (count_params, decode_step, init_cache,
                                    init_params, prefill)
    torch.backends.cuda.matmul.allow_tf32 = False
    launches_by_cfg, out = {}, {}
    for mod_name, layers in LM_FAMILIES:
        t_cfg = time.perf_counter()
        full = importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
        cfg = dc.replace(full, n_layers=layers, attention_impl="pallas")
        plain_cfg = dc.replace(cfg, attention_impl="chunked")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(LM_SEED, cfg)
        n_params = sum(p.numel() for p in params.parameters())
        check(n_params == count_params(cfg), f"{cfg.name}: parameter count")
        print(f"{cfg.name}: {n_params} float32 parameters "
              f"({n_params * 4 / 1e9:.3f} GB), {layers} of {full.n_layers} "
              f"layers, d_model {cfg.d_model}, {cfg.n_heads}/"
              f"{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab}, pattern {cfg.block_pattern}, window "
              f"{cfg.window}, experts {cfg.n_experts} top-{cfg.top_k} "
              f"(capacity factor {cfg.moe_capacity_factor}, shared "
              f"{cfg.shared_expert})", flush=True)
        with torch.inference_mode():
            toks, stats, secs, launches = serve(params, cfg,
                                                f"{cfg.name} serve (flash)")
            n_flash = launches["flash_attention"]["flash_attention"]
            n_attn = attention_layers(cfg)
            check(n_flash == n_attn * stats["admitted"],
                  f"{cfg.name}: flash kernel launched {n_flash} times for "
                  f"{stats['admitted']} prefills of {n_attn} attention "
                  f"layers")
            plain_toks, plain_stats, plain_secs, _ = serve(
                params, plain_cfg, f"{cfg.name} serve (plain)")
            check(stats == plain_stats, f"{cfg.name}: stats differ")
            d_logit, differing, ties = compare_served(
                params, cfg, plain_cfg, toks, plain_toks)
            reqs = lm_requests(cfg.vocab)
            longest = max(reqs, key=lambda r: len(r.prompt))
            S = len(longest.prompt)
            t = torch.from_numpy(longest.prompt.astype(np.int64))[None].to(
                DEVICE)
            prefill_ms, pk = device_profile(
                lambda: prefill(params, {"tokens": t}, cfg, LM_MAX_LEN),
                host=False)
            print_breakdown(f"{cfg.name} prefill of {S} tokens", prefill_ms,
                            pk)
            cache = init_cache(cfg, LM_SLOTS, LM_MAX_LEN)
            tok4 = torch.zeros(LM_SLOTS, dtype=torch.int64, device=DEVICE)
            pos4 = torch.full((LM_SLOTS,), S, dtype=torch.int32,
                              device=DEVICE)
            decode_ms, dk = device_profile(
                lambda: decode_step(params, cache, tok4, pos4, cfg), 3,
                host=False)
            print_breakdown(f"{cfg.name} decode step of {LM_SLOTS} slots",
                            decode_ms, dk)
            del cache
            patches = (patch_prefill(params, cfg, plain_cfg)
                       if cfg.n_patches else None)
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_tok = sum(len(v) for v in toks.values())
        busy = {k: (None if kk is None else sum(
            x for x, _ in kk.values()) / wall)
            for k, (wall, kk) in {"prefill": (prefill_ms, pk),
                                  "decode": (decode_ms, dk)}.items()}
        print(f"{cfg.name} x {layers} layers: flash run {secs:.3f} s "
              f"({n_tok / secs:.2f} tokens/s), plain run {plain_secs:.3f} "
              f"s, {differing} of {len(toks)} requests differ in tokens "
              f"({len(ties)} after a routing near-tie); prefill logits "
              f"|diff| {d_logit:.3e}; one prefill of {S} tokens "
              f"{prefill_ms:.3f} ms, one decode step of {LM_SLOTS} slots "
              f"{decode_ms:.3f} ms (profiled); weights "
              f"{n_params * 4 / HBM_BYTES_PER_S * 1e3:.3f} ms to read at "
              f"3.35 TB/s; peak device memory {peak:.3f} GB; flash "
              f"launches {n_flash}; {time.perf_counter() - t_cfg:.3f} s; "
              f"card {smi}", flush=True)
        launches_by_cfg[cfg.name] = n_flash
        out[cfg.name] = {
            "layers": layers, "params": n_params, "flash_launches": n_flash,
            "serve_s": secs, "plain_serve_s": plain_secs,
            "tokens_per_s": n_tok / secs, "requests_differing": differing,
            "routing_near_ties": ties, "prefill_logit_max_abs_err": d_logit,
            "prefill_tokens": S, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "busy_share": busy, "peak_gb": peak,
            "s": time.perf_counter() - t_cfg}
        if patches is not None:
            out[cfg.name]["patch_prefill"] = dict(zip(
                ("flash_launches", "logit_max_abs_err", "tokens", "ms"),
                patches))
        del params
        torch.cuda.empty_cache()
    return launches_by_cfg, out


def whisper_decode(params, cfg, frames, prompt):
    """prefill of ``prompt`` [B, P] over ``frames``, then greedy
    decode_steps to WHISPER_NEW tokens a row; launch counts zeroed just
    before.  Returns (the prefill's logits, tokens [B][WHISPER_NEW],
    seconds, flash launches)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import decode_step, prefill
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt, "frames": frames},
                            cfg, cfg.dec_max)
    first = logits
    toks = [torch.argmax(logits, -1)]
    P = prompt.shape[1]
    for i in range(WHISPER_NEW - 1):
        logits, cache = decode_step(params, cache, toks[-1], P + i, cfg)
        toks.append(torch.argmax(logits, -1))
    out = torch.stack(toks, 1).cpu().tolist()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite "
          "logits")
    return first, out, secs, FK.LAUNCHES["flash_attention"]


@phase("whisper-medium at full width: encoder over frames, greedy decode")
def phase_whisper(smi):
    """whisper-medium at its full published width and depth (24 encoder
    and 24 decoder layers), float32 weights from init_params(LM_SEED): a
    batch of WHISPER_BATCH seeded frames [B, 1,500, 1,024] and prompts of
    WHISPER_PROMPT tokens through prefill and greedy decode steps, with
    attention_impl="pallas" (launches zeroed just before the prefill and
    read after the decode: one a layer, 24 of them non-causal at D 64 over
    1,500 frames, 24 causal in the decoder; decode launches none) and
    "chunked"; the tokens agree, or a row differs only after a near-tie
    (top-2 gap <= LOGIT_TOL of the chunked prefill over the prefix).  One
    prefill and one decode step are profiled.  Returns (flash launches,
    the numbers)."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import whisper_medium
    from repro_torch.models import (count_params, decode_step, init_params,
                                    prefill)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dc.replace(whisper_medium.CONFIG, attention_impl="pallas")
    plain_cfg = dc.replace(cfg, attention_impl="chunked")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(LM_SEED, cfg)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == count_params(cfg), f"{cfg.name}: parameter count")
    g = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
    B, P = WHISPER_BATCH, WHISPER_PROMPT
    frames = torch.randn(B, cfg.enc_seq, cfg.d_model, generator=g,
                         device=DEVICE)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=g, device=DEVICE)
    print(f"{cfg.name}: {n_params} float32 parameters "
          f"({n_params * 4 / 1e9:.3f} GB), {cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{B} x {cfg.enc_seq} frames, prompts of {P}", flush=True)
    with torch.inference_mode():
        la, toks, secs, n_flash = whisper_decode(params, cfg, frames, prompt)
        n_attn = cfg.n_enc_layers + cfg.n_layers
        check(n_flash == n_attn, f"{cfg.name}: flash launched {n_flash} "
              f"times for one prefill of {n_attn} attention layers")
        lb, plain_toks, plain_secs, _ = whisper_decode(params, plain_cfg,
                                                       frames, prompt)
        d_logit = max_abs_err(la, lb)
        check(d_logit <= LOGIT_TOL, f"{cfg.name}: prefill logits differ "
              f"by {d_logit}")
        differ = [b for b in range(B) if toks[b] != plain_toks[b]]
        for b in differ:
            j = next(i for i, (x, y) in enumerate(zip(toks[b],
                                                      plain_toks[b]))
                     if x != y)
            ctx = torch.cat([prompt[b], torch.tensor(
                toks[b][:j], dtype=prompt.dtype, device=DEVICE)])[None]
            lg, _ = prefill(params, {"tokens": ctx,
                                     "frames": frames[b:b + 1]},
                            plain_cfg, cfg.dec_max)
            top = torch.topk(lg[0], 2).values
            gap = float(top[0] - top[1])
            print(f"row {b}: tokens differ from step {j} on; top-2 logit "
                  f"gap there {gap:.3e}", flush=True)
            check(gap <= LOGIT_TOL, f"{cfg.name} row {b}: token {j} "
                  f"differs with a top-2 gap of {gap} > {LOGIT_TOL}")
        prefill_ms, pk = device_profile(lambda: prefill(
            params, {"tokens": prompt, "frames": frames}, cfg, cfg.dec_max),
            host=False)
        print_breakdown(f"{cfg.name} prefill ({B} x {cfg.enc_seq} frames, "
                        f"{P} tokens)", prefill_ms, pk)
        _, cache = prefill(params, {"tokens": prompt, "frames": frames},
                           cfg, cfg.dec_max)
        tok = torch.zeros(B, dtype=torch.int64, device=DEVICE)
        decode_ms, dk = device_profile(
            lambda: decode_step(params, cache, tok, P, cfg), 3, host=False)
        print_breakdown(f"{cfg.name} decode step of {B} rows", decode_ms, dk)
        del cache
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy = {k: (None if kk is None else sum(x for x, _ in kk.values()) / w)
            for k, (w, kk) in {"prefill": (prefill_ms, pk),
                               "decode": (decode_ms, dk)}.items()}
    n_tok = B * WHISPER_NEW
    print(f"{cfg.name}: flash run {secs:.3f} s ({n_tok / secs:.2f} "
          f"tokens/s), plain run {plain_secs:.3f} s, {len(differ)} of {B} "
          f"rows differ in tokens; prefill logits |diff| {d_logit:.3e}; "
          f"one prefill {prefill_ms:.3f} ms, one decode step "
          f"{decode_ms:.3f} ms (profiled); peak device memory {peak:.3f} "
          f"GB; flash launches {n_flash}; card {smi}", flush=True)
    del params
    torch.cuda.empty_cache()
    return n_flash, {
        "layers": [cfg.n_enc_layers, cfg.n_layers], "params": n_params,
        "flash_launches": n_flash, "decode_s": secs,
        "plain_decode_s": plain_secs, "tokens_per_s": n_tok / secs,
        "rows_differing": len(differ), "prefill_logit_max_abs_err": d_logit,
        "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "busy_share": busy, "peak_gb": peak}


def train_flops(params, cfg, batch, seq) -> float:
    """FLOPs of one training step: 6 x the parameters that enter a matrix
    product (every 2-D weight but the embedding table, which is gathered)
    x the tokens, plus the attention products over the causal pairs
    (forward and backward, 3 x the forward's 4 B H D per pair).  Remat's
    second forward pass is not counted."""
    n = sum(p.numel() for k, p in params.named_parameters()
            if p.dim() == 2 and k != "embed")
    pairs = seq * (seq + 1) // 2
    attn = 12 * batch * cfg.n_heads * cfg.d_head * pairs * cfg.n_layers
    return 6.0 * n * batch * seq + attn


def leaf_sums(tree) -> dict:
    """Per-leaf float64 sums of a name -> tensor dict (moments kept as a
    digest where a second copy does not fit)."""
    return {k: float(t.double().sum()) for k, t in tree.items()}


@phase("qwen2.5-14b training at full width")
def phase_train(smi):
    """The LM training path at qwen2.5-14b's full width, cut to
    TRAIN_LAYERS layers (float32, chunked attention, remat, no TF32),
    weights from init_params(LM_SEED) on the card, SyntheticLM batches of
    TRAIN_BATCH x TRAIN_SEQ tokens, AdamW with a cosine schedule:

    * one step with 4 microbatches against one without, from the same
      weights: loss rtol MB_LOSS_RTOL, parameters atol MB_PARAM_ATOL;
    * T_TRAIN steps: every loss finite, the last below the first; timed;
    * the same run under run_with_recovery, a checkpoint after step
      TRAIN_CKPT_AT and a failure injected at TRAIN_FAIL_AT: the restarted
      run's parameters bitwise the uninterrupted run's, its moments'
      per-leaf sums equal;
    * TRAIN_PROFILE_STEPS more steps profiled (device busy share);
    * the trained weights served through ServingEngine with the flash
      kernel and with chunked attention (the same tokens; the kernel's
      launches counted as in phase_lm);
    * the training CLI as a program, --fail-at 30 recovered at step 20.
    Returns (the flash launches of the serving check, the numbers)."""
    import dataclasses as dc
    import shutil

    import torch
    from repro_torch.configs import qwen2_5_14b
    from repro_torch.data import SyntheticLM
    from repro_torch.models import count_params, init_params
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import (FaultConfig, init_train_state,
                                   make_train_step, restore_checkpoint,
                                   save_checkpoint, simulate_failures)
    from repro_torch.train.fault import run_with_recovery
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dc.replace(qwen2_5_14b.CONFIG, n_layers=TRAIN_LAYERS)
    check(cfg.attention_impl == "chunked" and cfg.remat
          and cfg.param_dtype == torch.float32, "the training config")
    n_params = count_params(cfg)
    ds = SyntheticLM(vocab=cfg.vocab, seq=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH, seed=LM_SEED)
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, TRAIN_WARMUP, T_TRAIN))
    step = make_train_step(cfg, opt)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"layers": TRAIN_LAYERS, "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ}

    def fresh():
        return init_train_state(init_params(LM_SEED, cfg), opt)

    # microbatching: one step of 4 microbatches against one of the batch
    batch0 = ds.batch_at(0)
    s1, m1 = step(fresh(), batch0)
    p1 = s1.params
    del s1
    s4, m4 = make_train_step(cfg, opt, microbatches=4)(fresh(), batch0)
    l1, l4 = float(m1["loss"]), float(m4["loss"])
    check(abs(l4 - l1) <= MB_LOSS_RTOL * abs(l1),
          f"microbatched loss {l4} != {l1}")
    mb_err = max(max_abs_err(a.detach(), b.detach()) for a, b in
                 zip(p1.parameters(), s4.params.parameters()))
    check(mb_err <= MB_PARAM_ATOL, f"microbatched params differ by {mb_err}")
    print(f"{cfg.name} x {TRAIN_LAYERS} layers ({n_params} parameters): "
          f"4 microbatches against one batch: loss {l4} against {l1}, "
          f"params |diff| {mb_err:.3e}", flush=True)
    out["microbatch"] = {"loss_1": l1, "loss_4": l4, "params_max_abs_err":
                         mb_err}
    del p1, s4

    # the uninterrupted run, timed step by step
    state = fresh()
    losses, ms = [], []
    for i in range(T_TRAIN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, ds.batch_at(i))
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    want_params = state.params
    want_m, want_v = leaf_sums(state.opt.m), leaf_sums(state.opt.v)
    del state

    # the same run under run_with_recovery
    ckpt = work_dir("train")
    faults = FaultConfig(fail_at_steps=(TRAIN_FAIL_AT,))
    attempts, final, io_s = [], {}, {}

    def attempt(resume):
        attempts.append(resume)
        state, start = fresh(), 0
        if resume is not None:
            t0 = time.perf_counter()
            state, _ = restore_checkpoint(ckpt, resume, state)
            torch.cuda.synchronize()
            io_s["restore"] = time.perf_counter() - t0
            shutil.rmtree(ckpt)
            start = resume
        for i in range(start, T_TRAIN):
            if resume is None:          # the failure strikes once
                simulate_failures(i, faults)
            state, _ = step(state, ds.batch_at(i))
            if i + 1 == TRAIN_CKPT_AT:
                t0 = time.perf_counter()
                save_checkpoint(ckpt, TRAIN_CKPT_AT, state)
                io_s["save"] = time.perf_counter() - t0
        final["state"] = state
        return T_TRAIN

    t0 = time.perf_counter()
    run_with_recovery(attempt, max_restarts=1, checkpoint_dir=ckpt)
    recovery_s = time.perf_counter() - t0
    got = final.pop("state")
    check(attempts == [None, TRAIN_CKPT_AT], f"attempts {attempts}")
    check(equal_all(list(got.params.parameters()),
                    list(want_params.parameters())),
          "the recovered run's parameters differ from the uninterrupted run")
    check(leaf_sums(got.opt.m) == want_m and leaf_sums(got.opt.v) == want_v,
          "the recovered run's moments differ from the uninterrupted run")
    del want_params
    print(f"run_with_recovery: failure at step {TRAIN_FAIL_AT}, resumed from "
          f"the step-{TRAIN_CKPT_AT} checkpoint ({3 * n_params * 4 / 1e9:.3f}"
          f" GB: save {io_s['save']:.3f} s, restore {io_s['restore']:.3f} s),"
          f" {recovery_s:.3f} s in all; parameters bitwise the "
          f"uninterrupted run's, moments' sums equal", flush=True)
    out["recovery"] = {"s": recovery_s, "save_s": io_s["save"],
                       "restore_s": io_s["restore"], "bitwise": True}

    # where the time goes: profiled steps of the recovered state
    batch = ds.batch_at(T_TRAIN)
    holder = {"state": got}
    del got

    def one_step():
        holder["state"], m = step(holder["state"], batch)
        return m
    wall_ms, kernels = device_profile(one_step, TRAIN_PROFILE_STEPS)
    print_breakdown(f"training step ({tokens} tokens)", wall_ms, kernels,
                    top=10)
    busy = (None if kernels is None
            else sum(k_ms for k_ms, _ in kernels.values()) / wall_ms)
    params = holder.pop("state").params
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = train_flops(params, cfg, TRAIN_BATCH, TRAIN_SEQ)
    step_ms = sum(ms[1:]) / (len(ms) - 1)
    bound_ms = flops / F32_FLOP_PER_S * 1e3
    busy_text = "not measured" if busy is None else f"{100 * busy:.2f}%"
    print(f"training: losses {losses}; ms per step {[round(x, 3) for x in ms]}"
          f" (first {ms[0]:.3f}, mean of the rest {step_ms:.3f}); "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; peak device memory "
          f"{peak:.3f} GB; {flops:.4e} FLOP a step, {bound_ms:.3f} ms at "
          f"67 TFLOP/s float32 = {100 * bound_ms / step_ms:.2f}% of the "
          f"step; device busy {busy_text} over {TRAIN_PROFILE_STEPS} "
          f"profiled steps; card {smi}", flush=True)
    out.update({"losses": losses, "ms_per_step": step_ms, "first_ms": ms[0],
                "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak,
                "flop_per_step": flops, "flop_bound_ms": bound_ms,
                "flop_share": bound_ms / step_ms, "busy_share": busy,
                "profiled_wall_ms": wall_ms})

    # the trained weights served with the flash kernel and without
    flash_cfg = dc.replace(cfg, attention_impl="pallas")
    with torch.inference_mode():
        toks, stats, _, launches = serve(params, flash_cfg,
                                         "serve trained (flash)")
        n_flash = launches["flash_attention"]["flash_attention"]
        check(n_flash == cfg.n_layers * stats["admitted"],
              f"flash kernel launched {n_flash} times for "
              f"{stats['admitted']} prefills of {cfg.n_layers} layers")
        plain_toks, _, _, _ = serve(params, cfg, "serve trained (plain)")
        d_logit, differing, _ = compare_served(params, flash_cfg, cfg, toks,
                                               plain_toks)
    print(f"trained weights served: {differing} of {len(toks)} requests "
          f"differ in tokens; prefill logits |diff| {d_logit:.3e}; flash "
          f"launches {n_flash}", flush=True)
    out["serving"] = {"flash_launches": n_flash, "requests_differing":
                      differing, "prefill_logit_max_abs_err": d_logit}
    del params
    torch.cuda.empty_cache()

    # the training CLI as a program: a failure at step 30, resumed at 20
    here = os.path.dirname(os.path.abspath(__file__))
    cli_dir = work_dir("train_cli")
    args = TRAIN_CLI + ["--ckpt-dir", cli_dir, "--device", DEVICE]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args], cwd=here, capture_output=True, text=True,
                       env={**os.environ,
                            "PYTHONPATH": os.path.join(here, "src")},
                       timeout=600)
    cli_s = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    print(f"$ python -m repro_torch.launch.train {' '.join(args)}: exit "
          f"{r.returncode}, {cli_s:.3f} s; {lines[-4:]}", flush=True)
    check(r.returncode == 0, f"the training CLI failed:\n{r.stderr[-3000:]}")
    check("[train] resumed from step 20" in lines
          and lines[-1] == "[train] done at step 60",
          f"the training CLI did not recover: {lines[-6:]}")
    shutil.rmtree(os.path.join(here, WORK_DIR, "train_cli"))
    out["cli_s"] = cli_s
    return n_flash, out


@phase("qwen2.5-14b training in bfloat16 compute_dtype")
def phase_train_bf16(smi, f32):
    """phase_train's uninterrupted run with compute_dtype=torch.bfloat16
    (float32 masters, gradients and AdamW moments; every parameter of two
    or more dimensions cast to bfloat16 for the forward and backward
    passes): the same weights, batches and schedule, T_TRAIN steps, no
    recovery run.  Gates: the loss falls, and every step's loss is within
    BF16_LOSS_ATOL of the float32 run's (``f32``: phase_train's numbers).
    TRAIN_PROFILE_STEPS more steps profiled; the FLOP share is against
    the card's dense bfloat16 rate."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import qwen2_5_14b
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dc.replace(qwen2_5_14b.CONFIG, n_layers=TRAIN_LAYERS,
                     compute_dtype=torch.bfloat16)
    ds = SyntheticLM(vocab=cfg.vocab, seq=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH, seed=LM_SEED)
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, TRAIN_WARMUP, T_TRAIN))
    step = make_train_step(cfg, opt)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(init_params(LM_SEED, cfg), opt)
    losses, ms = [], []
    for i in range(T_TRAIN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, ds.batch_at(i))
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(p.dtype == torch.float32 for p in state.params.parameters())
          and all(v.dtype == torch.float32 for v in state.opt.m.values()),
          "the masters or moments are not float32")
    gap = max(abs(a - b) for a, b in zip(losses, f32["losses"]))
    check(gap <= BF16_LOSS_ATOL, f"bfloat16 losses {losses} are {gap} from "
          f"the float32 run's {f32['losses']}")
    batch = ds.batch_at(T_TRAIN)
    holder = {"state": state}
    del state

    def one_step():
        holder["state"], m = step(holder["state"], batch)
        return m
    wall_ms, kernels = device_profile(one_step, TRAIN_PROFILE_STEPS)
    print_breakdown(f"bfloat16 training step ({tokens} tokens)", wall_ms,
                    kernels, top=10)
    busy = (None if kernels is None
            else sum(k_ms for k_ms, _ in kernels.values()) / wall_ms)
    params = holder.pop("state").params
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = train_flops(params, cfg, TRAIN_BATCH, TRAIN_SEQ)
    del params
    torch.cuda.empty_cache()
    step_ms = sum(ms[1:]) / (len(ms) - 1)
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    busy_text = "not measured" if busy is None else f"{100 * busy:.2f}%"
    print(f"bfloat16 training: losses {losses} (float32 run "
          f"{f32['losses']}; largest gap {gap:.4e}); ms per step "
          f"{[round(x, 3) for x in ms]} (first {ms[0]:.3f}, mean of the "
          f"rest {step_ms:.3f}; float32 {f32['ms_per_step']:.3f}, "
          f"{f32['ms_per_step'] / step_ms:.3f}x); "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; peak device memory "
          f"{peak:.3f} GB; {flops:.4e} FLOP a step, {bound_ms:.3f} ms at "
          f"989 TFLOP/s bfloat16 = {100 * bound_ms / step_ms:.2f}% of the "
          f"step; device busy {busy_text} over {TRAIN_PROFILE_STEPS} "
          f"profiled steps; card {smi}", flush=True)
    return {"losses": losses, "max_abs_loss_gap_to_f32": gap,
            "ms_per_step": step_ms, "first_ms": ms[0],
            "f32_ms_per_step": f32["ms_per_step"],
            "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak,
            "flop_per_step": flops, "bf16_bound_ms": bound_ms,
            "flop_share_bf16": bound_ms / step_ms, "busy_share": busy,
            "profiled_wall_ms": wall_ms}


def dist_run(d, sim, scheme, t_steps, stim, probes, label):
    """One simulate_distributed() run with the launch counts zeroed just
    before and read just after; returns (result, ms per step, launches)."""
    import torch
    from repro_torch.core import DistConfig, simulate_distributed
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.threefry import kernel as TFK
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    res = simulate_distributed(d, DistConfig(sim=sim, scheme=scheme),
                               t_steps, seed=0, stimulus=stim, probes=probes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / t_steps
    launches = {**K.LAUNCHES, **TFK.LAUNCHES}
    stats = {k: int(v) for k, v in res.stats.items()}
    print(f"{label}: {ms:.4f} ms/step over {t_steps} steps at P = "
          f"{d.n_parts}, {int(res.counts.sum())} spikes, dropped "
          f"{res.dropped}, stats {stats}, launches {launches}", flush=True)
    return res, ms, launches


def same_dist(a, b) -> bool:
    import torch
    return (torch.equal(a.counts, b.counts) and a.dropped == b.dropped
            and all(torch.equal(x, y) for x, y in zip(a.state, b.state)))


def partition_csr(d, p, device):
    """Partition p's synapses as a torch.sparse CSR matrix [U, P*U] (the
    library yardstick of one partition's delivery)."""
    import numpy as np
    import torch
    n_glob = d.n_parts * d.part_size
    ok = d.syn_src[p] < n_glob
    idx = torch.from_numpy(np.stack([d.syn_tgt_local[p][ok],
                                     d.syn_src[p][ok]]).astype(np.int64))
    A = torch.sparse_coo_tensor(idx, torch.from_numpy(d.syn_w[p][ok]),
                                (d.part_size, n_glob)).coalesce()
    return A.to_sparse_csr().to(device)


def sharded_kernels(d, state, res, cfg, smi):
    """Both kernels on every partition's slab of the sharded store, at the
    gathered spikes of the run's busiest step, each bitwise against its
    plain version (tolerance 0); the fused one on the run's final LIF
    state.  Then both timed on the slab with the most live tiles, beside
    their byte bounds (`delivery_bytes` for that slab), the plain versions
    and, for `spike_deliver`, the partition's torch.sparse CSR product."""
    import torch
    from repro_torch.core.exchange.blocked import event_spike_blocks
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
    P_, U, n_sb = d.n_parts, d.part_size, state.n_sb
    n_glob = P_ * U
    perm = torch.from_numpy(d.perm).to(DEVICE)
    t = int(res.raster.sum(dim=1).argmax())
    glob = torch.zeros(n_glob, dtype=torch.bool, device=DEVICE)
    glob[perm] = res.raster[t]
    spk, nspk = pad_spike_blocks(glob, n_glob, n_sb)
    ev_spk, ev_nspk = event_spike_blocks(
        torch.nonzero(glob).flatten().to(torch.int32), n_glob, n_sb)
    check(torch.equal(spk, ev_spk) and torch.equal(nspk, ev_nspk),
          "the gathered events give other spike blocks")

    def rows(x):
        full = torch.zeros(n_glob, dtype=x.dtype, device=DEVICE)
        full[perm] = x
        return [torch.nn.functional.pad(full[q * U:(q + 1) * U],
                                        (0, state.blk_id.shape[1] * 128 - U)
                                        ).reshape(-1, 128)
                for q in range(P_)]
    lif = [rows(x) for x in res.state]
    kw = dict(params=cfg.params, fixed_point=cfg.fixed_point)
    err = {"spike_deliver": 0.0, "fused_deliver_lif": 0.0}
    live = []
    for q in range(P_):
        store = (state.blk_id[q], state.weights[q], spk, nspk)
        a, b = K.spike_deliver_tiles(*store), K.spike_deliver_plain(*store)
        fa = K.fused_deliver_lif(*store, lif[0][q], lif[1][q], lif[2][q], **kw)
        fb = K.fused_deliver_lif_plain(*store, lif[0][q], lif[1][q],
                                       lif[2][q], **kw)
        torch.cuda.synchronize()
        err["spike_deliver"] = max(err["spike_deliver"], max_abs_err(a, b))
        err["fused_deliver_lif"] = max(err["fused_deliver_lif"], max(
            max_abs_err(x, y) for x, y in zip(fa, fb)))
        check(torch.equal(a, b), f"spike_deliver != plain on partition {q}")
        check(equal_all(fa, fb), f"fused_deliver_lif != plain on partition "
              f"{q}")
        refs = torch.bincount(state.blk_id[q].reshape(-1).long(),
                              minlength=n_sb + 1)[:n_sb]
        live.append(int(((nspk[:n_sb] > 0).long() * refs).sum()))
        del a, b, fa, fb
    q = max(range(P_), key=lambda i: live[i])
    store = (state.blk_id[q], state.weights[q], spk, nspk)
    st = (lif[0][q], lif[1][q], lif[2][q])
    refs = torch.bincount(state.blk_id[q].reshape(-1).long(),
                          minlength=n_sb + 1)[:n_sb]
    n_rows = st[0].numel()
    cols, d_bytes = delivery_bytes(state.blk_id[q], n_sb, refs, spk, nspk,
                                   n_rows * 4)
    _, f_bytes = delivery_bytes(state.blk_id[q], n_sb, refs, spk, nspk,
                                n_rows * 4 * 7)
    ms_d = kernel_device_ms(lambda: K.spike_deliver_tiles(*store), 200,
                            "spike_deliver_kernel")
    ms_f = kernel_device_ms(lambda: K.fused_deliver_lif(*store, *st, **kw),
                            200, "fused_deliver_lif_kernel")
    plain_d = cuda_ms(lambda: K.spike_deliver_plain(*store), 2, warmup=1)
    plain_f = cuda_ms(lambda: K.fused_deliver_lif_plain(*store, *st, **kw), 2,
                      warmup=1)
    A = partition_csr(d, q, DEVICE)
    s_col = glob.to(torch.float32)[:, None]
    check(torch.equal((A @ s_col).reshape(-1),
                      K.spike_deliver_tiles(*store).reshape(-1)[:U]),
          "torch.sparse CSR product != delivery kernel on the slab")
    lib_ms = cuda_ms(lambda: A @ s_col, 50)
    del A
    bound_d = d_bytes / HBM_BYTES_PER_S * 1e3
    bound_f = f_bytes / HBM_BYTES_PER_S * 1e3
    print(f"sharded store, step {t} of the bitmap run ({int(glob.sum())} "
          f"spikes gathered, {int((nspk[:n_sb] > 0).sum())} live source "
          f"blocks): all {P_} partitions' kernels bitwise equal to plain; "
          f"live tiles per partition {live}; card {smi}", flush=True)
    print(f"spike_deliver on partition {q}'s slab ({live[q]} live tiles, "
          f"{cols} spiking columns): {ms_d:.5f} ms/launch (device time, "
          f"profiler), plain {plain_d:.3f} ms, torch.sparse CSR mv "
          f"{lib_ms:.5f} ms, bound {bound_d:.5f} ms ({d_bytes} B)",
          flush=True)
    print(f"fused_deliver_lif on partition {q}'s slab: {ms_f:.5f} ms/launch "
          f"(device time, profiler), plain {plain_f:.3f} ms, bound "
          f"{bound_f:.5f} ms ({f_bytes} B)", flush=True)
    return {"spike_deliver": (ms_d, plain_d, bound_d, lib_ms,
                              err["spike_deliver"]),
            "fused_deliver_lif": (ms_f, plain_f, bound_f, None,
                                  err["fused_deliver_lif"])}


def dist_trials(d, cfg, stim, state, smi):
    """``run_dist_trials`` with DIST_TRIAL_SEEDS seeds and T_DIST_TRIALS
    steps for each of DIST_RUNS on the P = 12 partitioning: the four
    bitwise equal to each other (counts, state, dropped, raster; the
    blocked pair also in the tile counters, per lane), ``bitmap`` equal
    lane by lane to ``simulate_distributed`` of each seed, each blocked
    run launching its kernel once per partition and step for all lanes.
    Then both kernels on the slab with the most live tiles at each lane's
    busiest step (the gathered spikes of all lanes in one launch; the
    fused one on the lanes' final state), bitwise against their plain
    versions (tolerance 0)."""
    import torch
    from repro_torch.core import DistConfig, simulate_distributed
    from repro_torch.exp import ProbeSpec, run_dist_trials
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
    P_, U, n_sb = d.n_parts, d.part_size, state.n_sb
    n_glob, T = P_ * U, T_DIST_TRIALS
    seeds = tuple(range(DIST_TRIAL_SEEDS))
    probes = ProbeSpec(raster=True)
    runs = {}
    for label, (scheme, engine) in DIST_RUNS.items():
        sim = cfg if engine is None else dataclasses.replace(cfg,
                                                             engine=engine)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        res = run_dist_trials(d, DistConfig(sim=sim, scheme=scheme), T,
                              seeds=seeds, stimulus=stim, probes=probes)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / T
        runs[label] = (res, ms, dict(K.LAUNCHES))
        print(f"run_dist_trials {label} Q19.12: {ms:.4f} ms/step over {T} "
              f"steps of {len(seeds)} lanes at P = {P_}, spikes per lane "
              f"{res.counts.sum(dim=1).tolist()}, dropped "
              f"{res.dropped.tolist()}, stats "
              f"{ {k: v.tolist() for k, v in res.stats.items()} }, launches "
              f"{runs[label][2]}", flush=True)
        want = {"spike_deliver": P_ * T if label == "blocked" else 0,
                "fused_deliver_lif": P_ * T if label == "blocked_fused"
                else 0}
        check(runs[label][2] == want, f"run_dist_trials {label}: launches "
              f"{runs[label][2]}, expected {want}")
    base = runs["bitmap"][0]
    check(int(base.counts.sum()) > 0, "the partitioned trials never spiked")
    for label, (res, _, _) in runs.items():
        check(torch.equal(res.counts, base.counts)
              and torch.equal(res.dropped, base.dropped)
              and all(torch.equal(x, y) for x, y in zip(res.state,
                                                         base.state))
              and torch.equal(res.records["raster"], base.records["raster"]),
              f"run_dist_trials {label} != bitmap at P = {P_}")
    bl, bf = runs["blocked"][0].stats, runs["blocked_fused"][0].stats
    check(all(torch.equal(bl[k], bf[k]) for k in ("tiles_live",
                                                  "tiles_skipped")),
          f"tile counters differ: {bl} vs {bf}")
    for b, seed in enumerate(seeds):
        one = simulate_distributed(d, DistConfig(sim=cfg, scheme="bitmap"),
                                   T, seed=seed, stimulus=stim, probes=probes)
        check(torch.equal(one.counts, base.counts[b])
              and one.dropped == int(base.dropped[b])
              and all(torch.equal(x, y[b]) for x, y in zip(one.state,
                                                           base.state))
              and torch.equal(one.raster, base.records["raster"][b]),
              f"run_dist_trials lane {b} != simulate_distributed(seed="
              f"{seed})")
    # each lane's busiest step, gathered, in one launch of each kernel
    perm = torch.from_numpy(d.perm).to(DEVICE)
    raster = base.records["raster"]                      # [B, T, n_orig]
    B = raster.shape[0]
    t = raster.sum(dim=2).argmax(dim=1)
    glob = torch.zeros((B, n_glob), dtype=torch.bool, device=DEVICE)
    glob[:, perm] = raster[torch.arange(B, device=DEVICE), t]
    spk, nspk = pad_spike_blocks(glob, n_glob, n_sb)
    live = [int(((nspk[:, :n_sb] > 0).long()
                 * torch.bincount(state.blk_id[q].reshape(-1).long(),
                                  minlength=n_sb + 1)[:n_sb]).sum())
            for q in range(P_)]
    q = max(range(P_), key=lambda i: live[i])
    n_tb = state.blk_id.shape[1]

    def rows(x):
        full = torch.zeros((B, n_glob), dtype=x.dtype, device=DEVICE)
        full[:, perm] = x
        return torch.nn.functional.pad(
            full[:, q * U:(q + 1) * U], (0, n_tb * 128 - U)
        ).reshape(B, n_tb, 128).contiguous()
    store = (state.blk_id[q], state.weights[q], spk, nspk)
    kw = dict(params=cfg.params, fixed_point=cfg.fixed_point)
    a, b = K.spike_deliver_tiles(*store), K.spike_deliver_plain(*store)
    lif = [rows(x) for x in runs["blocked_fused"][0].state]
    fa = K.fused_deliver_lif(*store, *lif, **kw)
    fb = K.fused_deliver_lif_plain(*store, *lif, **kw)
    torch.cuda.synchronize()
    err = {"spike_deliver": max_abs_err(a, b),
           "fused_deliver_lif": max(max_abs_err(x, y)
                                    for x, y in zip(fa, fb))}
    check(torch.equal(a, b), f"spike_deliver != plain at B = {B} on "
          f"partition {q}")
    check(equal_all(fa, fb), f"fused_deliver_lif != plain at B = {B} on "
          f"partition {q}")
    ms = {label: r[1] for label, r in runs.items()}
    rounded = {k: round(v, 4) for k, v in ms.items()}
    print(f"P = {P_} trials: ms/step {json.dumps(rounded)} "
          f"at B = {B}; the four variants bitwise equal, bitmap lane by "
          f"lane equal to simulate_distributed; both kernels on partition "
          f"{q}'s slab ({live[q]} live tiles over the lanes' busiest steps "
          f"{t.tolist()}) bitwise equal to plain; card {smi}", flush=True)
    launches = {"spike_deliver": runs["blocked"][2]["spike_deliver"],
                "fused_deliver_lif": runs["blocked_fused"][2][
                    "fused_deliver_lif"]}
    return {"ms": ms, "launches": launches, "max_abs_err": err,
            "lanes": lane_digests(base)}


def dist_resilience(c, d, cfg, stim, clean, ms_clean, smi):
    """``run_resilient`` over ``simulate_distributed`` on the ``faulty``
    scheme (inner ``blocked``, the fused kernel): partition 1 fails at
    step RESILIENT_FAIL_AT of T_DIST, in chunks of RESILIENT_CHUNK with
    checkpoints; it restarts once from the last checkpoint and is bitwise
    ``clean``, phase_distributed's unfused ``blocked`` run (``ms_clean``
    a step), the fused kernel launched once per partition and step run.
    Then dropped payloads on inner ``event`` under ``activity_sweep``
    (partition 0's outgoing spikes zeroed from step 10 on) count more
    dropped synapse events than the clean run."""
    import torch
    from repro_torch import obs
    from repro_torch.core import (DistConfig, FaultSpec, configure_faulty,
                                  run_resilient, simulate_distributed)
    from repro_torch.exp import ProbeSpec, build_scenario
    from repro_torch.kernels.spike_prop import kernel as K
    probes = ProbeSpec(raster=True)
    T, Kc = T_DIST, RESILIENT_CHUNK
    fused = DistConfig(sim=dataclasses.replace(cfg, engine="blocked_fused"),
                       scheme="faulty")
    work = work_dir("resilient")
    configure_faulty(inner="blocked", spec=FaultSpec(
        partition=1, fail_at=(RESILIENT_FAIL_AT,)))
    attempts, events = [], []

    def attempt(resume, cap):
        attempts.append(resume)
        return simulate_distributed(
            d, fused, T, seed=0, stimulus=stim, probes=probes,
            chunk_steps=Kc, checkpoint_dir=work, resume=resume is not None)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        with obs.telemetry(events.append):
            got = run_resilient(attempt, checkpoint_dir=work)
        torch.cuda.synchronize()
    finally:
        configure_faulty()
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    resume_at = RESILIENT_FAIL_AT // Kc * Kc
    restarts = [e for e in events if e["type"] == "restart"]
    check(attempts == [None, resume_at] and len(restarts) == 1
          and restarts[0]["error"] == "ExchangeFault",
          f"attempts {attempts}, restarts {restarts}")
    check(same_dist(got, clean) and torch.equal(got.raster, clean.raster),
          f"the recovered faulty run != the clean blocked run at P = "
          f"{P_DIST}")
    check(launches == {"spike_deliver": 0,
                       "fused_deliver_lif": P_DIST * T},
          f"recovered run launches {launches}, expected {P_DIST * T} fused "
          f"({resume_at} steps before the failure, {T - resume_at} after)")
    chunk_s = [e["wall_s"] for e in events if e["type"] == "chunk"]

    Tq = T_PAYLOAD_DROP
    sweep = build_scenario("activity_sweep", c, cfg)
    base, _, _ = dist_run(d, cfg, "event", Tq, sweep, probes,
                          f"activity_sweep event, {Tq} steps")
    configure_faulty(inner="event", spec=FaultSpec(
        partition=0, drop_payload_at=tuple(range(10, Tq))))
    try:
        lost, _, _ = dist_run(d, cfg, "faulty", Tq, sweep, probes,
                              f"activity_sweep faulty(event), partition 0's "
                              f"payload dropped from step 10")
    finally:
        configure_faulty()
    check(lost.dropped > base.dropped,
          f"dropped payloads counted {lost.dropped}, clean {base.dropped}")
    outside = secs - sum(chunk_s)
    print(f"run_resilient at P = {P_DIST}: partition 1 failed at step "
          f"{RESILIENT_FAIL_AT}, restarted from the step-{resume_at} "
          f"checkpoint, {T} steps in {secs:.3f} s, {outside:.3f} s of it "
          f"outside the chunks (chunks {[round(x, 3) for x in chunk_s]} s; "
          f"the clean unfused blocked run {ms_clean * T / 1e3:.3f} s), "
          f"bitwise equal to the clean run, "
          f"launches {launches}; payload drop: dropped {lost.dropped} vs "
          f"{base.dropped} clean over {Tq} steps; card {smi}", flush=True)
    return {"seconds": secs, "clean_seconds": ms_clean * T / 1e3,
            "chunk_s": chunk_s, "outside_chunks_s": outside,
            "resume_step": resume_at,
            "launches": launches["fused_deliver_lif"],
            "dropped_faulty": lost.dropped, "dropped_clean": base.dropped}


@phase("partitioned simulator, P = 12, full FlyWire (Q19.12)")
def phase_distributed(c, stim, smi):
    """The paper's partitioned mapping, its 12 partitions emulated on the
    card: partitioned as the JAX package's CLI does (greedy SAR under
    CoreBudget.tpu_vmem(), pad_to_uniform to 12, build_dcsr with 9-bit
    weights); ``shard_stimulus`` of the main path's stimulus; T_DIST steps
    of each of DIST_RUNS, which must agree bitwise (counts, state,
    dropped, raster; the blocked pair also in tile counters), the blocked
    runs launching their kernel once per partition and step.  Then the
    kernels on every partition's slab, a profiled window of
    ``blocked_fused``, and a float32 cross-check."""
    import gc

    import torch
    from repro_torch.configs.flywire import CONFIG
    from repro_torch.core import (DistConfig, build_dcsr, edge_cut,
                                  greedy_partition, pad_to_uniform,
                                  simulate_distributed)
    from repro_torch.core.compress import CoreBudget
    from repro_torch.core.exchange import build_dist_arrays, get_scheme
    from repro_torch.core.partition import caps_from_budget
    from repro_torch.exp import ProbeSpec
    cfg = CONFIG.sim
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    greedy = greedy_partition(c, caps_from_budget(CoreBudget.tpu_vmem(),
                                                  "sar"), scheme="sar")
    d = build_dcsr(c, pad_to_uniform(greedy, P_DIST, c.n),
                   quantize_bits=cfg.quantize_bits)
    t_dcsr = time.perf_counter() - t0
    sizes = d.cum_neurons[1:] - d.cum_neurons[:-1]
    print(f"DCSR: greedy SAR gave {greedy.n_parts} parts (cuts "
          f"{greedy.offsets.tolist()}), re-cut to {d.n_parts} of "
          f"{sizes.min()}-{sizes.max()} neurons; U = {d.part_size}, S_max "
          f"= {d.s_max}, weights [{d.syn_w.min():.0f}, {d.syn_w.max():.0f}]"
          f"; edge cut {json.dumps(edge_cut(d))}; {t_dcsr:.3f} s",
          flush=True)
    t0 = time.perf_counter()
    build_dist_arrays(d, DEVICE)
    torch.cuda.synchronize()
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = get_scheme("blocked").build(d, cfg, DistConfig(sim=cfg).capacity,
                                        DEVICE)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    gb = state.weights.numel() * state.weights.element_size() / 1e9
    print(f"sharded tile store: [P, n_tb, E] = {list(state.blk_id.shape)}, "
          f"n_sb {state.n_sb}, {state.tiles_stored} tiles, occupancy "
          f"{state.occupancy:.6f}, int16 {gb:.3f} GB; set-up: DCSR "
          f"{t_dcsr:.3f} s, dist arrays {t_arrays:.3f} s, sharded store "
          f"{t_store:.3f} s", flush=True)

    probes = ProbeSpec(raster=True)
    runs = {}
    for label, (scheme, engine) in DIST_RUNS.items():
        sim = cfg if engine is None else dataclasses.replace(cfg,
                                                             engine=engine)
        runs[label] = dist_run(d, sim, scheme, T_DIST, stim, probes,
                               f"{label} Q19.12")
    base = runs["bitmap"][0]
    check(int(base.counts.sum()) > 0, "the partitioned run never spiked")
    for label, (res, _, _) in runs.items():
        check(same_dist(res, base) and torch.equal(res.raster, base.raster),
              f"{label} != bitmap (counts, state, dropped or raster) at P = "
              f"{P_DIST}")
    bl, bf = runs["blocked"][0].stats, runs["blocked_fused"][0].stats
    check(all(int(bl[k]) == int(bf[k]) for k in ("tiles_live",
                                                 "tiles_skipped")),
          f"tile counters differ: {bl} vs {bf}")
    launches = {"spike_deliver": runs["blocked"][2]["spike_deliver"],
                "fused_deliver_lif": runs["blocked_fused"][2][
                    "fused_deliver_lif"]}
    want = P_DIST * T_DIST
    check(launches == {"spike_deliver": want, "fused_deliver_lif": want}
          and runs["blocked"][2]["fused_deliver_lif"] == 0
          and runs["blocked_fused"][2]["spike_deliver"] == 0,
          f"sharded launches {launches}, expected {want} of each kernel "
          f"in its own run only")
    # the threefry kernel on the partitioned path: the [P, ...] key split
    # and each partition's sugar draws, whose [P, U] mask is one & after
    # the launch
    for name in ("threefry_split", "threefry_bernoulli"):
        launches[name] = runs["blocked_fused"][2][name]
    check(launches["threefry_split"] > 0
          and launches["threefry_bernoulli"] > 0,
          f"the threefry kernel never launched at P = {P_DIST}: {launches}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80.0, f"peak device memory {peak:.3f} GB")
    ms = {label: r[1] for label, r in runs.items()}
    emulated = {"digests": {label: result_digest(r[0])
                            for label, r in runs.items()}}
    yard = sharded_kernels(d, state, base, cfg, smi)
    clean, ms_clean, _ = runs["blocked"]
    del runs, bl, bf
    trials = dist_trials(d, cfg, stim, state, smi)
    emulated["trial_lanes"] = trials.pop("lanes")
    resilient = dist_resilience(c, d, cfg, stim, clean, ms_clean, smi)
    del clean

    fused_sim = dataclasses.replace(cfg, engine="blocked_fused")
    wall_ms, kernels = device_profile(lambda: simulate_distributed(
        d, DistConfig(sim=fused_sim, scheme="blocked"), T_DIST_TRACE, seed=1,
        stimulus=stim, probes=ProbeSpec()))
    per_step = None if kernels is None else {
        k: (v / T_DIST_TRACE, n / T_DIST_TRACE)
        for k, (v, n) in kernels.items()}
    print_breakdown(f"blocked_fused at P = {P_DIST}, trace over "
                    f"{T_DIST_TRACE} steps, per step", wall_ms / T_DIST_TRACE,
                    per_step, top=6)

    f32 = dataclasses.replace(cfg, fixed_point=False)
    a, _, _ = dist_run(d, f32, "bitmap", T_DIST_F32, stim, probes,
                       "bitmap float32")
    b, _, lf = dist_run(d, dataclasses.replace(f32, engine="blocked_fused"),
                        "blocked", T_DIST_F32, stim, probes,
                        "blocked_fused float32")
    check(lf["fused_deliver_lif"] == P_DIST * T_DIST_F32, "fused f32 launches")
    check(same_dist(a, b) and torch.equal(a.raster, b.raster),
          f"blocked_fused float32 != bitmap float32 at P = {P_DIST}")
    rounded = {k: round(v, 4) for k, v in ms.items()}
    print(f"P = {P_DIST}: ms/step {json.dumps(rounded)}; all four schemes "
          f"bitwise equal in Q19.12, "
          f"blocked_fused == bitmap in float32; {int(base.counts.sum())} "
          f"spikes in {T_DIST} steps; launches {launches}; peak device "
          f"memory {peak:.3f} GB; card {smi}", flush=True)
    # the partitioning and stimulus for phase_multiprocess's ranks
    emulated["data"] = os.path.join(work_dir("multiprocess"), "data.pt")
    t0 = time.perf_counter()
    torch.save({"d": d, "stim": stim, "cfg": cfg}, emulated["data"])
    print(f"saved the P = {P_DIST} DCSR and stimulus for the ranks in "
          f"{time.perf_counter() - t0:.3f} s "
          f"({os.path.getsize(emulated['data']) / 1e6:.1f} MB)", flush=True)
    del a, b, base, state
    emulated["dryrun"] = phase_flywire_dryrun(
        c, d, cfg, stim, None if per_step is None else
        sum(n for _, n in per_step.values()), smi)
    del d, greedy
    gc.collect()
    torch.cuda.empty_cache()
    return yard, launches, ms, trials, resilient, emulated


@phase("FlyWire dry run: one rank's window counted")
def phase_flywire_dryrun(c, d, cfg, stim, measured, smi):
    """repro_torch.launch.flywire_dryrun's count of one rank's window
    (DRY_STEPS steps, the event scheme, meta tensors) on the P = 12
    partition the phase above ran, with its stimulus, beside the launches
    a step ``measured`` by that phase's profile of the emulated run.
    Then the reference's partitioning of the same connectome for each of
    DRY_CORES ranks, one rank's window counted: its resident bytes and
    peak.  Returns the numbers."""
    from repro_torch.core.capacity import CapacityConfig
    from repro_torch.launch import flywire_dryrun as FD
    cap = CapacityConfig(spike_capacity=256, syn_budget=65536)
    t0 = time.perf_counter()
    cost, resident = FD.count_window(d, cfg, "event", DRY_STEPS, cap,
                                     stimulus=stim)
    a_step = cost.launches / DRY_STEPS
    print(f"flywire dry run, P = {d.n_parts} ({d.part_size} slots a rank, "
          f"counted in {time.perf_counter() - t0:.3f} s): {a_step:.1f} "
          f"launches a step counted for one rank of the event scheme, x "
          f"{d.n_parts} = {a_step * d.n_parts:.1f}; the emulated "
          f"blocked_fused run above {measured} launches a step "
          f"(profiler; PERF.md section 6 has the emulated event run's); "
          f"resident {resident} B, peak "
          f"{cost.peak_bytes} B a rank; {cost.bytes:.6e} B and "
          f"{cost.link_bytes:.6e} link B a window", flush=True)
    out = {f"cores{d.n_parts}": {
        "launches_per_step": a_step, "measured_emulated_per_step": measured,
        "resident_bytes": resident, "peak_bytes": cost.peak_bytes,
        "bytes_per_window": cost.bytes, "link_bytes": cost.link_bytes}}
    for cores in DRY_CORES:
        t0 = time.perf_counter()
        dc = FD.partition(c, cores)
        t1 = time.perf_counter()
        cost, resident = FD.count_window(dc, cfg, "event", DRY_STEPS, cap)
        terms = FD.window_terms(cost, DRY_STEPS, cfg.params.dt)
        out[f"cores{cores}"] = {
            "part_size": dc.part_size, "s_max": dc.s_max,
            "resident_bytes": resident, "peak_bytes": cost.peak_bytes,
            "launches_per_step": cost.launches / DRY_STEPS,
            "bytes_per_window": cost.bytes, "link_bytes": cost.link_bytes,
            "modelled_window_ms": terms["bound_s"] * 1e3,
            "partition_s": t1 - t0, "count_s": time.perf_counter() - t1}
        print(f"flywire dry run at {cores} ranks (U {dc.part_size}, S_max "
              f"{dc.s_max}): resident {resident} B and peak "
              f"{cost.peak_bytes} B a rank; "
              f"{cost.launches / DRY_STEPS:.1f} launches a step; a window "
              f"{cost.bytes:.6e} B, {cost.link_bytes:.6e} link B, modelled "
              f"{terms['bound_s'] * 1e3:.4f} ms on {smi} (nccl ranks); "
              f"partition {t1 - t0:.3f} s, count "
              f"{out[f'cores{cores}']['count_s']:.3f} s", flush=True)
    return out


WORK_DIR = os.path.join("build", "chip_smoke")   # under the checkout


def work_dir(name: str) -> str:
    """An empty directory for ``name`` under build/chip_smoke/."""
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, WORK_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


@phase("supervision at full size: chunks, telemetry, checkpoints")
def phase_supervision(c, cfg, stim, syn, smi):
    """The main path's run in one chunk and in chunks of SUPERVISE_CHUNK
    steps, alternated SUPERVISE_REPS times (medians and spread of the
    host clock), then chunked with a telemetry session and with
    synchronous and background checkpoints: all bitwise equal (counts,
    state, dropped).  Both forms are profiled over T_SUPERVISE_TRACE
    steps (device ops and busy time a step), so the cost of a chunk
    boundary is counted rather than read off the host clock.  Then, each
    on its own, a checkpoint save and restore of the full carry and what
    a telemetry session does at a chunk boundary."""
    import statistics

    import torch
    from repro_torch import obs
    from repro_torch.core import init_carry, simulate
    from repro_torch.core.health import SimCheckpointer, carry_counters
    from repro_torch.exp import ProbeSpec
    from repro_torch.train.checkpoint import flatten
    work = work_dir("supervision")
    T, K_ = T_SUPERVISE, SUPERVISE_CHUNK

    def run(label, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate(c, cfg, T, seed=0, syn=syn, stimulus=stim, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / T
        print(f"{label}: {ms:.4f} ms/step over {T} steps, "
              f"{int(res.counts.sum())} spikes", flush=True)
        return res, ms
    base, ms_whole, ms_chunk = None, [], []
    for rep in range(SUPERVISE_REPS):
        r, ms = run(f"one chunk, rep {rep}")
        base = r if base is None else base
        check(same_result(r, base), "a run in one chunk != the first")
        ms_whole.append(ms)
        r, ms = run(f"chunk_steps={K_}, rep {rep}", chunk_steps=K_)
        check(same_result(r, base), "the chunked run != the one chunk")
        ms_chunk.append(ms)
    with obs.telemetry(os.path.join(work, "run.jsonl")):
        teled, ms_tele = run(f"chunk_steps={K_} + telemetry", chunk_steps=K_)
    synced, ms_ck = run(f"chunk_steps={K_} + checkpoints",
                        chunk_steps=K_, checkpoint_dir=os.path.join(work, "a"))
    backed, ms_ck_async = run(f"chunk_steps={K_} + background checkpoints",
                              chunk_steps=K_, async_checkpoint=True,
                              checkpoint_dir=os.path.join(work, "b"))
    for label, r in (("telemetry", teled), ("checkpoints", synced),
                     ("background", backed)):
        check(same_result(r, base), f"{label} run != the one chunk")
    del teled, synced, backed

    # device work a step, in one chunk and in chunks of
    # SUPERVISE_TRACE_CHUNK: the difference is what the boundaries add.
    # The host's launch / copy / memset calls are counted from the
    # profiler's runtime records, which it keeps whole (it may drop
    # device records, so those give the busy time, not the count).
    Tp, Kp = T_SUPERVISE_TRACE, SUPERVISE_TRACE_CHUNK
    trace = {}
    for label, chunk in (("one chunk", None), (f"chunk_steps={Kp}", Kp)):
        def go():
            simulate(c, cfg, Tp, seed=0, syn=syn, stimulus=stim,
                     probes=ProbeSpec(), chunk_steps=chunk)
        go()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        busy = sum(e.time_range.end - e.time_range.start for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        issued = sum(1 for e in events
                     if re.match(r"cu(da)?(Launch|Memcpy|Memset)", e.name))
        trace[label] = {"wall_ms_per_step": wall / Tp,
                        "busy_ms_per_step": busy / Tp,
                        "issued_per_step": issued / Tp, "issued": issued}
        print(f"supervision trace, {label}, over {Tp} steps: "
              f"{json.dumps(trace[label])}", flush=True)
        check(busy > 0, f"{label}: the profiler recorded no device time")
    one, cut = trace["one chunk"], trace[f"chunk_steps={Kp}"]
    extra_ops = (cut["issued"] - one["issued"]) / (Tp // Kp - 1)

    carry = init_carry(c.n, cfg, stim, 0, DEVICE)
    nbytes = sum(x.numel() * x.element_size()
                 for x in flatten(carry).values()
                 if isinstance(x, torch.Tensor))
    ck = SimCheckpointer(os.path.join(work, "c"))
    save_s, restore_s = [], []
    for step in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step, carry, {})
        save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back, _, _ = ck.restore_latest(carry)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
    check(all(torch.equal(a, b) for a, b in zip(
        flatten(carry).values(), flatten(back).values())
        if isinstance(a, torch.Tensor)), "a restored carry differs")
    # what a telemetry session adds at a chunk boundary: the device
    # drained, the counters reduced and fetched, one chunk event written
    hook_ms = []
    with obs.telemetry(os.path.join(work, "hooks.jsonl")) as tele:
        for _ in range(20):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            counters = carry_counters(carry)
            tele.emit("chunk", step=0, steps=K_, wall_s=0.0,
                      steps_per_s=0.0, counters=counters, delta=counters)
            hook_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"ms_one_chunk": statistics.median(ms_whole),
           "ms_one_chunk_range": [min(ms_whole), max(ms_whole)],
           "ms_chunked": statistics.median(ms_chunk),
           "ms_chunked_range": [min(ms_chunk), max(ms_chunk)],
           "trace_one_chunk": one, "trace_chunked": cut,
           "issued_per_extra_boundary": extra_ops,
           "telemetry_ms_per_chunk": sorted(hook_ms)[10],
           "ms_telemetry": ms_tele, "ms_checkpoints": ms_ck,
           "ms_background_checkpoints": ms_ck_async, "carry_bytes": nbytes,
           "save_ms": min(save_s) * 1e3, "restore_ms": min(restore_s) * 1e3}
    print(f"supervision over {T} steps: ms/step in one chunk "
          f"{[round(x, 4) for x in ms_whole]} (median "
          f"{out['ms_one_chunk']:.4f}), in chunks of {K_} "
          f"{[round(x, 4) for x in ms_chunk]} (median "
          f"{out['ms_chunked']:.4f}); + telemetry {ms_tele:.4f}, + "
          f"checkpoints {ms_ck:.4f}, + background checkpoints "
          f"{ms_ck_async:.4f}; all bitwise equal; traced over {Tp} steps: "
          f"busy {one['busy_ms_per_step']:.4f} / "
          f"{cut['busy_ms_per_step']:.4f} ms a step, device calls issued "
          f"{one['issued']} / {cut['issued']} (one chunk / chunks of "
          f"{Kp}), {extra_ops:.2f} a boundary; telemetry a chunk "
          f"{out['telemetry_ms_per_chunk']:.3f} ms (median of 20); carry "
          f"{nbytes} B; save {out['save_ms']:.3f} ms (min of 3: "
          f"{[round(x * 1e3, 3) for x in save_s]}), restore "
          f"{out['restore_ms']:.3f} ms "
          f"({[round(x * 1e3, 3) for x in restore_s]}); card {smi}",
          flush=True)
    return out


@phase("every scenario at full size (blocked_fused vs csr, Q19.12)")
def phase_scenarios(c, cfg, syn, smi):
    """Each of the seven scenarios of the port's catalog (the sugar
    population from CONFIG, as the CLI takes it), T_SCENARIO steps through
    blocked_fused and csr, bitwise equal (counts, state, dropped), the
    fused kernel launched once a step; spikes a step and ms/step of each.
    Then background_storm, the dense point: its device busy time a step
    (profiler, T_STORM_TRACE steps once the ring delivers) and both
    delivery kernels at the spikes of its last step, beside the
    torch.sparse CSR mv."""
    import numpy as np
    import torch
    from repro_torch.configs.flywire import CONFIG
    from repro_torch.core import build_synapses, init_carry, run_steps
    from repro_torch.exp import (ProbeSpec, available_scenarios,
                                 build_scenario, get_scenario)
    from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
    csr_cfg = dataclasses.replace(cfg, engine="csr")
    csr_syn = build_synapses(c, csr_cfg)
    rows, storm, fused_launches = [], None, 0
    for name in available_scenarios():
        defaults = get_scenario(name).defaults
        kw = {k: v for k, v in (("n_sugar", CONFIG.n_sugar),
                                ("rate_hz", CONFIG.sugar_rate_hz))
              if k in defaults}
        stim = build_scenario(name, c, cfg, **kw)
        probes = ProbeSpec(raster=name == "background_storm")
        fused, ms_f, launches = run_engine(c, cfg, T_SCENARIO, stim, syn,
                                           probes, f"{name} blocked_fused")
        check(launches["fused_deliver_lif"] == T_SCENARIO,
              f"{name}: fused kernel launched {launches} times")
        fused_launches += launches["fused_deliver_lif"]
        ref, ms_c, _ = run_engine(c, csr_cfg, T_SCENARIO, stim, csr_syn,
                                  probes, f"{name} csr")
        check(same_result(fused, ref), f"{name}: blocked_fused != csr")
        spikes = int(fused.counts.sum())
        rows.append({"scenario": name, "spikes_per_step": spikes / T_SCENARIO,
                     "ms_per_step_blocked_fused": ms_f,
                     "ms_per_step_csr": ms_c})
        if name == "background_storm":
            check(torch.equal(fused.raster, ref.raster), "storm raster")
            storm = (stim, fused)
        del fused, ref
    del csr_syn
    torch.cuda.empty_cache()
    stim, fused = storm
    # the trace starts in the steady state: the ring delivers nothing for
    # the first delay_steps steps of a run
    warm_steps = 2 * cfg.params.delay_steps
    stim = stim.to(DEVICE)
    warm, _ = run_steps(syn, init_carry(c.n, cfg, stim, 0, DEVICE), stim,
                        cfg, ProbeSpec(), warm_steps, c.n)
    wall_ms, kernels = device_profile(lambda: run_steps(
        syn, warm, stim, cfg, ProbeSpec(), T_STORM_TRACE, c.n,
        t0=warm_steps))
    per_step = None if kernels is None else {
        k: (ms / T_STORM_TRACE, n / T_STORM_TRACE)
        for k, (ms, n) in kernels.items()}
    print_breakdown(f"background_storm blocked_fused trace over "
                    f"{T_STORM_TRACE} steps after {warm_steps}, per step",
                    wall_ms / T_STORM_TRACE, per_step, top=6)
    busy = (None if per_step is None
            else sum(ms for ms, _ in per_step.values()))
    # the spikes of the run's last step, as the kernels receive them
    s = fused.raster[-1].cpu().numpy()
    spk, nspk = pad_spike_blocks(fused.raster[-1], syn.n, syn.n_sb)
    refs = torch.bincount(syn.blk_id.reshape(-1).long(),
                          minlength=syn.n_sb + 1)[:syn.n_sb]
    n_tb = syn.blk_id.shape[0]

    def rowblk(x):
        out = torch.zeros(n_tb * 128, dtype=x.dtype, device=DEVICE)
        out[:syn.n] = x
        return out.reshape(n_tb, 128)
    state = tuple(rowblk(x) for x in fused.state)
    A = sparse_matrix(c, cfg, DEVICE)
    storm_rows = activity_case(syn, refs, None, state,
                               dict(params=cfg.params,
                                    fixed_point=cfg.fixed_point), smi, A,
                               s=s.astype(bool), case="background_storm")
    del A, fused, storm
    torch.cuda.empty_cache()
    print(f"scenarios: {json.dumps(rows)}; background_storm device busy "
          f"{busy if busy is None else round(busy, 4)} ms a step; card {smi}",
          flush=True)
    return rows, busy, storm_rows, fused_launches


def cli_lines(out: str) -> dict:
    """The digest, kill and spike lines of the CLI's output."""
    got = {}
    for line in out.splitlines():
        for key, head in (("digest", "[simulate] digest "),
                          ("kill", "[simulate] injected kill"),
                          ("spikes", "[simulate] mean total spikes")):
            if line.startswith(head):
                got[key] = line[len(head):] if key == "digest" else line
    return got


@phase("the CLI on full FlyWire (python -m repro_torch.launch.simulate)")
def phase_cli(smi):
    """The port's CLI at ``--scale full --fixed-point``: as a program, one
    uninterrupted run in one chunk with telemetry, a run killed after two
    chunks of CLI_CHUNK steps and its resume, and a csr run, all with the
    same digest; the telemetry stream checked and reported.  Then in
    process through ``main(argv)``: a kill and resume with background
    checkpoint writes, the blocked engine, and the partitioned CLI (P =
    12, the blocked scheme with the fused kernel) unchunked and killed
    and resumed in chunks of CLI_DIST_CHUNK: each pair with one digest,
    the kernels' launches counted."""
    import contextlib
    import io

    import torch
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.launch import simulate as cli
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(here, "src")}
    work = work_dir("cli")
    tele = os.path.join(work, "run.jsonl")
    full = ["--scale", CLI_SCALE, "--fixed-point", "--t-ms", str(CLI_T_MS),
            "--digest"]
    fused = full + ["--engine", "blocked_fused"]
    steps = int(round(CLI_T_MS / 0.1))

    def program(args, module="repro_torch.launch.simulate"):
        if module.endswith("simulate"):
            args = args + ["--device", DEVICE]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", module, *args], cwd=here,
                           env=env, capture_output=True, text=True,
                           timeout=900)
        secs = time.perf_counter() - t0
        print(f"$ python -m {module} {' '.join(args)}: exit {r.returncode}, "
              f"{secs:.3f} s", flush=True)
        if r.returncode != 0:
            raise RuntimeError(f"{module} failed:\n{r.stdout[-3000:]}\n"
                               f"{r.stderr[-3000:]}")
        for line in r.stdout.splitlines():
            if line.startswith("[simulate] ") and "connectome:" not in line:
                print(f"  {line}", flush=True)
        return r.stdout, secs

    def in_process(args, **kw):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(args + ["--device", DEVICE], **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"main({' '.join(args)}): {secs:.3f} s", flush=True)
        for line in buf.getvalue().splitlines():
            if line.startswith("[simulate] ") and "connectome:" not in line:
                print(f"  {line}", flush=True)
        torch.cuda.empty_cache()
        return cli_lines(buf.getvalue()), secs

    out, secs_whole = program(fused + ["--chunk-steps", str(steps),
                                       "--telemetry", tele])
    whole = cli_lines(out)
    check("digest" in whole, "no digest line")
    ck = ["--chunk-steps", str(CLI_CHUNK), "--checkpoint-dir",
          os.path.join(work, "ck")]
    out, _ = program(fused + ck + ["--inject-fail-at-chunk", "2"])
    check(set(cli_lines(out)) == {"kill"}, "the killed run printed a result")
    out, secs_resume = program(fused + ck + ["--resume"])
    check(cli_lines(out) == whole, "resumed digest != uninterrupted digest")
    out, _ = program(full + ["--engine", "csr", "--chunk-steps", str(steps)])
    check(cli_lines(out) == whole, "csr digest != blocked_fused digest")
    program([tele], "repro_torch.obs.check")
    from repro_torch.obs import report
    check(report.main([tele]) == 0, "empty telemetry stream")

    launches = {}
    ck = ["--chunk-steps", str(CLI_CHUNK), "--checkpoint-dir",
          os.path.join(work, "ck_async")]
    K.reset_launches()
    got, _ = in_process(fused + ck + ["--inject-fail-at-chunk", "2"],
                        async_checkpoint=True)
    check(set(got) == {"kill"}, "the killed in-process run printed a result")
    got, _ = in_process(fused + ck + ["--resume"], async_checkpoint=True)
    launches["fused_deliver_lif"] = K.LAUNCHES["fused_deliver_lif"]
    check(got == whole, "background-checkpoint resume digest differs")
    check(dict(K.LAUNCHES) == {"fused_deliver_lif": steps,
                               "spike_deliver": 0},
          f"kill and resume launches {K.LAUNCHES}, expected {steps} fused")
    K.reset_launches()
    got, _ = in_process(full + ["--engine", "blocked", "--chunk-steps",
                                str(steps)])
    launches["spike_deliver"] = K.LAUNCHES["spike_deliver"]
    check(got == whole, "blocked digest != blocked_fused digest")
    check(dict(K.LAUNCHES) == {"fused_deliver_lif": 0,
                               "spike_deliver": steps},
          f"blocked CLI launches {K.LAUNCHES}")

    dist = ["--scale", CLI_SCALE, "--fixed-point", "--distributed",
            "--emulate", "--cores", str(P_DIST), "--dist-scheme", "blocked",
            "--engine", "blocked_fused", "--t-ms", str(CLI_DIST_T_MS),
            "--digest"]
    d_steps = int(round(CLI_DIST_T_MS / 0.1))
    K.reset_launches()
    one, secs_dist = in_process(dist)
    check("digest" in one, "no partitioned digest")
    ck = ["--chunk-steps", str(CLI_DIST_CHUNK), "--checkpoint-dir",
          os.path.join(work, "ck_dist")]
    got, _ = in_process(dist + ck + ["--inject-fail-at-chunk", "2"])
    check(set(got) == {"kill"}, "the killed partitioned run printed a result")
    got, _ = in_process(dist + ck + ["--resume"])
    check(got == one, "partitioned resumed digest != unchunked digest")
    launches["fused_deliver_lif_p12"] = K.LAUNCHES["fused_deliver_lif"]
    check(dict(K.LAUNCHES) == {"fused_deliver_lif": 2 * P_DIST * d_steps,
                               "spike_deliver": 0},
          f"partitioned CLI launches {K.LAUNCHES}")
    # the same flags without --emulate: one process a partition under
    # torchrun, gloo (12 ranks on one card), only rank 0 printing
    torch.cuda.empty_cache()
    out, secs_torchrun = torchrun(P_DIST, [
        "-m", "repro_torch.launch.simulate",
        *[a for a in dist if a != "--emulate"], "--dist-backend", "gloo",
        "--device", DEVICE])
    check(cli_lines(out) == one, f"the torchrun CLI's P = {P_DIST} digest "
          f"!= the emulated CLI's")
    check(out.count("[simulate] connectome:") == 1,
          "more than one rank printed")
    print(f"CLI: digest {whole['digest'][:16]} for the whole, resumed "
          f"(program and in process, background writes), csr and blocked "
          f"runs; P = {P_DIST} digest {one['digest'][:16]} unchunked and "
          f"resumed; launches {json.dumps(launches)}; whole run "
          f"{secs_whole:.3f} s, resume {secs_resume:.3f} s, P = {P_DIST} "
          f"{secs_dist:.3f} s (set-up included), P = {P_DIST} under torchrun "
          f"(12 processes, gloo, the same digest) {secs_torchrun:.3f} s; "
          f"card {smi}", flush=True)
    return launches, secs_torchrun


@phase("the serving CLI on full FlyWire (python -m repro_torch.launch.serve)")
def phase_serve_cli(smi):
    """``python -m repro_torch.launch.serve`` as a program at full FlyWire
    size on ``blocked_fused``, with a crash-injected and a NaN-poisoned
    request and a telemetry stream: it exits 0, the poisoned request is
    quarantined, every request ends terminal, the stream passes
    ``obs/check.py`` and ``obs/report.py`` summarizes it."""
    from repro_torch.obs import report
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(here, "src")}
    tele = os.path.join(work_dir("serve_cli"), "serve.jsonl")
    args = ["--n", str(N_FULL), "--synapses", str(SYN_FULL), "--engine",
            "blocked_fused", "--requests", str(SERVE_CLI_REQUESTS),
            "--inject-fault", "--poison", "--telemetry", tele, "--device",
            DEVICE]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *args], cwd=here, env=env, capture_output=True,
                       text=True, timeout=900)
    secs = time.perf_counter() - t0
    print(f"$ python -m repro_torch.launch.serve {' '.join(args)}: exit "
          f"{r.returncode}, {secs:.3f} s", flush=True)
    for line in r.stdout.splitlines():
        print(f"  {line}", flush=True)
    check(r.returncode == 0, f"the serving CLI failed:\n{r.stderr[-3000:]}")
    lines = [ln for ln in r.stdout.splitlines() if " -> " in ln]
    check(len(lines) == SERVE_CLI_REQUESTS + 1, f"{len(lines)} request lines")
    poisoned = lines[-1]
    check("-> quarantined (nonfinite)" in poisoned,
          f"the poisoned request: {poisoned}")
    check(all("-> completed" in ln for ln in lines[:-1]),
          "a healthy request did not complete")
    # one retry for the crash, one for the poison's first health failure
    check(f"{SERVE_CLI_REQUESTS} completed / 0 rejected / 1 quarantined"
          in r.stdout and "(2 retries, 0 escalations, 0 shed)" in r.stdout,
          "the summary line")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.check",
                          tele], cwd=here, env=env, capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"obs.check: {out.stdout[-2000:]}")
    check(report.main([tele]) == 0, "empty serving telemetry stream")
    latency = [ln for ln in r.stdout.splitlines() if "latency" in ln]
    print(f"serving CLI: {secs:.3f} s (start-up and set-up included); "
          f"{latency[0] if latency else 'no latency line'}; card {smi}",
          flush=True)
    return secs


def small_result(res):
    """Counts, dropped and LIF state of a run: what the exact engines are
    held to."""
    return (res.counts, res.dropped, tuple(res.state))


def same_small(a, b) -> bool:
    import torch
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and equal_all(a[2], b[2]))


@phase("exact engines at full FlyWire: binned, ell, dense (Q19.12)")
def phase_exact_engines(c, cfg, stim, want, smi):
    """The reference's exact engines on the main path's network, stimulus
    and seed, after the monolithic store is freed: ``binned`` for T_EXACT
    steps, bitwise equal to the main path's ``csr`` run ``want`` in
    counts, LIF state and ``dropped``; ``ell`` at the uncapped width
    (every row whole, so every sum an integer) for T_EXACT_SHORT steps
    (cut from T_EXACT, to keep the script's total near 1,000 s),
    bitwise equal to ``csr`` of as many steps; ``ell`` at the default cap
    for
    T_EXACT_SHORT steps, its spike-count difference to ``csr`` printed
    (it samples the rows over the cap); ``dense`` (77.57 GB, built on the
    card) for T_EXACT_SHORT steps, bitwise equal to ``csr``, beside its
    byte bound; and ``run_trials`` of EXACT_TRIAL_SEEDS seeds through
    ``binned`` and ``dense``, each lane bitwise equal to the ``csr``
    ``simulate()`` of its seed.  For each engine: ms/step, device busy ms
    a step over T_EXACT_TRACE profiled steps, build seconds, peak GB."""
    import gc

    import torch
    from repro_torch.core import build_synapses, simulate
    from repro_torch.core.compress import effective_fan_in_sar
    from repro_torch.exp import ProbeSpec, run_trials
    probes = ProbeSpec()
    seeds = tuple(range(EXACT_TRIAL_SEEDS))
    numbers = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def timed_run(run_cfg, t_steps, syn, label, seed=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate(c, run_cfg, t_steps, seed=seed, syn=syn,
                       stimulus=stim, probes=probes)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / t_steps
        print(f"{label}: {ms:.4f} ms/step over {t_steps} steps, "
              f"{int(res.counts.sum())} spikes, dropped {int(res.dropped)}",
              flush=True)
        return res, ms

    def built(run_cfg):
        free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        syn = build_synapses(c, run_cfg)
        torch.cuda.synchronize()
        return syn, time.perf_counter() - t0

    def traced(run_cfg, syn, label):
        wall, kernels = device_profile(lambda: simulate(
            c, run_cfg, T_EXACT_TRACE, seed=1, syn=syn, stimulus=stim,
            probes=probes))
        per_step = None if kernels is None else {
            k: (ms / T_EXACT_TRACE, n / T_EXACT_TRACE)
            for k, (ms, n) in kernels.items()}
        print_breakdown(f"{label} trace over {T_EXACT_TRACE} steps, per "
                        f"step", wall / T_EXACT_TRACE, per_step, top=4)
        return (None if per_step is None
                else sum(ms for ms, _ in per_step.values()))

    def trials_case(run_cfg, syn, label):
        t0 = time.perf_counter()
        res = run_trials(c, run_cfg, T_EXACT_TRIALS, seeds=seeds, syn=syn,
                         stimulus=stim, probes=probes)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / T_EXACT_TRIALS
        for b in seeds:
            lane = (res.counts[b], res.dropped[b],
                    tuple(x[b] for x in res.state))
            check(same_small(lane, lanes[b]), f"run_trials {label} lane {b} "
                  f"!= csr simulate(seed={b})")
        print(f"run_trials {label}: {ms:.4f} ms/step over {T_EXACT_TRIALS} "
              f"steps of {len(seeds)} lanes, each lane bitwise equal to "
              f"the csr simulate() of its seed", flush=True)
        return ms

    def report(name, ms, busy, build_s, **extra):
        peak = torch.cuda.max_memory_allocated() / 1e9
        numbers[name] = {"ms_per_step": ms, "busy_ms_per_step": busy,
                         "build_s": build_s, "peak_gb": peak, **extra}
        busy_s = "not measured" if busy is None else f"{busy:.4f} ms a step"
        print(f"{name}: {ms:.4f} ms/step, device busy {busy_s}, build "
              f"{build_s:.3f} s, peak {peak:.3f} GB; card {smi}", flush=True)

    # the csr yardsticks: T_EXACT_SHORT steps, and each trial seed alone
    csr_cfg = dataclasses.replace(cfg, engine="csr")
    syn, _ = built(csr_cfg)
    short, _ = timed_run(csr_cfg, T_EXACT_SHORT, syn, "csr Q19.12")
    short = small_result(short)
    lanes = [small_result(simulate(c, csr_cfg, T_EXACT_TRIALS, seed=s,
                                   syn=syn, stimulus=stim, probes=probes))
             for s in seeds]
    del syn

    b_cfg = dataclasses.replace(cfg, engine="binned")
    syn, build_s = built(b_cfg)
    bin_gb = syn.bin_w.numel() * 4 / 1e9
    res, ms = timed_run(b_cfg, T_EXACT, syn, "binned Q19.12")
    check(same_small(small_result(res), want), "binned != csr at full size")
    busy = traced(b_cfg, syn, "binned")
    trials_ms = trials_case(b_cfg, syn, "binned")
    eff16 = int(effective_fan_in_sar(c, 16).max())
    report("binned", ms, busy, build_s, n_bins=syn.n_bins,
           bin_w_gb=bin_gb, trials_b10_ms_per_step=trials_ms,
           n_bins_16bit=-(-eff16 // 8) * 8,
           bin_w_16bit_gb=c.n * (-(-eff16 // 8) * 8) * 4 / 1e9)
    print(f"binned: n_bins {syn.n_bins} at 9 bits (bin_w {bin_gb:.3f} GB); "
          f"raw 16-bit weights would give n_bins "
          f"{numbers['binned']['n_bins_16bit']} (bin_w "
          f"{numbers['binned']['bin_w_16bit_gb']:.3f} GB)", flush=True)
    del syn, res

    width = int(c.fan_in.max())
    e_cfg = dataclasses.replace(cfg, engine="ell", ell_width_cap=width)
    syn, build_s = built(e_cfg)
    ell_gb = (syn.idx.numel() * 4 + syn.w.numel() * 4) / 1e9
    check(syn.n_capped == 0, f"{syn.n_capped} rows capped at the full width")
    res, ms = timed_run(e_cfg, T_EXACT_SHORT, syn, f"ell (width "
                        f"{syn.idx.shape[1]}, uncapped) Q19.12")
    check(same_small(small_result(res), short),
          "uncapped ell != csr at full size")
    busy = traced(e_cfg, syn, "ell uncapped")
    report("ell_uncapped", ms, busy, build_s, width=int(syn.idx.shape[1]),
           state_gb=ell_gb)
    del syn, res

    cap_cfg = dataclasses.replace(cfg, engine="ell")
    syn, build_s = built(cap_cfg)
    res, ms = timed_run(cap_cfg, T_EXACT_SHORT, syn,
                        f"ell (width {syn.idx.shape[1]}, "
                        f"{syn.n_capped} rows capped) Q19.12")
    diff = (res.counts.long() - short[0].long())
    busy = traced(cap_cfg, syn, "ell capped")
    report("ell_capped", ms, busy, build_s, width=int(syn.idx.shape[1]),
           n_capped=syn.n_capped, spikes=int(res.counts.sum()),
           csr_spikes=int(short[0].sum()),
           neurons_differing=int((diff != 0).sum()),
           abs_count_diff=int(diff.abs().sum()))
    print(f"ell at the default cap ({syn.n_capped} rows sampled): "
          f"{int(res.counts.sum())} spikes against csr's "
          f"{int(short[0].sum())}; {int((diff != 0).sum())} neurons differ, "
          f"sum |count difference| {int(diff.abs().sum())} (it samples: "
          f"not held to csr)", flush=True)
    del syn, res, diff

    d_cfg = dataclasses.replace(cfg, engine="dense")
    free()
    left = torch.cuda.memory_allocated() / 1e9
    syn, build_s = built(d_cfg)
    res, ms = timed_run(d_cfg, T_EXACT_SHORT, syn, "dense Q19.12")
    check(same_small(small_result(res), short), "dense != csr at full size")
    busy = traced(d_cfg, syn, "dense")
    trials_ms = trials_case(d_cfg, syn, "dense")
    bound = c.n * c.n * 4 / HBM_BYTES_PER_S * 1e3
    report("dense", ms, busy, build_s, bound_ms_per_step=bound,
           trials_b10_ms_per_step=trials_ms, held_before_gb=left)
    print(f"dense: W [{c.n}, {c.n}] float32 {c.n * c.n * 4 / 1e9:.2f} GB "
          f"built on the card in {build_s:.3f} s ({left:.3f} GB held "
          f"before); {ms:.4f} ms/step against its {bound:.2f} ms bound "
          f"(W read once a step at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
          f"card {smi}", flush=True)
    del syn, res
    free()
    return numbers


def result_digest(res) -> str:
    """sha256 over a run's counts, dropped, LIF state and raster (the
    bytes the emulated and multi-process runs must share)."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for x in (res.counts.long(), torch.tensor(int(res.dropped)), *res.state,
              res.raster if res.raster is not None else torch.zeros(0)):
        h.update(x.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def lane_digests(res) -> list:
    """result_digest of every lane of a DistTrialResult."""
    from types import SimpleNamespace
    return [result_digest(SimpleNamespace(
        counts=res.counts[b], dropped=res.dropped[b],
        state=tuple(x[b] for x in res.state),
        raster=res.records["raster"][b])) for b in range(len(res.seeds))]


def run_group(cmd, env, timeout: int):
    """Run ``cmd`` in its own process group and wait; on the time limit
    kill the whole group (torchrun and its ranks) and raise."""
    import signal
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{' '.join(cmd[:6])} ... ran past {timeout} s")
    return proc.returncode, out, err


def torchrun(nproc: int, args, timeout: int = MP_TIMEOUT):
    """``python -m torch.distributed.run --standalone`` of ``nproc``
    ranks (a free localhost port, one intra-op thread a rank); raises
    with the output's tail unless every rank exits 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(here, "src"),
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *args]
    t0 = time.perf_counter()
    code, out, err = run_group(cmd, env, timeout)
    secs = time.perf_counter() - t0
    print(f"$ torchrun --nproc-per-node {nproc} {' '.join(args)}: exit "
          f"{code}, {secs:.3f} s", flush=True)
    if code != 0:
        raise RuntimeError(f"torchrun failed:\n{out[-3000:]}\n{err[-5000:]}")
    return out, secs


def mp_worker(spec_path: str) -> int:
    """One rank of phase_multiprocess (``chip_smoke.py --mp-worker
    SPEC``, under torchrun): partition ``RANK`` of the saved P = 12 DCSR
    on a gloo mesh, through each of DIST_RUNS for T_DIST steps (launches
    counted from 0 just before each run), ``run_dist_trials`` of
    DIST_TRIAL_SEEDS seeds, a chunked run killed after two chunks and
    resumed, then both kernels on the rank's own slab held against their
    plain versions (one rank at a time: the plain versions' temporaries
    would not fit twelve at once).  Writes ``rank<r>.json``."""
    import torch
    from repro_torch.core import DistConfig, simulate_distributed
    from repro_torch.core.distributed import make_core_mesh
    from repro_torch.core.exchange import get_scheme
    from repro_torch.exp import ProbeSpec, run_dist_trials
    from repro_torch.kernels.spike_prop import kernel as K
    from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
    t_start = time.perf_counter()
    with open(spec_path) as f:
        spec = json.load(f)
    P_ = spec["P"]
    dev = spec["device"]
    mesh = make_core_mesh(P_, None if dev == "cuda" else [dev] * P_,
                          backend="gloo")
    blob = torch.load(spec["data"], weights_only=False)
    d, stim, cfg = blob["d"], blob["stim"], blob["cfg"]
    probes = ProbeSpec(raster=True)
    out = {"rank": mesh.rank, "device": str(mesh.device), "runs": {},
           "launches": {}}

    def launches_sum():
        mine = torch.tensor([K.LAUNCHES["spike_deliver"],
                             K.LAUNCHES["fused_deliver_lif"]],
                            device=mesh.device)
        tot = mesh.all_reduce_sum(mine).tolist()
        return {"spike_deliver": tot[0], "fused_deliver_lif": tot[1]}

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        mesh.barrier()

    out["setup_load_s"] = time.perf_counter() - t_start
    results = {}
    for label, (scheme, engine) in DIST_RUNS.items():
        sim = cfg if engine is None else dataclasses.replace(cfg,
                                                             engine=engine)
        dcfg = DistConfig(sim=sim, scheme=scheme)
        sync()
        t0 = time.perf_counter()
        get_scheme(scheme).build(d, sim, dcfg.capacity, mesh.device,
                                 parts=[mesh.rank])
        sync()
        build_s = time.perf_counter() - t0
        K.reset_launches()
        t0 = time.perf_counter()
        res = simulate_distributed(d, dcfg, spec["T"], seed=0,
                                   stimulus=stim, probes=probes, mesh=mesh)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / spec["T"]
        out["launches"][label] = launches_sum()
        results[label] = res
        out["runs"][label] = {"digest": result_digest(res), "ms": ms,
                              "build_s": build_s,
                              "spikes": int(res.counts.sum()),
                              "dropped": int(res.dropped),
                              "stats": {k: int(v) for k, v in
                                        res.stats.items()}}
    trials = run_dist_trials(d, DistConfig(sim=cfg, scheme="bitmap"),
                             spec["T_trials"], seeds=spec["seeds"],
                             stimulus=stim, probes=probes, mesh=mesh)
    out["trial_lanes"] = lane_digests(trials)
    fused = DistConfig(sim=dataclasses.replace(cfg, engine="blocked_fused"),
                       scheme="blocked")
    ck = os.path.join(spec["work"], "ck")
    kw = dict(seed=0, stimulus=stim, probes=probes, mesh=mesh,
              chunk_steps=spec["chunk"], checkpoint_dir=ck)
    simulate_distributed(d, fused, 2 * spec["chunk"], **kw)
    out["checkpoints_after_kill"] = sorted(os.listdir(ck))
    res = simulate_distributed(d, fused, spec["T"], resume=True, **kw)
    out["resumed_digest"] = result_digest(res)

    # both kernels on this rank's slab, at the gathered spikes of the
    # bitmap run's busiest step; the fused one on this partition's final
    # state; one rank at a time
    base = results["bitmap"]
    state = get_scheme("blocked").build(d, cfg, DistConfig(sim=cfg).capacity,
                                        mesh.device, parts=[mesh.rank])
    U, n_sb = d.part_size, state.n_sb
    n_glob = d.n_parts * U
    perm = torch.from_numpy(d.perm).to(mesh.device)
    t = int(base.raster.sum(dim=1).argmax())
    glob = torch.zeros(n_glob, dtype=torch.bool, device=mesh.device)
    glob[perm] = base.raster[t]
    spk, nspk = pad_spike_blocks(glob, n_glob, n_sb)
    n_tb = state.blk_id.shape[1]
    lo = mesh.rank * U

    def rows(x):
        full = torch.zeros(n_glob, dtype=x.dtype, device=mesh.device)
        full[perm] = x
        return torch.nn.functional.pad(full[lo:lo + U],
                                       (0, n_tb * 128 - U)).reshape(-1, 128)
    lif = [rows(x) for x in results["blocked_fused"].state]
    store = (state.blk_id[0], state.weights[0], spk, nspk)
    kw = dict(params=cfg.params, fixed_point=cfg.fixed_point)
    for r in range(P_):
        if r == mesh.rank:
            a, b = K.spike_deliver_tiles(*store), K.spike_deliver_plain(
                *store)
            fa = K.fused_deliver_lif(*store, *lif, **kw)
            fb = K.fused_deliver_lif_plain(*store, *lif, **kw)
            out["kernel_equal"] = {
                "spike_deliver": bool(torch.equal(a, b)),
                "fused_deliver_lif": equal_all(fa, fb)}
            out["max_abs_err"] = {
                "spike_deliver": max_abs_err(a, b),
                "fused_deliver_lif": max(max_abs_err(x, y)
                                         for x, y in zip(fa, fb))}
            out["live_tiles"] = int(((nspk[:n_sb] > 0).long() * torch.bincount(
                state.blk_id[0].reshape(-1).long(),
                minlength=n_sb + 1)[:n_sb]).sum())
            del a, b, fa, fb
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
        sync()
    out["peak_gb"] = (torch.cuda.max_memory_allocated(mesh.device) / 1e9
                      if mesh.device.type == "cuda" else 0.0)
    out["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(spec["work"], f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def par_train(spec) -> dict:
    """One rank of phase_parallel's sharded training (``--par-worker``,
    job "train", 2 ranks): phi3-medium-14b at full width and PAR_LAYERS
    layers, PAR_STEPS AdamW steps of PAR_BATCH x PAR_SEQ tokens, on a
    (data 1, model 2) mesh, then a (data 2, model 1) one.  After each,
    rank 0 runs the same steps unsharded in its own process and holds the
    gathered shards of the parameters and both moments (and the losses)
    against them (rank 1 sends its shards): bitwise on (1, 2), at
    MB_LOSS_RTOL / MB_PARAM_ATOL on (2, 1), where each leaf's distance
    is also measured against the unsharded run's motion from the initial
    weights (parameters) or its own norm (moments), and the grad norms
    are compared; the blocks a spec leaves
    replicated must hold the same bits on every rank that holds them."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch.configs import phi3_medium_14b
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import count_params, init_params
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.parallel.sharding import shard_index
    from repro_torch.train import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dc.replace(phi3_medium_14b.CONFIG, n_layers=PAR_LAYERS,
                     attention_impl="chunked")
    out = {"params": count_params(cfg), "meshes": {}}
    meshes = {"data1_model2": make_host_mesh(data=1, model=2),
              "data2_model1": make_host_mesh(data=2, model=1)}
    for label, mesh in meshes.items():
        exact = label == "data1_model2"
        dev = mesh.device
        out["rank"], out["device"] = mesh.rank, str(dev)
        ds = SyntheticLM(vocab=cfg.vocab, seq=PAR_SEQ,
                         global_batch=PAR_BATCH, seed=LM_SEED)

        def optimizer():
            return AdamW(lr=cosine_schedule(TRAIN_LR, TRAIN_WARMUP,
                                            PAR_STEPS))
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        opt = optimizer()
        state = init_train_state(init_params(LM_SEED, cfg, dev), opt,
                                 mesh=mesh)
        step = make_train_step(cfg, opt, mesh=mesh)
        losses, gnorms, ms = [], [], []
        for i in range(PAR_STEPS):
            torch.cuda.synchronize(dev)
            mesh.barrier()
            t0 = time.perf_counter()
            state, m = step(state, ds.batch_at(i, dev))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.empty_cache()     # the cache back for rank 0's run
        sp = state.params
        held = sum(t.numel() for t in sp.module.parameters())
        replicas_equal, replicated = True, 0
        for k, s in sp.shards.items():
            used = {a for e in sp.specs[k] if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            free = tuple(a for a in mesh.axis_names if a not in used)
            if free and mesh.axis_size(free) > 1:
                got = mesh.all_gather(s, free)
                replicas_equal &= all(torch.equal(got[0], g) for g in got)
                replicated += 1
        res = {"losses": losses, "grad_norms": gnorms, "ms_per_step": ms,
               "peak_gb": peak,
               "full_params_held_between_steps": held,
               "replicas_equal": replicas_equal,
               "replicated_leaves": replicated}
        mesh.barrier()
        ref = None
        if mesh.rank == 0:
            ropt = optimizer()
            rstate = init_train_state(init_params(LM_SEED, cfg, dev), ropt)
            init = {k: p.detach().clone() for k, p in
                    rstate.params.named_parameters()}
            rstep = make_train_step(cfg, ropt)
            ref_losses, ref_gnorms = [], []
            for i in range(PAR_STEPS):
                rstate, m = rstep(rstate, ds.batch_at(i, dev))
                ref_losses.append(float(m["loss"]))
                ref_gnorms.append(float(m["grad_norm"]))
            ref = {"params": {k: p.detach() for k, p in
                              rstate.params.named_parameters()},
                   "m": rstate.opt.m, "v": rstate.opt.v}
            # each leaf's distance is held against the unsharded run's
            # motion from the initial weights (a frozen state reads 1)
            # and each moment's against its own size (zeros read 1)
            scale = {"params": {k: float(torch.linalg.vector_norm(
                (p.double() - init[k].double()))) for k, p in
                ref["params"].items()}}
            del init, rstate
            for part in ("m", "v"):
                scale[part] = {k: float(torch.linalg.vector_norm(t.double()))
                               for k, t in ref[part].items()}
            res["unsharded_losses"] = ref_losses
            res["unsharded_grad_norms"] = ref_gnorms
            res["unsharded_peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                        / 1e9)
        mesh.barrier()
        # every other rank sends its shards to rank 0, which holds each
        # against its slice of the unsharded run (its own in place)
        equal, err, rel = True, {}, {}
        t0 = time.perf_counter()
        for part, tree in (("params", sp.shards), ("m", state.opt.m),
                           ("v", state.opt.v)):
            err[part], rel[part] = 0.0, {}
            for k, s in tree.items():
                if ref is None:
                    mesh.exchange(s, 0, None, None)
                    continue
                want, sq = ref[part][k], 0.0
                for r in range(mesh.size):
                    block = s if r == 0 else mesh.exchange(None, None, s, r)
                    coords = dict(zip(mesh.axis_names,
                                      (int(c) for c in np.unravel_index(
                                          r, mesh.shape))))
                    exp = want[shard_index(want.shape, sp.specs[k], mesh,
                                           coords)]
                    equal &= torch.equal(block, exp)
                    err[part] = max(err[part], max_abs_err(block, exp))
                    sq += float((block.double() - exp.double()).square()
                                .sum())
                    del block, exp
                den = scale[part][k]
                rel[part][k] = (math.sqrt(sq) / den if den > 0 else
                                0.0 if sq == 0 else math.inf)
        res["compare_s"] = time.perf_counter() - t0
        if ref is not None:
            res["bitwise"] = equal
            res["max_abs_err"] = err
            res["max_rel_dist"] = {part: max(v.values())
                                   for part, v in rel.items()}
            res["worst_leaf"] = {part: max(v, key=v.get)
                                 for part, v in rel.items()}
            res["exact_required"] = exact
        del state, sp, ref
        torch.cuda.empty_cache()
        mesh.barrier()
        out["meshes"][label] = res
    return out


def par_pipeline(spec) -> dict:
    """One rank of phase_parallel's pipeline and compressed_psum
    (``--par-worker``, job "pipeline", 4 ranks).  The GPipe schedule over a
    (stage 4) mesh, one full-width phi3-medium-14b block a stage
    (attention_impl "pallas": the flash kernel), PIPE_MICRO microbatches
    of 1 x PIPE_SEQ tokens, under inference mode, the flash launches
    counted from 0 just before and read just after; rank 0 then runs the
    four blocks in sequence (launches counted likewise) and holds the
    pipeline's outputs against them bitwise, and the kernel against its
    plain version at the stage's shapes.  Then compressed_psum over the
    same ranks as (pod 2, data 2) on a w_up-shaped gradient leaf a rank,
    held bitwise against the same reduction written out in one process
    on rank 0."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import phi3_medium_14b
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import join, mesh_layout
    from repro_torch.models import transformer as tf
    from repro_torch.optim import compressed_psum
    from repro_torch.optim.compress import _INV_127
    from repro_torch.parallel.pipeline import pipeline_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    S = PIPE_STAGES
    cfg = dc.replace(phi3_medium_14b.CONFIG, n_layers=S,
                     attention_impl="pallas")
    stages = join(mesh_layout((S,), ("stage",)))
    dev, rank = stages.device, stages.rank
    mine = stages.coords["stage"]
    torch.cuda.reset_peak_memory_stats(dev)

    def block(i):
        gen = torch.Generator(device=dev).manual_seed(LM_SEED + i)
        return tf.block_init(gen, "attn", cfg, dev)

    def stage_fn(blk, x):
        return tf.block_apply(blk, x, cfg)[0]
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 100)
    xs = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), generator=gen,
                     device=dev)
    out = {"rank": rank, "device": str(dev)}
    with torch.inference_mode():
        blocks = {mine: block(mine)}
        stage_fn(blocks[mine], xs[0])           # warm-up, not counted
        torch.cuda.synchronize(dev)
        stages.barrier()
        FK.reset_launches()
        t0 = time.perf_counter()
        outs = pipeline_apply(stage_fn, [blocks.get(i) for i in range(S)],
                              xs, stages, S)
        torch.cuda.synchronize(dev)
        out["pipeline_s"] = time.perf_counter() - t0
        out["pipeline_launches"] = FK.LAUNCHES["flash_attention"]
        stages.barrier()
        if rank == 0:
            for i in range(1, S):
                blocks[i] = block(i)
            FK.reset_launches()
            t0 = time.perf_counter()
            seq = []
            for x in xs:
                for i in range(S):
                    x = stage_fn(blocks[i], x)
                seq.append(x)
            seq = torch.stack(seq)
            torch.cuda.synchronize(dev)
            out["sequence_s"] = time.perf_counter() - t0
            out["sequence_launches"] = FK.LAUNCHES["flash_attention"]
            out["pipeline_bitwise_sequence"] = bool(torch.equal(outs, seq))
            out["finite"] = bool(torch.isfinite(outs).all())
            q, k, v = flash_inputs(1, cfg.n_heads, cfg.n_kv_heads, PIPE_SEQ,
                                   cfg.d_head, 23)
            got = flash_attention(q, k, v, causal=True)
            plain = FK.flash_attention_plain(q, k, v, scale=cfg.d_head ** -0.5,
                                             causal=True, window=None)
            out["flash_max_abs_err"] = max_abs_err(got, plain)
            del seq, q, k, v, got, plain
        digest = torch.tensor([float(outs.double().sum())],
                              dtype=torch.float64, device=dev)
        sums = stages.all_gather(digest, "stage")
        out["outputs_equal_on_every_rank"] = all(torch.equal(sums[0], x)
                                                 for x in sums)
        del blocks, outs
    torch.cuda.empty_cache()

    pd = join(mesh_layout((2, 2), ("pod", "data")))

    def grad_leaf(r):
        g = torch.Generator(device=dev).manual_seed(1000 + r)
        return torch.randn((cfg.d_model, cfg.d_ff), generator=g,
                           device=dev).mul_(1e-3)
    x = grad_leaf(rank)
    torch.cuda.synchronize(dev)
    pd.barrier()
    t0 = time.perf_counter()
    y = compressed_psum(x, pd, pod_axis="pod", data_axis="data")
    torch.cuda.synchronize(dev)
    out["psum_s"] = time.perf_counter() - t0
    out["psum_shape"] = list(y.shape)
    del x
    sums = pd.all_gather(torch.tensor([float(y.double().sum())],
                                      dtype=torch.float64, device=dev),
                         ("pod", "data"))
    out["psum_equal_on_every_rank"] = all(torch.equal(sums[0], s_)
                                          for s_ in sums)
    if rank == 0:
        # ranks (pod p, data d) = 2 p + d: float32 sums in pod, the
        # shared scale, int8 quantization, the int32 sum across pods
        pods = [grad_leaf(2 * p) + grad_leaf(2 * p + 1) for p in range(2)]
        amax = torch.maximum(pods[0].abs().amax(), pods[1].abs().amax())
        scale = amax.clamp_min(1e-12) * _INV_127
        q = [torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
             for t in pods]
        want = (q[0].to(torch.int32) + q[1].to(torch.int32)).float() * scale
        out["psum_bitwise_one_process"] = bool(torch.equal(y, want))
        out["psum_max_abs_err_to_float_sum"] = max_abs_err(
            y, pods[0] + pods[1])
        out["psum_scale"] = float(scale)
        del pods, q, want
    del y
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def par_worker(spec_path: str) -> int:
    """One rank of phase_parallel (``chip_smoke.py --par-worker SPEC``,
    under torchrun, gloo): runs the spec's job and writes
    ``rank<r>.json``."""
    with open(spec_path) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    out = {"train": par_train, "pipeline": par_pipeline}[spec["job"]](spec)
    out["total_s"] = time.perf_counter() - t0
    rank = int(os.environ["RANK"])
    with open(os.path.join(spec["work"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def train_lines(text: str) -> list:
    """The training CLI's ``[train]`` lines but its straggler report,
    which flags steps slow on the wall clock (a z-score over the run's
    step times): it differs between two runs of the same steps."""
    return [ln for ln in text.splitlines() if ln.startswith("[train]")
            and not ln.startswith("[train] stragglers flagged")]


@phase("parallel/ at phi3-medium-14b's width: sharded training, GPipe, "
       "compressed_psum, the mesh CLI (gloo ranks on one card)")
def phase_parallel(smi):
    """The sharded train step, the GPipe schedule and compressed_psum, each
    run as gloo ranks on the one card (nccl refuses two ranks on one
    device; this script's ``--par-worker`` mode is one rank), and the
    training CLI's mesh path: ``python -m repro_torch.launch.train
    --smoke --data 2 --model 1`` under torchrun against the same flags
    unsharded through ``main(argv)`` in this process ([train] lines at
    MB_LOSS_RTOL plus one unit of the printed digit).  Returns (the
    flash launches of the pipeline, the numbers)."""
    import re
    out = {}
    ranks = {}
    for job, n in (("train", 2), ("pipeline", PIPE_STAGES)):
        work = work_dir(f"parallel_{job}")
        spec_path = os.path.join(work, "spec.json")
        with open(spec_path, "w") as f:
            json.dump({"job": job, "work": work}, f)
        _, secs = torchrun(n, ["chip_smoke.py", "--par-worker", spec_path],
                           timeout=PAR_TIMEOUT)
        ranks[job] = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks[job].append(json.load(f))
        out[f"{job}_torchrun_s"] = secs
    train = ranks["train"]
    out["train"] = {"params": train[0]["params"], "ranks": train}
    for label, res in train[0]["meshes"].items():
        peaks = [r["meshes"][label]["peak_gb"] for r in train]
        check(all(r["meshes"][label]["replicas_equal"] for r in train),
              f"{label}: replicated blocks differ across ranks")
        check(all(r["meshes"][label]["full_params_held_between_steps"] == 0
                  for r in train), f"{label}: full parameters held between "
              f"steps")
        check(all(r["meshes"][label]["losses"] == res["losses"]
                  for r in train), f"{label}: the ranks' losses differ")
        got, want = res["losses"], res["unsharded_losses"]
        if res["exact_required"]:
            check(res["bitwise"] and got == want,
                  f"{label}: the sharded run is not bitwise the unsharded "
                  f"one: losses {got} / {want}, |err| {res['max_abs_err']}")
        else:
            check(all(abs(a - b) <= MB_LOSS_RTOL * abs(b)
                      for a, b in zip(got, want)),
                  f"{label}: losses {got} against {want}")
            check(max(res["max_abs_err"].values()) <= MB_PARAM_ATOL,
                  f"{label}: shards off by {res['max_abs_err']}")
            # MB_PARAM_ATOL alone cannot fail here: 3 steps move no
            # weight by more than ~1.6e-3.  These do (a frozen state reads
            # 1, a gradient summed and not averaged reads ~1 on the
            # moments and 2x on the grad norms)
            rd = res["max_rel_dist"]
            check(rd["params"] <= PAR_DP_PARAM_RTOL,
                  f"{label}: parameters {rd['params']} of the unsharded "
                  f"run's motion apart ({res['worst_leaf']['params']})")
            check(max(rd["m"], rd["v"]) <= PAR_DP_MOMENT_RTOL,
                  f"{label}: moments {rd} of their size apart "
                  f"({res['worst_leaf']})")
            check(all(abs(a - b) <= MB_LOSS_RTOL * abs(b) for a, b in
                      zip(res["grad_norms"], res["unsharded_grad_norms"])),
                  f"{label}: grad norms {res['grad_norms']} against "
                  f"{res['unsharded_grad_norms']}")
        check(all(math.isfinite(x) for x in got), f"{label}: losses {got}")
        ms = [r["meshes"][label]["ms_per_step"] for r in train]
        print(f"sharded training, {label}, phi3-medium-14b x {PAR_LAYERS} "
              f"layers ({train[0]['params']} parameters), {PAR_STEPS} steps "
              f"of {PAR_BATCH} x {PAR_SEQ} tokens: losses {got} (unsharded "
              f"{want}); grad norms {res['grad_norms']} (unsharded "
              f"{res['unsharded_grad_norms']}); bitwise {res['bitwise']}, "
              f"|err| {res['max_abs_err']}, largest distance of a leaf "
              f"relative to the unsharded motion (params) or size "
              f"(moments) {res['max_rel_dist']} at {res['worst_leaf']}; "
              f"ms a step per rank {ms}; peak device "
              f"memory per rank {peaks} GB (the unsharded run on rank 0 "
              f"{res['unsharded_peak_gb']:.3f}); {res['replicated_leaves']} "
              f"replicated leaves equal on every rank; compare "
              f"{res['compare_s']:.3f} s; card {smi}", flush=True)
    pipe = ranks["pipeline"]
    p0 = pipe[0]
    n_pipe = sum(r["pipeline_launches"] for r in pipe)
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    check(n_pipe == PIPE_STAGES * ticks,
          f"flash launched {n_pipe} times in the pipeline, not "
          f"{PIPE_STAGES} x {ticks}")
    check(p0["sequence_launches"] == PIPE_STAGES * PIPE_MICRO,
          f"flash launched {p0['sequence_launches']} times in the sequence")
    check(p0["pipeline_bitwise_sequence"] and p0["finite"]
          and all(r["outputs_equal_on_every_rank"] for r in pipe),
          "the pipeline's outputs differ from the blocks in sequence")
    check(p0["flash_max_abs_err"] <= FLASH_ATOL,
          f"flash off by {p0['flash_max_abs_err']} at the stage's shapes")
    check(p0["psum_bitwise_one_process"]
          and all(r["psum_equal_on_every_rank"] for r in pipe),
          "compressed_psum differs from the one-process reduction")
    print(f"GPipe over {PIPE_STAGES} ranks, one phi3-medium-14b block a "
          f"stage, {PIPE_MICRO} microbatches of 1 x {PIPE_SEQ}: "
          f"{p0['pipeline_s']:.3f} s ({ticks} ticks), bitwise the blocks in "
          f"sequence ({p0['sequence_s']:.3f} s); flash launches {n_pipe} in "
          f"the pipeline, {p0['sequence_launches']} in the sequence; "
          f"|err| to plain at the stage's shapes "
          f"{p0['flash_max_abs_err']:.3e}; compressed_psum of w_up "
          f"{p0['psum_shape']} on (pod 2, data 2): {p0['psum_s']:.3f} s, "
          f"bitwise the one-process reduction, |err| to the float sum "
          f"{p0['psum_max_abs_err_to_float_sum']:.3e} (scale "
          f"{p0['psum_scale']:.3e}); peak device memory per rank "
          f"{[round(r['peak_gb'], 3) for r in pipe]} GB; card {smi}",
          flush=True)
    out["pipeline"] = {"ranks": pipe, "flash_launches": n_pipe,
                       "sequence_flash_launches": p0["sequence_launches"]}

    # the training CLI's mesh path against the same flags unsharded
    args = ["-m", "repro_torch.launch.train", *PAR_CLI, "--data", "2",
            "--model", "1", "--device", DEVICE]
    mesh_out, cli_s = torchrun(2, args, timeout=PAR_TIMEOUT)
    # the same flags unsharded, in this process (main(argv))
    import contextlib
    import io

    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        train_cli.main([*PAR_CLI, "--device", DEVICE])
    plain_s = time.perf_counter() - t0
    a, b = train_lines(mesh_out), train_lines(text.getvalue())
    shape = [re.sub(r"[-\d.]+", "#", x) for x in a]
    check(len(a) == len(b) and shape == [re.sub(r"[-\d.]+", "#", x)
                                         for x in b]
          and a[-1] == f"[train] done at step {PAR_CLI[2]}",
          f"the mesh CLI's lines {a[-3:]} against {b[-3:]}")
    worst = 0.0
    for x, y in zip(a, b):
        for u, w in zip(re.findall(r"-?\d+\.\d+", x),
                        re.findall(r"-?\d+\.\d+", y)):
            unit = 10.0 ** -len(w.split(".")[1])
            gap = abs(float(u) - float(w))
            worst = max(worst, gap)
            check(gap <= MB_LOSS_RTOL * abs(float(w)) + unit,
                  f"the mesh CLI printed {x} against {y}")
    check(len(re.findall(r"\[mesh\] rank \d of 2 at \{[^}]*\} on cuda",
                         mesh_out)) == 2,
          "the CLI's ranks did not report their devices")
    print(f"mesh CLI (torchrun, 2 ranks, --data 2 --model 1): {cli_s:.3f} s; "
          f"unsharded {plain_s:.3f} s; {len(a)} [train] lines, largest "
          f"printed difference {worst:.4g}; {a[-2]}", flush=True)
    out["cli"] = {"torchrun_s": cli_s, "unsharded_s": plain_s,
                  "lines": len(a), "max_printed_gap": worst}
    return n_pipe, out


@phase("12 ranks on the card: the multi-process partitioned path (gloo)")
def phase_multiprocess(c, cfg, emulated, smi):
    """The P = 12 partitioning of phase_distributed as 12 processes on the
    card (``torchrun``, gloo: NCCL refuses two ranks on one device), each
    rank its own partition: DIST_RUNS for T_DIST steps, each bitwise equal
    (digest of counts, dropped, state and raster) to the emulated run of
    the same scheme, on every rank; ``run_dist_trials`` of
    DIST_TRIAL_SEEDS seeds equal lane by lane to the emulated trials; a
    chunked run (K = MP_CHUNK) killed after its second chunk and resumed
    from the checkpoints the ranks wrote in the emulated layout, equal to
    the whole run; every rank's kernels on its slab equal to their plain
    versions; the kernels launched once per rank and step.  Then one rank
    under ``nccl`` at P = 1 (in this process), equal to ``simulate()`` on
    a deterministic drive (``step_response``: at P = 1 the partition's
    key is split from the seed, the run's is the seed, so a Poisson drive
    would differ)."""
    import gc

    import torch
    data = emulated["data"]
    work = os.path.dirname(data)
    spec = {"P": P_DIST, "T": T_DIST, "T_trials": T_DIST_TRIALS,
            "seeds": list(range(DIST_TRIAL_SEEDS)), "chunk": MP_CHUNK,
            "data": data, "work": work, "device": DEVICE}
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    gc.collect()
    torch.cuda.empty_cache()
    _, secs = torchrun(P_DIST, ["chip_smoke.py", "--mp-worker", spec_path])
    ranks = []
    for r in range(P_DIST):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r, out in enumerate(ranks):
        check(out["rank"] == r, f"rank file {r} holds rank {out['rank']}")
        for label, run in out["runs"].items():
            check(run["digest"] == emulated["digests"][label],
                  f"rank {r}: {label} at P = {P_DIST} over processes != "
                  f"the emulated run")
        check(out["trial_lanes"] == emulated["trial_lanes"],
              f"rank {r}: run_dist_trials lanes != the emulated trials")
        check(out["resumed_digest"] == emulated["digests"]["blocked_fused"],
              f"rank {r}: the resumed chunked run != the whole run")
        check(out["checkpoints_after_kill"] == sorted(
            [f"step_{MP_CHUNK}", f"step_{MP_CHUNK * 2}"]),
            f"rank {r}: checkpoints {out['checkpoints_after_kill']}")
        check(all(out["kernel_equal"].values()),
              f"rank {r}: a kernel != its plain version on its slab "
              f"{out['kernel_equal']}")
    launches = ranks[0]["launches"]
    want = P_DIST * T_DIST
    check(launches["blocked"] == {"spike_deliver": want,
                                  "fused_deliver_lif": 0}
          and launches["blocked_fused"] == {"spike_deliver": 0,
                                            "fused_deliver_lif": want},
          f"12-rank launches {launches}, expected {want} of each kernel in "
          f"its own run")
    ms = {label: max(o["runs"][label]["ms"] for o in ranks)
          for label in DIST_RUNS}
    build = {label: max(o["runs"][label]["build_s"] for o in ranks)
             for label in DIST_RUNS}
    peak = [round(o["peak_gb"], 3) for o in ranks]
    err = {k: max(o["max_abs_err"][k] for o in ranks)
           for k in ("spike_deliver", "fused_deliver_lif")}
    print(f"12 ranks (gloo, one card): ms/step "
          f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}, the "
          f"four bitwise equal to the emulated runs on every rank, trials "
          f"and the resumed run too; set-up: load "
          f"{max(o['setup_load_s'] for o in ranks):.3f} s, scheme builds "
          f"{json.dumps({k: round(v, 3) for k, v in build.items()})} s; "
          f"peak GB per rank {peak}; live tiles per slab "
          f"{[o['live_tiles'] for o in ranks]}; torchrun {secs:.3f} s; "
          f"card {smi}", flush=True)
    nccl = nccl_single_rank(c, cfg, smi)
    return {"ms_per_step": ms, "build_s": build, "peak_gb": peak,
            "torchrun_s": secs, "max_abs_err": err,
            "launches": {"spike_deliver": launches["blocked"][
                "spike_deliver"], "fused_deliver_lif": launches[
                "blocked_fused"]["fused_deliver_lif"]}, "nccl_p1": nccl}


def nccl_single_rank(c, cfg, smi, backend: str = "nccl"):
    """One rank in this process under nccl (world size 1, a file://
    rendezvous): the P = 1 partitioning through ``bitmap`` for T_MP_NCCL
    steps of ``step_response`` (deterministic), equal to ``simulate()``
    with ``csr``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import (DistConfig, build_dcsr, build_synapses,
                                  even_partition, simulate,
                                  simulate_distributed)
    from repro_torch.core.distributed import make_core_mesh
    from repro_torch.core.exchange import get_scheme
    from repro_torch.exp import ProbeSpec, build_scenario
    csr = dataclasses.replace(cfg, engine="csr")
    stim = build_scenario("step_response", c, csr)
    probes = ProbeSpec(raster=True)
    t0 = time.perf_counter()
    d1 = build_dcsr(c, even_partition(c, 1), quantize_bits=cfg.quantize_bits)
    t_dcsr = time.perf_counter() - t0
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(work_dir("nccl"),
                                                      "init"),
        rank=0, world_size=1)
    try:
        mesh = make_core_mesh(1, None if DEVICE == "cuda" else [DEVICE],
                              backend=backend)
        dcfg = DistConfig(sim=csr, scheme="bitmap")
        # the rank's arrays are built (and memoized) outside the timing
        get_scheme("bitmap").build(d1, csr, dcfg.capacity, mesh.device,
                                   parts=[0])
        t0 = time.perf_counter()
        res = simulate_distributed(d1, dcfg, T_MP_NCCL, seed=0,
                                   stimulus=stim, probes=probes, mesh=mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / T_MP_NCCL
    finally:
        dist.destroy_process_group()
    syn = build_synapses(c, csr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = simulate(c, csr, T_MP_NCCL, seed=0, syn=syn, stimulus=stim,
                   probes=probes)
    torch.cuda.synchronize()
    ms_one = (time.perf_counter() - t0) * 1e3 / T_MP_NCCL
    check(int(one.counts.sum()) > 0, "step_response never spiked")
    check(result_digest(res) == result_digest(one),
          "nccl P = 1 != simulate()")
    print(f"nccl, one rank, P = 1: {ms:.4f} ms/step over {T_MP_NCCL} steps "
          f"of step_response ({int(res.counts.sum())} spikes), equal to "
          f"simulate() (csr, {ms_one:.4f} ms/step); DCSR {t_dcsr:.3f} s; "
          f"card {smi}", flush=True)
    return {"ms_per_step": ms, "simulate_ms_per_step": ms_one,
            "spikes": int(res.counts.sum())}


def flywire_section(smi):
    """The simulate() phases at full FlyWire size, then the P = 12
    simulate_distributed() phase; returns the kernel numbers of the two
    spike_prop kernels on both paths and frees the card."""
    import gc

    import torch
    from repro_torch.configs.flywire import CONFIG
    from repro_torch.core.connectome import synthetic_flywire_cached
    from repro_torch.exp import build_scenario
    t0 = time.perf_counter()
    # cached on disk (build/repro_cache): the CLI phase's programs load it
    c = synthetic_flywire_cached(N_FULL, target_synapses=SYN_FULL, seed=0)
    print(f"[phase] connectome: {time.perf_counter() - t0:.3f} s "
          f"(n={c.n}, synapses={c.nnz}, max fan-in {int(c.fan_in.max())})",
          flush=True)
    cfg = dataclasses.replace(CONFIG.sim, engine="blocked_fused")
    stim = build_scenario("sugar_feeding", c, cfg, n_sugar=CONFIG.n_sugar,
                          rate_hz=CONFIG.sugar_rate_hz)
    syn, fused, ref, ms_fused, ms_csr, main_launches = phase_main(c, cfg, stim)
    ms_event = phase_event_config(c, stim, ref)
    want = small_result(ref)
    del ref
    phase_trace(c, cfg, stim, syn)
    other_launches = phase_other(c, cfg, stim, syn)
    supervision = phase_supervision(c, cfg, stim, syn, smi)
    scenarios, storm_busy, storm_rows, scenario_launches = phase_scenarios(
        c, cfg, syn, smi)
    yard, activity = phase_yardstick(c, cfg, syn, fused, smi)
    activity += storm_rows
    launches = {"spike_deliver": other_launches["spike_deliver"],
                "fused_deliver_lif": main_launches["fused_deliver_lif"],
                "threefry_split": main_launches["threefry_split"],
                "threefry_bernoulli": main_launches["threefry_bernoulli"]}
    del fused
    trials, trial_launches = phase_trials(c, cfg, stim, syn, smi)
    lanes = phase_trials_yardstick(c, cfg, syn, trials, smi)
    for name, cases in lanes.items():
        lanes[name] = {"launches": trial_launches[name], "cases": cases}
    del trials
    serving = phase_serving(c, cfg, syn, smi)
    del syn
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.3f} GB still allocated after the monolithic "
          f"FlyWire phases")
    exact = phase_exact_engines(c, cfg, stim, want, smi)
    del want
    (sharded, sharded_launches, ms_dist, dist_trials_out, resilient,
     emulated) = phase_distributed(c, stim, smi)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun = emulated.pop("dryrun")
    multiprocess = phase_multiprocess(c, CONFIG.sim, emulated, smi)
    del stim, c
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.3f} GB still allocated after the FlyWire "
          f"phases")
    print(f"FlyWire phases: blocked_fused {ms_fused:.4f} ms/step, csr "
          f"{ms_csr:.4f} ms/step, CONFIG.sim (event) {ms_event:.4f} ms/step; "
          f"P = {P_DIST} ms/step {json.dumps(ms_dist)}; {left:.3f} GB left "
          f"allocated", flush=True)
    extra = {"supervision": supervision, "scenarios": scenarios,
             "background_storm_busy_ms_per_step": storm_busy,
             "scenario_launches": scenario_launches, "serving": serving,
             "resilient_p12": resilient, "exact_engines": exact,
             "multiprocess_p12": multiprocess, "flywire_dryrun": dryrun}
    return (yard, activity, launches, sharded, sharded_launches, lanes,
            dist_trials_out, extra)



def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit("chip_smoke.py: no src/repro_torch beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, src)
    if sys.argv[1:2] == ["--mp-worker"]:
        # one rank of phase_multiprocess, started by torchrun
        return mp_worker(sys.argv[2])
    if sys.argv[1:2] == ["--par-worker"]:
        # one rank of phase_parallel, started by torchrun
        return par_worker(sys.argv[2])
    t_all = time.perf_counter()
    smi = phase_env()
    phase_build()
    check_err = phase_kernel_check()
    check_err.update(phase_lif_check())
    check_err["flash_attention"] = phase_flash_check()
    threefry = phase_threefry(smi)
    delay_event = phase_delay_event(smi)

    (yard, activity, launches, sharded, sharded_launches, lanes,
     dist_trials_out, extra) = flywire_section(smi)
    cli_launches, cli_torchrun_s = phase_cli(smi)
    extra["serve_cli_s"] = phase_serve_cli(smi)
    lif_yard, lif_ms_step = phase_lif_path(smi)
    for name, (ms, plain_ms, bound, lib_ms, err, n) in lif_yard.items():
        yard[name] = (ms, plain_ms, bound, lib_ms, err)
        launches[name] = n
    launches["flash_attention"], roof = phase_lm(smi)
    family_launches, families = phase_lm_families(smi)
    w_launches, families["whisper-medium"] = phase_whisper(smi)
    family_launches["whisper-medium"] = w_launches
    train_launches, training = phase_train(smi)
    training["bf16"] = phase_train_bf16(smi, training)
    pipe_launches, parallel = phase_parallel(smi)
    flash_qwen, flash_cases = phase_flash_yardstick(smi)
    yard["flash_attention"] = (*flash_qwen, 0.0)

    K, LK, FK, TFK = kernel_modules()
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
            "max_abs_err": max([err, check_err[name]] + [
                case["max_abs_err"] for case in
                lanes.get(name, {}).get("cases", [])]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if name == "flash_attention"
            else "bytes",
            "library_ms": lib_ms, "held_against_plain": True})
        if name in sharded:
            # the same kernel on the partitioned path: one launch per
            # partition and step of the blocked / blocked_fused run
            s_ms, s_plain, s_bound, s_lib, s_err = sharded[name]
            kernels[-1]["sharded_p12"] = {
                "launches": sharded_launches[name], "ms": s_ms,
                "plain_ms": s_plain, "bound_ms": s_bound,
                "library_ms": s_lib, "max_abs_err": s_err,
                "trials_b3_launches": dist_trials_out["launches"][name],
                "trials_b3_max_abs_err": dist_trials_out["max_abs_err"][
                    name]}
        if name in lanes:
            # the same kernel over B = 10 lanes of run_trials: one launch
            # a step for all lanes, and the B = 10 yardstick cases
            kernels[-1]["trials_b10"] = lanes[name]
        if name in cli_launches:
            # the CLI's in-process runs (counted from 0 before them) and
            # the seven scenarios (the fused kernel)
            kernels[-1]["cli_launches"] = cli_launches[name]
            if name == "fused_deliver_lif":
                kernels[-1]["cli_p12_launches"] = cli_launches[
                    "fused_deliver_lif_p12"]
                kernels[-1]["scenario_launches"] = extra["scenario_launches"]
        if name in extra["serving"]["launches"]:
            # the simulation server's batches (the fused kernel) and the
            # blocked server's (spike_deliver), counted from 0 before
            # each; the fused kernel also under run_resilient at P = 12
            kernels[-1]["serving_launches"] = extra["serving"]["launches"][
                name]
            if name == "fused_deliver_lif":
                kernels[-1]["resilient_p12_launches"] = extra[
                    "resilient_p12"]["launches"]
        if name in extra["multiprocess_p12"]["launches"]:
            # the 12-rank run (one process a partition, gloo), summed
            # over the ranks, counted from 0 before each run
            kernels[-1]["multiprocess_p12_launches"] = extra[
                "multiprocess_p12"]["launches"][name]
            kernels[-1]["multiprocess_p12_max_abs_err"] = extra[
                "multiprocess_p12"]["max_abs_err"][name]
        if name == "flash_attention":
            # the trained weights' serving check (4 layers): training
            # itself never launches it (chunked attention; no backward)
            kernels[-1]["train_serving_launches"] = train_launches
            # the configs of phase_lm_families and whisper's (attention
            # layers x prefills; 0 for rwkv6, which has none)
            kernels[-1]["families_launches"] = family_launches
            # phase_parallel's GPipe schedule: 4 stages x 9 ticks, and the
            # 4 blocks in sequence on rank 0 (6 microbatches x 4)
            kernels[-1]["pipeline_launches"] = pipe_launches
            kernels[-1]["pipeline_sequence_launches"] = parallel[
                "pipeline"]["sequence_flash_launches"]
            kernels[-1]["max_abs_err"] = max(
                kernels[-1]["max_abs_err"],
                parallel["pipeline"]["ranks"][0]["flash_max_abs_err"])
            # gemma3's local layers (D 256, window 1,024), whisper's
            # encoder (D 64, not causal), recurrentgemma's local layers
            # (Hkv 1 for 10 heads, D 256, window 2,048)
            for label, (ms, plain_ms, b_ms, lib_ms, err) in \
                    flash_cases.items():
                kernels[-1][label] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": "operations", "library_ms": lib_ms,
                    "max_abs_err": err}
    # kernel #6 stands in for no TPU kernel: it replaces the int64 chain
    # that computed jax.random's threefry; one entry a wrapper the step
    # loop launches, with the main path's launches (T_MAIN steps of
    # blocked_fused), the P = 12 run's and every case of phase_threefry
    for name, first in (("threefry_split", "split_b32"),
                        ("threefry_bernoulli", "storm")):
        kernels.append({
            "name": name, "route": "cuda", "source": rel(TFK.SOURCES[name]),
            "replaces": "src/repro_torch/kernels/threefry/ref.py",
            "launches": launches[name],
            "sharded_p12_launches": sharded_launches[name],
            "max_abs_err": 0.0, **threefry[first],
            "held_against_plain": True,
            "cases": {label: case for label, case in threefry.items()
                      if case["wrapper"] == name}})
    # the delay_event engine's two kernels stand in for no TPU kernel (the
    # JAX package has one uniform delay): the microcircuit cell's run and
    # the step after it
    from repro_torch.kernels.delay_event import kernel as DK
    for name in ("pending_lif", "delay_deliver"):
        kernels.append({
            "name": name, "route": "cuda", "source": rel(DK.SOURCE),
            "replaces": "src/repro_torch/kernels/delay_event/ref.py",
            "max_abs_err": 0.0, **delay_event[name],
            "held_against_plain": True})
    check(len(family_launches) == len(LM_FAMILIES) + 1
          and all(n > 0 for name, n in family_launches.items()
                  if not name.startswith("rwkv6"))
          and all(n == 0 for name, n in family_launches.items()
                  if name.startswith("rwkv6")),
          "the flash kernel never launched for a config of phase_lm_families "
          "with attention layers (or launched for rwkv6)")
    check(all(k["launches"] > 0 for k in kernels)
          and all(k["sharded_p12"]["launches"] > 0
                  and k["sharded_p12"]["trials_b3_launches"] > 0
                  and k["trials_b10"]["launches"] > 0
                  for k in kernels if "sharded_p12" in k),
          "a kernel never launched")
    check(all(k["cli_launches"] > 0 for k in kernels if "cli_launches" in k)
          and len([k for k in kernels if "cli_launches" in k]) == 2,
          "a delivery kernel never launched on the CLI path")
    check(all(k["serving_launches"] > 0 for k in kernels
              if "serving_launches" in k)
          and len([k for k in kernels if "serving_launches" in k]) == 2,
          "a delivery kernel never launched on the serving path")
    check(all(k["multiprocess_p12_launches"] > 0 for k in kernels
              if "multiprocess_p12_launches" in k)
          and len([k for k in kernels
                   if "multiprocess_p12_launches" in k]) == 2,
          "a delivery kernel never launched on the 12-rank path")
    print(f"total {time.perf_counter() - t_all:.3f} s; LIF entry points "
          f"{json.dumps({k: round(v, 5) for k, v in lif_ms_step.items()})} "
          f"ms/step", flush=True)
    import torch
    print(json.dumps({"supervision": extra["supervision"],
                      "scenarios": extra["scenarios"],
                      "background_storm_busy_ms_per_step":
                      extra["background_storm_busy_ms_per_step"]}))
    print(json.dumps({"serving": extra["serving"],
                      "resilient_p12": extra["resilient_p12"],
                      "serve_cli_s": extra["serve_cli_s"]}))
    print(json.dumps({"exact_engines": extra["exact_engines"],
                      "multiprocess_p12": extra["multiprocess_p12"],
                      "cli_torchrun_p12_s": cli_torchrun_s}))
    print(json.dumps({"training": training}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"lm_families": families}))
    print_roofline(roof, smi)
    print(json.dumps({"launch_tools": {
        "roofline": roof, "flywire_dryrun": extra["flywire_dryrun"]}}))
    print(json.dumps({"activity": activity}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
