"""The readings that set the comparison's limits, for one cell at its own
size (on the card; not part of a benchmark run).

    python3 portbench/control.py --workload q19-storm-b32 \\
        --program-seeds 11 12 13 14 15 16 --control-seeds 11 12 13

For each program seed, one experiment of the cell's T steps through the
timed path (the family's program on the cell's lanes, chunked as the
window runs it) is held against the family's plain reference: the
numbers of ``portbench/check.py`` for sound runs, the lower readings.
For each control seed, the reference computed in the nearest precision
below the configuration's (``control=True``; for the FlyWire LIF family
bfloat16 for float32, Q23.8 for Q19.12) is put in the program's place
and held against the reference: the upper readings.  Prints one JSON line
per seed and a summary line.
"""

import os
import sys
import time

if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = ROOT
    sys.path.insert(1, os.path.join(ROOT, "src"))

import json  # noqa: E402


def readings(root: str, cell: str, program_seeds, control_seeds, device,
             log=print) -> dict:
    import torch

    from portbench import check, spec

    bench = spec.benchmark(root)
    wl = spec.workload(bench, cell)
    conf = spec.config(root, wl["config"])
    fam = spec.family(root, conf)
    traf = spec.traffic(root, wl["traffic"])
    B, T, K = traf["lanes"], traf["t_steps"], traf["chunk_steps"]
    net = fam.network(conf["network"],
                      os.path.join(root, "build", "portbench"))
    exact: dict = {}

    def lanes(seed):
        return spec.check_lanes(seed, B, check.CHECK_LANES)

    def ref(seed, control=False):
        seeds = spec.lane_seeds(seed, B)
        return fam.reference(net, conf, traf,
                             [seeds[i] for i in lanes(seed)], T, device,
                             control=control)

    out = {"cell": cell, "program": {}, "control": {}}
    if program_seeds:
        program = fam.program(conf, traf, net, device)
        for s in program_seeds:
            t0 = time.perf_counter()
            res = program(T, spec.lane_seeds(s, B), K, lambda rec: None)
            t1 = time.perf_counter()
            exact[s] = ref(s)
            nums, _ = check.compare([res], exact[s], fam.STATE, lanes(s))
            out["program"][s] = nums
            log(json.dumps({"seed": s, "side": "program", **nums,
                            "spikes": int(res[0].sum()),
                            "program_s": t1 - t0,
                            "reference_s": time.perf_counter() - t1}))
        del program, res
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for s in control_seeds:
        t0 = time.perf_counter()
        if s not in exact:
            exact[s] = ref(s)
        ctl = ref(s, control=True)
        nums, _ = check.compare([(ctl.counts, ctl.dropped, ctl.state)],
                                exact[s], fam.STATE)
        out["control"][s] = nums
        log(json.dumps({"seed": s, "side": "control", **nums,
                        "spikes": int(ctl.counts.sum()),
                        "exact_spikes": int(exact[s].counts.sum()),
                        "seconds": time.perf_counter() - t0}))
    for side in ("program", "control"):
        if out[side]:
            vals = list(out[side].values())
            agg = max if side == "program" else min
            out[side + ("_max" if side == "program" else "_min")] = {
                k: agg(v[k] for v in vals) for k in check.LIMITS}
    return out


def main(argv=None) -> int:
    import argparse

    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    out = readings(ROOT, args.workload, args.program_seeds,
                   args.control_seeds, "cuda",
                   log=lambda s: print(s, flush=True))
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("program", "control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
