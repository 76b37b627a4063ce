"""The benchmark of the PyTorch/CUDA port ``repro_torch``: one run of one
cell.

    python3 portbench/run.py --workload q19-storm-b32 --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; ``--trace 0`` prints its end-to-end metrics,
``--trace 1`` its per-layer metrics, as the last line of standard output
(one JSON object).  The run refuses (exit code 2, no result) without a
CUDA device, and exits with 3 and no result if it finds JAX or the JAX
package loaded.  See ``portbench/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# this directory's modules are imported as the package ``portbench``, never
# as top-level modules that could shadow the standard library's
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", "portbench", sub))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("portbench: the program src/repro_torch is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch

    from portbench import harness, spec
    chips = spec.workload(spec.benchmark(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad}: nothing that runs here "
              f"may load JAX or the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
