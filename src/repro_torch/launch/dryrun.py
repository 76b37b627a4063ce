"""Dry run of every (architecture x input cell) on the production meshes:
what one rank of the port holds and does, counted on meta tensors.

Counterpart of ``repro/launch/dryrun.py``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \
        --cell train_4k [--multi-pod | --mesh 2x2] [--smoke] \
        [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each cell for 256 or 512 devices and
reads XLA's memory and cost analyses.  Here rank 0's step
(:func:`repro_torch.launch.build.build_step`) runs once under
:func:`repro_torch.launch.hlo.count` at full width and depth; nothing is
allocated and nothing needs a card.  One JSON a cell, under the
reference's keys where they mean the same:

* ``memory.peak_device_bytes``: the counted peak (the rank's resident
  inputs and the high-water mark of what the step allocates);
* ``cost.flops_per_device`` / ``bytes_per_device`` (and ``launches``,
  ``kernels``), ``collectives`` (the reference's summary keys),
  ``analytic_bytes`` (the reference's layout, from the specs);
* ``count_s`` for the reference's ``compile_s``, ``while_trips`` the
  ``(label, n)`` of the counted loops' :func:`~repro_torch.launch.hlo.
  repeat` regions;
* ``fits``: whether the peak is within one H100's 80 GB.

Dropped, having no counterpart without XLA: ``memory.argument_bytes`` /
``output_bytes`` / ``temp_bytes`` / ``alias_bytes`` and
``cost.xla_flops_one_trip`` / ``xla_bytes_one_trip``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs.shapes import SHAPES, cell_supported
from repro_torch.launch.build import analytic_bytes, build_step, count_step
from repro_torch.launch.mesh import make_production_mesh, mesh_layout
from repro_torch.launch.roofline import H100


def run_cell(arch: str, cell: str, multi_pod: bool, out_dir: str,
             microbatches: int = 0, overrides: dict | None = None,
             tag: str = "", mesh_shape: tuple | None = None,
             smoke: bool = False) -> dict:
    mesh = (mesh_layout(mesh_shape, ("pod", "data", "model")[
        -len(mesh_shape):]) if mesh_shape
        else make_production_mesh(multi_pod=multi_pod))
    t0 = time.time()
    built = build_step(arch, cell, mesh, microbatches=microbatches,
                       smoke=smoke, overrides=overrides)
    cost = count_step(built)
    t1 = time.time()
    mesh_name = ("x".join(str(x) for x in mesh_shape) if mesh_shape
                 else ("pod2x16x16" if multi_pod else "16x16"))
    rec = {
        "arch": arch, "cell": cell,
        "mesh": mesh_name,
        "n_devices": int(mesh.size),
        "kind": built.kind,
        "meta": built.meta,
        "count_s": round(t1 - t0, 1),
        "memory": {"peak_device_bytes": cost.peak_bytes},
        "cost": {"flops_per_device": cost.flops,
                 "bytes_per_device": cost.bytes,
                 "launches": cost.launches, "kernels": cost.kernels},
        "collectives": cost.summary(),
        "analytic_bytes": analytic_bytes(built, mesh),
        "while_trips": cost.trips[:40],
        "fits": cost.peak_bytes <= H100["hbm_bytes"],
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(
            out_dir, f"{arch}_{cell}_{rec['mesh']}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"[dryrun] {arch} x {cell} x {rec['mesh']}: "
          f"count {rec['count_s']}s, "
          f"peak/rank {cost.peak_bytes / 2**30:.2f} GiB "
          f"(fits one H100: {rec['fits']}; the reference's layout "
          f"{rec['analytic_bytes']['total'] / 2**30:.2f}), "
          f"{cost.flops / 1e9:.1f} GFLOP/rank, {cost.launches} launches, "
          f"link {cost.link_bytes / 2**20:.1f} MiB/rank", flush=True)
    return rec


def iter_cells():
    for arch in all_arch_names():
        cfg = get_config(arch)
        for cell in SHAPES:
            ok, why = cell_supported(cfg, cell)
            yield arch, cell, ok, why


def _mesh_arg(text: str) -> tuple:
    return tuple(int(x) for x in text.lower().split("x"))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--cell", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    help="a (data, model) mesh DxM, or (pod, data, "
                         "model) PxDxM, in place of the production one")
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE configs at smoke-scale cells")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    kw = dict(microbatches=args.microbatches, mesh_shape=args.mesh,
              smoke=args.smoke)
    results, failures = [], []
    if args.all:
        for arch, cell, ok, why in iter_cells():
            if not ok:
                print(f"[dryrun] SKIP {arch} x {cell}: {why}")
                results.append({"arch": arch, "cell": cell, "skipped": why})
                continue
            try:
                results.append(run_cell(arch, cell, args.multi_pod,
                                        args.out, **kw))
            except Exception as e:  # noqa: BLE001 - reported, then raised
                traceback.print_exc()
                failures.append((arch, cell, str(e)))
                if not args.continue_on_error:
                    raise
    else:
        results.append(run_cell(args.arch, args.cell, args.multi_pod,
                                args.out, **kw))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:", failures)
        raise SystemExit(1)
    print(f"[dryrun] complete: {len(results)} cells")
    return results


if __name__ == "__main__":
    main()


__all__ = ["iter_cells", "main", "run_cell"]
