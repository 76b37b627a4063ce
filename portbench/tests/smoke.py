"""A benchmark root at the CPU tests' size: ``BENCHMARK.json`` and the
family files as they are, every configuration at its family's ``small``
size, every traffic mix at 3 lanes and a short experiment."""

from __future__ import annotations

import json
import os
import shutil

from portbench import spec

LANES = 3


def make_root(path, t_steps: int = 60, chunk_steps: int = 20) -> str:
    root = str(path)
    bench = spec.benchmark(spec.ROOT)
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(root, "portbench", sub), exist_ok=True)
    shutil.copytree(os.path.join(spec.PACKAGE, "families"),
                    os.path.join(root, "portbench", "families"),
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    for c in bench["configs"]:
        conf = spec.config(spec.ROOT, c["name"])
        conf = spec.family(spec.ROOT, conf).small(conf)
        with open(os.path.join(root, "portbench", "configs",
                               c["name"] + ".json"), "w") as f:
            json.dump(conf, f)
    for name in {w["traffic"] for w in bench["workloads"]}:
        traf = spec.traffic(spec.ROOT, name)
        traf.update(lanes=LANES, t_steps=t_steps, chunk_steps=chunk_steps)
        with open(os.path.join(root, "portbench", "traffic", name + ".json"),
                  "w") as f:
            json.dump(traf, f)
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    return root
