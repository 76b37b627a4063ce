"""What a run reads: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file of its own, ``portbench/configs/<config>.json``
and ``portbench/traffic/<traffic>.json``, and each per-layer metric is a
reader ``portbench/metrics/<name>.py``.  A later change adds a cell, a
configuration, a traffic mix or a metric by adding such files and
entries; nothing here names one.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

PACKAGE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise ValueError(f"no workload {name!r} in BENCHMARK.json; have "
                     f"{[w['name'] for w in bench['workloads']]}")


def config(root: str, name: str) -> dict:
    return _load(os.path.join(root, "portbench", "configs",
                              _named("config", name) + ".json"))


def traffic(root: str, name: str) -> dict:
    return _load(os.path.join(root, "portbench", "traffic",
                              _named("traffic", name) + ".json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports (``--trace 0``)."""
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell reports (``--trace 1``): those that
    list it, and those without a list whose end-to-end metric it
    reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def metric_reader(name: str):
    """The ``read(record)`` function of ``portbench/metrics/<name>.py``,
    loaded by path (a metric's name may hold dots)."""
    import importlib.util
    path = os.path.join(PACKAGE, "metrics", _named("metric", name) + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_lanes(seed: int, lanes: int, k: int) -> list[int]:
    """The lanes the comparison checks: all of them up to ``k``, else
    ``k`` drawn from the run's seed (ascending)."""
    if lanes <= k:
        return list(range(lanes))
    rng = np.random.default_rng(int(seed))
    return sorted(int(i) for i in rng.choice(lanes, k, replace=False))


def lane_seeds(seed: int, lanes: int) -> list[int]:
    """Lane ``b`` of a run from ``seed`` has the PRNG seed ``seed * lanes +
    b``, taken modulo 2**31: the program's keys take 32-bit seeds, and a
    run's seed may be larger."""
    return [(int(seed) * lanes + b) % (1 << 31) for b in range(lanes)]
