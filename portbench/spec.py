"""What a run reads: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file of its own, ``portbench/configs/<config>.json``
and ``portbench/traffic/<traffic>.json``.  A configuration names its
model family, a module ``portbench/families/<family>.py`` that builds the
network, the program and the plain reference (see :func:`family`), and
each per-layer metric is a reader ``portbench/metrics/<name>.py``.  A
later change adds a cell, a configuration, a traffic mix, a family or a
metric by adding such files and entries; nothing here names one.
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


def _module(kind: str, name: str, path: str):
    """The module at ``path``, loaded by path (a name may hold dots)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(record)`` function of ``portbench/metrics/<name>.py``."""
    return _module("metric", name, os.path.join(
        PACKAGE, "metrics", _named("metric", name) + ".py")).read


#: What a family module provides (``portbench/README.md`` says what each
#: must give).
FAMILY = ("STATE", "dt_ms", "network", "program", "reference", "least_work",
          "small")


def family(root: str, conf: dict):
    """The module ``<root>/portbench/families/<family>.py`` that the
    configuration's ``family`` names, loaded by path.  A configuration
    that names no family, or a family whose file is missing or lacks part
    of :data:`FAMILY`, is refused."""
    name = conf.get("family")
    if name is None:
        raise ValueError(f"configuration {conf.get('name')!r} names no "
                         f"family: it needs a \"family\" key naming "
                         f"portbench/families/<family>.py")
    path = os.path.join(root, "portbench", "families",
                        _named("family", name) + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"configuration {conf.get('name')!r} names the "
                         f"family {name!r}, and there is no {path}")
    mod = _module("family", name, path)
    missing = [k for k in FAMILY if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"family {name!r} ({path}) lacks {missing}")
    return mod


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
