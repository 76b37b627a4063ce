"""``BENCHMARK.json`` and every file it names: they load, their names and
units keep to the allowed characters, and the harness finds what each
entry needs by its name alone."""

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_the_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configurations(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert spec.NAME.match(c["name"]) and LINE.match(c["why"])
    assert LINE.match(c["source"]) and c["source"].startswith("https://")
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    conf = spec.config(spec.ROOT, c["name"])
    assert conf["name"] == c["name"] and conf["source"] == c["source"]
    assert conf["reduced"] == c["reduced"]
    assert conf["assumed"]
    assert all(spec.NAME.match(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    # the family it names: a file of portbench/families/ with the interface
    assert spec.NAME.match(conf["family"])
    assert os.path.isfile(os.path.join(spec.PACKAGE, "families",
                                       conf["family"] + ".py"))
    fam = spec.family(spec.ROOT, conf)
    assert fam.STATE and all(isinstance(k, str) for k in fam.STATE)
    assert all(callable(getattr(fam, k)) for k in spec.FAMILY
               if k != "STATE")
    assert fam.small(conf)["name"] == conf["name"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert spec.NAME.match(w[k])
    assert w["chips"] == 1 and LINE.match(w["why"])
    traf = spec.traffic(spec.ROOT, w["traffic"])
    assert {"lanes", "t_steps", "chunk_steps", "drive"} <= set(traf)
    assert traf["t_steps"] % traf["chunk_steps"] == 0
    assert spec.end_to_end(BENCH, w["name"])
    assert any(m["name"] == "setup_s"
               for m in spec.end_to_end(BENCH, w["name"]))
    assert spec.per_layer(BENCH, w["name"])


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and LINE.match(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    assert callable(spec.metric_reader(m["name"]))


def test_every_reader_finds_nothing_in_an_empty_record():
    rec = {"chunks": [], "stretch": None, "steps": 0, "least_s": None}
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"])(rec) is None


def test_the_json_is_plain():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == BENCH
