"""BENCHMARK.json keeps to the benchmark's contract: its keys, names and
units of the allowed characters, one file a configuration under the
benchmark's folder, every per-layer metric with its layer as PERF.md
lists it and one end-to-end metric it moves, and bounds in range."""

import json
import os
import re

import pytest

from conftest import REPO

SPEC = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert all(_line(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(REPO, p))


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(REPO, "benchmark", "traffic",
                                           w["traffic"] + ".json"))


def _perf_layers():
    text = open(os.path.join(REPO, "PERF.md")).read()
    sec = text.split("## 3. Layers", 1)[1].split("\n## ", 1)[0]
    return {row.split("|")[1].strip() for row in sec.splitlines()
            if row.startswith("| ") and not row.startswith("| layer")}


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    all_names = [m["name"] for g in ("end_to_end", "per_layer") for m in SPEC[g]]
    assert len(set(all_names)) == len(all_names)
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))
        if group == "end_to_end":
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                              "bound", "source"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                              "layer", "moves"}
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in e2e and _line(m["layer"])
            assert m["layer"] in _perf_layers(), m["layer"]
    if group == "end_to_end":
        assert "setup_s" in e2e and len(e2e) >= 2
