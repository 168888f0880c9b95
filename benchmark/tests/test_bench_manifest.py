"""BENCHMARK.json against the benchmark's contract, and each cell's files
found by name."""

import json
import os
import re

import pytest
from conftest import ROOT

from benchmark.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.manifest()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_names_and_units():
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[part]]
    for n in names + [w["traffic"] for w in M["workloads"]] + [
            k for c in M["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for part in ("configs", "workloads"):
        assert len({x["name"] for x in M[part]}) == len(M[part])
    metrics = M["end_to_end"] + M["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def _reports(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_what_it_must(w):
    e2e = [m["name"] for m in M["end_to_end"] if _reports(m, w)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in M["per_layer"] if _reports(m, w)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], w)


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(w):
    c = manifest.cell(w)
    assert c.driver().window_run and c.driver().traced_run
    assert c.scene().host and c.check().judge and c.check().control
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert set(c.check().LIMITS)


def test_configs_and_cells():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in M["workloads"])
    for text in [w["why"] for w in M["workloads"]] + [c["why"] for c in M["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_layers_named_alike():
    by = {}
    for m in M["per_layer"]:
        by.setdefault(m["layer"], []).append(m["name"])
    assert all(1 <= len(k) <= 200 for k in by)


def test_check_budget_fits_the_full_benchmark():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_harness_names_no_cell():
    with open(os.path.join(ROOT, "benchmark", "run.py")) as f:
        run = f.read()
    for folder in ("harness",):
        for name in os.listdir(os.path.join(ROOT, "benchmark", folder)):
            if name.endswith(".py"):
                with open(os.path.join(ROOT, "benchmark", folder, name)) as f:
                    run += f.read()
    for x in M["workloads"] + M["configs"] + M["per_layer"]:
        assert x["name"] not in run, x["name"]
