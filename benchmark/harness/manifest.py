"""Finds a cell's files by the names ``BENCHMARK.json`` gives: the
configuration (``configs/<file>``), the traffic mix
(``traffic/<traffic>.json``), the driver the mix names
(``drivers/<driver>.py``), the scene recipe and check the configuration
names (``scenes/<scene>.py``, ``checks/<check>.py``) and one reader a
per-layer metric (``metrics/<name>.py``). No name of a cell lives here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_file(path: str, name: str | None = None):
    """Import a Python file as a module (metric names hold dots, so not
    by ``import``)."""
    name = name or "benchmark_file_" + os.path.relpath(path, BENCH).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    end_to_end: list      # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list       # ... and with --trace 1

    def driver(self):
        return load_file(os.path.join(BENCH, "drivers", self.traffic["driver"] + ".py"))

    def scene(self):
        return load_file(os.path.join(BENCH, "scenes", self.config["scene"] + ".py"))

    def check(self):
        return load_file(os.path.join(BENCH, "checks", self.config["check"] + ".py"))

    def reader(self, metric: str):
        return load_file(os.path.join(BENCH, "metrics", metric + ".py"))


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    m = manifest(root)
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                end_to_end=[e for e in m["end_to_end"] if _reports(e, name)],
                per_layer=[p for p in m["per_layer"] if _reports(p, name)])
