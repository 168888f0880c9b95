"""A later change adds a configuration, a traffic mix and a per-layer
metric with new files and entries alone: in a copy of the benchmark, a
throwaway cell (a smaller tracer scene under a 2-sample mix) with a new
metric is found by name and runs on the CPU, no existing file edited."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.harness import cell, manifest
c = manifest.cell("tracer-64.pair")
print(json.dumps({{"reader": c.reader("idle_twice").read(None, None),
                   "run": cell.run("tracer-64.pair", 5, 0.0, False, device="cpu")}}))
"""


def test_a_new_cell_needs_only_new_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    before = {p: open(p, "rb").read() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    with open(os.path.join(ROOT, "benchmark", "configs", "tracer-512.json")) as f:
        conf = json.load(f)
    conf["name"] = "tracer-64"
    conf["scene_args"].update(width=32, height=32, spheres=2, rings=6, sectors=12)
    conf["render"]["spp"] = 2
    (tmp_path / "benchmark" / "configs" / "tracer-64.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark" / "traffic" / "pair.json").write_text(json.dumps(
        {"driver": "renders", "max_in_flight": 2, "sample_batch": 2, "bounce_sort": True,
         "warmup_renders": 1, "traced_renders": 1, "judge_among": 1, "judged_slots": 32,
         "judged_rays": 64}))
    (tmp_path / "benchmark" / "metrics" / "idle_twice.py").write_text(
        "def read(trace, session):\n    return 2.0\n")
    m["configs"].append({"name": "tracer-64", "source": "https://github.com/aantropov/Sailor",
                         "file": "benchmark/configs/tracer-64.json", "reduced": ["spp"],
                         "why": "throwaway"})
    m["workloads"].append({"name": "tracer-64.pair", "config": "tracer-64", "traffic": "pair",
                           "chips": 1, "why": "throwaway"})
    m["per_layer"].append({"name": "idle_twice", "unit": "share", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "mrays_per_s",
                           "workloads": ["tracer-64.pair"]})
    for e in m["end_to_end"]:
        if "workloads" in e and e["name"] == "mrays_per_s":
            e["workloads"].append("tracer-64.pair")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(tmp_path))],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["reader"] == 2.0
    assert res["run"]["correct"] and set(res["run"]["metrics"]) == {"mrays_per_s", "setup_s"}
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
