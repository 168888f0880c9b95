"""The import guard: names compared whole by their top-level part, the
plain reference free of the program, and a run refused without a card."""

import os
import subprocess
import sys

from conftest import ROOT

from benchmark.harness import guard


def test_top_level_names_compared_whole():
    mods = {"sailor_tpu_torch": 1, "sailor_tpu_torch.kernels": 1, "numpy": 1}
    assert guard.loaded(modules=mods) == []
    assert guard.loaded(modules=dict(mods, **{"sailor_tpu.raster": 1})) == ["sailor_tpu.raster"]
    assert guard.loaded(modules={"jaxlib.xla": 1, "jaxtyping": 1}) == ["jaxlib.xla"]


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_imports() == []
    assert guard.imported_by("import sailor_tpu_torch.kernels as k\nfrom jax import numpy") \
        == {"sailor_tpu_torch", "jax"}


def test_run_refused_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "tracer-512.pooled", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refused_outside_a_checkout(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tracer-512.pooled",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
