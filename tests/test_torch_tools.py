"""The port's tracer tools on the CPU's plain twins at their ``--cpu`` size
(32 x 32, the bench tracer scene cut to 2 spheres of 6 x 12): each runs
as ``python -m``, exits 0 and prints its lines; time_sweep also with its
any-hit and incoherent options."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_time_sweep_cpu():
    out = _run("sailor_tpu_torch.tools.time_sweep", "--cpu", "--k", "3")
    assert out.returncode == 0, out.stderr
    assert re.search(r"T\(1\)=[\d.]+ ms  T\(3\)=[\d.]+ ms  per-dispatch=-?[\d.]+ ms", out.stdout)
    assert "clusters" in out.stderr and "device=cpu" in out.stderr


@pytest.mark.parametrize("flags", [["--any-hit"], ["--incoherent", "--size", "16"]],
                         ids=["any_hit", "incoherent"])
def test_time_sweep_options(capsys, flags):
    from sailor_tpu_torch.tools import time_sweep

    assert time_sweep.main(["--cpu", "--k", "2", *flags]) == 0
    out, err = capsys.readouterr()
    assert "per-dispatch=" in out
    assert ("any_hit=True" in err) == ("--any-hit" in flags)
    assert ("incoherent=True" in err) == ("--incoherent" in flags)


def test_profile_trace_cpu():
    out = _run("sailor_tpu_torch.tools.profile_trace", "--cpu", "--bounces", "2")
    assert out.returncode == 0, out.stderr
    for phase in ("closest coherent:", "closest incoherent:", "any-hit coherent:",
                  "prologue alone:", "one sample pass:", "shade_hit alone:"):
        assert re.search(re.escape(phase) + r"\s+[\d.]+ ms", out.stdout), (phase, out.stdout)
    assert "(2 bounces)" in out.stdout


def test_tools_need_the_card_without_cpu():
    """Without --cpu the tools run on the card and refuse where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run("sailor_tpu_torch.tools.profile_trace", "--small")
    assert out.returncode != 0 and "CUDA" in out.stderr
