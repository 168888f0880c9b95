"""The port's tools on the CPU's plain twins: the tracer tools at their
``--cpu`` size (32 x 32, the bench tracer scene cut to 2 spheres of 6 x
12), time_hiz at a small TH_* size and profile_frame ``--small`` on a
content GLB with a trace; each runs as ``python -m``, exits 0 and prints
its lines; time_sweep also with its any-hit and incoherent options."""

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


def test_time_hiz_cpu():
    """tools/time_hiz.py's scene at a small TH_* size on the plain twins:
    the cull removes triangles with hiz on and none with it off."""
    env = {"TH_W": "128", "TH_H": "96", "TH_CUBES": "40", "TH_LIGHTS": "8", "TH_FRAMES": "1"}
    out = subprocess.run([sys.executable, "-m", "sailor_tpu_torch.tools.time_hiz", "--cpu"],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                                            **env),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    on = re.search(r"hiz=1  frame [\d.]+ ms  \([\d.]+ FPS\)  culled (\d+)/484", out.stdout)
    off = re.search(r"hiz=0  frame [\d.]+ ms  \([\d.]+ FPS\)  culled 0/484", out.stdout)
    assert on and off and int(on.group(1)) > 0, out.stdout
    assert "40 cubes behind a wall" in out.stderr and "device=cpu" in out.stderr


def test_profile_frame_cpu_content_and_trace(tmp_path):
    """``profile_frame --small --content GLB --trace DIR`` on the plain
    twins: the frame times, a Chrome trace, and every node of
    DefaultRenderer.renderer in the per-node table."""
    import json

    sys.path.insert(0, REPO)
    import chip_smoke
    from sailor_tpu_torch.scenes import procedural_test_maps

    glb = tmp_path / "balls.glb"
    glb.write_bytes(chip_smoke.balls_glb(procedural_test_maps(0, 16), 2, 3, jpeg=True))
    out = _run("sailor_tpu_torch.tools.profile_frame", "--cpu", "--small", "--frames", "1",
               "--content", str(glb), "--trace", str(tmp_path / "tr"))
    assert out.returncode == 0, out.stderr
    assert re.search(r"== frames: best [\d.]+ ms", out.stdout)
    assert "60 instances of balls.glb" in out.stderr
    for node in ("DepthPrepass", "RenderScene", "Bloom", "EyeAdaptation", "TOTAL"):
        assert re.search(node + r"\s+[\d.]+ ms", out.stdout), (node, out.stdout)
    with open(tmp_path / "tr" / "frame.json") as f:
        assert json.load(f)["traceEvents"]
