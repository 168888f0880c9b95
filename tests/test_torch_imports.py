"""The port stands alone and refuses what it does not implement.

- Importing every module of sailor_tpu_torch, and chip_smoke, loads no jax
  and no sailor_tpu module (checked in a fresh interpreter);
- no source line of the port imports them;
- entry points default to the CUDA device and raise when there is none;
- kernel wrappers take CUDA tensors only, and the dispatch runs the plain
  version only for CPU tensors: nothing falls back;
- configuration and nodes outside the slice raise NotImplementedError.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.kernels import pbr_kernel
from sailor_tpu_torch.raster import tile_raster
from sailor_tpu_torch.scenes import flagship_scene
from test_torch_scenes import MINIMAL_GRAPH, SLICE_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sailor_tpu_torch")

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import sailor_tpu_torch
for m in pkgutil.walk_packages(sailor_tpu_torch.__path__, "sailor_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "sailor_tpu"))
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_reference():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_no_source_line_imports_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|sailor_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = [(f, line) for f in files for line in open(f).read().splitlines()
            if pat.match(line)]
    assert len(files) > 20 and hits == []


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 256, 128, SLICE_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_scene(256, 128, 4, 2)


def test_kernel_wrappers_take_cuda_tensors_only():
    rows = torch.zeros(256, 54)
    big = torch.zeros(32, 54)
    st = torch.zeros(1, dtype=torch.int32)
    n_big = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        tile_raster.rasterize_worklist_cuda(rows, big, st, st, n_big, tiles_y=1, tiles_x=1)
    with pytest.raises(ValueError, match="cuda"):
        tile_raster.resolve_worklist_cuda(rows, big, torch.zeros(64, 128, dtype=torch.int32),
                                          st, st, torch.zeros(32), tiles_y=1, tiles_x=1, na=37)
    with pytest.raises(ValueError, match="cuda"):
        pbr_kernel.shade_tiles_cuda(torch.zeros(1, 1, 4, 16), st.reshape(1, 1),
                                    torch.zeros(16, 16, 4), torch.zeros(16, 16),
                                    torch.zeros(16, 16), torch.zeros(16, 16, 3),
                                    torch.zeros(16, 16, 3), None, torch.zeros(3))
    with pytest.raises(ValueError, match="no kernel"):
        tile_raster.rasterize_worklist(None, None, None, st, st, None, n_big, tiles_y=1,
                                       tiles_x=1, prebuilt=(rows.to("meta"), big.to("meta")))


@pytest.mark.parametrize("change", [
    {"hiz_culling": True}, {"raster_mode": "dma"}, {"raster_worklist": False},
    {"raster_mxu": True}, {"fused_resolve": False}, {"tonemap": "uncharted2"},
], ids=lambda c: next(iter(c)))
def test_unsupported_config_raises(change):
    with pytest.raises(NotImplementedError):
        FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 256, 128,
                   dict(SLICE_CONFIG, **change), device="cpu")


@pytest.mark.parametrize("name", ["DepthHighZ", "ShadowPrepass", "Sky", "Bloom"])
def test_unported_node_raises(name):
    with pytest.raises(NotImplementedError):
        FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH + [name]), 256, 128,
                   SLICE_CONFIG, device="cpu")


def test_sharding_raises():
    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 64, 64, SLICE_CONFIG,
                    device="cpu")
    with pytest.raises(NotImplementedError):
        fg.process_sharded(None, {}, None)


def test_materials_raise():
    scene = flagship_scene(64, 64, 2, 2, device="cpu")
    scene.materials = np.zeros(1)
    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 64, 64, SLICE_CONFIG,
                    device="cpu")
    with pytest.raises(NotImplementedError):
        fg.process(scene, fg.initial_state())
