"""The whole DefaultRenderer frame (all 18 entries) on a scene with
materials in all three queues, through the JAX package's FrameGraph and
the port's, on the CPU: ``scenes.flagship_queue_scene`` at 256x128 (24
point lights, 10 objects: Opaque, Masked with striped alpha and
Transparent, 256x256 maps), ``FULL_CONFIG`` with ``shadow_resolution``
cut to 128 and the reference's ``masked_layers`` 3 and
``transparent_layers`` 3. One frame, ``prepare`` first.

Tolerances as test_torch_frame_full.py's: Depth, TriId, LightIndices,
LightCounts, ShadowMaps exact (Depth and TriId need no exception at
pixels whose alpha lies at the cutoff: measured none differ); Main within
1e-4 relative (to max(|ref|, 1e-3)) on >= 99.9% of the pixels more than
16 px from the border and on >= 99% of all (measured: every inner pixel,
99.49% of all; the misses lie in the border band, where the reference's
compiled HBAO occludes otherwise, ROADMAP C 8); Final within 2/255 on
every pixel (measured 2.2e-4).

Also the transparent peel's layers: the port's two-sided setup with the
reference frame's depth-plane rounding (``zplane_rounding="frame"``;
"standalone" in the dense raster mode) gives depths and ids equal to the
reference's RenderTransparent layers, captured from its compiled frame
(ROADMAP C 2).
"""

import os

import jax
import numpy as np
import pytest
import torch

from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.framegraph import nodes as j_nodes
from sailor_tpu.kernels import pbr_pallas as j_pk
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset, nodes
from sailor_tpu_torch.framegraph.graph import RenderContext
from test_torch_queues import queue_scenes
from test_torch_scenes import FULL_CONFIG
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDERER = os.path.join(REPO, "content", "DefaultRenderer.renderer")
W, H = 256, 128
CONFIG = dict(FULL_CONFIG, shadow_resolution=128, masked_layers=3, transparent_layers=3)
EXACT = ("Depth", "TriId", "LightIndices", "LightCounts", "ShadowMaps")
BAND = 16
PEEL_GRAPH = ("frame:\n - name: DepthPrepass\n - name: LinearizeDepth\n"
              " - name: LightCulling\n - name: RenderScene\n - name: RenderTransparent\n")


def _capture_transparent_layers(mp):
    """Make the reference's RenderTransparent publish the depth and ids of
    its peel layers ("Peel<k>"), read from inside its compiled frame."""
    seen = []
    make = j_nodes._make_raster

    def recording(*args, **kwargs):
        raster, overflow = make(*args, **kwargs)

        def rec(z_bounds=None):
            out = raster(z_bounds)
            seen.append(out)
            return out

        if hasattr(raster, "stream_bins"):
            rec.stream_bins = raster.stream_bins
        return rec, overflow

    process = j_nodes.RenderTransparentNode.process

    def publish(self, ctx, targets):
        n0 = len(seen)
        targets = process(self, ctx, targets)
        for k, out in enumerate(seen[n0:]):
            targets[f"Peel{k}"] = out
        return targets

    mp.setattr(j_nodes, "_make_raster", recording)
    mp.setattr(j_nodes.RenderTransparentNode, "process", publish)


@pytest.fixture(scope="module")
def frames():
    js, ts = queue_scenes(W, H, 24, 10)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        jfg = JFrameGraph(JAsset.load(RENDERER), W, H, config=dict(CONFIG))
        state = jfg.initial_state()
        jfg.prepare(js, state)
        jt, _ = jfg.process(js, state)
        ref = {k: np.asarray(jt[k]) for k in EXACT + ("Main", "Final")}
        _capture_transparent_layers(mp)
        peel = {}
        for mode in ("stream", "dense"):
            cfg = dict(CONFIG, raster_mode=mode)
            pfg = JFrameGraph(JAsset.from_yaml(PEEL_GRAPH), W, H, config=cfg)
            pt, _ = pfg.process(js, pfg.initial_state())
            peel[mode] = (np.array(pt["Depth"]),
                          [tuple(np.asarray(a) for a in pt[f"Peel{k}"]) for k in range(3)])
    finally:
        mp.undo()
        jax.clear_caches()
    fg = FrameGraph(FrameGraphAsset.load(RENDERER), W, H, dict(CONFIG), device="cpu")
    state = fg.initial_state()
    fg.prepare(ts, state)
    tt, _ = fg.process(ts, state)
    got = {k: tt[k].numpy() for k in EXACT + ("Main", "Final")}
    got["MaskedPeelLayers"] = tt["MaskedPeelLayers"]
    return got, ref, peel, ts


def test_queue_frame_matches_jax(frames):
    got, ref, _, ts = frames
    tid = ref["TriId"]
    assert (tid >= 0).mean() > 0.3 and (tid < 0).mean() > 0.1
    for k in EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rel = np.abs(got["Main"] - ref["Main"]) / np.maximum(np.abs(ref["Main"]), 1e-3)
    main_ok = rel.max(-1) <= 1e-4
    assert main_ok[BAND:-BAND, BAND:-BAND].mean() >= 0.999
    assert main_ok.mean() >= 0.99
    assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255
    # all three queues are on screen, and the masked peel went past layer 1
    mid = ts.geometry.material_id.numpy()
    src = np.repeat(np.arange(mid.shape[0]), 2)  # the near clipper's two slots a triangle
    queues = ts.materials.queue.numpy()[mid[src[np.maximum(tid, 0)]]][tid >= 0]
    assert (queues == 0).any() and (queues == 1).any()
    assert got["MaskedPeelLayers"] >= 2


@pytest.mark.parametrize("mode", ["stream", "dense"])
def test_transparent_peel_layers_match_jax(frames, mode):
    """The peel's three layers, from the reference's compiled frame, equal
    the port's raster on its two-sided setup bit for bit."""
    _, _, peel, ts = frames
    zlo, layers = peel[mode]
    ctx = RenderContext(width=W, height=H, scene=ts, state={}, values={},
                        config=dict(CONFIG, raster_mode=mode))
    _, _, raster, _ = nodes.transparent_raster(ctx)
    zhi = torch.full((H, W), 2.0)
    covered = 0
    for d_ref, t_ref in layers:
        d, t = raster((torch.from_numpy(zlo), zhi))
        np.testing.assert_array_equal(d.numpy(), d_ref)
        np.testing.assert_array_equal(t.numpy(), t_ref)
        covered += int((t >= 0).sum())
        zhi = torch.where(t[:H, :W] >= 0, d[:H, :W], 0.0)
    assert covered > 100
