"""The slice end to end: the minimal Forward+ graph (DepthPrepass ->
LinearizeDepth -> LightCulling -> RenderScene -> EyeAdaptation) through the
JAX package's FrameGraph and the port's, on the flagship scene at 256x128
(24 point lights, 10 objects), two frames with the state threaded through.

Both packages render from identical inputs (scene_from_numpy) with the
slice's configuration. Two substitutions make the comparison one of the
port, not of rounding the port does not control:
- the reference's shade kernel gets exact division for its approximate
  reciprocal (see test_torch_shade.py);
- in the first test, the port's RenderScene gets the reference's own
  inverse view-projection; the second test keeps the port's own
  (``math3d.inverse``: LAPACK's getrf/getrs through scipy, which jaxlib's
  CPU kernels call) and holds it to the same bar. The pixel ray is the
  difference of two unprojected points 0.2 m apart at a 30 m scale, so a
  last-bit difference in the inverse (``torch.linalg.inv`` gives one in 6
  of the 16 entries here) moves grazing surface points visibly;
  ``test_inverse_matches_jax`` holds the port's inverse to
  ``jnp.linalg.inv`` bit for bit.

Tolerances (first test): Depth, TriId, LightIndices and LightCounts
exact; Main within 1e-4 relative
(to max(|ref|, 1e-3)) on >= 99.9% of pixels; Final within 2/255 on every
pixel; adapted luminance within 1e-4 relative.

The third test renders one frame in each other raster configuration the
reference accepts (dense bins, per-tile DMA walk, grid-k stream with the
fused grid-k resolve, its MXU plane form, the gather resolve) and holds it
to the reference's frame in the same configuration at the first test's
tolerances, with BinOverflow equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.kernels import pbr_pallas as j_pk
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.framegraph import nodes as t_nodes
from sailor_tpu_torch.scenes import flagship_scene
from test_torch_scenes import MINIMAL_GRAPH, SLICE_CONFIG, jax_scene, torch_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 256, 128


KEYS = ("Depth", "TriId", "LightIndices", "LightCounts", "Main", "Final")


def _two_frames(fg, scene, state):
    out = []
    for _ in range(2):
        targets, state = fg.process(scene, state)
        out.append(({k: np.asarray(targets[k]) for k in KEYS},
                    float(np.asarray(state["avg_luminance"]))))
    return out


@pytest.fixture(scope="module")
def reference():
    js = jax_scene(W, H, 24, 10)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        yaml_text = "frame:\n" + "".join(f" - name: {n}\n" for n in MINIMAL_GRAPH)
        fg = JFrameGraph(JAsset.from_yaml(yaml_text), W, H, config=dict(SLICE_CONFIG))
        frames = _two_frames(fg, js, fg.initial_state())
    finally:
        mp.undo()
        jax.clear_caches()
    return js, frames


def _port_frames(js):
    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), W, H, SLICE_CONFIG,
                    device="cpu")
    return _two_frames(fg, torch_scene(js), fg.initial_state())


def _main_rel(got, ref):
    return (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)).max(-1)


def test_frame_matches_jax(reference, monkeypatch):
    js, ref_frames = reference
    inv = torch.from_numpy(np.array(jnp.linalg.inv(js.frame.view_projection)))
    monkeypatch.setattr(t_nodes, "inverse_view_projection", lambda frame: inv)
    for (got, g_avg), (ref, r_avg) in zip(_port_frames(js), ref_frames):
        assert (ref["TriId"] >= 0).mean() > 0.3
        np.testing.assert_array_equal(got["TriId"], ref["TriId"])
        np.testing.assert_array_equal(got["Depth"], ref["Depth"])
        np.testing.assert_array_equal(got["LightCounts"], ref["LightCounts"])
        np.testing.assert_array_equal(got["LightIndices"], ref["LightIndices"])
        assert (_main_rel(got["Main"], ref["Main"]) <= 1e-4).mean() >= 0.999
        assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255
        assert abs(g_avg - r_avg) <= 1e-4 * r_avg
    assert ref_frames[0][1] != ref_frames[1][1]  # the exposure adapts


def test_frame_with_own_inverse_matches_jax(reference):
    """The port's own inverse view-projection, at the first test's bar."""
    js, ref_frames = reference
    for (got, g_avg), (ref, r_avg) in zip(_port_frames(js), ref_frames):
        np.testing.assert_array_equal(got["TriId"], ref["TriId"])
        np.testing.assert_array_equal(got["Depth"], ref["Depth"])
        np.testing.assert_array_equal(got["LightCounts"], ref["LightCounts"])
        np.testing.assert_array_equal(got["LightIndices"], ref["LightIndices"])
        assert (_main_rel(got["Main"], ref["Main"]) <= 1e-4).mean() >= 0.999
        assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255
        assert abs(g_avg - r_avg) <= 1e-4 * r_avg


def _inverse_cases():
    """(name, matrix): the flagship and tracer cameras' view-projections
    and projections (the port's scene builders), this file's frame, and
    seeded random matrices."""
    from sailor_tpu_torch.scenes import tracer_camera

    flag = flagship_scene(1920, 1088, 4, 2, device="cpu").frame
    _, view, proj = tracer_camera("cpu")
    rng = np.random.default_rng(5)
    return ([("flagship_vp", flag.view_projection.numpy()), ("flagship_proj", flag.projection.numpy()),
             ("tracer_vp", (proj @ view).numpy()), ("tracer_proj", proj.numpy()),
             ("frame_vp", np.asarray(jax_scene(W, H, 24, 10).frame.view_projection))]
            + [(f"random{i}", rng.normal(size=(4, 4)).astype(np.float32)) for i in range(64)])


def test_inverse_matches_jax():
    """``math3d.inverse`` equals ``jnp.linalg.inv`` bit for bit."""
    for name, m in _inverse_cases():
        want = np.asarray(jnp.linalg.inv(jnp.asarray(m, jnp.float32)))
        got = m3.inverse(torch.from_numpy(np.array(m, np.float32))).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), name)


RASTER_CONFIGS = {
    "dense": {"raster_mode": "dense"},
    "dma": {"raster_mode": "dma"},
    "stream": {"raster_worklist": False},
    "stream_mxu": {"raster_worklist": False, "raster_mxu": True},
    "gather_resolve": {"fused_resolve": False},
}


@pytest.mark.parametrize("name", list(RASTER_CONFIGS))
def test_frame_raster_config_matches_jax(reference, monkeypatch, name):
    js = reference[0]
    config = dict(SLICE_CONFIG, **RASTER_CONFIGS[name])
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    try:
        yaml_text = "frame:\n" + "".join(f" - name: {n}\n" for n in MINIMAL_GRAPH)
        jfg = JFrameGraph(JAsset.from_yaml(yaml_text), W, H, config=config)
        rt, _ = jfg.process(js, jfg.initial_state())
        ref = {k: np.asarray(rt[k]) for k in KEYS + ("BinOverflow",)}
    finally:
        mp.undo()
        jax.clear_caches()
    inv = torch.from_numpy(np.array(jnp.linalg.inv(js.frame.view_projection)))
    monkeypatch.setattr(t_nodes, "inverse_view_projection", lambda frame: inv)
    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), W, H, config, device="cpu")
    gt, _ = fg.process(torch_scene(js), fg.initial_state())
    got = {k: np.asarray(gt[k]) for k in KEYS + ("BinOverflow",)}
    assert (ref["TriId"] >= 0).mean() > 0.3
    for k in ("TriId", "Depth", "LightCounts", "LightIndices", "BinOverflow"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (_main_rel(got["Main"], ref["Main"]) <= 1e-4).mean() >= 0.999
    assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255
