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
  inverse view-projection. The two packages invert it with different
  LAPACK builds, which differ in the last bit of a few entries, and the
  pixel ray is the difference of two unprojected points 0.2 m apart at a
  30 m scale, so that bit moves grazing surface points visibly; the second
  test keeps the port's own inverse and bounds that effect.

Tolerances (first test): Depth, TriId, LightIndices and LightCounts
exact; Main within 1e-4 relative
(to max(|ref|, 1e-3)) on >= 99.9% of pixels; Final within 2/255 on every
pixel; adapted luminance within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.kernels import pbr_pallas as j_pk
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.framegraph import nodes as t_nodes
from test_torch_scenes import MINIMAL_GRAPH, SLICE_CONFIG, jax_scene, torch_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 256, 128


def _two_frames(fg, scene, state):
    out = []
    for _ in range(2):
        targets, state = fg.process(scene, state)
        out.append(({k: np.asarray(targets[k]) for k in
                     ("Depth", "TriId", "LightIndices", "LightCounts", "Main", "Final")},
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
    """The port's own inverse view-projection: TriId and LightIndices exact;
    Main within 1e-4 on >= 97% and within 1e-2 on >= 99.9% of pixels;
    Final within 2/255 on >= 99.9%."""
    js, ref_frames = reference
    for (got, g_avg), (ref, r_avg) in zip(_port_frames(js), ref_frames):
        np.testing.assert_array_equal(got["TriId"], ref["TriId"])
        np.testing.assert_array_equal(got["LightIndices"], ref["LightIndices"])
        rel = _main_rel(got["Main"], ref["Main"])
        assert (rel <= 1e-4).mean() >= 0.97
        assert (rel <= 1e-2).mean() >= 0.999
        assert (np.abs(got["Final"] - ref["Final"]).max(-1) <= 2 / 255).mean() >= 0.999
        assert abs(g_avg - r_avg) <= 1e-3 * r_avg
