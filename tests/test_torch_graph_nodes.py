"""The frame graph's last nodes and ``process_views`` against the JAX
package's, on the CPU.

- Clear and Blit, node by node on the same inputs (the reference's node
  compiled): Clear of a declared target and of one that is not there
  (left alone), Blit at the same size (the source itself) and resized
  into a declared target and into the viewport: bit-equal.
- A graph of test_framegraph.py's scene at 128x96 with Clear (Main, 0)
  first, Blit of Final into a declared 48x27 Thumbnail and of Main into a
  viewport-size copy, and CopyTextureToRam of both (the reference's graph
  function run uncompiled: its compiled graph cannot return the node's
  list of names, ROADMAP C 5): ``fetch`` returns the
  same keys in both packages and numpy arrays, the copy of Main within
  1e-4 relative (to max(|ref|, 1e-3)) on >= 99.9% of the pixels more than
  16 px from the border and >= 99% of all (ROADMAP C 8's band), the
  thumbnail within 2/255 (Final's bar).
- ``process_views``: test_framegraph.py's ``test_multi_camera_views``
  setup (DefaultRenderer.renderer, two cameras, a state each) over two
  steps: each view's Depth, TriId and LightIndices exact, Main within
  1e-4 relative on >= 99.9% of the pixels more than 16 px from the border
  and >= 99% of all, Final within 2/255; the views differ, and the main
  camera's view equals a plain ``process`` of the scene.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.framegraph import nodes as jnodes
from sailor_tpu.framegraph.graph import RenderContext as JContext
from sailor_tpu.kernels import pbr_pallas as j_pk
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset, nodes
from sailor_tpu_torch.framegraph.graph import RenderContext
from test_torch_scenes import release_jax_executables, scene_arrays  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDERER = os.path.join(REPO, "content", "DefaultRenderer.renderer")
W, H = 128, 96
CONFIG = {"z_far": 100.0, "shadow_resolution": 128, "env_resolution": 16,
          "bin_capacity": 256, "bin_rounds": 2, "sky_clouds": False}
BAND = 16


def _node_pair(name, params, targets, w=W, h=H):
    """Run the reference's node (compiled) and the port's on the same
    targets; returns (port targets, reference targets) as numpy."""
    jnode = jnodes.ClearNode if name == "Clear" else jnodes.BlitNode
    tnode = nodes.ClearNode if name == "Clear" else nodes.BlitNode
    jctx = JContext(width=w, height=h, config={})
    ref = jax.jit(lambda t: jnode(dict(params)).process(jctx, dict(t)))(
        {k: jnp.asarray(v) for k, v in targets.items()})
    got = tnode(dict(params)).process(RenderContext(width=w, height=h, config={}),
                                      {k: torch.from_numpy(v.copy()) for k, v in targets.items()})
    return ({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in ref.items()})


@pytest.mark.parametrize("params", [
    {"target": "Main", "clearValue": 0.25}, {"target": "Absent", "clearValue": 1.0},
    {"target": "AO"}], ids=["main", "absent", "default_value"])
def test_clear_matches_reference(params):
    rng = np.random.default_rng(0)
    targets = {"Main": rng.random((H, W, 3), np.float32), "AO": rng.random((H, W), np.float32)}
    got, ref = _node_pair("Clear", params, targets)
    assert sorted(got) == sorted(ref) == ["AO", "Main"]
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if params["target"] == "Absent":
        np.testing.assert_array_equal(got["Main"], targets["Main"])


@pytest.mark.parametrize("dst", ["same", "resize", "viewport"])
def test_blit_matches_reference(dst):
    rng = np.random.default_rng(1)
    targets = {"Sky": rng.random((H // 2, W // 2, 3), np.float32) * 4}
    params = {"src": "Sky", "dst": "Out"}
    if dst == "same":
        targets["Out"] = np.zeros((H // 2, W // 2, 3), np.float32)
    elif dst == "resize":
        targets["Out"] = np.zeros((27, 48, 4), np.float32)
    got, ref = _node_pair("Blit", params, targets)
    assert got["Out"].shape == ref["Out"].shape == {
        "same": (H // 2, W // 2, 3), "resize": (27, 48, 3), "viewport": (H, W, 3)}[dst]
    np.testing.assert_array_equal(got["Out"], ref["Out"])
    if dst == "same":
        np.testing.assert_array_equal(got["Out"], targets["Sky"])


def _scenes():
    import test_framegraph

    from sailor_tpu_torch.rhi.scene_view import scene_from_numpy

    js = test_framegraph._scene_view()
    return js, scene_from_numpy(scene_arrays(js), "cpu")


def _main_ok(got, ref):
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)).max(-1)
    ok = rel <= 1e-4
    return ok[BAND:-BAND, BAND:-BAND].mean() >= 0.999 and ok.mean() >= 0.99


THUMB_GRAPH = """\
renderTargets:
  - name: Thumbnail
    width: 48
    height: 27
frame:
  - name: Clear
    target: Main
  - name: DepthPrepass
  - name: LinearizeDepth
  - name: LightCulling
  - name: RenderScene
  - name: EyeAdaptation
  - name: Blit
    src: Final
    dst: Thumbnail
  - name: Blit
    src: Main
    dst: MainCopy
  - name: CopyTextureToRam
    target: Thumbnail
  - name: CopyTextureToRam
    target: MainCopy
"""


def test_thumbnail_readback_matches_reference():
    js, ts = _scenes()
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        # the reference's CopyTextureToRam lists its targets' names in the
        # target dict, which its compiled graph cannot return (ROADMAP C 5):
        # its graph function runs uncompiled here
        jfg = JFrameGraph(JAsset.from_yaml(THUMB_GRAPH), W, H, config=dict(CONFIG))
        with pytest.raises(TypeError, match="str"):
            jfg.process(js, jfg.initial_state())
        jt, _ = jfg._run(js, jfg.initial_state())
        ref = jnodes.CopyTextureToRamNode.fetch(jt)
    finally:
        mp.undo()
        jax.clear_caches()
    fg = FrameGraph(FrameGraphAsset.from_yaml(THUMB_GRAPH), W, H, dict(CONFIG), device="cpu")
    tt, _ = fg.process(ts, fg.initial_state())
    got = nodes.CopyTextureToRamNode.fetch(tt)
    assert tt["readback"] == ["Thumbnail", "MainCopy"]
    assert sorted(got) == sorted(ref) == ["MainCopy", "Thumbnail"]
    assert all(isinstance(v, np.ndarray) for v in got.values())
    assert got["Thumbnail"].shape == ref["Thumbnail"].shape == (27, 48, 3)
    assert np.abs(got["Thumbnail"] - ref["Thumbnail"]).max() <= 2 / 255
    assert got["MainCopy"].shape == (H, W, 3) and _main_ok(got["MainCopy"], ref["MainCopy"])
    np.testing.assert_array_equal(got["MainCopy"], tt["Main"].numpy())


def _second_camera(js, ts):
    from sailor_tpu.core import math3d as jm3
    from sailor_tpu.rhi.types import FrameData as JFrameData
    from sailor_tpu_torch.rhi.types import FrameData

    cam2 = jnp.asarray([-6.0, 2.0, -6.0])
    view2 = jm3.look_at(cam2, jnp.asarray([0.0, 0.75, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    proj2 = jm3.perspective(jnp.pi / 4, W / H, 0.1, 100.0)
    jf = JFrameData.create(view2, proj2, cam2, 0.1, 100.0, dt=1 / 60)
    tf = FrameData(**{f.name: torch.from_numpy(np.array(getattr(jf, f.name)))
                      for f in dataclasses.fields(FrameData)})
    return jf, tf


KEYS = ("Depth", "TriId", "LightIndices", "Main", "Final")


def test_process_views_matches_reference():
    js, ts = _scenes()
    jf2, tf2 = _second_camera(js, ts)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    ref = []
    try:
        jfg = JFrameGraph(JAsset.load(RENDERER), W, H, config=dict(CONFIG))
        states = [jfg.initial_state(), jfg.initial_state()]
        jfg.prepare(js, states[0])
        jfg.prepare(js.replace(frame=jf2), states[1])
        for _ in range(2):
            outs, states = jfg.process_views(js, states, [js.frame, jf2])
            ref.append([{k: np.asarray(o[k]) for k in KEYS} for o in outs])
    finally:
        mp.undo()
        jax.clear_caches()
    fg = FrameGraph(FrameGraphAsset.load(RENDERER), W, H, dict(CONFIG), device="cpu")
    states = [fg.initial_state(), fg.initial_state()]
    fg.prepare(ts, states[0])
    fg.prepare(dataclasses.replace(ts, frame=tf2), states[1])
    got = []
    for _ in range(2):
        outs, states = fg.process_views(ts, states, [ts.frame, tf2])
        got.append([{k: o[k].numpy() for k in KEYS} for o in outs])
    for step in range(2):
        for view in range(2):
            g, r = got[step][view], ref[step][view]
            for k in ("Depth", "TriId", "LightIndices"):
                np.testing.assert_array_equal(g[k], r[k], err_msg=f"{step}/{view}/{k}")
            assert _main_ok(g["Main"], r["Main"]), (step, view)
            assert np.abs(g["Final"] - r["Final"]).max() <= 2 / 255
    a, b = got[0][0]["Final"], got[0][1]["Final"]
    assert np.abs(a - b).mean() > 1e-3  # opposite sides of the cube
    # the main camera's view is a plain frame of the scene
    state = fg.initial_state()
    fg.prepare(ts, state)
    single, _ = fg.process(ts, state)
    np.testing.assert_array_equal(single["Final"].numpy(), a)
