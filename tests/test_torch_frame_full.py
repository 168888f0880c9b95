"""The whole DefaultRenderer frame (content/DefaultRenderer.renderer, all 18
entries) through the JAX package's FrameGraph and the port's, on the CPU,
on the flagship scene at 256x128 (24 point lights, 10 objects, the bench's
sun) with ``FULL_CONFIG`` (bench.py's flagship config with the reference's
defaults; ``shadow_resolution`` cut to 128). Two frames with the state
threaded through and ``prepare`` before each: frame 1 static (the
previous camera is the camera), frame 2 with the camera turned 0.05 rad,
the previous frame's camera as MotionBlur's history and the sun moved
(the sky re-renders, the environment refreshes one face, frame 2 tests
its triangles against frame 1's pyramid; at this size it culls none,
tests/test_torch_hiz.py holds frames that cull).

The reference's shade kernel gets exact division for its approximate
reciprocal (see test_torch_shade.py). Tolerances: Depth, TriId,
LightIndices, LightCounts, ShadowMaps and HiZCulledCount exact; the sky
cache key's sun and time entries exact and its rounded corners within 1
(measured: all exact); Sky within 5e-5 * (1 + |ref|) (measured 3.5e-5 and
3.7e-5: the rays are rounded as the reference's frame rounds them,
unfused); AO within 1e-5 and Main within 1e-4 relative (to
max(|ref|, 1e-3)) on >= 99.9% of the pixels more than 16 px from the
border (measured: all of them, on both frames), and on >= 99% of all
pixels (AO measured 99.53% and 99.40%, Main 99.50% and 99.15%: every
miss lies within 16 px of the border, where the reference's compiled
HBAO occludes a few pixels whose taps clamp, test_torch_post.py, and
the ambient follows the AO); Final within 2/255 on every pixel
(measured 2.6e-4).

Also: the port's render of tests/test_golden.py's ``forward_frame`` scene
and config against tests/golden/forward_frame.png at test_golden's own bar
(mean |diff| < 2.5 and p99 < 12 in u8); the port's counterparts of
test_framegraph.py's full-pipeline, debug-compose, incremental
environment and sky-cache tests; stars, DebugDraw and RenderOverlay given
what their full paths need (once refusals: test_torch_stars.py,
test_torch_debug_draw.py and test_torch_overlay.py hold them to the
reference) and RenderTransparent's blend over Main given a transparent
queue.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.core import math3d as jax_m3
from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.kernels import pbr_pallas as j_pk
from sailor_tpu.rhi.types import FrameData as JFrameData
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.framegraph.graph import RenderContext
from sailor_tpu_torch.framegraph.nodes import (DebugDrawNode, EnvironmentNode,
                                               RenderOverlayNode, RenderTransparentNode)
from sailor_tpu_torch.kernels import sky
from sailor_tpu_torch.rhi.scene_view import scene_from_numpy
from sailor_tpu_torch.rhi.types import FrameData
from test_torch_scenes import FULL_CONFIG, jax_scene, scene_arrays, torch_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDERER = os.path.join(REPO, "content", "DefaultRenderer.renderer")
W, H = 256, 128
CONFIG = dict(FULL_CONFIG, shadow_resolution=128)
EXACT = ("Depth", "TriId", "LightIndices", "LightCounts", "ShadowMaps", "HiZCulledCount")
KEYS = EXACT + ("Sky", "AO", "Main", "Final")
#: Width of the border band where the reference's compiled HBAO clamps its
#: taps differently (test_torch_post.py); AO and Main are held tighter inside.
BAND = 16


def _second_frame(js):
    """Frame 2: the camera turned 0.05 rad about y, the previous frame's
    camera kept for MotionBlur, the sun moved."""
    f = js.frame
    cam = f.camera_position
    fwd = jnp.asarray([0.0, 0.5, 0.0]) - cam
    c, s = np.cos(0.05), np.sin(0.05)
    rot = jnp.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], jnp.float32)
    view = jax_m3.look_at(cam, cam + rot @ fwd, jnp.asarray([0.0, 1.0, 0.0]))
    frame = JFrameData.create(view, f.projection, cam, 0.1, 150.0, time=0.1, dt=1 / 60)
    sun = np.asarray([-0.25, -0.75, -0.35], np.float32)
    return js.replace(frame=frame, prev_frame=f,
                      sky=js.sky.replace(sun_direction=sun / np.linalg.norm(sun)))


def _run(fg, scenes):
    state = fg.initial_state()
    out = []
    for scene in scenes:
        fg.prepare(scene, state)
        t, state = fg.process(scene, state)
        frame = {k: np.asarray(t[k]) for k in KEYS}
        frame["sky/key"] = np.asarray(state["sky/key"])
        out.append(frame)
    return out


@pytest.fixture(scope="module")
def frames():
    js = jax_scene(W, H, 24, 10)
    scenes = [js, _second_frame(js)]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        ref = _run(JFrameGraph(JAsset.load(RENDERER), W, H, config=dict(CONFIG)), scenes)
    finally:
        mp.undo()
        jax.clear_caches()
    got = _run(FrameGraph(FrameGraphAsset.load(RENDERER), W, H, dict(CONFIG), device="cpu"),
               [torch_scene(s) for s in scenes])
    return got, ref


def _rel(got, ref):
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)
    return rel.max(-1) if rel.ndim == 3 else rel


@pytest.mark.parametrize("i", [0, 1], ids=["frame1", "frame2"])
def test_full_frame_matches_jax(frames, i):
    got, ref = frames[0][i], frames[1][i]
    assert (ref["TriId"] >= 0).mean() > 0.3 and (ref["TriId"] < 0).mean() > 0.1
    for k in EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["sky/key"][12:], ref["sky/key"][12:])
    assert np.abs(got["sky/key"][:12] - ref["sky/key"][:12]).max() <= 1.0
    assert (np.abs(got["Sky"] - ref["Sky"]) / (1 + np.abs(ref["Sky"]))).max() <= 5e-5
    ao_ok = np.abs(got["AO"] - ref["AO"]) <= 1e-5 * np.maximum(np.abs(ref["AO"]), 1e-3)
    main_ok = _rel(got["Main"], ref["Main"]) <= 1e-4
    inner = (slice(BAND, -BAND), slice(BAND, -BAND))
    assert ao_ok[inner].mean() >= 0.999 and main_ok[inner].mean() >= 0.999
    assert ao_ok.mean() >= 0.99 and main_ok.mean() >= 0.99  # the border band
    assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255


def test_second_frame_moved(frames):
    """Frame 2 re-rendered the sky (turned camera) and blurred by the
    camera's motion: its Main differs from frame 1's beyond the parity
    bars, in both packages alike."""
    got, ref = frames
    for f in (got, ref):
        assert np.abs(f[1]["Sky"] - f[0]["Sky"]).max() > 1e-2
        assert np.abs(f[1]["sky/key"][:12] - f[0]["sky/key"][:12]).max() > 100


def _golden_scene():
    import test_golden

    return test_golden, scene_from_numpy(scene_arrays(test_golden._forward_scene()), "cpu")


def test_forward_frame_golden():
    """The port's render of test_golden's forward_frame within its bar."""
    tg, scene = _golden_scene()
    fg = FrameGraph(FrameGraphAsset.load(RENDERER), tg.W, tg.H, dict(
        z_far=80.0, shadow_resolution=256, env_resolution=16, bin_capacity=256,
        bin_rounds=2, sky_clouds=True, cloud_stride=2), device="cpu")
    state = fg.initial_state()
    fg.prepare(scene, state)
    targets, _ = fg.process(scene, state)
    got = tg._to_u8(targets["Final"].numpy()).astype(np.float32)
    ref = tg.load_png(os.path.join(tg.GOLDEN_DIR, "forward_frame.png")).astype(np.float32)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.mean() < 2.5, diff.mean()
    assert np.percentile(diff, 99) < 12, np.percentile(diff, 99)


# --- counterparts of tests/test_framegraph.py ------------------------------

FW, FH = 128, 96


def _framegraph_scene():
    import test_framegraph

    return scene_from_numpy(scene_arrays(test_framegraph._scene_view()), "cpu")


def test_full_pipeline_runs():
    fg = FrameGraph(FrameGraphAsset.load(RENDERER), FW, FH, {
        "z_far": 100.0, "shadow_resolution": 128, "env_resolution": 16,
        "bin_capacity": 256, "bin_rounds": 2, "sky_clouds": False}, device="cpu")
    scene = _framegraph_scene()
    state = fg.initial_state()
    fg.prepare(scene, state)
    targets, state = fg.process(scene, state)
    final = targets["Final"].numpy()
    assert final.shape == (FH, FW, 3) and np.isfinite(final).all()
    assert final.max() <= 1.0 + 1e-5 and final.min() >= 0.0 and final.std() > 0.02
    assert float(state["avg_luminance"]) > 0.0


def test_debug_compose_modes():
    base = ("frame:\n - name: DepthPrepass\n - name: LinearizeDepth\n"
            " - name: LightCulling\n - name: ShadowPrepass\n"
            " - name: PostProcess\n   shader: HBAO\n"
            " - name: RenderScene\n - name: EyeAdaptation\n"
            " - name: PostProcess\n   shader: Debug\n   mode: {mode}\n")
    scene = _framegraph_scene()
    outs = {}
    for mode in ("none", "ao", "light_tiles", "cascades"):
        fg = FrameGraph(FrameGraphAsset.from_yaml(base.format(mode=mode)), FW, FH, {
            "bin_capacity": 256, "bin_rounds": 2, "shadow_resolution": 128, "z_far": 100.0},
            device="cpu")
        state = fg.initial_state()
        fg.prepare(scene, state)
        targets, _ = fg.process(scene, state)
        outs[mode] = targets["Final"].numpy()
        assert np.isfinite(outs[mode]).all(), mode
    assert np.allclose(outs["ao"][..., 0], outs["ao"][..., 1])
    assert np.abs(outs["ao"] - outs["none"]).max() > 0.01
    assert (outs["light_tiles"][..., 0] - outs["light_tiles"][..., 2]).max() > 0.04
    assert np.abs(outs["cascades"] - outs["none"]).max() > 0.05


def test_env_incremental_face_updates():
    import test_framegraph

    arrays = scene_arrays(test_framegraph._scene_view())
    node = EnvironmentNode({})
    cfg = {"env_resolution": 16, "env_incremental": True}

    def ctx_for(sun):
        s = scene_from_numpy(dict(arrays, **{"sky.sun_direction": _unit(sun)}), "cpu")
        return RenderContext(width=FW, height=FH, scene=s, state={}, config=cfg)

    ctx = ctx_for((-0.4, -0.8, -0.3))
    node.prepare(ctx)
    cube0 = ctx.state["env/cube"].clone()
    irr0 = ctx.state["env/irradiance"].clone()
    for i in range(5):
        ctx = ctx_for((0.6, -0.6, 0.1))
        node.prepare(ctx)
        assert torch.equal(ctx.state["env/irradiance"], irr0)  # mid-sweep: the old bake
        assert torch.equal(ctx.state["env/cube"][i + 1:], cube0[i + 1:])  # one face a call
        if i != 3:  # -Y is all ground, which the sun does not light
            assert not torch.equal(ctx.state["env/cube"][i], cube0[i])
    ctx = ctx_for((0.6, -0.6, 0.1))
    node.prepare(ctx)  # the sixth face completes the sweep: derived maps refresh
    assert float((ctx.state["env/cube"] - cube0).abs().max()) > 1e-3
    assert float((ctx.state["env/irradiance"] - irr0).abs().max()) > 1e-4
    baked = dict(ctx.state)
    ctx = ctx_for((0.6, -0.6, 0.1))
    node.prepare(ctx)  # the key held: the cache, nothing re-rendered
    assert all(ctx.state[k] is v for k, v in baked.items())


def _unit(v):
    v = np.asarray(v, np.float32)
    return (v / np.linalg.norm(v)).astype(np.float32)


def _moved_frame(f, view, time):
    return FrameData.create(view, f.projection, f.camera_position, 0.1, 100.0, time=time,
                            dt=1 / 60)


def test_sky_change_snapshot_cache():
    """A translated camera keeps the cached sky bit for bit (and renders
    nothing); a turned camera re-renders it."""
    from sailor_tpu_torch.kernels import sky as sky_k

    fg = FrameGraph(FrameGraphAsset.from_nodes(["Sky"]), FW, FH, {"sky_clouds": False},
                    device="cpu")
    scene = _framegraph_scene()
    state = fg.initial_state()
    assert state["sky/buf"].shape == (FH, FW, 3) and state["sky/key"].shape == (18,)
    assert bool((state["sky/key"] == np.float32(-1e30)).all())
    t1, s1 = fg.process(scene, state)
    sky1 = s1["sky/buf"]
    assert float(sky1.max()) > 0.0 and torch.equal(t1["Sky"], sky1)

    f = scene.frame
    shift = torch.tensor([0.5, 0.2, -0.3])
    view2 = f.view.clone()
    view2[:3, 3] -= f.view[:3, :3] @ shift
    frame2 = FrameData.create(view2, f.projection, f.camera_position + shift, 0.1, 100.0,
                              time=0.05, dt=1 / 60)
    calls = []
    real = sky_k.sky_radiance
    sky_k.sky_radiance = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        t2, s2 = fg.process(_with_frame(scene, frame2), s1)
    finally:
        sky_k.sky_radiance = real
    assert not calls and torch.equal(t2["Sky"], sky1)

    cam = f.camera_position
    view3 = m3.look_at(cam, cam + torch.tensor([1.0, -0.1, 0.2]), torch.tensor([0.0, 1.0, 0.0]))
    t3, _ = fg.process(_with_frame(scene, _moved_frame(f, view3, 0.1)), s2)
    assert float((t3["Sky"] - sky1).abs().max()) > 0.0


def _with_frame(scene, frame):
    import dataclasses

    return dataclasses.replace(scene, frame=frame, prev_frame=frame)


def test_sky_cache_key_matches_reference():
    """The port's cache key of the flagship frame equals the reference's."""
    js = jax_scene(W, H, 4, 2)
    jfg = JFrameGraph(JAsset.from_yaml("frame:\n - name: Sky\n"), W, H, config={})
    _, jstate = jfg.process(js, jfg.initial_state())
    fg = FrameGraph(FrameGraphAsset.from_nodes(["Sky"]), W, H, {}, device="cpu")
    _, state = fg.process(torch_scene(js), fg.initial_state())
    want, got = np.asarray(jstate["sky/key"]), state["sky/key"].numpy()
    np.testing.assert_array_equal(got[12:], want[12:])
    assert np.abs(got[:12] - want[:12]).max() <= 1.0


# --- refusals --------------------------------------------------------------


def test_stars_raise():
    """Once the refusal of stars; now they draw: under a night sun the sky
    toward each catalogue star above the horizon brightens, under the
    default (day) sun it is the starless sky."""
    from sailor_tpu_torch.assets import stars

    sd, sc = (torch.from_numpy(a) for a in stars.procedural(256, seed=0))
    d = sd[sd[:, 1] > 0.1]
    for sun, lit in (((-0.35, 0.7, -0.3), True), (None, False)):
        p = sky.SkyParams.default() if sun is None else sky.SkyParams.default(sun_direction=sun)
        with_stars = sky.sky_radiance(d, p, star_dirs=sd, star_colors=sc, with_stars=True)
        without = sky.sky_radiance(d, p)
        if lit:
            assert len(d) > 50 and bool((with_stars > without).all(-1).all())
        else:
            assert torch.equal(with_stars, without)


@pytest.mark.parametrize("node", ["RenderTransparent", "DebugDraw", "RenderOverlay"])
def test_pass_through_node_refuses_full_path(node):
    """With nothing to draw each node passes Main through. Their full paths
    were once refused; now each draws: RenderTransparent, given a
    transparent queue, blends over Main (test_torch_frame_queues.py holds
    it to the reference), DebugDraw splats a line across the view into
    Main, and RenderOverlay blends an opaque 8x8 canvas into Final's
    top-left corner and nothing else."""
    scene = _framegraph_scene()
    main = torch.rand(FH, FW, 3)
    targets = {"Main": main, "Final": main.clone()}
    ctx = RenderContext(width=FW, height=FH, scene=scene, state={}, config={})
    cls = {"RenderTransparent": RenderTransparentNode, "DebugDraw": DebugDrawNode,
           "RenderOverlay": RenderOverlayNode}[node]
    out = cls({}).process(ctx, dict(targets))  # nothing to draw: pass through
    assert out["Main"] is main
    if node == "RenderTransparent":
        from sailor_tpu_torch.scenes import flagship_queue_scene

        ctx.scene = flagship_queue_scene(FW, FH, 4, 6, device="cpu")[0]
        lin = torch.zeros(FH, FW)
        t = 16  # the light tiles: every light in every tile
        idx = torch.arange(5, dtype=torch.int32).repeat(FH // t, FW // t, 1)
        out = cls({}).process(ctx, dict(targets, Depth=lin, LightIndices=idx))
        assert out["Main"] is not main and not torch.equal(out["Main"], main)
        return
    if node == "DebugDraw":
        from sailor_tpu_torch.rhi.debug_context import DebugContext

        # a line across the view: two NDC points at mid depth, unprojected
        inv = m3.inverse(scene.frame.view_projection)
        ends = [m3.homogenize(inv @ torch.tensor([x, 0.0, 0.5, 1.0])) for x in (-0.8, 0.8)]
        dbg = DebugContext()
        dbg.draw_line(ends[0].numpy(), ends[1].numpy(), (1.0, 0.0, 1.0))
        ctx.config = {"debug_context": dbg}
        out = cls({}).process(ctx, dict(targets))
        drawn = (out["Main"] == torch.tensor([1.0, 0.0, 1.0])).all(-1)
        assert int(drawn.sum()) > FW // 4 and torch.equal(out["Main"][~drawn], main[~drawn])
        return
    canvas = torch.rand(8, 8, 4)
    canvas[..., 3] = 1.0
    ctx.state = {"overlay/canvas": canvas}
    out = cls({}).process(ctx, dict(targets))
    assert torch.equal(out["Final"][:8, :8], canvas[..., :3])
    rest = torch.ones(FH, FW, dtype=torch.bool)
    rest[:8, :8] = False
    assert torch.equal(out["Final"][rest], targets["Final"][rest])
