"""The port's overlay (the HUD canvas) against the JAX package's, on the
CPU, and the engine's night frame on the flagship world.

- ``OverlayContext`` draws without Pillow: its canvas equals the
  reference's (Pillow's ImageDraw on an RGBA image, Aileron at size 10)
  byte for byte after 300 random calls on random canvases: text (clipped at
  the edges, over transparent and opaque pixels, with newlines), one-pixel
  lines (clipped), rectangles with and without an outline, progress bars,
  and ``canvas()`` at scale 1 and 2 (float32 equal);
- ``stats_hud`` with and without node timings and console lines: canvases
  equal; a progress bar at 0 and text outside printable ASCII raise, as
  noted there; the font atlas holds the 95 printable ASCII glyphs;
- the reference's tests/test_overlay.py on the port: the canvas has text
  and is mostly transparent; RenderOverlay blends it over Final in the
  minimal graph's top-left corner only;
- RenderOverlay's placement against the reference's node on the same Final
  and canvas: exact at (0, 0), inside, clamped at the edges (the
  reference's ``dynamic_update_slice``), with a canvas larger than Final,
  and raising where the reference's shapes fail;
- ``EngineLoop.run(2)`` over ``flagship_world_doc(40, 8)`` at 128x96 at
  night with stars, the HUD and debug lines (test_torch_debug_draw.py's
  ``run_night_both`` and bars).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.engine import overlay as jax_overlay
from sailor_tpu.framegraph.graph import RenderContext as JRenderContext
from sailor_tpu.framegraph.nodes import RenderOverlayNode as JRenderOverlayNode
from sailor_tpu_torch.engine import overlay
from sailor_tpu_torch.engine.overlay import OverlayContext, stats_hud
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.framegraph.graph import RenderContext
from sailor_tpu_torch.framegraph.nodes import RenderOverlayNode
from sailor_tpu_torch.scenes import flagship_scene, flagship_world_doc
from test_torch_debug_draw import check_night_frame, run_night_both
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

CHARS = [chr(c) for c in range(32, 127)]


def _pair(w, h, scale=1):
    return OverlayContext(w, h, scale), jax_overlay.OverlayContext(w, h, scale)


def _set(ctxs, img):
    from PIL import Image, ImageDraw

    ctxs[0]._img = img.copy()
    ctxs[1]._img = Image.fromarray(img.copy(), "RGBA")
    ctxs[1]._draw = ImageDraw.Draw(ctxs[1]._img)


def _random_call(rng, w, h):
    kind = rng.integers(5)
    col = tuple(int(v) for v in rng.integers(0, 256, 4))
    if kind == 0:
        s = "".join(rng.choice(CHARS, rng.integers(1, 40)))
        if rng.random() < 0.2:
            s = s[:8] + "\n" + s[8:]
        return "text", (int(rng.integers(-20, w)), int(rng.integers(-10, h)), s), {"color": col}
    if kind == 1:
        return "line", tuple(int(v) for v in rng.integers(-10, w + 10, 4)), {"color": col}
    if kind == 2:
        out = tuple(int(v) for v in rng.integers(0, 256, 4)) if rng.random() < 0.5 else None
        return "rect", (int(rng.integers(-10, w)), int(rng.integers(-10, h)),
                        int(rng.integers(1, 60)), int(rng.integers(1, 40))), {
            "fill": col, "outline": out}
    if kind == 3:
        return "progress_bar", (int(rng.integers(-5, w)), int(rng.integers(-5, h)),
                                int(rng.integers(8, 80)), int(rng.integers(3, 12)),
                                float(rng.uniform(0.05, 1.2))), {"color": col}
    return "rect", (int(rng.integers(0, w)), int(rng.integers(0, h)), 1, 1), {"fill": col}


@pytest.mark.parametrize("scale", [1, 2])
def test_canvas_matches_pillow(scale):
    w, h = 160, 90
    rng = np.random.default_rng(scale)
    ctxs = _pair(w, h, scale)
    for i in range(150):
        if i % 10 == 0:
            base = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
            base[rng.random((h, w)) < 0.4, 3] = 0
            _set(ctxs, base)
        name, args, kw = _random_call(rng, w, h)
        for c in ctxs:
            getattr(c, name)(*args, **kw)
        np.testing.assert_array_equal(ctxs[0]._img, np.asarray(ctxs[1]._img), err_msg=name)
    got, want = ctxs[0].canvas(), ctxs[1].canvas()
    assert got.dtype == want.dtype == np.float32 and got.shape == (h * scale, w * scale, 4)
    np.testing.assert_array_equal(got, want)
    for c in ctxs:
        c.new_frame()
    np.testing.assert_array_equal(ctxs[0].canvas(), ctxs[1].canvas())


@pytest.mark.parametrize("stats,console", [
    ({"last_frame_ms": 16.6, "gpu_frames": 7}, ()),
    ({"last_frame_ms": 0.0, "gpu_frames": 123456, "triangles": 49730,
      "node_ms": {f"Node{i}WithAVeryLongName": 0.37 * i for i in range(11)}},
     ("> profile", "RenderScene 17.99 ms", "x" * 45)),
], ids=["fps", "timings_console"])
def test_stats_hud_matches_reference(stats, console):
    ctxs = _pair(384, 192)
    stats_hud(ctxs[0], stats, console)
    jax_overlay.stats_hud(ctxs[1], stats, console)
    np.testing.assert_array_equal(ctxs[0].canvas(), ctxs[1].canvas())
    assert (ctxs[0].canvas()[..., 3] > 0).sum() > 1000


def test_refusals():
    ctxs = _pair(64, 32)
    for c in ctxs:  # a bar at 0 is a rectangle 0 wide: Pillow raises
        with pytest.raises(ValueError):
            c.progress_bar(2, 2, 40, 8, 0.0)
    with pytest.raises(ValueError, match="glyph"):
        ctxs[0].text(0, 0, "16 µs")
    with pytest.raises(NotImplementedError):
        ctxs[0].line(0, 0, 10, 10, width=3)
    glyphs, line_height = overlay._font()
    assert sorted(glyphs) == CHARS and line_height == 10


# -- tests/test_overlay.py on the port -----------------------------------------


def test_overlay_canvas_text_and_rect():
    ov = OverlayContext(128, 64)
    ov.new_frame()
    ov.rect(0, 0, 60, 20, fill=(0, 0, 0, 128))
    ov.text(4, 4, "60.0 FPS")
    c = ov.canvas()
    assert c.shape == (64, 128, 4)
    assert c[..., 3].max() > 0.4          # something drawn
    assert (c[..., 3] > 0).mean() < 0.3   # mostly transparent


def test_overlay_composites_over_final():
    graph = ["DepthPrepass", "LinearizeDepth", "LightCulling", "RenderScene", "EyeAdaptation",
             "RenderOverlay"]
    config = {"bin_capacity": 256, "bin_rounds": 2}
    fg = FrameGraph(FrameGraphAsset.from_nodes(graph), 128, 96, config, device="cpu")
    scene = flagship_scene(128, 96, 8, 4, device="cpu")
    state = fg.initial_state()
    base, _ = fg.process(scene, state)   # no canvas: no-op
    ov = OverlayContext(96, 48)
    stats_hud(ov, {"last_frame_ms": 16.6, "gpu_frames": 7})
    hud, _ = fg.process(scene, dict(state, **{"overlay/canvas": torch.from_numpy(ov.canvas())}))
    changed = (hud["Final"] - base["Final"]).abs().sum(-1) > 1e-4
    # the HUD changes the top-left canvas region only, and does change it
    assert changed[:48, :96].sum() > 100
    assert changed[48:, :].sum() == 0 and changed[:, 96:].sum() == 0


@pytest.mark.parametrize("xy,canvas_hw", [
    ((0, 0), (48, 96)), ((10, 7), (48, 96)), ((100, 60), (48, 96)), ((-12, -5), (30, 40)),
    ((0, 0), (120, 200)), ((3, 95), (48, 96)), ((127, 2), (20, 1)), ((200, 0), (40, 96)),
], ids=lambda v: str(v))
def test_render_overlay_placement_matches_reference(xy, canvas_hw):
    rng = np.random.default_rng(sum(xy) + canvas_hw[0])
    final = rng.random((96, 128, 3)).astype(np.float32)
    canvas = rng.random(canvas_hw + (4,)).astype(np.float32)
    params = {"x": xy[0], "y": xy[1]}
    try:
        want = JRenderOverlayNode(params).process(
            JRenderContext(width=128, height=96, state={"overlay/canvas": jnp.asarray(canvas)}),
            {"Final": jnp.asarray(final)})["Final"]
    except (TypeError, ValueError) as e:  # the reference's shapes do not broadcast
        with pytest.raises(RuntimeError):
            RenderOverlayNode(params).process(
                RenderContext(width=128, height=96, state={"overlay/canvas": torch.from_numpy(
                    canvas)}), {"Final": torch.from_numpy(final)})
        assert "shapes" in str(e) or "broadcast" in str(e)
        return
    got = RenderOverlayNode(params).process(
        RenderContext(width=128, height=96, state={"overlay/canvas": torch.from_numpy(canvas)}),
        {"Final": torch.from_numpy(final)})["Final"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flagship_world_night_loop_matches_jax(monkeypatch):
    got, ref, term, dd = run_night_both(flagship_world_doc(40, 8, aspect=128 / 96), 128, 96,
                                        monkeypatch)
    check_night_frame(got, ref, term, dd)
