"""The port's debug drawing against the JAX package's, on the CPU, and the
engine's night frame with the HUD and debug lines on Editor.world.

- ``DebugContext``: every ``draw_*`` gives the reference's lines (points,
  colours, lifetimes bit-equal); ``tick`` expires and counts down as the
  reference's over a sequence of ticks; ``rasterize_over`` (64 samples a
  line) equals the reference's image exactly, run op by op and compiled,
  with crossing lines (the later sample wins a shared pixel), lines that
  leave the frustum or pass behind the camera (their hidden samples write
  a border pixel's own colour back, so they can erase an earlier line's
  pixel there), on 200 random lines and on an empty context;
- the reference's tests/test_engine_aux.py::test_debug_context_draw_and_expire
  on the port;
- ``EngineLoop.run(2)`` over content/Editor.world at 128x96 through all of
  DefaultRenderer.renderer (tests/test_world.py:96-100's config with
  ``tonemap: "uncharted2"``), at night (sun (-0.35, 0.7, -0.3)) with
  ``stars.procedural(4096)``, an ``OverlayContext(96, 48)`` HUD drawn from
  one fixed stats dict (``last_frame_ms`` is a wall-clock time) and debug
  lines (a box on each solid mesh, an origin, two crossing lines, one that
  leaves the view), in both packages: Depth, TriId and LightIndices exact;
  the pixels DebugDraw writes, and their colours, exact; Sky within
  5e-5 * (1 + |ref|) + 2e-3 * |star term| (test_torch_stars.py), the
  stars lighting >= 500 of its pixels; Main as test_torch_world.py's
  check_frame holds it, a pixel also passing within
  1e-4 * max(|ref|, 1e-3) + 2e-3 * (the star term's largest channel within
  2 px: motion blur and the half-resolution sky carry a star's error to
  its neighbours); Final within 2/255.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sailor_tpu.core import math3d as jax_m3
from sailor_tpu.engine import World as JWorld
from sailor_tpu.engine import overlay as jax_overlay
from sailor_tpu.engine.app import EngineLoop as JEngineLoop
from sailor_tpu.engine.app import Renderer as JRenderer
from sailor_tpu.framegraph import nodes as jax_nodes
from sailor_tpu.kernels.sky import SkyParams as JSkyParams
from sailor_tpu.rhi.debug_context import DebugContext as JDebugContext
from sailor_tpu_torch.assets import stars
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.engine import World
from sailor_tpu_torch.engine import overlay
from sailor_tpu_torch.engine.app import EngineLoop, Renderer
from sailor_tpu_torch.framegraph import nodes
from sailor_tpu_torch.kernels.sky import SkyParams
from sailor_tpu_torch.rhi.debug_context import DebugContext
from sailor_tpu_torch.scenes import mesh_boxes
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)
from test_torch_stars import NIGHT_SUN, STAR_REL, star_bar
from test_torch_world import BAND, EDITOR_WORLD, EXACT, RENDERER, TEST_CONFIG

NIGHT_CONFIG = dict(TEST_CONFIG, tonemap="uncharted2")
HUD_STATS = {"last_frame_ms": 16.6, "gpu_frames": 7, "triangles": 2074,
             "node_ms": {"Sky": 3.25, "RenderScene": 5.5, "Bloom": 1.0}}
HUD_SIZE = (96, 48)


def assert_same_lines(got, want):
    assert len(got._lines) == len(want._lines) > 0
    for g, w in zip(got._lines, want._lines):
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]


def _both(fn):
    got, want = DebugContext(), JDebugContext()
    fn(got)
    fn(want)
    return got, want


def _inv_vp():
    view = jax_m3.look_at(jnp.asarray([2.0, 1.5, 4.0]), jnp.asarray([0.0, 0.5, 0.0]),
                          jnp.asarray([0.0, 1.0, 0.0]))
    return np.linalg.inv(np.asarray(jax_m3.perspective(1.0, 1.5, 0.5, 20.0) @ view))


@pytest.mark.parametrize("what", ["line", "aabb", "sphere", "frustum", "origin"])
def test_draw_calls_match_reference(what):
    calls = {
        "line": lambda c: (c.draw_line([0, 0, -5], [1, 2, -5]),
                           c.draw_line((1.5, 0.1, 2), (3, 1, -1), (0.2, 0.4, 0.6), 0.25)),
        "aabb": lambda c: c.draw_aabb([-1, -1, -6], [1, 1.5, -4], duration=2.0),
        "sphere": lambda c: (c.draw_sphere([0.5, 1, -3], 0.75),
                             c.draw_sphere((0, 0, 0), 2.0, segments=7, duration=1.0)),
        "frustum": lambda c: c.draw_frustum(_inv_vp(), duration=0.5),
        "origin": lambda c: c.draw_origin((1, 2, 3), size=0.5, duration=3.0),
    }
    assert_same_lines(*_both(calls[what]))


def test_tick_expires_as_reference():
    def draw(c):
        for i, ttl in enumerate((0.0, 0.1, 0.5, 1.0, 1 / 60, 2 / 60, 5.0)):
            c.draw_line([i, 0, 0], [i, 1, 0], duration=ttl)

    got, want = _both(draw)
    for dt in (1 / 60, 1 / 60, 0.1, 0.5, 0.0, 2.0, 1e10):
        got.tick(dt)
        want.tick(dt)
        assert [e[3] for e in got._lines] == [e[3] for e in want._lines]
        if got._lines:
            assert_same_lines(got, want)
    got.clear()
    assert not got.has_lines


def _view_projection(eye=(0.3, 1.0, 4.0), target=(0.0, 0.0, -1.0), aspect=1.5):
    view = jax_m3.look_at(jnp.asarray(eye), jnp.asarray(target), jnp.asarray([0.0, 1.0, 0.0]))
    return np.array(jax_m3.perspective(1.0, aspect, 0.1, 50.0) @ view)


def _random_lines(c, n=200, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        c.draw_line(rng.normal(size=3) * 3, rng.normal(size=3) * 3, rng.random(3))


def _crossing_and_clipped(c):
    # two lines crossing at the origin, the second drawn last
    c.draw_line([-2, 0, 0], [2, 0, 0], (1, 0, 0))
    c.draw_line([0, -2, 0], [0, 2, 0], (0, 0, 1))
    c.draw_line([-1.5, -1, 0], [1.5, 1, 0], (0, 1, 1))
    # leaves the frustum sideways, and passes behind the camera
    c.draw_line([0, 0.2, 0], [40, 0.2, 0], (1, 1, 0))
    c.draw_line([0.1, 0.9, 2], [0.3, 1.0, 8], (1, 0, 1))
    c.draw_line([-3, 0, 3], [3, 0, -30], (0.5, 1, 0.5))
    c.draw_aabb([-1, -1, -2], [1, 1, 0])
    c.draw_origin()


@pytest.mark.parametrize("lines", ["random", "crossing_clipped", "none"])
def test_rasterize_over_matches_reference(lines):
    fill = {"random": _random_lines, "crossing_clipped": _crossing_and_clipped,
            "none": lambda c: None}[lines]
    got_ctx, want_ctx = _both(fill)
    h, w = 96, 144
    img = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    vp = _view_projection()
    eager = np.asarray(want_ctx.rasterize_over(jnp.asarray(img), jnp.asarray(vp)))
    compiled = np.asarray(jax.jit(want_ctx.rasterize_over)(jnp.asarray(img), jnp.asarray(vp)))
    got = got_ctx.rasterize_over(torch.from_numpy(img), torch.from_numpy(vp)).numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(got, compiled)
    written = (got != img).any(-1).sum()
    assert written == 0 if lines == "none" else written > 300
    if lines == "crossing_clipped":  # the vertical line, drawn later, holds the crossing
        x = np.flatnonzero((got == [0, 0, 1]).all(-1).any(0))
        y = np.flatnonzero((got == [1, 0, 0]).all(-1).any(1))
        assert len(x) and len(y)
    # drawing again reuses the uploaded rows and gives the same image
    np.testing.assert_array_equal(
        got_ctx.rasterize_over(torch.from_numpy(img), torch.from_numpy(vp)).numpy(), got)


def test_debug_context_draw_and_expire():
    """tests/test_engine_aux.py's test on the port."""
    dbg = DebugContext()
    dbg.draw_line([0, 0, -5], [1, 0, -5], duration=0.1)
    dbg.draw_aabb([-1, -1, -6], [1, 1, -4], duration=0.0)
    dbg.draw_origin(duration=1.0)
    assert dbg.has_lines
    view = m3.look_at(torch.tensor([0.0, 0.0, 0.0]), torch.tensor([0.0, 0.0, -1.0]),
                      torch.tensor([0.0, 1.0, 0.0]))
    proj = m3.perspective(np.pi / 2, 1.0, 0.1, 100.0)
    out = dbg.rasterize_over(torch.zeros(64, 64, 3), proj @ view)
    assert out.sum() > 0  # pixels were written
    n0 = len(dbg._lines)
    dbg.tick(0.5)  # expire the 0.0 s lines; keep the others
    assert len(dbg._lines) < n0


# -- the engine's night frame, both packages ---------------------------------------


def night_lines(doc, dbg):
    """Debug lines for a night loop: a box on each solid mesh object, an
    origin, two crossing lines and one that leaves the view."""
    for lo, hi in mesh_boxes(doc):
        dbg.draw_aabb(lo, hi)
    dbg.draw_origin((0, 0.05, 0), 2.0)
    dbg.draw_line([-3, 0.5, -3], [3, 0.5, 3], (1, 0, 1))
    dbg.draw_line([-3, 0.5, 3], [3, 0.5, -3], (0, 1, 1))
    dbg.draw_line([0, 1, 0], [300, 1, 20], (1, 0.5, 0))


def _capture_debug_draw(monkeypatch, cls, record):
    """Wrap DebugDraw's process: record (Main before, Main after)."""
    inner = cls.process

    def process(self, ctx, targets):
        before = targets["Main"]
        t = inner(self, ctx, targets)
        record(before, t["Main"])
        return t

    monkeypatch.setattr(cls, "process", process)


def run_night_both(doc, width, height, monkeypatch, frames=2):
    """EngineLoop.run(frames) at night with stars, the HUD and debug lines
    in both packages, the port on the CPU. Returns (port targets,
    reference targets, the port's star term on the Sky shown, the (before,
    after) Main of DebugDraw in each package)."""
    sd, sc = stars.procedural(4096, seed=0)
    for mod in (overlay, jax_overlay):  # one fixed stats dict for the HUD
        monkeypatch.setattr(mod, "stats_hud", lambda ov, s, console_lines=(), _f=mod.stats_hud:
                            _f(ov, HUD_STATS))
    dd = {"port": [], "ref": []}
    _capture_debug_draw(monkeypatch, nodes.DebugDrawNode,
                        lambda b, a: dd["port"].append((b.numpy(), a.numpy())))

    def ref_capture(b, a):
        jax.debug.callback(lambda x, y: dd["ref"].append((np.asarray(x), np.asarray(y))), b, a)

    _capture_debug_draw(monkeypatch, jax_nodes.DebugDrawNode, ref_capture)

    dbg = DebugContext()
    night_lines(doc, dbg)
    w = World.deserialize(doc, device="cpu")
    r = Renderer(RENDERER, width, height, config=dict(NIGHT_CONFIG, debug_context=dbg),
                 device="cpu")
    scenes = []
    push = r.push_frame
    monkeypatch.setattr(r, "push_frame", lambda s: (scenes.append(s), push(s))[1])
    loop = EngineLoop(w, r, sky=SkyParams.default(sun_direction=NIGHT_SUN), stars=(sd, sc),
                      overlay=overlay.OverlayContext(*HUD_SIZE))
    got = loop.run(frames)

    jdbg = JDebugContext()
    for a, b, c, ttl in dbg._lines:
        jdbg.draw_line(a, b, c, ttl)
    jw = JWorld.deserialize(doc)
    jr = JRenderer(RENDERER, width, height, config=dict(NIGHT_CONFIG, debug_context=jdbg))
    ref = JEngineLoop(jw, jr, sky=JSkyParams.default(sun_direction=NIGHT_SUN), stars=(sd, sc),
                      overlay=jax_overlay.OverlayContext(*HUD_SIZE)).run(frames)
    assert r.stats["gpu_frames"] == jr.stats["gpu_frames"] == frames
    assert len(dd["port"]) == len(dd["ref"]) == frames
    # the star term of the Sky on show: the frame whose render it is
    node, term = nodes.SkyNode({}), None
    for s in scenes:
        ctx = r.frame_graph._ctx(s, {})
        lit = node.process(ctx, {})["Sky"]
        if torch.equal(lit, got["Sky"]):
            dark = node.process(r.frame_graph._ctx(
                dataclasses.replace(s, star_dirs=None, star_colors=None), {}), {})["Sky"]
            term = (lit - dark).numpy()
    assert term is not None, "no frame's Sky render is the one shown"
    return ({k: v.numpy() for k, v in got.items() if torch.is_tensor(v)},
            {k: np.asarray(ref[k]) for k in got if torch.is_tensor(got[k])}, term, dd)


def check_night_frame(got, ref, term, dd, main_all=0.98, lit_sky=500):
    for k in EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (np.abs(term).max(-1) > 1e-6).sum() >= lit_sky
    assert np.all(np.abs(got["Sky"] - ref["Sky"]) <= star_bar(ref["Sky"], term))
    near = torch.nn.functional.max_pool2d(
        torch.from_numpy(np.abs(term).max(-1))[None, None], 5, 1, 2)[0, 0].numpy()[..., None]
    err = np.abs(got["Main"] - ref["Main"])
    scale = np.maximum(np.abs(ref["Main"]), 1e-3)
    ok = ((err / scale <= 1e-4) | (err <= 1e-4 * scale + STAR_REL * near)).all(-1)
    assert ok[BAND:-BAND, BAND:-BAND].mean() >= 0.999 and ok.mean() >= main_all
    for (pb, pa), (rb, ra) in zip(dd["port"], dd["ref"]):
        wrote = (pa != pb).any(-1)
        assert wrote.sum() > 20
        np.testing.assert_array_equal(wrote, (ra != rb).any(-1))
        np.testing.assert_array_equal(pa[wrote], ra[wrote])
    assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255
    assert got["Final"].std() > 0.01


def test_editor_world_night_loop_matches_jax(monkeypatch):
    with open(EDITOR_WORLD) as f:
        doc = yaml.safe_load(f)
    got, ref, term, dd = run_night_both(doc, 128, 96, monkeypatch)
    assert got["Final"].shape == (96, 128, 3)
    check_night_frame(got, ref, term, dd)
