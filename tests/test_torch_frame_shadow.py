"""The shadowed, HiZ-culled Forward+ frame end to end: DepthPrepass (HiZ
cull) -> LinearizeDepth -> LightCulling -> ShadowPrepass (four cascades,
EVSM) -> DepthHighZ -> RenderScene (EVSM shadow factor) -> EyeAdaptation,
through the JAX package's FrameGraph and the port's, on the flagship scene
at 256x128 (24 point lights, 10 objects, the bench's sun) with
``shadow_resolution`` 128 and the frame's config otherwise
(``SHADOW_HIZ_CONFIG``), two frames with the state threaded through: frame
1 renders the cascades (dirty), frame 2 takes them from the CSM cache and
culls against frame 1's pyramid.

The reference's shade kernel gets exact division for its approximate
reciprocal (see test_torch_shade.py). Tolerances: ShadowMaps,
LightMatrices, Depth, TriId, LightIndices, LightCounts and HiZCulledCount
exact; EvsmMaps within 1e-5 relative; Main within 1e-4 relative (to
max(|ref|, 1e-3)) on >= 99.5% of pixels; Final within 2/255 on every
pixel. The dense raster configuration (the cascades through B9, their
setup rounded as a standalone unit's) is held to the same bars on one
frame.
"""

import jax
import numpy as np
import pytest

from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.kernels import pbr_pallas as j_pk
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.raster import setup as t_setup
from test_torch_scenes import (SHADOW_HIZ_CONFIG, SHADOW_HIZ_GRAPH, SHADOW_HIZ_VALUES,
                               jax_scene, torch_scene)
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 256, 128
CONFIG = dict(SHADOW_HIZ_CONFIG, shadow_resolution=128)
EXACT = ("ShadowMaps", "LightMatrices", "Depth", "TriId", "LightIndices", "LightCounts",
         "HiZCulledCount")
KEYS = EXACT + ("EvsmMaps", "Main", "Final")


def _frames(fg, scene, n=2):
    state = fg.initial_state()
    out = []
    for _ in range(n):
        t, state = fg.process(scene, state)
        out.append({k: np.asarray(t[k]) for k in KEYS})
    return out


def _reference(js, config, n):
    yaml_text = ("float:\n" + "".join(f"  {k}: {v}\n" for k, v in SHADOW_HIZ_VALUES.items())
                 + "frame:\n" + "".join(f" - name: {n}\n" for n in SHADOW_HIZ_GRAPH))
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        return _frames(JFrameGraph(JAsset.from_yaml(yaml_text), W, H, config=dict(config)),
                       js, n)
    finally:
        mp.undo()
        jax.clear_caches()


def _port(js, config, n):
    fg = FrameGraph(FrameGraphAsset.from_nodes(SHADOW_HIZ_GRAPH, SHADOW_HIZ_VALUES), W, H,
                    dict(config), device="cpu")
    return _frames(fg, torch_scene(js), n)


@pytest.fixture(scope="module")
def reference():
    js = jax_scene(W, H, 24, 10)
    return js, _reference(js, CONFIG, 2)


def _assert_frame(got, ref):
    assert (ref["TriId"] >= 0).mean() > 0.3
    assert (ref["ShadowMaps"] > 0).mean() > 0.1
    for k in EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    ev = np.abs(got["EvsmMaps"] - ref["EvsmMaps"]) / np.abs(ref["EvsmMaps"])
    assert ev.max() <= 1e-5, ev.max()
    rel = (np.abs(got["Main"] - ref["Main"]) / np.maximum(np.abs(ref["Main"]), 1e-3)).max(-1)
    assert (rel <= 1e-4).mean() >= 0.995
    assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255


def test_shadow_frame_matches_jax(reference):
    js, ref_frames = reference
    for got, ref in zip(_port(js, CONFIG, 2), ref_frames):
        _assert_frame(got, ref)


def test_shadow_cache_skips_the_cascades(reference, monkeypatch):
    """With the CSM cache the static frame 2 rasters no cascade and reuses
    frame 1's maps; without it every frame rasters all four, to the same
    maps."""
    js = reference[0]
    setups = []
    real = t_setup.triangle_setup

    def counting(*args, **kw):
        setups.append(kw.get("clip", True))
        return real(*args, **kw)

    monkeypatch.setattr(t_setup, "triangle_setup", counting)
    cached = _port(js, CONFIG, 2)
    assert setups.count(False) == 4  # the cascades of frame 1 only
    setups.clear()
    uncached = _port(js, dict(CONFIG, csm_cache=False), 2)
    assert setups.count(False) == 8
    for a, b in zip(cached, uncached):
        for k in ("ShadowMaps", "EvsmMaps", "Main"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", ["dense"])
def test_shadow_frame_raster_config_matches_jax(reference, mode):
    js = reference[0]
    config = dict(CONFIG, raster_mode=mode)
    _assert_frame(_port(js, config, 1)[0], _reference(js, config, 1)[0])
