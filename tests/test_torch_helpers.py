"""Public helpers the port had left out, each against the JAX package's on
seeded inputs, and the port's tools/time_hiz.py scene against the
reference tool's:

- ``math3d.refract`` (with total internal reflection), ``lerp``,
  ``saturate``, ``transform_vector``, ``srgb_to_linear`` and
  ``luminance``: within 2e-6 relative (float32 math in two frameworks;
  saturate and lerp exact);
- ``setup.transform_vertices`` with one model matrix and with a batch of
  instances: within 1e-5 relative; ``setup.bin_triangles`` exact (bins,
  counts, overflow) over random AABBs with a slot offset and overflow;
- ``primitives.cylinder`` and ``quad`` exact;
- ``scenes.content_instances_scene`` (profile_frame's ``--content``)
  against bench.py's ``_build_content_scene`` on a GLB written here:
  geometry, lights and material rows exact, textures within 1e-6;
- ``tools/time_hiz.py``'s scene at a small TH_* size: the reference
  tool's own scene (captured where it reaches its frame graph) and
  ``time_hiz.occlusion_heavy_scene`` hold the same geometry, lights and
  sky exactly (the camera within 1e-6), and both packages' HiZ graphs
  cull the same number of triangles on frame 2 on the CPU.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets import primitives as j_prim
from sailor_tpu.core import math3d as j_m3
from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.raster import setup as j_setup
from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.raster import setup
from sailor_tpu_torch.tools import time_hiz
from test_hiz_culling import _GRAPH
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)
from test_torch_scenes import scene_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(20)


def _vecs(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _close(got, want, rtol=2e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_refract_matches_jax():
    i = _vecs(500, 3)
    i /= np.linalg.norm(i, axis=-1, keepdims=True)
    n = _vecs(500, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    for eta in (0.66, 1.0, 1.5):  # 1.5 reflects a part totally
        want = np.asarray(j_m3.refract(jnp.asarray(i), jnp.asarray(n), eta))
        got = m3.refract(torch.from_numpy(i), torch.from_numpy(n), eta).numpy()
        _close(got, want, rtol=2e-6, atol=2e-6)
        if eta == 1.5:
            assert (np.abs(want).sum(-1) == 0).any()


def test_lerp_saturate_match_jax():
    a, b, t = _vecs(64, 3), _vecs(64, 3), _vecs(64, 1)
    np.testing.assert_array_equal(
        m3.lerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t)).numpy(),
        np.asarray(j_m3.lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))))
    x = _vecs(256) * 2
    np.testing.assert_array_equal(m3.saturate(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_m3.saturate(jnp.asarray(x))))


def test_transform_vector_srgb_luminance_match_jax():
    m = _vecs(4, 4)
    v = _vecs(100, 3)
    _close(m3.transform_vector(torch.from_numpy(m), torch.from_numpy(v)).numpy(),
           j_m3.transform_vector(jnp.asarray(m), jnp.asarray(v)), rtol=2e-6, atol=1e-6)
    c = RNG.uniform(-0.2, 1.2, (300, 3)).astype(np.float32)
    _close(m3.srgb_to_linear(torch.from_numpy(c)).numpy(), j_m3.srgb_to_linear(jnp.asarray(c)))
    _close(m3.luminance(torch.from_numpy(c)).numpy(), j_m3.luminance(jnp.asarray(c)))


@pytest.mark.parametrize("instances", [0, 3], ids=["single", "batched"])
def test_transform_vertices_matches_jax(instances):
    pos, nrm = _vecs(50, 3), _vecs(50, 3)
    model = _vecs(instances, 4, 4) if instances else _vecs(4, 4)
    vp = _vecs(4, 4)
    want = j_setup.transform_vertices(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(model),
                                      jnp.asarray(vp))
    got = setup.transform_vertices(torch.from_numpy(pos), torch.from_numpy(nrm),
                                   torch.from_numpy(model), torch.from_numpy(vp))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("capacity,slot_offset", [(16, 0), (8, 8), (64, 0)])
def test_bin_triangles_matches_jax(capacity, slot_offset):
    t, tiles_x, tiles_y, tw, th = 400, 6, 4, 16, 16
    x0 = RNG.uniform(-20, tiles_x * tw + 10, t).astype(np.float32)
    y0 = RNG.uniform(-20, tiles_y * th + 10, t).astype(np.float32)
    aabb = (x0, x0 + RNG.uniform(0, 40, t).astype(np.float32),
            y0, y0 + RNG.uniform(0, 40, t).astype(np.float32))
    valid = RNG.random(t) < 0.8
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tw, tile_h=th, capacity=capacity,
              slot_offset=slot_offset)
    want = j_setup.bin_triangles(jnp.asarray(valid), tuple(jnp.asarray(a) for a in aabb), **kw)
    got = setup.bin_triangles(torch.from_numpy(valid), tuple(torch.from_numpy(a) for a in aabb),
                              **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(want[2]) > 0 or capacity == 64


def test_cylinder_and_quad_match_reference():
    for got, want in ((primitives.cylinder(0.7, 3.0, 12, 2.0), j_prim.cylinder(0.7, 3.0, 12, 2.0)),
                      (primitives.quad(2.0, 1.5, 3.0), j_prim.quad(2.0, 1.5, 3.0))):
        for f in ("positions", "normals", "uvs", "colors", "indices"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)), err_msg=f)


def test_content_instances_scene_matches_bench(tmp_path, monkeypatch):
    import sys

    sys.path.insert(0, REPO)
    import bench
    import chip_smoke
    from sailor_tpu_torch.scenes import content_instances_scene, procedural_test_maps

    path = tmp_path / "balls.glb"
    path.write_bytes(chip_smoke.balls_glb(procedural_test_maps(0, 16), 4, 8, jpeg=True))
    monkeypatch.setattr(bench, "DUCK_GLB", str(path))
    ref = bench._build_content_scene(64, 48, 8, 3)
    got = content_instances_scene(64, 48, 8, 3, str(path), device="cpu")
    want = scene_arrays(ref)
    for key, value in want.items():
        group, _, field = key.partition(".")
        if group in ("geometry", "lights"):
            have = getattr(getattr(got, group), field)
            have = np.asarray(have.numpy() if torch.is_tensor(have) else have)
            np.testing.assert_array_equal(have, value, err_msg=key)
    for f in ("albedo", "metallic", "roughness", "albedo_texture"):
        np.testing.assert_array_equal(getattr(got.materials, f).numpy(),
                                      np.asarray(getattr(ref.materials, f)), err_msg=f)
    np.testing.assert_allclose(got.materials.textures.numpy(),
                               np.asarray(ref.materials.textures), rtol=1e-6, atol=1e-6)


SMALL = {"TH_W": "128", "TH_H": "96", "TH_CUBES": "60", "TH_LIGHTS": "12", "TH_FRAMES": "1"}


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def time_hiz_scenes():
    """The reference tool's scene, captured where its main hands it to the
    frame graph, and the port's, at the SMALL TH_* size."""
    import sailor_tpu.framegraph as j_fg

    spec = importlib.util.spec_from_file_location("ref_time_hiz",
                                                  os.path.join(REPO, "tools", "time_hiz.py"))
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    seen = {}

    class Capture:
        def __init__(self, *a, **kw):
            pass

        def initial_state(self):
            return {}

        def prepare(self, scene, state):
            seen["scene"] = scene
            raise _Captured

    saved_env = {k: os.environ.get(k) for k in SMALL}
    saved_fg = j_fg.FrameGraph
    os.environ.update(SMALL)
    j_fg.FrameGraph = Capture
    try:
        with pytest.raises(_Captured):
            ref_tool.main()
        port = time_hiz.occlusion_heavy_scene(128, 96, 60, 12, device="cpu")
    finally:
        j_fg.FrameGraph = saved_fg
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert time_hiz.settings()["width"] == int(os.environ.get("TH_W", "1920"))
    return seen["scene"], port


def test_time_hiz_scene_matches_reference_tool(time_hiz_scenes):
    ref, port = time_hiz_scenes
    want = scene_arrays(ref)
    for key, value in want.items():
        group, _, field = key.partition(".")
        if group == "attrs_packed":
            have = port.attrs_packed
        elif group == "sky":
            have = torch.as_tensor(np.asarray(getattr(port.sky, field)))
        else:
            have = getattr(getattr(port, group), field)
        have = np.asarray(have.numpy() if torch.is_tensor(have) else have)
        if group in ("frame", "prev_frame"):
            np.testing.assert_allclose(have, value, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(have, value, err_msg=key)
    assert port.geometry.indices.shape[0] == 4 + 12 * 60


def test_time_hiz_scene_culls_as_reference(time_hiz_scenes):
    """Both packages' HiZ graphs (tests/test_hiz_culling.py's) over the
    scene: frame 1 culls nothing, frame 2 the same count, > 0."""
    ref, port = time_hiz_scenes
    config = {"bin_capacity": 256, "bin_rounds": 2, "hiz_culling": True, "z_far": 150.0}
    jax.clear_caches()
    fg = JFrameGraph(JAsset.from_yaml(_GRAPH), 128, 96, config=dict(config))
    state = fg.initial_state()
    want = []
    for _ in range(2):
        t, state = fg.process(ref, state)
        want.append(int(t["HiZCulledCount"]))
    jax.clear_caches()
    names = [e["name"] for e in JAsset.from_yaml(_GRAPH).frame]
    tg = FrameGraph(FrameGraphAsset.from_nodes(names), 128, 96, dict(config), device="cpu")
    state = tg.initial_state()
    got = []
    for _ in range(2):
        t, state = tg.process(port, state)
        got.append(int(t["HiZCulledCount"]))
    assert want[0] == 0 and want[1] > 0
    assert got == want
