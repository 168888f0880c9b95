"""The gather resolve (``interpolate.resolve_gbuffer``) and the standalone
raster entry point (``raster.rasterize``: setup -> bin_all -> B9 per pass
-> depth merge -> resolve) of the PyTorch port against the JAX package.

Inputs: the flagship scene at 256x128 (24 lights, 10 objects), fed to both
packages through scene_from_numpy; the JAX package's Pallas kernels run in
interpret mode, the port's wrappers their plain twins.

Tolerances:
- depth, triangle ids, material ids and the stats (bin overflow, per-tile
  counts) exact;
- G-buffer planes and uv as the fused resolve's in test_torch_raster.py:
  within 1e-4 and exact on >= 99% of values, given the reference's inverse
  view-projection: the two packages' inverses differ in the last bit
  (ROADMAP C), which the pixel ray amplifies on grazing pixels;
- ``rasterize`` is held with the reference's triangle setup and inverse
  substituted (all of the above), and end to end with its own (depth, ids
  and stats exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu import raster as j_raster
from sailor_tpu.raster import interpolate as j_interp
from sailor_tpu.raster import setup as j_setup
from sailor_tpu.raster import tile_raster as j_tr
from sailor_tpu_torch import raster as t_raster
from sailor_tpu_torch.raster import interpolate as t_interp
from test_torch_scenes import jax_scene, torch_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 256, 128
FIELDS = ("world_position", "normal", "albedo", "metallic", "roughness", "ao", "emissive",
          "coverage")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scenes():
    js = jax_scene(W, H, 24, 10)
    return js, torch_scene(js)


def _planes(gb, uv):
    return np.concatenate([np.asarray(getattr(gb, f)).reshape(H, W, -1) for f in FIELDS]
                          + [np.asarray(uv)], axis=-1)


def _close(got, ref, tol, exact):
    err = np.abs(got - ref)
    assert err.max() <= tol, err.max()
    assert (err == 0).mean() >= exact


def test_resolve_gbuffer_matches_jax(scenes):
    js, ts = scenes
    vp = js.frame.view_projection
    tri, aabb = j_setup.triangle_setup(js.geometry, vp, width=W, height=H, cull="back")
    rb = j_setup.bin_sorted(tri.valid, aabb, tiles_x=2, tiles_y=2, tile_w=128, tile_h=64)
    _, tid, _ = j_tr.rasterize_worklist(tri, aabb, *rb[:5], tiles_y=2, tiles_x=2)
    tid = tid[:H, :W]
    inv = jnp.linalg.inv(vp)
    cam = js.frame.camera_position
    ref_gb, ref_uv, ref_mid = j_interp.resolve_gbuffer(js.geometry, tri, tid, inv, cam)
    tsetup = t_raster.setup.TriangleSetup(edge=_t(tri.edge), zplane=_t(tri.zplane),
                                          valid=_t(tri.valid), src_id=_t(tri.src_id),
                                          zmax=_t(tri.zmax))
    gb, uv, mid = t_interp.resolve_gbuffer(ts.geometry, tsetup, _t(tid), _t(inv), _t(cam))
    assert (np.asarray(tid) >= 0).mean() > 0.3
    np.testing.assert_array_equal(mid.numpy(), np.asarray(ref_mid))
    _close(_planes(gb, uv), _planes(ref_gb, ref_uv), 1e-4, 0.99)


def test_pixel_rays_match_jax(scenes):
    js, _ = scenes
    inv = jnp.linalg.inv(js.frame.view_projection)
    cam = js.frame.camera_position
    ref = j_interp.pixel_rays(inv, cam, 64, 96, 16, 128)
    got = t_interp.pixel_rays(_t(inv), _t(cam), 64, 96, 16, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _reference_setup(monkeypatch, js):
    """Hand the port's pipeline the reference's own triangle setup and
    inverse view-projection."""
    inv = _t(jnp.linalg.inv(js.frame.view_projection))
    monkeypatch.setattr(torch.linalg, "inv", lambda m: inv)
    tri, aabb = j_setup.triangle_setup(js.geometry, js.frame.view_projection, width=W,
                                       height=H, cull="back")
    got = (t_raster.setup.TriangleSetup(edge=_t(tri.edge), zplane=_t(tri.zplane),
                                        valid=_t(tri.valid), src_id=_t(tri.src_id),
                                        zmax=_t(tri.zmax)), tuple(_t(a) for a in aabb))
    monkeypatch.setattr(t_raster.setup, "triangle_setup", lambda *a, **k: got)


@pytest.mark.parametrize("capacity,rounds,camera", [
    (512, 1, False), (64, 2, False), (512, 1, True),
], ids=["default", "overflow_rounds", "camera_given"])
def test_rasterize_matches_jax(scenes, monkeypatch, capacity, rounds, camera):
    """The pipeline with the reference's triangle setup and inverse: depth,
    ids and stats exact, the G-buffer as the resolve's."""
    js, ts = scenes
    _reference_setup(monkeypatch, js)
    kw = dict(width=W, height=H, capacity=capacity, rounds=rounds)
    cam = js.frame.camera_position if camera else None
    ref_gb, ref_d, ref_t, ref_stats = j_raster.rasterize(js.geometry, js.frame.view_projection,
                                                         cam, **kw)
    gb, d, t, stats = t_raster.rasterize(ts.geometry, ts.frame.view_projection,
                                         None if cam is None else _t(cam), device="cpu", **kw)
    assert (np.asarray(ref_t) >= 0).mean() > 0.3
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    assert int(stats["bin_overflow"]) == int(ref_stats["bin_overflow"])
    assert int(stats["bin_overflow"]) > (1000 if capacity == 64 else 0)
    np.testing.assert_array_equal(stats["tile_tri_counts"].numpy(),
                                  np.asarray(ref_stats["tile_tri_counts"]))
    empty = np.zeros((H, W, 0))
    _close(_planes(gb, empty), _planes(ref_gb, empty), 1e-4, 0.99)


def test_rasterize_with_own_setup_matches_jax(scenes):
    """The port end to end, its own setup rounding the depth plane as the
    reference's standalone setup does: depth, ids and stats exact."""
    js, ts = scenes
    kw = dict(width=W, height=H, capacity=512, rounds=1)
    _, ref_d, ref_t, ref_stats = j_raster.rasterize(js.geometry, js.frame.view_projection, **kw)
    _, d, t, stats = t_raster.rasterize(ts.geometry, ts.frame.view_projection, device="cpu", **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    assert int(stats["bin_overflow"]) == int(ref_stats["bin_overflow"])
    np.testing.assert_array_equal(stats["tile_tri_counts"].numpy(),
                                  np.asarray(ref_stats["tile_tri_counts"]))


def test_rasterize_runs_on_the_card_by_default(scenes, monkeypatch):
    _, ts = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_raster.rasterize(ts.geometry, ts.frame.view_projection, width=W, height=H)
