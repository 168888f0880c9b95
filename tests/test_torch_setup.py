"""Triangle setup and binning of the PyTorch port against the JAX package.

Inputs: the flagship scene at 512x256 (bench._build_scene, seed 11), fed to
both packages through scene_from_numpy.

Tolerances:
- integers (validity, source ids, tile bins, work lists, row ids) exact;
- screen AABBs and zmax exact (the same float32 operations);
- edge coefficients within 1e-6 of max(1, |row|) for every live triangle
  of nonzero area, depth-plane coefficients for every live triangle of at
  least 0.1 px^2. The reference's compiled setup computes rsqrt by a
  refined estimate, not as 1 / sqrt, so normalised edges may differ in
  the last bit. The rest are ill-conditioned: the zero-length edge of a
  sphere's pole triangle is normalised by rsqrt(1e-20), and a depth plane
  divides by the triangle's area, so last-bit differences grow without
  bound there. Those are held by their integer outcomes (validity here,
  winner ids in test_torch_raster.py) only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.raster import setup as j_setup
from sailor_tpu.raster import tile_raster as j_tr
from sailor_tpu_torch.raster import setup as t_setup
from sailor_tpu_torch.raster import tile_raster as t_tr
from test_torch_scenes import jax_scene, torch_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 512, 256
TX, TY = W // 128, H // 64


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scenes():
    js = jax_scene(W, H, 24, 12)
    return js, torch_scene(js)


@pytest.fixture(scope="module")
def setups(scenes):
    js, ts = scenes
    vp = js.frame.view_projection
    jt, ja = j_setup.triangle_setup(js.geometry, vp, width=W, height=H, cull="back")
    tt, ta = t_setup.triangle_setup(ts.geometry, _t(vp), width=W, height=H, cull="back")
    return (jt, ja), (tt, ta)


def _area2_unclipped(js):
    """float64 screen-space doubled area per raster slot; NaN where the
    near plane clips the triangle."""
    vp = np.asarray(js.frame.view_projection, np.float64)
    pos = np.asarray(js.geometry.position, np.float64)
    clip = np.concatenate([pos, np.ones((len(pos), 1))], 1) @ vp.T
    tri = clip[np.asarray(js.geometry.indices)]
    w = tri[..., 3]
    x = (tri[..., 0] / w * 0.5 + 0.5) * W
    y = (0.5 - tri[..., 1] / w * 0.5) * H
    a = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (y[:, 1] - y[:, 0]) * (x[:, 2] - x[:, 0])
    a = np.where((w > 1e-4).all(-1), np.abs(a), np.nan)
    return np.repeat(a, 2)  # slot 0 holds the unclipped triangle


def test_triangle_setup_matches_jax(scenes, setups):
    js, _ = scenes
    (jt, ja), (tt, ta) = setups
    valid = np.asarray(jt.valid)
    np.testing.assert_array_equal(tt.valid.numpy(), valid)
    np.testing.assert_array_equal(tt.src_id.numpy(), np.asarray(jt.src_id))
    np.testing.assert_array_equal(tt.zmax.numpy(), np.asarray(jt.zmax))
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b.numpy()[valid], np.asarray(a)[valid])
    area = np.nan_to_num(_area2_unclipped(js), nan=np.inf)
    for field, live in (("edge", valid & (area > 0.0)), ("zplane", valid & (area >= 0.1))):
        assert live.sum() > 1000
        ref = np.asarray(getattr(jt, field))[live]
        got = getattr(tt, field).numpy()[live]
        scale = np.maximum(1.0, np.abs(ref).reshape(len(ref), -1).max(-1))
        err = np.abs(got - ref).reshape(len(ref), -1).max(-1) / scale
        assert err.max() <= 1e-6, (field, err.max())


def test_bin_sorted_matches_jax(setups):
    (jt, ja), _ = setups
    ref = j_setup.bin_sorted(jt.valid, ja, tiles_x=TX, tiles_y=TY, tile_w=128, tile_h=64)
    got = t_setup.bin_sorted(_t(jt.valid), tuple(_t(a) for a in ja), tiles_x=TX,
                             tiles_y=TY, tile_w=128, tile_h=64)
    assert int(np.asarray(ref[4])) > 0  # the ground plane is a big triangle
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("chunk", [128, 256])
def test_window_worklist_matches_jax(setups, chunk):
    (jt, ja), _ = setups
    order, starts, counts, *_ = j_setup.bin_sorted(
        jt.valid, ja, tiles_x=TX, tiles_y=TY, tile_w=128, tile_h=64)
    ntiles = TX * TY
    nw_max = ntiles + (order.shape[0] + 2 * chunk) // chunk
    ref = j_tr._window_worklist(starts, counts, ntiles, chunk, nw_max)
    got = t_tr._window_worklist(_t(starts), _t(counts), ntiles, chunk, nw_max)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_build_stream_rows_matches_jax(scenes, setups):
    js, _ = scenes
    (jt, ja), _ = setups
    order, _, _, big_ids, _, _ = j_setup.bin_sorted(
        jt.valid, ja, tiles_x=TX, tiles_y=TY, tile_w=128, tile_h=64)
    attrs = js.attrs_packed[jt.src_id]
    rows, big, na = j_tr.build_stream_rows(jt, ja, order, big_ids, attrs=attrs, chunk=256)
    tsetup = t_setup.TriangleSetup(edge=_t(jt.edge), zplane=_t(jt.zplane), valid=_t(jt.valid),
                                   src_id=_t(jt.src_id), zmax=_t(jt.zmax))
    trows, tbig, tna = t_tr.build_stream_rows(
        tsetup, tuple(_t(a) for a in ja), _t(order), _t(big_ids), attrs=_t(attrs), chunk=256)
    assert tna == na == 37
    np.testing.assert_array_equal(trows.numpy(), np.asarray(rows))
    np.testing.assert_array_equal(tbig.numpy(), np.asarray(big))
    assert jnp.asarray(rows).shape[0] % 256 == 0
