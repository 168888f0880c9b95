"""Visibility raster (B1) and fused resolve (B2) of the PyTorch port
against the JAX package's Pallas kernels, which run here in interpret mode.

Inputs: the JAX package's own rows for the flagship scene at 256x128 (the
setup, bins and row table it builds), handed to both packages as numpy.
On the CPU the port's wrappers run their plain PyTorch versions.

Tolerances:
- B1 depth and triangle id exact, with and without (zlo, zhi) bounds: the
  plain version evaluates each plane as fma(a, px, b * py) + c, the rounding
  of the reference's compiled kernel, and merges in its 32-row groups;
- B2 planes within 1e-4 absolute and exact on >= 99% of values: the
  reference rebuilds each selected attribute from three bfloat16 parts
  (its one-hot matrix product), which can differ from the float32 value in
  the last bits; everything else rounds alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.raster import setup as j_setup
from sailor_tpu.raster import tile_raster as j_tr
from sailor_tpu_torch.raster import tile_raster as t_tr
from test_torch_scenes import jax_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 256, 128
TX, TY = W // 128, H // 64


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frame_rows():
    js = jax_scene(W, H, 24, 10)
    vp = js.frame.view_projection
    tri, aabb = j_setup.triangle_setup(js.geometry, vp, width=W, height=H, cull="back")
    order, starts, counts, big_ids, n_big, _ = j_setup.bin_sorted(
        tri.valid, aabb, tiles_x=TX, tiles_y=TY, tile_w=128, tile_h=64)
    attrs = js.attrs_packed[tri.src_id]
    rows, big, na = j_tr.build_stream_rows(tri, aabb, order, big_ids, attrs=attrs, chunk=256)
    return dict(js=js, tri=tri, aabb=aabb, order=order, starts=starts, counts=counts,
                big_ids=big_ids, n_big=n_big, rows=rows, big=big, na=na,
                inv_vp=jnp.linalg.inv(vp))


def _raster_both(fr, z_bounds):
    kw = dict(tiles_y=TY, tiles_x=TX, chunk=128)
    jd, jt, _ = j_tr.rasterize_worklist(
        fr["tri"], fr["aabb"], fr["order"], fr["starts"], fr["counts"], fr["big_ids"],
        fr["n_big"], z_bounds=z_bounds, prebuilt=(fr["rows"], fr["big"]), **kw)
    tb = None if z_bounds is None else tuple(_t(z) for z in z_bounds)
    td, tt, _ = t_tr.rasterize_worklist(
        None, None, _t(fr["order"]), _t(fr["starts"]), _t(fr["counts"]), _t(fr["big_ids"]),
        _t(fr["n_big"]), z_bounds=tb, prebuilt=(_t(fr["rows"]), _t(fr["big"])), **kw)
    return (np.asarray(jd), np.asarray(jt)), (td.numpy(), tt.numpy())


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
def test_rasterize_worklist_matches_jax(frame_rows, bounded):
    z_bounds = None
    if bounded:
        # second depth layer: strictly behind the first, in front of the far plane
        (d0, t0), _ = _raster_both(frame_rows, None)
        z_bounds = (jnp.zeros((H, W)), jnp.where(t0 >= 0, d0, 2.0))
    (jd, jt), (td, tt) = _raster_both(frame_rows, z_bounds)
    if bounded:
        assert (jt >= 0).sum() > 100  # a real second layer
    else:
        assert (jt >= 0).mean() > 0.3
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(td, jd)


def _rows_with(fr, extra_cols):
    """The frame's rows with extra attribute columns (material columns of
    the 49-column layout), seeded, on dead rows too."""
    rng = np.random.default_rng(3)
    out = []
    for r in (fr["rows"], fr["big"]):
        r = np.asarray(r)
        out.append(np.concatenate(
            [r, rng.uniform(-1, 1, (len(r), extra_cols)).astype(np.float32)], 1))
    return out


@pytest.mark.parametrize("na,mode", [(37, "full"), (49, "full"), (49, "alpha")])
def test_resolve_worklist_matches_jax(frame_rows, na, mode):
    fr = frame_rows
    (d, tid), _ = _raster_both(fr, None)
    rows, big = (np.asarray(fr["rows"]), np.asarray(fr["big"])) if na == 37 else _rows_with(fr, 12)
    cam = fr["js"].frame.camera_position
    kw = dict(tiles_y=TY, tiles_x=TX, na=na, width=W, full_height=H, chunk=256, mode=mode)
    ref = j_tr.resolve_worklist(jnp.asarray(rows), jnp.asarray(big), jnp.asarray(tid),
                                fr["starts"], fr["counts"], fr["n_big"], fr["inv_vp"], cam, **kw)
    got = t_tr.resolve_worklist(_t(rows), _t(big), _t(tid), _t(fr["starts"]), _t(fr["counts"]),
                                _t(fr["n_big"]), _t(fr["inv_vp"]), _t(cam), **kw)
    assert len(got) == len(ref) == {"full": 13 if na == 37 else 29, "alpha": 5}[mode]
    ref = np.stack([np.asarray(p) for p in ref])
    got = torch.stack(got).numpy()
    err = np.abs(got - ref)
    assert err.max() <= 1e-4, err.max()
    assert (err == 0).mean() >= 0.99
    # background pixels read no row: every plane is zero there
    assert not got[:, tid < 0].any()
