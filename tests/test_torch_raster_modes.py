"""The raster variants of the PyTorch port against the JAX package's Pallas
kernels, which run here in interpret mode: dense binning (``bin_all``),
B7 (``rasterize_stream``, both plane forms), B8 (``rasterize_dma``), B9
(``rasterize_tiles``) and B10 (``resolve_stream``).

Inputs: the JAX package's own setup, bins and rows for the flagship scene
at 256x128 (24 lights, 10 objects), handed to both packages as numpy; for
``bin_all`` also random screen boxes with big triangles and overflow. On
the CPU the port's wrappers run their plain PyTorch twins.

Tolerances:
- bins, counts, overflow, depth and triangle ids exact, with and without
  z bounds and the AABB clamp: each twin walks its variant's groups in the
  reference's order, and evaluates the planes in the rounding of the
  reference's CPU build (B7's MXU form included: its re-centred planes
  round as fma(b, oy, fma(a, ox, c)) and fma(b, dy, a*dx) + c_t);
- B10 planes as B2's in test_torch_raster.py: within 1e-4 and exact on
  >= 99% of values (the reference rebuilds each attribute from three
  bfloat16 parts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.raster import setup as j_setup
from sailor_tpu.raster import tile_raster as j_tr
from sailor_tpu_torch.raster import setup as t_setup
from sailor_tpu_torch.raster import tile_raster as t_tr
from test_torch_scenes import jax_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 256, 128
TX, TY = W // 128, H // 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _tsetup(tri):
    return t_setup.TriangleSetup(edge=_t(tri.edge), zplane=_t(tri.zplane), valid=_t(tri.valid),
                                 src_id=_t(tri.src_id), zmax=_t(tri.zmax))


@pytest.fixture(scope="module")
def frame():
    js = jax_scene(W, H, 24, 10)
    vp = js.frame.view_projection
    tri, aabb = j_setup.triangle_setup(js.geometry, vp, width=W, height=H, cull="back")
    rb = j_setup.bin_sorted(tri.valid, aabb, tiles_x=TX, tiles_y=TY, tile_w=128, tile_h=64)
    return dict(js=js, tri=tri, aabb=aabb, rb=rb, ttri=_tsetup(tri),
                taabb=tuple(_t(a) for a in aabb), trb=[_t(x) for x in rb],
                inv_vp=jnp.linalg.inv(vp))


def _same(ref, got):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def _second_layer(ref):
    """z bounds of the layer behind ``ref``'s winners."""
    d, t = np.asarray(ref[0]), np.asarray(ref[1])
    return jnp.zeros(d.shape), jnp.where(t >= 0, d, 2.0)


def _random_boxes(n, rng):
    """Screen boxes over a 512x256 screen: mostly small, some spanning more
    than 2x2 tiles (big), some off screen, a few dead."""
    x0 = rng.uniform(-40, 530, n)
    y0 = rng.uniform(-20, 270, n)
    size = np.where(rng.random(n) < 0.1, rng.uniform(150, 400, n), rng.uniform(0, 60, n))
    xmax = x0 + size * rng.uniform(0.2, 1, n)
    ymax = y0 + size * rng.uniform(0.2, 1, n)
    valid = rng.random(n) > 0.1
    return valid, tuple(a.astype(np.float32) for a in (x0, xmax, y0, ymax))


@pytest.mark.parametrize("case", ["frame", "random_boxes"])
def test_bin_all_matches_jax(frame, case):
    if case == "frame":
        valid, aabb = np.array(frame["tri"].valid), tuple(np.array(a) for a in frame["aabb"])
        kw = dict(tiles_x=TX, tiles_y=TY, capacity=128, rounds=3)
    else:
        valid, aabb = _random_boxes(3000, np.random.default_rng(5))
        kw = dict(tiles_x=4, tiles_y=4, capacity=64, rounds=2)
    kw.update(tile_w=128, tile_h=64)
    ref_passes, ref_ovf = j_setup.bin_all(jnp.asarray(valid), tuple(jnp.asarray(a) for a in aabb),
                                          **kw)
    got_passes, got_ovf = t_setup.bin_all(torch.from_numpy(valid),
                                          tuple(torch.from_numpy(a) for a in aabb), **kw)
    assert len(got_passes) == len(ref_passes) == kw["rounds"] + 1
    for (rb, rc), (gb, gc) in zip(ref_passes, got_passes):
        np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    assert int(got_ovf) == int(ref_ovf) > 0
    if case == "random_boxes":  # more big triangles than the big pass holds
        big = t_setup._small_keys(torch.from_numpy(valid), tuple(torch.from_numpy(a) for a in aabb),
                                  tiles_x=4, tiles_y=4, tile_w=128, tile_h=64)[3]
        assert int(big.sum()) > 64


def test_bin_all_refuses_int32_key_overflow():
    n = 2**31 // 256
    with pytest.raises(ValueError, match="int32"):
        t_setup.bin_all(torch.zeros(n, dtype=torch.bool), (torch.zeros(n),) * 4, tiles_x=16,
                        tiles_y=16, tile_w=128, tile_h=64, capacity=32)


@pytest.mark.parametrize("chunk,kmax,mxu,bounded", [
    (256, 16, False, False), (64, 2, False, False), (256, 16, False, True),
    (256, 16, True, False), (128, 2, True, False), (128, 8, True, True),
], ids=["vpu", "vpu_capped", "vpu_z_bounds", "mxu", "mxu_capped", "mxu_z_bounds"])
def test_rasterize_stream_matches_jax(frame, chunk, kmax, mxu, bounded):
    f = frame
    kw = dict(tiles_y=TY, tiles_x=TX, chunk=chunk, kmax=kmax, mxu=mxu)
    ref = j_tr.rasterize_stream(f["tri"], f["aabb"], *f["rb"][:5], **kw)
    tb = None
    if bounded:
        zb = _second_layer(ref)
        ref = j_tr.rasterize_stream(f["tri"], f["aabb"], *f["rb"][:5], z_bounds=zb, **kw)
        tb = tuple(_t(z) for z in zb)
    got = t_tr.rasterize_stream(f["ttri"], f["taabb"], *f["trb"][:5], z_bounds=tb, **kw)
    assert (np.asarray(ref[1]) >= 0).sum() > (50 if bounded else 10000)
    _same(ref, got)
    assert int(got[2]) == int(ref[2])
    assert (int(ref[2]) > 0) == (kmax == 2)


def test_rasterize_stream_mxu_guards(frame):
    f = frame
    with pytest.raises(ValueError, match="chunk"):
        t_tr.rasterize_stream(f["ttri"], f["taabb"], *f["trb"][:5], tiles_y=TY, tiles_x=TX,
                              chunk=64, kmax=8, mxu=True)
    with pytest.raises(ValueError, match="chunk"):
        j_tr.rasterize_stream(f["tri"], f["aabb"], *f["rb"][:5], tiles_y=TY, tiles_x=TX,
                              chunk=64, kmax=8, mxu=True)


@pytest.mark.parametrize("dchunk,bounded", [(128, False), (64, True)],
                         ids=["no_bounds", "z_bounds"])
def test_rasterize_dma_matches_jax(frame, dchunk, bounded):
    f = frame
    kw = dict(tiles_y=TY, tiles_x=TX, dchunk=dchunk)
    ref = j_tr.rasterize_dma(f["tri"], f["aabb"], *f["rb"][:5], **kw)
    tb = None
    if bounded:
        zb = _second_layer(ref)
        ref = j_tr.rasterize_dma(f["tri"], f["aabb"], *f["rb"][:5], z_bounds=zb, **kw)
        tb = tuple(_t(z) for z in zb)
    got = t_tr.rasterize_dma(f["ttri"], f["taabb"], *f["trb"][:5], z_bounds=tb, **kw)
    assert (np.asarray(ref[1]) >= 0).sum() > (50 if bounded else 10000)
    _same(ref, got)
    assert int(got[2]) == 0


@pytest.mark.parametrize("clamp", [False, True], ids=["no_aabb", "aabb"])
@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
def test_rasterize_tiles_matches_jax(frame, clamp, bounded):
    f = frame
    passes, _ = j_setup.bin_all(f["tri"].valid, f["aabb"], tiles_x=TX, tiles_y=TY, tile_w=128,
                                tile_h=64, capacity=256, rounds=2)
    bins, counts = passes[0]
    aabb, taabb = (f["aabb"], f["taabb"]) if clamp else (None, None)
    kw = dict(tiles_y=TY, tiles_x=TX)
    ref = j_tr.rasterize_tiles(f["tri"], bins, counts=counts, screen_aabb=aabb, **kw)
    tb = None
    if bounded:
        zb = _second_layer(ref)
        ref = j_tr.rasterize_tiles(f["tri"], bins, counts=counts, screen_aabb=aabb,
                                   z_bounds=zb, **kw)
        tb = tuple(_t(z) for z in zb)
    got = t_tr.rasterize_tiles(f["ttri"], _t(bins), counts=_t(counts), screen_aabb=taabb,
                               z_bounds=tb, **kw)
    assert (np.asarray(ref[1]) >= 0).sum() > (50 if bounded else 10000)
    _same(ref, got)
    if not bounded:  # the live counts are the bins' own
        _same(ref, t_tr.rasterize_tiles(f["ttri"], _t(bins), screen_aabb=taabb, **kw))


@pytest.mark.parametrize("chunk,kmax", [(256, 16), (64, 2)], ids=["uncapped", "capped"])
def test_resolve_stream_matches_jax(frame, chunk, kmax):
    """The grid-k fused resolve on the work-list raster's winners: with the
    cap, winners past it resolve to zero in both packages."""
    f = frame
    js, rb = f["js"], f["rb"]
    attrs = js.attrs_packed[f["tri"].src_id]
    rows, big, na = j_tr.build_stream_rows(f["tri"], f["aabb"], rb[0], rb[3], attrs=attrs,
                                           chunk=chunk)
    _, tid, _ = j_tr.rasterize_worklist(f["tri"], f["aabb"], *rb[:5], tiles_y=TY, tiles_x=TX,
                                        chunk=64, prebuilt=(rows, big))
    cam = js.frame.camera_position
    kw = dict(tiles_y=TY, tiles_x=TX, na=na, width=W, full_height=H, chunk=chunk, kmax=kmax)
    ref = j_tr.resolve_stream(rows, big, tid, rb[1], rb[2], rb[4], f["inv_vp"], cam, **kw)
    got = t_tr.resolve_stream(_t(rows), _t(big), _t(tid), _t(rb[1]), _t(rb[2]), _t(rb[4]),
                              _t(f["inv_vp"]), _t(cam), **kw)
    assert len(got) == len(ref) == 13
    ref = np.stack([np.asarray(p) for p in ref])
    got = torch.stack(got).numpy()
    err = np.abs(got - ref)
    assert err.max() <= 1e-4, err.max()
    assert (err == 0).mean() >= 0.99
    tid = np.asarray(tid)
    assert not got[:, tid < 0].any()
    dropped = (tid >= 0) & ~got.any(0)
    assert dropped.any() == (kmax == 2)
