"""The raster tile height (``SAILOR_RASTER_TILE_H``) in the port against the
JAX package's, on the CPU.

Both packages read the height at import into ``tile_raster.TILE_H``; here
the ``tile_h`` fixture sets both modules' (and clears JAX's caches on entry
and exit: the reference's jitted kernels read it while they trace). At
heights 8, 16, 24 and 128, on the same numpy inputs: the flagship scene at
256x128 (24 lights, 4 objects) with a soup of 120 large triangles in front
of it (both windings, so one of each pair faces the camera), which makes
the 64-entry big list overflow at 8 and 16 (asserted: the reference drops
those triangles, and so must the port). The reference's setup is
handed to the port as numpy, as in ``test_torch_raster_modes.py``.

- ``bin_sorted`` and ``bin_all`` (capacity 64, 2 rounds) exact, overflow
  included;
- B1, B7 (both plane forms), B8 and B9 (with and without the AABB clamp,
  on the first and the big-triangle pass): depth and triangle ids exact, the twins against the reference's kernels
  in interpret mode;
- B2 (37 columns in full mode and 49 in alpha mode; at 16 also 49 in full
  mode) and B10: within 1e-4 and
  exact on >= 99% of values, zero where no triangle won (the bars of
  ``test_torch_raster.py`` and ``test_torch_raster_modes.py``);
- the minimal Forward+ graph at 256x128 (one frame) at 16 and 128, at
  ``test_torch_frame.py``'s bars (Depth, TriId, light lists exact; Main
  within 1e-4 relative on >= 99.9%; Final within 2/255);
- ``sharded_forward_frame`` at 128x64 over 4 shards at a tile height of 16
  (whole 16-row tile rows a shard: the reference renders it, and the port
  refused it before it took the height; it still refuses it at 64) within
  2e-3 of the reference's LDR frame, ``test_torch_parallel.py``'s bar;
- heights 0, 12 and -8 raise ValueError naming the variable before
  anything runs, from each entry point; 12 also at import;
- ``SAILOR_RASTER_TILE_H=32`` in a subprocess (``torch_raster_tile_h_env.py``):
  both packages read it at import, and a 128x64 frame equals the
  reference's.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.kernels import pbr_pallas as j_pk
from sailor_tpu.raster import interpolate as j_interp
from sailor_tpu.raster import setup as j_setup
from sailor_tpu.raster import tile_raster as j_tr
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.framegraph import nodes as t_nodes
from sailor_tpu_torch.parallel import make_mesh, mesh as t_mesh
from sailor_tpu_torch.raster import pipeline as t_pipeline
from sailor_tpu_torch.raster import setup as t_setup
from sailor_tpu_torch.raster import tile_raster as t_tr
from test_torch_scenes import MINIMAL_GRAPH, SLICE_CONFIG, jax_scene, torch_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 256, 128
TX = W // 128
HEIGHTS = [8, 16, 24, 128]
REFUSED = [0, 12, -8]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=HEIGHTS, ids=[f"h{h}" for h in HEIGHTS])
def tile_h(request):
    """Both packages at the tile height of the parameter (the module's tests
    run height by height, so the reference compiles each kernel once a
    height)."""
    mp = pytest.MonkeyPatch()
    jax.clear_caches()
    for mod in (t_tr, j_tr):
        mp.setattr(mod, "TILE_H", request.param)
    yield request.param
    mp.undo()
    jax.clear_caches()


def _with_soup(js, n=120, seed=7):
    """The scene's geometry with ``n`` large triangles (each in both
    windings) unprojected from random NDC positions 0.002-0.3 deep
    (reverse-Z), random normals, uvs and colours, material 0."""
    g = js.geometry
    rng = np.random.default_rng(seed)
    inv = np.linalg.inv(np.asarray(js.frame.view_projection, np.float64))
    centre = rng.uniform(-0.9, 0.9, (n, 1, 2))
    offset = rng.uniform(-0.45, 0.45, (n, 3, 2))
    z = rng.uniform(0.002, 0.3, (n, 1, 1)) * rng.uniform(0.9, 1.1, (n, 3, 1))
    p = np.concatenate([centre + offset, z, np.ones((n, 3, 1))], -1) @ inv.T
    p = (p[..., :3] / p[..., 3:]).astype(np.float32)
    p = np.concatenate([p, p[:, ::-1]])
    m, nv = p.shape[0], g.position.shape[0]
    nrm = rng.normal(size=(m * 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    def cat(a, b):
        return jnp.asarray(np.concatenate([np.asarray(a), b]))

    return dataclasses.replace(
        g, position=cat(g.position, p.reshape(-1, 3)), normal=cat(g.normal, nrm),
        uv=cat(g.uv, rng.uniform(0, 1, (m * 3, 2)).astype(np.float32)),
        color=cat(g.color, rng.uniform(0, 1, (m * 3, 4)).astype(np.float32)),
        indices=cat(g.indices, nv + np.arange(m * 3, dtype=np.int32).reshape(m, 3)),
        material_id=cat(g.material_id, np.zeros(m, np.int32)))


@pytest.fixture(scope="module")
def soup():
    """The reference's setup of the soup scene, its packed attributes and
    the port's copies."""
    js = jax_scene(W, H, 24, 4)
    geo = _with_soup(js)
    vp = js.frame.view_projection
    tri, aabb = j_setup.triangle_setup(geo, vp, width=W, height=H, cull="back")
    ttri = t_setup.TriangleSetup(edge=_t(tri.edge), zplane=_t(tri.zplane), valid=_t(tri.valid),
                                 src_id=_t(tri.src_id), zmax=_t(tri.zmax))
    return dict(js=js, tri=tri, aabb=aabb, ttri=ttri, taabb=tuple(_t(a) for a in aabb),
                attrs=j_interp.pack_triangle_attributes(geo, tri.src_id),
                inv_vp=jnp.linalg.inv(vp))


def _tiles_y(th):
    return -(-H // th)


def _bins(s, th):
    """The reference's bin_sorted at height th, and the port's copy."""
    rb = j_setup.bin_sorted(s["tri"].valid, s["aabb"], tiles_x=TX, tiles_y=_tiles_y(th),
                            tile_w=128, tile_h=th)
    return rb, [_t(x) for x in rb]


def _same(ref, got):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def _close_planes(ref, got, tid):
    ref = np.stack([np.asarray(p) for p in ref])
    got = torch.stack(got).numpy()
    err = np.abs(got - ref)
    assert err.max() <= 1e-4, err.max()
    assert (err == 0).mean() >= 0.99
    assert not got[:, np.asarray(tid) < 0].any()


def test_binning_matches_reference(soup, tile_h):
    s = soup
    ty = _tiles_y(tile_h)
    ref, _ = _bins(s, tile_h)
    got = t_setup.bin_sorted(_t(s["tri"].valid), s["taabb"], tiles_x=TX, tiles_y=ty,
                             tile_w=128, tile_h=tile_h)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # a big list of 64 entries: the reference drops the rest at 8 and 16 rows
    assert (int(got[5]) > 0) == (tile_h <= 16)
    if tile_h == 16:
        assert int(got[4]) == 64 and int(got[5]) > 10
    kw = dict(tiles_x=TX, tiles_y=ty, tile_w=128, tile_h=tile_h, capacity=64, rounds=2)
    ref_passes, ref_ovf = j_setup.bin_all(s["tri"].valid, s["aabb"], **kw)
    got_passes, got_ovf = t_setup.bin_all(_t(s["tri"].valid), s["taabb"], **kw)
    assert len(got_passes) == len(ref_passes) == 3
    for (rb, rc), (gb, gc) in zip(ref_passes, got_passes):
        np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    assert int(got_ovf) == int(ref_ovf) > 0


def test_worklist_raster_and_resolve_match_reference(soup, tile_h):
    """B1, then B2 on its winners at 37 columns (full) and 49 (alpha, and
    at 16 full; 12 seeded material columns)."""
    s = soup
    ty = _tiles_y(tile_h)
    rb, trb = _bins(s, tile_h)
    rows, big, na = j_tr.build_stream_rows(s["tri"], s["aabb"], rb[0], rb[3], attrs=s["attrs"],
                                           chunk=256)
    kw = dict(tiles_y=ty, tiles_x=TX, chunk=128)
    ref = j_tr.rasterize_worklist(s["tri"], s["aabb"], *rb[:5], prebuilt=(rows, big), **kw)
    got = t_tr.rasterize_worklist(None, None, *trb[:5], prebuilt=(_t(rows), _t(big)), **kw)
    assert got[0].shape == (ty * tile_h, W)
    assert (np.asarray(ref[1]) >= 0).mean() > 0.5
    _same(ref, got)
    tid = ref[1]
    rng = np.random.default_rng(3)
    extra = [np.concatenate([np.asarray(r), rng.uniform(-1, 1, (len(r), 12)).astype(np.float32)],
                            1) for r in (rows, big)]
    cam = s["js"].frame.camera_position
    modes = ((37, "full"), (49, "alpha")) + (((49, "full"),) if tile_h == 16 else ())
    for cols, mode in modes:
        r, b = (np.asarray(rows), np.asarray(big)) if cols == 37 else extra
        kw2 = dict(tiles_y=ty, tiles_x=TX, na=cols, width=W, full_height=H, chunk=256, mode=mode)
        want = j_tr.resolve_worklist(jnp.asarray(r), jnp.asarray(b), tid, rb[1], rb[2], rb[4],
                                     s["inv_vp"], cam, **kw2)
        planes = t_tr.resolve_worklist(_t(r), _t(b), _t(tid), trb[1], trb[2], trb[4],
                                       _t(s["inv_vp"]), _t(cam), **kw2)
        assert len(planes) == len(want) == {"full": 13 if cols == 37 else 29, "alpha": 5}[mode]
        _close_planes(want, planes, tid)


def test_stream_rasters_and_resolve_match_reference(soup, tile_h):
    """B7 in both plane forms (windows of 256, kmax 16) and B10 on the VPU
    form's winners."""
    s = soup
    ty = _tiles_y(tile_h)
    rb, trb = _bins(s, tile_h)
    rows, big, na = j_tr.build_stream_rows(s["tri"], s["aabb"], rb[0], rb[3], attrs=s["attrs"],
                                           chunk=256)
    for mxu in (False, True):
        kw = dict(tiles_y=ty, tiles_x=TX, chunk=256, kmax=16, mxu=mxu)
        ref = j_tr.rasterize_stream(s["tri"], s["aabb"], *rb[:5], prebuilt=(rows, big), **kw)
        got = t_tr.rasterize_stream(None, None, *trb[:5], prebuilt=(_t(rows), _t(big)), **kw)
        assert (np.asarray(ref[1]) >= 0).mean() > 0.5
        _same(ref, got)
        assert int(got[2]) == int(ref[2])
        if not mxu:
            tid = ref[1]
    cam = s["js"].frame.camera_position
    kw = dict(tiles_y=ty, tiles_x=TX, na=na, width=W, full_height=H, chunk=256, kmax=16)
    want = j_tr.resolve_stream(rows, big, tid, rb[1], rb[2], rb[4], s["inv_vp"], cam, **kw)
    planes = t_tr.resolve_stream(_t(rows), _t(big), _t(tid), trb[1], trb[2], trb[4],
                                 _t(s["inv_vp"]), _t(cam), **kw)
    assert len(planes) == len(want) == 13
    _close_planes(want, planes, tid)


def test_dma_and_dense_rasters_match_reference(soup, tile_h):
    """B8 (windows of 128 rows) and B9 on bin_all's first pass and its
    big-triangle pass, with and without the AABB clamp."""
    s = soup
    ty = _tiles_y(tile_h)
    rb, trb = _bins(s, tile_h)
    kw = dict(tiles_y=ty, tiles_x=TX)
    ref = j_tr.rasterize_dma(s["tri"], s["aabb"], *rb[:5], dchunk=128, **kw)
    got = t_tr.rasterize_dma(s["ttri"], s["taabb"], *trb[:5], dchunk=128, **kw)
    assert (np.asarray(ref[1]) >= 0).mean() > 0.5
    _same(ref, got)
    passes, _ = j_setup.bin_all(s["tri"].valid, s["aabb"], tiles_x=TX, tiles_y=ty, tile_w=128,
                                tile_h=tile_h, capacity=256, rounds=2)
    for npass in (0, -1):  # the small triangles' first pass, the big list's
        bins, counts = passes[npass]
        for aabb, taabb in ((s["aabb"], s["taabb"]), (None, None)):
            ref = j_tr.rasterize_tiles(s["tri"], bins, counts=counts, screen_aabb=aabb, **kw)
            got = t_tr.rasterize_tiles(s["ttri"], _t(bins), counts=_t(counts),
                                       screen_aabb=taabb, **kw)
            if npass == 0 or tile_h < 128:  # no triangle is big at 128 rows
                assert (np.asarray(ref[1]) >= 0).sum() > 500
            _same(ref, got)


KEYS = ("Depth", "TriId", "LightIndices", "LightCounts", "Main", "Final")


@pytest.mark.parametrize("tile_h", [16, 128], indirect=True, ids=["h16", "h128"])
def test_minimal_frame_matches_reference(tile_h, monkeypatch):
    """One frame of the minimal graph at 256x128 through FrameGraph.process
    in both packages (the reference's approximate reciprocal made exact
    and its inverse view-projection handed to the port, as in
    test_torch_frame.py)."""
    w, h = 256, 128
    js = jax_scene(w, h, 24, 10)
    yaml_text = "frame:\n" + "".join(f" - name: {n}\n" for n in MINIMAL_GRAPH)
    monkeypatch.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    fg = JFrameGraph(JAsset.from_yaml(yaml_text), w, h, config=dict(SLICE_CONFIG))
    ref = {k: np.asarray(v) for k, v in fg.process(js, fg.initial_state())[0].items()
           if k in KEYS}
    inv = _t(jnp.linalg.inv(js.frame.view_projection))
    monkeypatch.setattr(t_nodes, "inverse_view_projection", lambda frame: inv)
    tfg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), w, h, SLICE_CONFIG, device="cpu")
    got = {k: np.asarray(v) for k, v in tfg.process(torch_scene(js), tfg.initial_state())[0].items()
           if k in KEYS}
    assert (ref["TriId"] >= 0).mean() > 0.3
    for k in ("TriId", "Depth", "LightCounts", "LightIndices"):
        np.testing.assert_array_equal(got[k], ref[k])
    rel = (np.abs(got["Main"] - ref["Main"]) / np.maximum(np.abs(ref["Main"]), 1e-3)).max(-1)
    assert (rel <= 1e-4).mean() >= 0.999
    assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255


@pytest.mark.parametrize("tile_h", [16], indirect=True, ids=["h16"])
def test_sharded_forward_frame_at_tile_height_16(tile_h, monkeypatch):
    """128x64 over 4 shards: 16-row slices, one tile row each at 16."""
    import __graft_entry__ as g
    from sailor_tpu.parallel import make_mesh as j_make_mesh
    from sailor_tpu.parallel import sharded_forward_frame as j_forward

    w, h = 128, 64
    js = g._demo_scene(w, h, num_lights=8)
    want = np.asarray(j_forward(js, width=w, height=h, mesh=j_make_mesh(4)))
    stats = {}
    got = t_mesh.sharded_forward_frame(torch_scene(js), width=w, height=h,
                                       mesh=make_mesh(4, device="cpu"), stats=stats).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    assert len(stats["bin_overflow"]) == 4
    assert np.abs(got - want).max() <= 2e-3, np.abs(got - want).max()
    assert got.std() > 0.02
    monkeypatch.setattr(t_tr, "TILE_H", 64)  # neither whole 64- nor 32-row slices
    with pytest.raises(ValueError, match="SAILOR_RASTER_TILE_H"):
        t_mesh.sharded_forward_frame(None, width=w, height=h, mesh=make_mesh(4, device="cpu"))


@pytest.mark.parametrize("th", REFUSED)
def test_refused_heights_raise_before_anything_runs(th, monkeypatch):
    """Every entry point checks the height first: the inputs here are None,
    so anything that ran before the check would fail otherwise."""
    monkeypatch.setattr(t_tr, "TILE_H", th)
    kw = dict(tiles_y=2, tiles_x=2)
    calls = [
        lambda: t_tr.check_tile_h(),
        lambda: t_tr.rasterize_worklist(None, None, None, None, None, None, None, **kw),
        lambda: t_tr.rasterize_stream(None, None, None, None, None, None, None, **kw),
        lambda: t_tr.rasterize_dma(None, None, None, None, None, None, None, **kw),
        lambda: t_tr.rasterize_tiles(None, None, **kw),
        lambda: t_tr.resolve_worklist(None, None, None, None, None, None, None, None, na=37,
                                      width=8, full_height=8, **kw),
        lambda: t_tr.resolve_stream(None, None, None, None, None, None, None, None, na=37,
                                    width=8, full_height=8, **kw),
        lambda: t_pipeline.rasterize(None, None, width=8, height=8, device="cpu"),
        lambda: FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 64, 64, SLICE_CONFIG,
                           device="cpu").process(None, {}),
        lambda: t_mesh.sharded_forward_frame(None, width=8, height=64,
                                             mesh=make_mesh(2, device="cpu")),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="SAILOR_RASTER_TILE_H"):
            call()


def test_refused_height_raises_at_import():
    """SAILOR_RASTER_TILE_H=12: the port raises ValueError naming it when
    tile_raster is imported (the reference asserts there)."""
    env = dict(os.environ, SAILOR_RASTER_TILE_H="12")
    proc = subprocess.run([sys.executable, "-c", "import sailor_tpu_torch.raster.tile_raster"],
                          cwd=os.path.dirname(HERE), env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "ValueError: SAILOR_RASTER_TILE_H=12" in proc.stderr, proc.stderr[-2000:]


def test_tile_height_environment_sets_the_default():
    """Both packages read SAILOR_RASTER_TILE_H=32 at import, and the frame
    at 128x64 equals the reference's (torch_raster_tile_h_env.py)."""
    env = dict(os.environ, SAILOR_RASTER_TILE_H="32", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_raster_tile_h_env.py")],
                          cwd=os.path.dirname(HERE), env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "tile_h=32" in proc.stdout
