"""Materials on the raster path and the Masked and Transparent queues,
through the JAX package and the port, on the CPU.

Inputs: ``scenes.flagship_queue_scene``'s geometry and materials at
256x128 (24 lights, 48 objects: the ground and every third object from 0
Opaque, from 1 Masked with striped alpha, from 2 Transparent; 256x256
maps),
the JAX package's scene from bench.py with the port's material ids and
``MaterialTable.from_host`` of the same host rows, the port's scene from
its arrays (``scene_from_numpy``, the reference's u8 int32 lanes
unpacked); and tests/test_render_queues.py's quad scenes. The reference's
Pallas kernels run in interpret mode, the port's wrappers their plain
twins. Tolerances:

- exact: the 49-column packed attribute table, ``uv_screen_lod`` (even
  and odd sizes, with and without the coverage mask), the fused path's
  bin segments and the rows' id and attribute columns, and every Depth
  and TriId;
- ``resolve_alpha`` (gather), ``resolve_alpha_stream`` (B2's 5-plane
  emit, and B10's full one on the grid-k bins) and ``resolve_gbuffer`` /
  ``resolve_gbuffer_stream`` with materials over the opaque and masked
  bin sets: the resolve bar of test_torch_pipeline.py, within 1e-4 and
  exact on >= 99% of values, mat ids exact (measured: the gather path's
  alpha within 3e-8, the fused alpha exact, the other planes within
  3.8e-6); the albedo and the mapped normal within 1e-6, as the
  reference fuses its texture weights inside its compiled resolve
  (measured 2.4e-7; 81% of the gather path's normal values exact);
- the queue scenes' frames (cutout, second layer revealed, transparent
  blend) on the default work-list path and with ``fused_resolve`` off:
  Depth and TriId exact, Main and Final within 1e-5 (measured 2.4e-7 and
  3e-7); the port holds test_render_queues.py's own oracles too (the
  cut-out subset, nothing of a fully transparent quad, the blend linear
  in opacity);
- the port's render of test_golden.py's ``queues`` scene against
  tests/golden/queues.png at test_golden's bar (mean |diff| < 2.5, p99
  < 12 in u8).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_render_queues as rq
from sailor_tpu.assets.materials import MaterialTable as JMaterialTable
from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.raster import interpolate as j_interp
from sailor_tpu.rhi.scene_view import SceneView as JSceneView
from sailor_tpu_torch.assets import materials as mat
from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset, nodes
from sailor_tpu_torch.raster import interpolate as t_interp
from sailor_tpu_torch.rhi.scene_view import scene_from_numpy
from sailor_tpu_torch.scenes import QUEUE_TEXTURE_SIZE, flagship_queue_scene
from test_torch_scenes import jax_scene, scene_arrays
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 256, 128
DEPTH_GRAPH = "frame:\n - name: DepthPrepass\n"


def queue_scenes(width=W, height=H, num_lights=24, num_objects=48):
    """(JAX SceneView, the port's SceneView) of the flagship queue scene:
    the reference's flagship scene with the port's material ids and the
    same host material rows; the port's from the reference's arrays and
    material table (``materials.<field>``)."""
    ts, table, images = flagship_queue_scene(width, height, num_lights, num_objects,
                                             device="cpu")
    js = jax_scene(width, height, num_lights, num_objects)
    jm = JMaterialTable.from_host(table, images, texture_size=QUEUE_TEXTURE_SIZE)
    geo = js.geometry.replace(material_id=jnp.asarray(ts.geometry.material_id.numpy()))
    js = JSceneView.create(geo, js.lights, js.frame, sky=js.sky, materials=jm)
    arrays = scene_arrays(js)
    arrays.update({"materials." + f: getattr(jm, f)
                   for f in mat.TENSOR_FIELDS + mat.HOST_FIELDS})
    return js, scene_from_numpy(arrays, "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scenes():
    return queue_scenes()


@pytest.fixture(scope="module")
def prepass(scenes):
    """DepthPrepass of both packages on the fused work-list path and on
    the grid-k stream path (``raster_worklist`` off): (reference targets,
    reference bins with their static fields, the port's targets)."""
    js, ts = scenes
    out = {}
    for name, cfg in (("worklist", {}), ("stream", {"raster_worklist": False})):
        cfg = dict(bin_capacity=1024, bin_rounds=4, hiz_culling=False, **cfg)
        jfg = JFrameGraph(JAsset.from_yaml(DEPTH_GRAPH), W, H, config=dict(cfg))
        jt, _ = jfg.process(js, jfg.initial_state())
        jbins = [dict(b, **m) for b, m in zip(jt["StreamBins"], jfg.config["_fused_meta"])]
        fg = FrameGraph(FrameGraphAsset.from_yaml(DEPTH_GRAPH), W, H, dict(cfg), device="cpu")
        tt, _ = fg.process(ts, fg.initial_state())
        out[name] = (jt, jbins, tt)
    return out


def _close(got, ref, tol=1e-4, exact=0.99):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert err.max() <= tol, err.max()
    assert (err == 0).mean() >= exact, (err == 0).mean()


FIELDS = ("world_position", "normal", "albedo", "metallic", "roughness", "emissive",
          "coverage")


def _gb_close(got, ref):
    """The resolve bar; the albedo and the mapped normal, which the
    reference samples inside its compiled resolve with the texture
    weights fused (the port rounds them as its samplers run alone,
    test_torch_material_table.py), within 1e-6 (measured 2.4e-7)."""
    gb, uv, mid = got
    rgb, ruv, rmid = ref
    cov = np.asarray(rgb.coverage) > 0
    np.testing.assert_array_equal(mid.numpy()[cov], np.asarray(rmid)[cov])
    for f in FIELDS:
        if f in ("albedo", "normal"):
            _close(getattr(gb, f).numpy(), np.asarray(getattr(rgb, f)), 1e-6, 0.0)
        else:
            _close(getattr(gb, f).numpy(), np.asarray(getattr(rgb, f)))
    _close(uv.numpy()[cov], np.asarray(ruv)[cov])


def test_packed_attributes_match_jax(scenes):
    js, ts = scenes
    np.testing.assert_array_equal(ts.attrs_packed.numpy(), np.asarray(js.attrs_packed))
    assert ts.attrs_packed.shape[1] == 49
    src = np.random.default_rng(0).integers(0, ts.geometry.indices.shape[0], 300)
    src = src.astype(np.int32)
    got = t_interp.pack_triangle_attributes(ts.geometry, torch.from_numpy(src), ts.materials)
    want = j_interp.pack_triangle_attributes(js.geometry, jnp.asarray(src), js.materials)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,masked", [((64, 96), False), ((64, 96), True),
                                          ((33, 47), True)],
                         ids=["even", "even_valid", "odd_valid"])
def test_uv_screen_lod_matches_jax(shape, masked):
    import jax

    rng = np.random.default_rng(7)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    uv = np.stack([xx * 0.013 + 0.3 * np.sin(yy * 0.1), yy * 0.021], -1)
    uv += rng.normal(0, 0.004, uv.shape)
    uv[rng.random((h, w)) < 0.05] += 0.98   # repeat seams
    uv = uv.astype(np.float32)
    valid = rng.random((h, w)) < 0.8 if masked else None
    ref = jax.jit(j_interp.uv_screen_lod, static_argnums=1)(
        jnp.asarray(uv), 256, None if valid is None else jnp.asarray(valid))
    got = t_interp.uv_screen_lod(torch.from_numpy(uv), 256,
                                 None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bins_match_jax(prepass):
    """The fused path's two bin sets (opaque, then masked): the tiles'
    segments and the rows' id and attribute columns exact, and Depth and
    TriId exact with the masked peel run. (The rows' edge and depth
    planes are the setup's, which a graph of DepthPrepass alone rounds
    otherwise in the reference: ROADMAP C 2.)"""
    for name, (jt, jbins, tt) in prepass.items():
        assert len(jbins) == len(tt["StreamBins"]) == 2, name
        for jb, tb in zip(jbins, tt["StreamBins"]):
            for k in ("starts", "counts", "n_big"):
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
            for k in ("rows", "big_rows"):  # the id and the 49 attribute columns
                np.testing.assert_array_equal(tb[k][:, 16:].numpy(), np.asarray(jb[k])[:, 16:],
                                              err_msg=k)
            assert int(tb["na"]) == int(jb["na"]) == 49
        np.testing.assert_array_equal(tt["Depth"].numpy(), np.asarray(jt["Depth"]))
        np.testing.assert_array_equal(tt["TriId"].numpy(), np.asarray(jt["TriId"]))
        assert tt["MaskedPeelLayers"] >= 2


def _masked_tid(prepass_out, ts):
    """The masked queue's nearest layer without bounds (the peel's first
    raster with no opaque depth in front): a visibility buffer of masked
    winners, made by the port's raster of the masked bins."""
    _, _, tt = prepass_out
    tri = tt["TriSetup"]
    queue = ts.materials.queue[ts.geometry.material_id[tri.src_id.long()].long()]
    raster, _, _ = nodes._make_raster(tri, tri.valid & (queue == 1), tt["TriAABB"], 2, 2,
                                      {"raster_worklist": False}, capacity=1024)
    tid = raster()[1][:H, :W]
    assert (tid >= 0).sum() > 100
    return tid.numpy()


def _inv(js):
    return jnp.linalg.inv(js.frame.view_projection)


def test_resolve_alpha_matches_jax(scenes, prepass):
    js, ts = scenes
    jt = prepass["worklist"][0]
    tid = _masked_tid(prepass["worklist"], ts)
    inv, cam = _inv(js), js.frame.camera_position
    ra, rc = j_interp.resolve_alpha(js.geometry, jt["TriSetup"], jnp.asarray(tid), inv, cam,
                                    js.materials)
    setup = types.SimpleNamespace(src_id=_t(jt["TriSetup"].src_id))
    a, c = t_interp.resolve_alpha(ts.geometry, setup, _t(tid), _t(inv), _t(cam), ts.materials)
    _close(a.numpy(), ra)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))


@pytest.mark.parametrize("path", ["worklist", "stream"], ids=["slim", "full"])
def test_resolve_alpha_stream_matches_jax(scenes, prepass, path):
    js, ts = scenes
    jt, jbins, tt = prepass[path]
    tid = _masked_tid(prepass[path], ts)
    inv, cam = _inv(js), js.frame.camera_position
    kw = dict(width=W, height=H, tiles_y=2, tiles_x=2)
    ra, rc = j_interp.resolve_alpha_stream(jbins[1], jnp.asarray(tid), inv, cam, js.materials,
                                           **kw)
    a, c = t_interp.resolve_alpha_stream(tt["StreamBins"][1], _t(tid), _t(inv), _t(cam),
                                         ts.materials, **kw)
    assert (np.asarray(ra) > 0).sum() > 100
    _close(a.numpy(), ra)
    _close(c.numpy(), rc)


def test_resolve_gbuffer_with_materials_matches_jax(scenes, prepass):
    js, ts = scenes
    jt = prepass["worklist"][0]
    tid = jnp.asarray(jt["TriId"])
    inv, cam = _inv(js), js.frame.camera_position
    ref = j_interp.resolve_gbuffer(js.geometry, jt["TriSetup"], tid, inv, cam,
                                   materials=js.materials)
    setup = types.SimpleNamespace(src_id=_t(jt["TriSetup"].src_id))
    got = t_interp.resolve_gbuffer(ts.geometry, setup, _t(tid), _t(inv), _t(cam),
                                   materials=ts.materials)
    _gb_close(got, ref)


@pytest.mark.parametrize("path", ["worklist", "stream"])
def test_resolve_gbuffer_stream_with_materials_matches_jax(scenes, prepass, path):
    """Both bin sets through the fused resolve (B2's or B10's 29 planes),
    with the extras the transparent blend reads."""
    js, ts = scenes
    jt, jbins, tt = prepass[path]
    tid = jnp.asarray(jt["TriId"])
    inv, cam = _inv(js), js.frame.camera_position
    kw = dict(width=W, height=H, tiles_y=2, tiles_x=2, return_extras=True)
    *ref, rex = j_interp.resolve_gbuffer_stream(jbins, tid, inv, cam, materials=js.materials,
                                                **kw)
    *got, ex = t_interp.resolve_gbuffer_stream(tt["StreamBins"], _t(tid), _t(inv), _t(cam),
                                               materials=ts.materials, **kw)
    _gb_close(got, ref)
    for k in ("cutoff", "opacity"):
        _close(ex[k].numpy(), rex[k])


# --- test_render_queues.py's scenes through both frame graphs ------------

CONFIGS = {"worklist": {}, "gather_resolve": {"fused_resolve": False}}


def _checker():
    tex = np.ones((8, 8, 4), np.float32)
    tex[::2, :, 3] = 0.0
    return tex


def _port_scene(js):
    arrays = scene_arrays(js)
    arrays.update({"materials." + f: getattr(js.materials, f)
                   for f in mat.TENSOR_FIELDS + mat.HOST_FIELDS})
    return scene_from_numpy(arrays, "cpu")


def _frames(change, jscenes):
    """The queue graph over the scenes in both packages (one reference
    graph, compiled once per scene structure): [(reference, port)]."""
    cfg = dict({"bin_capacity": 256, "bin_rounds": 2}, **change)
    jfg = JFrameGraph(JAsset.from_yaml(rq._GRAPH), rq.W, rq.H, config=dict(cfg))
    fg = FrameGraph(FrameGraphAsset.from_yaml(rq._GRAPH), rq.W, rq.H, dict(cfg), device="cpu")
    out = []
    for js in jscenes:
        jt, _ = jfg.process(js, jfg.initial_state())
        tt, _ = fg.process(_port_scene(js), fg.initial_state())
        out.append((jt, tt))
    return out


def _same_frame(jt, tt):
    for k in ("Depth", "TriId"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]), err_msg=k)
    for k in ("Main", "Final"):
        assert np.abs(tt[k].numpy() - np.asarray(jt[k])).max() <= 1e-5, k


def _quad_pixels(t):
    tid = t["TriId"].numpy()
    src = t["TriSetup"].src_id.numpy()
    return (tid >= 0) & (src[np.maximum(tid, 0)] >= primitives.plane(30.0).indices.shape[0])


@pytest.mark.parametrize("change", list(CONFIGS.values()), ids=list(CONFIGS))
def test_masked_queue_frames_match_jax(change):
    """Cutout and second layer revealed: the masked quad's checker alpha
    cuts a strict subset of the opaque quad's pixels, and a fully
    transparent masked quad shows the ground behind it; both frames equal
    the reference's."""
    cut = rq._quad_scene(rq._mat_table(1, alpha_tex=_checker()))
    clear = np.ones((8, 8, 4), np.float32)
    clear[..., 3] = 0.0
    gone = rq._quad_scene(rq._mat_table(1, alpha_tex=clear))
    (jc, tc), (jg, tg) = _frames(change, [cut, gone])
    _same_frame(jc, tc)
    _same_frame(jg, tg)
    opaque = _frames(change, [rq._quad_scene(rq._mat_table(0, alpha_tex=_checker()))])[0][1]
    quad_m, quad_o = _quad_pixels(tc), _quad_pixels(opaque)
    assert quad_o.sum() > 200
    assert 0.2 * quad_o.sum() < quad_m.sum() < 0.8 * quad_o.sum()
    assert not (quad_m & ~quad_o).any()
    assert _quad_pixels(tg).sum() == 0
    assert tg["MaskedPeelLayers"] >= 2  # the pixels cut out peeled on


@pytest.mark.parametrize("change", list(CONFIGS.values()), ids=list(CONFIGS))
def test_transparent_blend_matches_jax(change):
    """The exact blend equation: Main - Main(opacity 0) is linear in the
    opacity (test_render_queues.py's oracle), and the frame at opacity 0.5
    equals the reference's."""
    frames = _frames(change, [rq._quad_scene(rq._mat_table(2, opacity1=0.5))])
    _same_frame(*frames[0])
    port = {}
    fg = FrameGraph(FrameGraphAsset.from_yaml(rq._GRAPH), rq.W, rq.H,
                    dict({"bin_capacity": 256, "bin_rounds": 2}, **change), device="cpu")
    for op in (0.0, 0.25):
        js = rq._quad_scene(rq._mat_table(2, opacity1=op))
        port[op] = fg.process(_port_scene(js), fg.initial_state())[0]["Main"].numpy()
    m50 = frames[0][1]["Main"].numpy()
    np.testing.assert_allclose(m50 - port[0.0], 2.0 * (port[0.25] - port[0.0]), atol=5e-3)
    covered = np.abs(m50 - port[0.0]).sum(-1) > 1e-3
    assert covered.sum() > 200


def test_queues_golden():
    """The port's render of test_golden.py's ``queues`` scene (the masked
    checker quad through test_render_queues.py's graph) against
    tests/golden/queues.png at test_golden's bar."""
    import test_golden as tg

    scene = _port_scene(rq._quad_scene(rq._mat_table(1, alpha_tex=_checker())))
    fg = FrameGraph(FrameGraphAsset.from_yaml(rq._GRAPH), rq.W, rq.H,
                    {"bin_capacity": 256, "bin_rounds": 2}, device="cpu")
    state = fg.initial_state()
    fg.prepare(scene, state)
    targets, _ = fg.process(scene, state)
    got = tg._to_u8(targets["Final"].numpy()).astype(np.float32)
    ref = tg.load_png(f"{tg.GOLDEN_DIR}/queues.png").astype(np.float32)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.mean() < 2.5, diff.mean()
    assert np.percentile(diff, 99) < 12, np.percentile(diff, 99)
