"""The port stands alone and refuses what it does not implement.

- Importing every module of sailor_tpu_torch (the importers, the particles,
  the new nodes, the examples, the editor, the native bridge, bounds,
  octree, profiler and benchmarks among them), and chip_smoke, loads no
  jax and no sailor_tpu module, and building a BVH8 table and starting a
  scheduler load the port's own host libraries, not the JAX package's
  native/libsailor_native.so, and decoding a JPEG loads the port's image
  library and no Pillow or imageio (checked in a fresh interpreter);
- no source line of the port imports them;
- entry points default to the CUDA device and raise when there is none
  (the engine's World, Renderer and CLI without --cpu too);
- kernel wrappers take CUDA tensors only, and the dispatch runs the plain
  version only for CPU tensors: nothing falls back;
- configuration, nodes and inputs outside the ported slices raise
  NotImplementedError, and every raster configuration builds, as do HiZ
  culling, ShadowPrepass, DepthHighZ and the whole DefaultRenderer graph
  (content/DefaultRenderer.renderer) at the flagship size; a scene's
  material table renders (Masked and Transparent queues included) and
  anything else in its place raises TypeError; the path tracer's textures,
  env-map sky and ray sorting inside the intersector run, and so do
  ``tracer="bvh8"`` (no sweep built) and "auto" over MAX_SWEEP_TRIANGLES
  (no sweep; every pass takes the BVH8 traversal); the asset registry's
  OpenEXR importer raises NotImplementedError and an empty JPEG, GIF, BMP,
  TGA or HDR file ValueError naming its format, asynchronous loads run, and an unknown tonemap mode raises ValueError as
  the frame graph is built;
- no source line of the port imports Pillow or imageio (the card's machine
  has neither).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sailor_tpu_torch.__main__ import main as engine_main
from sailor_tpu_torch.assets.registry import AssetRegistry, load_async
from sailor_tpu_torch.engine import World
from sailor_tpu_torch.engine.app import Renderer
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.kernels import cubemap, ibl, pbr_kernel
from sailor_tpu_torch.kernels.sky import SkyParams
from sailor_tpu_torch.raster import tile_raster
from sailor_tpu_torch.raytracing import path_tracer, sweep
from sailor_tpu_torch.scenes import (dense_tracer_scene, flagship_queue_scene, flagship_scene,
                                     tracer_camera, tracer_scene, tracer_soup)
from test_torch_scenes import (FULL_CONFIG, MINIMAL_GRAPH, SHADOW_HIZ_CONFIG, SHADOW_HIZ_GRAPH,
                               SLICE_CONFIG)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sailor_tpu_torch")

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import sailor_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sailor_tpu_torch.__path__, "sailor_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {{"sailor_tpu_torch.assets." + m for m in ("gltf", "objmtl", "fbx", "textures",
                                                "particles")}} <= set(names)
assert {{"sailor_tpu_torch.kernels.particles", "sailor_tpu_torch.utils.png"}} <= set(names)
assert {{"sailor_tpu_torch." + m for m in (
    "examples.render_frame", "examples.trace", "engine.editor_server", "engine.editor_web",
    "native_bridge", "core.bounds", "core.octree", "utils.profiler", "utils.benchmarks")}} <= set(names)
import chip_smoke
import numpy as np
from sailor_tpu_torch.raytracing import bvh8
v = np.random.default_rng(0).random((3, 20, 3)).astype(np.float32)
assert len(bvh8.build_table(*v)) > 1
from sailor_tpu_torch import native_bridge
native_bridge.Scheduler(1).shutdown()
maps = open("/proc/self/maps").read()
assert "libsailor_torch_host" in maps and "libsailor_native" not in maps
assert "libsailor_torch_runtime" in maps
from sailor_tpu_torch.utils import gif, jpeg
rgb = jpeg.decode_jpeg(chip_smoke.jpeg_bytes(np.zeros((9, 17, 3), np.uint8)))
assert rgb.shape == (9, 17, 3)
assert "libsailor_torch_image" in open("/proc/self/maps").read()
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "sailor_tpu", "PIL", "imageio"))
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_reference():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_no_source_line_imports_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|sailor_tpu|PIL|imageio)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = [(f, line) for f in files for line in open(f).read().splitlines()
            if pat.match(line)]
    assert len(files) > 20 and hits == []


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 256, 128, SLICE_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_scene(256, 128, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tracer_scene(rings=4, sectors=8, spheres=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        path_tracer.scene_from_mesh(tracer_soup(4, 8, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        cubemap.face_directions(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        cubemap.render_cubemap(lambda d: d, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ibl.brdf_lut(4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        World()
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(os.path.join(REPO, "content", "DefaultRenderer.renderer"), 64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_main(["--world", os.path.join(REPO, "content", "Editor.world"),
                     "--width", "64", "--height", "64", "--frames", "1"])


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".bmp", ".tga", ".gif", ".hdr", ".exr"])
def test_unported_importers_raise(tmp_path, ext):
    """The registry knows the reference's image extensions. OpenEXR has no
    decoder in the port (imageio needs an optional plugin) and raises an error that
    names the format and the missing decoder; JPEG, GIF, BMP, TGA and
    Radiance HDR decode (tests/test_torch_jpeg.py, test_torch_gif.py,
    test_torch_image_formats.py), and a truncated (empty) file raises an
    error that names the format."""
    fmt = {".jpg": "JPEG", ".jpeg": "JPEG", ".bmp": "BMP", ".tga": "TGA", ".gif": "GIF",
           ".hdr": "Radiance HDR", ".exr": "OpenEXR"}[ext]
    path = tmp_path / f"asset{ext}"
    path.write_bytes(b"")
    reg = AssetRegistry(str(tmp_path))
    assert reg.scan_content_folder() == 1
    if ext != ".exr":
        with pytest.raises(ValueError, match=f"^{fmt}: "):
            reg.load(str(path))
    else:
        with pytest.raises(NotImplementedError, match=f"no {fmt} decoder"):
            reg.load(str(path))


def test_unported_engine_inputs_raise():
    """Asynchronous loads no longer refuse: they run on the port's native
    scheduler (tests/test_torch_native.py holds them to ``load``)."""
    doc = load_async(AssetRegistry(), os.path.join(REPO, "content", "Editor.world")).wait(60)
    assert doc["gameObjects"]


def test_kernel_wrappers_take_cuda_tensors_only():
    rows = torch.zeros(256, 54)
    big = torch.zeros(32, 54)
    st = torch.zeros(1, dtype=torch.int32)
    n_big = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        tile_raster.rasterize_worklist_cuda(rows, big, st, st, n_big, tiles_y=1, tiles_x=1)
    with pytest.raises(ValueError, match="cuda"):
        tile_raster.resolve_worklist_cuda(rows, big, torch.zeros(64, 128, dtype=torch.int32),
                                          st, st, torch.zeros(32), tiles_y=1, tiles_x=1, na=37)
    with pytest.raises(ValueError, match="cuda"):
        pbr_kernel.shade_tiles_cuda(torch.zeros(5, 16), torch.zeros(1, 1, 4, dtype=torch.int32),
                                    st.reshape(1, 1), torch.zeros(16, 16, 4), torch.zeros(16, 16),
                                    torch.zeros(16, 16), torch.zeros(16, 16, 3),
                                    torch.zeros(16, 16, 3), None, torch.zeros(3))
    feats = torch.zeros(2048, 16)
    with pytest.raises(ValueError, match="cuda"):
        sweep.visit_tables_cuda(feats[:, :3], feats[:, :3], torch.zeros(2048), torch.zeros(2, 3),
                                torch.zeros(2, 3))
    i32 = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        sweep.sweep_cuda(torch.zeros(8, 2, dtype=torch.int32), i32, i32,
                         torch.zeros(1, dtype=torch.int32), feats, torch.zeros(2048),
                         torch.zeros(2, 40, 256), any_hit=False)
    with pytest.raises(ValueError, match="cuda"):
        sweep.sweep_grid_cuda(torch.zeros(8, 2, dtype=torch.int32), i32, feats,
                              torch.zeros(2048), torch.zeros(2, 40, 256), any_hit=True)
    with pytest.raises(ValueError, match="no kernel"):
        tile_raster.rasterize_worklist(None, None, None, st, st, None, n_big, tiles_y=1,
                                       tiles_x=1, prebuilt=(rows.to("meta"), big.to("meta")))


@pytest.mark.parametrize("kernel", ["stream", "stream_mxu", "dma", "dense", "resolve_stream"])
def test_variant_kernel_wrappers_take_cuda_tensors_only(kernel):
    rows = torch.zeros(256, 54)
    big = torch.zeros(128, 54)
    st = torch.zeros(1, dtype=torch.int32)
    n_big = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        if kernel.startswith("stream"):
            tile_raster.rasterize_stream_cuda(rows, big, st, st, n_big, tiles_y=1, tiles_x=1,
                                              mxu=kernel == "stream_mxu")
        elif kernel == "dma":
            tile_raster.rasterize_dma_cuda(rows, big, st, st, n_big, tiles_y=1, tiles_x=1)
        elif kernel == "dense":
            tile_raster.rasterize_tiles_cuda(torch.zeros(64, 16),
                                             torch.zeros(64, dtype=torch.int32), st,
                                             tiles_y=1, tiles_x=1)
        else:
            tile_raster.resolve_stream_cuda(rows, big, torch.zeros(64, 128, dtype=torch.int32),
                                            st, st, st, st, torch.zeros(32), tiles_y=1,
                                            tiles_x=1, na=37)


@pytest.mark.parametrize("change", [
    {"tonemap": "filmic"},
], ids=lambda c: next(iter(c)))
def test_unsupported_config_raises(change):
    """A tonemap mode that no operator implements (the four modes are
    test_torch_tonemap.py's)."""
    with pytest.raises(ValueError, match="unknown tonemap mode"):
        FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 256, 128,
                   dict(SLICE_CONFIG, **change), device="cpu")


@pytest.mark.parametrize("change", [
    {"raster_mode": "dense"}, {"raster_mode": "dma"}, {"raster_worklist": False},
    {"raster_worklist": False, "raster_mxu": True}, {"fused_resolve": False},
], ids=["dense", "dma", "stream", "stream_mxu", "gather_resolve"])
def test_raster_configs_are_ported(change):
    """Every raster configuration the reference's frame graph accepts builds
    (test_torch_frame.py renders each against the reference)."""
    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 256, 128,
                    dict(SLICE_CONFIG, **change), device="cpu")
    assert fg.config == dict(SLICE_CONFIG, **change)


def test_shadow_hiz_frame_is_ported():
    """HiZ culling (the reference's default), ShadowPrepass and DepthHighZ
    build, and the state carries the CSM cache and the HiZ pyramid."""
    fg = FrameGraph(FrameGraphAsset.from_nodes(SHADOW_HIZ_GRAPH), 256, 128,
                    dict(SHADOW_HIZ_CONFIG, shadow_resolution=64), device="cpu")
    state = fg.initial_state()
    assert state["csm/maps"].shape == (4, 64, 64) and state["csm/evsm"].shape == (4, 64, 64, 4)
    assert [state[f"hiz/mip{i}"].shape for i in range(6)] == [
        (32, 64), (16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]


def test_default_renderer_is_ported():
    """Every entry of content/DefaultRenderer.renderer builds at the
    flagship size with bench.py's config; the state carries the sky cache."""
    fg = FrameGraph(FrameGraphAsset.load(os.path.join(REPO, "content", "DefaultRenderer.renderer")),
                    1920, 1088, dict(FULL_CONFIG), device="cpu")
    assert len(fg.nodes) == 18
    state = fg.initial_state()
    assert state["sky/buf"].shape == (1088, 1920, 3) and state["sky/key"].shape == (18,)


def test_sharding_raises():
    """process_sharded is ported (tests/test_torch_parallel.py); a height
    that does not split into 32-row tile rows a shard raises the
    reference's ValueError."""
    from sailor_tpu_torch.parallel import make_mesh

    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 64, 64, SLICE_CONFIG,
                    device="cpu")
    with pytest.raises(ValueError, match="32-px tile rows"):
        fg.process_sharded(None, {}, make_mesh(4, device="cpu"))


def test_materials_raise():
    """Materials are ported: a MaterialTable renders, anything else in its
    place raises."""
    scene, _, _ = flagship_queue_scene(64, 64, 2, 3, device="cpu")
    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH + ["RenderTransparent"]), 64, 64,
                    SLICE_CONFIG, device="cpu")
    targets, _ = fg.process(scene, fg.initial_state())
    assert bool(torch.isfinite(targets["Final"]).all())
    scene.materials = np.zeros(1)
    with pytest.raises(TypeError):
        fg.process(scene, fg.initial_state())


def _small_tracer():
    return tracer_scene("cpu", rings=4, sectors=8, spheres=1)


@pytest.mark.parametrize("what", ["albedo_texture", "normal_texture", "orm_texture",
                                  "emissive_texture", "images"])
def test_tracer_textures_are_ported(what):
    """A material with one map (or images but no map) builds and renders."""
    m = {"albedo": np.ones((1, 3), np.float32), "metallic": np.zeros(1, np.float32),
         "roughness": np.ones(1, np.float32), "emissive": np.ones((1, 3), np.float32),
         "images": [np.full((4, 4, 4), 0.5, np.float32)], "texture_size": 8}
    if what != "images":
        m[what] = np.zeros(1, np.int32)
    scene = path_tracer.scene_from_mesh(tracer_soup(4, 8, 1), m, device="cpu")
    kind = what.split("_")[0]
    assert scene.has_textures == (what != "images")
    assert scene.textures.shape == (1, 8, 8, 4) and scene.mip_sizes == (8, 4)
    assert [b[0] for b in scene.quad_blocks] == ([] if what == "images" else [kind])
    for k in ("normal", "orm", "emissive"):
        assert getattr(scene, f"has_{k}_maps") == (kind == k)
    img, rays = path_tracer.render(scene, *tracer_camera("cpu"), width=16, height=16, spp=1,
                                   max_bounces=2)
    assert bool(torch.isfinite(img).all()) and float(rays) > 0


def test_tracer_env_sky_is_ported():
    scene = path_tracer.scene_from_mesh(tracer_soup(4, 8, 1), sky=SkyParams.default(),
                                        env_size=(8, 16), device="cpu")
    assert scene.env_map.shape == (8, 16, 3) and bool((scene.env_map > 0).all())
    d = torch.nn.functional.normalize(torch.randn(64, 3), dim=1)
    assert bool(torch.isfinite(path_tracer.sky_radiance(scene, d)).all())


def _count_passes(monkeypatch):
    """Count the intersector passes each route takes."""
    counts = {"sweep": 0, "bvh8": 0}
    for name, mod in (("sweep", path_tracer.sweep_mod), ("bvh8", path_tracer.bvh8_mod)):
        def counted(*args, _f=mod.intersect, _n=name, **kw):
            counts[_n] += 1
            return _f(*args, **kw)
        monkeypatch.setattr(mod, "intersect", counted)
    return counts


def test_tracer_bvh8_builds_no_sweep_and_traces(monkeypatch):
    scene = path_tracer.scene_from_mesh(tracer_soup(4, 8, 1), tracer="bvh8", device="cpu")
    assert scene.sweep is None and scene.bvh.num_tris == scene.tri_pack.shape[0]
    counts = _count_passes(monkeypatch)
    img, rays = path_tracer.render(scene, *tracer_camera("cpu"), width=16, height=16, spp=1,
                                   max_bounces=2)
    assert counts == {"sweep": 0, "bvh8": 4}
    assert bool(torch.isfinite(img).all()) and float(rays) > 16 * 16
    with pytest.raises(ValueError, match="tracer"):
        path_tracer.scene_from_mesh(tracer_soup(4, 8, 1), tracer="binary", device="cpu")


def test_tracer_auto_over_the_sweep_limit_routes_to_bvh8(monkeypatch):
    scene, cam, view, proj = dense_tracer_scene("cpu")
    assert scene.tri_pack.shape[0] == 294914 > path_tracer.MAX_SWEEP_TRIANGLES
    assert scene.sweep is None
    counts = _count_passes(monkeypatch)
    img, rays = path_tracer.render_cached(scene, cam, view, proj, width=8, height=8, spp=1,
                                          max_bounces=2)
    assert counts == {"sweep": 0, "bvh8": 4}
    assert bool(torch.isfinite(img).all()) and float(rays) > 64


def test_tracer_sort_rays_is_ported():
    """Sorting the rays inside the intersector gives the unsorted hits."""
    scene, *_ = _small_tracer()
    gen = torch.Generator().manual_seed(0)
    o = torch.rand(3000, 3, generator=gen) * torch.tensor([8.0, 2.0, 8.0]) + torch.tensor(
        [-4.0, 0.05, -4.0])
    d = torch.nn.functional.normalize(torch.randn(3000, 3, generator=gen), dim=1)
    plain = sweep.intersect(scene.sweep, o, d)
    sorted_ = sweep.intersect(scene.sweep, o, d, sort_rays=True)
    assert 0.1 < plain["hit"].float().mean() < 0.9
    for k in ("hit", "tri", "t", "u", "v"):
        assert torch.equal(sorted_[k], plain[k]), k
    assert tracer_camera("cpu")[0].device.type == "cpu"
