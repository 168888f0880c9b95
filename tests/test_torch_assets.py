"""The port's asset importers against the JAX package's, on the CPU.

Every file is written by the test (``torch_asset_files``, and
``chip_smoke.GltfWriter`` for glTF); nothing is downloaded.

- PNG: the port's decoder (``utils.png.decode_png``) against
  ``imageio.v2.imread`` on files of every colour type (grey, RGB, palette,
  grey + alpha, RGBA) and bit depth the format allows, with and without a
  tRNS chunk, every row filter (each on its own and all five mixed), the
  zlib stream cut into several IDAT chunks: dtype, shape and values equal.
  An interlaced file raises.
- ``textures.load`` equal to the reference's for each ``srgb``, ``flip_y``
  and ``generate_mips`` setting.
- glTF: ``load_merged``, ``GLTF.materials`` and ``load_texture_images``
  bit-equal to the reference's on test_assets.py's ``_make_glb``, on a GLB
  with a rotated, scaled and matrix node hierarchy, an interleaved buffer
  view, normalized uint8/uint16 accessors, a primitive without normals and
  one without indices, embedded PNGs and the transmission, ior and volume
  extensions, and on a .gltf with a data-URI buffer, an external .bin and
  an external PNG; chip_smoke.py's content GLBs read equal in both.
- OBJ/MTL: test_assets.py's files (the texture written as PNG, found
  through the .dds name) and a library with an alpha mask, roughness and
  metallic maps (the synthesized ORM image), bit-equal.
- FBX: a binary FBX 7.4 (and 7.5, 64-bit offsets) written by the test,
  bit-equal: zlib-compressed and raw arrays, normal, UV and material
  layers, two Models, two Materials with Properties70, a connected Texture
  and name-convention textures.
- `.mat` and the registry: ``MaterialAsset`` equal to the reference's, the
  registry's scan, load, cache and hot reload as test_assets.py's
  ``test_registry_scan_load_hot_reload``, PNG and GLB loads equal.
- ``MaterialLibrary``: its table's fields equal to the reference's before
  and after an edit of a `.mat` file and the hot reload.
- Small renders: test_assets.py's GLB through the path tracer at 24x24
  (the tracer's parity bar with the reference's uniforms); the textured
  GLB through ``render_content``'s path (floor row, ``from_host``, the whole
  DefaultRenderer frame) at 128x96 (Depth and TriId exact, Main within
  1e-4 relative on >= 99.9% of the pixels more than 16 px from the border
  and >= 99% of all, Final within 2/255); an engine world with a
  ``MaterialLibrary`` at 128x96 through ``EngineLoop`` before and after a
  `.mat` edit (test_editor_material_edit.py without the EditorServer; the
  frame bars of test_torch_world.py, Main over the whole frame at 97%: the
  16-px border band of ROADMAP C 8 is half of a 128x96 frame).
"""

import base64
import dataclasses
import io
import json
import os
import shutil
import time

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sailor_tpu.assets import fbx as jfbx
from sailor_tpu.assets import gltf as jgltf
from sailor_tpu.assets import materials as jmat
from sailor_tpu.assets import objmtl as jobjmtl
from sailor_tpu.assets import textures as jtextures
from sailor_tpu.assets.registry import AssetRegistry as JAssetRegistry
from sailor_tpu_torch.assets import fbx, gltf, materials, objmtl, primitives, textures
from sailor_tpu_torch.assets.registry import AssetRegistry
from sailor_tpu_torch.utils.png import decode_png
from test_assets import _make_glb
from test_torch_material_table import _rows
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)
from torch_asset_files import fbx_scene, png_bytes, rgba_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDERER = os.path.join(REPO, "content", "DefaultRenderer.renderer")

# --- PNG ----------------------------------------------------------------------

_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
PNG_CASES = [(c, d, t) for c, ds in _DEPTHS.items() for d in ds
             for t in ((False, True) if c in (0, 2, 3) else (False,))]


def _png_case(ctype, depth, trns, filters, seed=0, h=9, w=13, interlace=0):
    rng = np.random.default_rng(seed)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1
    palette = tr = None
    if ctype == 3:
        npal = min(1 << depth, 200)
        top = npal - 1
        palette = rng.integers(0, 256, (npal, 3))
        if trns:
            tr = bytes(rng.integers(0, 256, max(1, npal // 2)).astype(np.uint8))
    elif trns:
        tr = bytes(2 * (3 if ctype == 2 else 1))
    s = rng.integers(0, top + 1, (h, w, nch))
    return png_bytes(s, ctype, depth, filters=filters, palette=palette, trns=tr, idat_chunks=3,
                     interlace=interlace)


@pytest.mark.parametrize("ctype,depth,trns", PNG_CASES,
                         ids=[f"c{c}-d{d}{'-trns' if t else ''}" for c, d, t in PNG_CASES])
def test_png_decoder_matches_imageio(ctype, depth, trns):
    for filters in [(f,) for f in range(5)] + [(0, 1, 2, 3, 4), (4, 3, 2, 1, 0)]:
        data = _png_case(ctype, depth, trns, filters, seed=sum(filters) + depth)
        want = np.asarray(imageio.imread(io.BytesIO(data)))
        got = decode_png(data)
        assert got.dtype == want.dtype and got.shape == want.shape, (filters, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=str(filters))


def test_png_interlaced_raises():
    """Adam7 files of every colour type and bit depth decode as imageio reads
    them, at sizes whose small passes are empty (1x1, 2x3, 5x1) and at 9x13
    and 17x10, with every row filter; an unknown interlace method raises."""
    import struct
    import zlib

    for ctype, depth, trns in PNG_CASES:
        for h, w in ((1, 1), (2, 3), (5, 1), (9, 13), (17, 10)):
            filters = (0, 1, 2, 3, 4) if (h + w) % 2 else (4, 3, 2, 1, 0)
            data = _png_case(ctype, depth, trns, filters, seed=h * w + depth, h=h, w=w,
                             interlace=1)
            want = np.asarray(imageio.imread(io.BytesIO(data)))
            got = decode_png(data)
            assert got.dtype == want.dtype and got.shape == want.shape, (ctype, depth, h, w)
            np.testing.assert_array_equal(got, want, err_msg=f"c{ctype} d{depth} {h}x{w}")
    data = _png_case(2, 8, False, (0,))
    # the IHDR chunk (bytes 8-33) with an unknown interlace method, and its CRC
    body = data[16:29][:-1] + b"\x02"
    ihdr = b"IHDR" + body
    bad = data[:8] + struct.pack(">I", 13) + ihdr + struct.pack(
        ">I", zlib.crc32(ihdr) & 0xFFFFFFFF) + data[33:]
    with pytest.raises(ValueError, match="interlace"):
        decode_png(bad)
    assert decode_png(data).shape == (9, 13, 3)


# --- textures.load ------------------------------------------------------------


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(4)
    files = {"rgb8.png": png_bytes(rng.integers(0, 256, (12, 10, 3)), 2, 8, filters=(1, 4)),
             "rgba8.png": png_bytes(rng.integers(0, 256, (8, 8, 4)), 6, 8, filters=(3, 2)),
             "grey16.png": png_bytes(rng.integers(0, 65536, (16, 6)), 0, 16, filters=(2,)),
             "palette4.png": png_bytes(rng.integers(0, 16, (7, 9)), 3, 4,
                                       palette=rng.integers(0, 256, (16, 3)))}
    for name, data in files.items():
        (d / name).write_bytes(data)
    return d, sorted(files)


@pytest.mark.parametrize("srgb", [None, True, False])
@pytest.mark.parametrize("flip_y", [False, True])
@pytest.mark.parametrize("mips", [False, True])
def test_textures_load_matches_reference(image_files, srgb, flip_y, mips):
    d, names = image_files
    for name in names:
        want = jtextures.load(str(d / name), srgb=srgb, flip_y=flip_y, generate_mips=mips)
        got = textures.load(str(d / name), srgb=srgb, flip_y=flip_y, generate_mips=mips)
        want, got = (want, got) if mips else ([want], [got])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=name)


# --- glTF -----------------------------------------------------------------------


def _same(got, want, what=""):
    """Equal nested dicts/lists of arrays: keys, dtypes, shapes, values."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)


def _quat_y(deg):
    a = np.radians(deg) / 2
    return [0.0, float(np.sin(a)), 0.0, float(np.cos(a))]


def hierarchy_glb(rng_seed=2) -> bytes:
    """A textured GLB: a root rotated 30 degrees about y, scaled and
    moved, holding a child placed by a matrix (a cube: interleaved
    position/normal/uv, uint16 indices, material 0 with a PNG albedo and a
    16-bit PNG normal map) and a translated child (a sphere without
    normals, uint32 indices, normalized uint8 COLOR_0 and uint16
    TEXCOORD_0, material 1: Masked, with an emissive and an ORM map); a
    second root holds a primitive without indices (material 2: Blend, with
    the transmission, ior and volume extensions)."""
    rng = np.random.default_rng(rng_seed)
    w = chip_smoke.GltfWriter()
    albedo = w.image_texture(rgba_png(rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)),
                             "image/png")
    normal = w.image_texture(png_bytes(rng.integers(0, 65536, (8, 8, 3)), 2, 16, filters=(4,)),
                             "image/png")
    grey = w.image_texture(png_bytes(rng.integers(0, 4, (8, 8)), 0, 2), "image/png")
    w.material((0.9, 0.8, 0.7), 0.2, 0.5, albedo_texture=albedo, normal_texture=normal)
    w.material((0.4, 0.9, 0.3), 0.0, 0.8, emissive=(0.2, 0.1, 0.0), alphaMode="MASK",
               alphaCutoff=0.4, emissiveTexture={"index": grey})
    w.doc["materials"][1]["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {"index": albedo}
    w.doc["materials"][1]["pbrMetallicRoughness"]["baseColorFactor"][3] = 0.7
    w.material((0.3, 0.5, 0.95), 0.0, 0.1, alphaMode="BLEND", extensions={
        "KHR_materials_transmission": {"transmissionFactor": 0.8},
        "KHR_materials_ior": {"ior": 1.33},
        "KHR_materials_volume": {"attenuationColor": [0.9, 0.95, 1.0],
                                 "attenuationDistance": 2.5}})
    w.doc["materials"][2]["pbrMetallicRoughness"]["baseColorFactor"][3] = 0.5
    cube = primitives.cube(0.8)
    pos, nrm, uv = w.interleaved([cube.positions, cube.normals, cube.uvs])
    cube_mesh = w._add("meshes", {"primitives": [{
        "attributes": {"POSITION": pos, "NORMAL": nrm, "TEXCOORD_0": uv},
        "indices": w.accessor(cube.indices.reshape(-1).astype(np.uint16)), "material": 0}]})
    sph = primitives.uv_sphere(0.5, 8, 12)
    col = (rng.random((len(sph.positions), 4)) * 255).astype(np.uint8)
    uv16 = (np.clip(sph.uvs, 0, 1) * 65535).astype(np.uint16)
    sph_mesh = w._add("meshes", {"primitives": [{
        "attributes": {"POSITION": w.accessor(sph.positions),
                       "COLOR_0": w.accessor(col, normalized=True),
                       "TEXCOORD_0": w.accessor(uv16, normalized=True)},
        "indices": w.accessor(sph.indices.reshape(-1).astype(np.uint32)), "material": 1}]})
    quad = np.array([[-0.6, 1.0, 0.0], [0.6, 1.0, 0.0], [0.6, 2.0, 0.0],
                     [-0.6, 1.0, 0.0], [0.6, 2.0, 0.0], [-0.6, 2.0, 0.0]], np.float32)
    quad_mesh = w._add("meshes", {"primitives": [{
        "attributes": {"POSITION": w.accessor(quad),
                       "NORMAL": w.accessor(np.tile([[0, 0, 1]], (6, 1)).astype(np.float32))},
        "material": 2}]})
    rot = np.eye(4)
    c, s = np.cos(0.4), np.sin(0.4)
    rot[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    rot[:3, 3] = [0.0, 0.6, 0.0]
    a = w.node(False, mesh=cube_mesh, matrix=[float(v) for v in rot.T.reshape(-1)])
    b = w.node(False, mesh=sph_mesh, translation=[1.2, 0.3, 0.0])
    w.node(children=[a, b], rotation=_quat_y(30.0), scale=[1.5, 1.0, 1.5],
           translation=[0.0, 0.5, 0.0])
    w.node(mesh=quad_mesh, translation=[0.0, 0.0, -1.5])
    return w.glb()


def gltf_with_uris(d) -> str:
    """A .gltf whose first buffer is a data URI and second an external
    .bin, with an external PNG image."""
    m = primitives.cube(1.0)
    b0 = m.positions.tobytes() + m.normals.tobytes()
    b1 = m.uvs.tobytes() + m.indices.reshape(-1).astype(np.uint32).tobytes()
    (d / "cube.bin").write_bytes(b1)
    (d / "tex.png").write_bytes(png_bytes(np.arange(48).reshape(4, 4, 3) * 5, 2, 8, filters=(2,)))
    nv = len(m.positions)
    doc = {
        "asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "scale": [2.0, 1.0, 1.0]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                                    "indices": 3, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}], "images": [{"uri": "tex.png"}],
        "buffers": [{"byteLength": len(b0), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(b0).decode()},
                    {"byteLength": len(b1), "uri": "cube.bin"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": nv * 12},
                        {"buffer": 0, "byteOffset": nv * 12, "byteLength": nv * 12},
                        {"buffer": 1, "byteOffset": 0, "byteLength": nv * 8},
                        {"buffer": 1, "byteOffset": nv * 8, "byteLength": m.indices.size * 4}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": nv, "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5126, "count": nv, "type": "VEC3"},
                      {"bufferView": 2, "componentType": 5126, "count": nv, "type": "VEC2"},
                      {"bufferView": 3, "componentType": 5125, "count": m.indices.size,
                       "type": "SCALAR"}]}
    (d / "cube.gltf").write_text(json.dumps(doc))
    return str(d / "cube.gltf")


def _glb_path(tmp_path, name):
    if name == "quad":
        return _make_glb(tmp_path)
    if name == "uris":
        return gltf_with_uris(tmp_path)
    maps = [np.random.default_rng(1).random((16, 16, 4)).astype(np.float32)] * 2
    data = {"hierarchy": hierarchy_glb, "content_flagship": lambda: chip_smoke.flagship_glb(6, maps),
            "content_balls": lambda: chip_smoke.balls_glb(maps, 6, 8)}[name]()
    path = tmp_path / f"{name}.glb"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("name", ["quad", "hierarchy", "uris", "content_flagship",
                                  "content_balls"])
def test_gltf_matches_reference(tmp_path, name):
    path = _glb_path(tmp_path, name)
    _same(gltf.load_merged(path), jgltf.load_merged(path), "load_merged")
    g, jg = gltf.GLTF.load(path), jgltf.GLTF.load(path)
    _same(g.materials(), jg.materials(), "materials")
    imgs = g.load_texture_images()
    _same(imgs, jg.load_texture_images(), "images")
    soup, mats = gltf.load_merged(path)
    assert soup["indices"].max() < len(soup["position"])
    if name == "hierarchy":
        assert len(imgs) == 3 and list(mats["queue"]) == [0, 1, 2]
        assert mats["transmission"][2] == np.float32(0.8) and mats["orm_texture"][1] == 0
    if name == "content_flagship":  # the ground and 6 objects, 8 materials
        assert len(mats["albedo"]) == 8 and len(imgs) == 2
        assert set(soup["material_id"]) == set(range(7))


def test_gltf_non_png_image_raises(tmp_path):
    """A GLB whose image is a JPEG (chip_smoke's writer, as the card's
    content-jpeg phases embed it) loads through the registry and its
    texture equals the reference's ``load_texture_images``; an image the
    port does not decode (OpenEXR) still raises, naming it."""
    from sailor_tpu_torch.scenes import procedural_test_maps

    w = chip_smoke.GltfWriter()
    tex = w.image_texture(chip_smoke.map_jpeg(procedural_test_maps(2, 40)[0]), "image/jpeg")
    w.node(mesh=w.mesh(primitives.plane(1.0), 0))
    w.material((1, 1, 1), 0.0, 0.5, albedo_texture=tex)
    path = tmp_path / "jpeg.glb"
    path.write_bytes(w.glb())
    soup, mats = AssetRegistry(str(tmp_path)).load(str(path))
    assert list(mats["albedo_texture"]) == [0] and len(soup["indices"]) == 2
    got = gltf.GLTF.load(str(path)).load_texture_images()
    want = jgltf.GLTF.load(str(path)).load_texture_images()
    assert len(got) == 1 and got[0].shape == (40, 40, 4)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6, atol=1e-7)
    w.doc["images"] = [{"bufferView": w.view(b"\x76\x2f\x31\x01" + bytes(16))}]
    path.write_bytes(w.glb())
    with pytest.raises(NotImplementedError, match="no OpenEXR decoder"):
        gltf.GLTF.load(str(path)).load_texture_images()


# --- OBJ / MTL ------------------------------------------------------------------


def _obj_files(d):
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[:, :4] = [255, 0, 0, 255]
    tex[:, 4:] = [0, 255, 0, 255]
    (d / "wall.png").write_bytes(rgba_png(tex))
    rng = np.random.default_rng(6)
    (d / "leaf.png").write_bytes(rgba_png(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)))
    (d / "leaf_mask.png").write_bytes(png_bytes(rng.integers(0, 256, (4, 4)), 0, 8))
    (d / "Rough.PNG").write_bytes(png_bytes(rng.integers(0, 256, (8, 8)), 0, 8, filters=(1,)))
    (d / "metal.png").write_bytes(png_bytes(rng.integers(0, 256, (16, 16, 3)), 2, 8))
    (d / "scene.mtl").write_text(
        "newmtl wall\nKd 1.0 1.0 1.0\nNs 50\nmap_Kd wall.dds\n"  # .dds -> .png fallback
        "newmtl glass\nKd 0.9 0.9 1.0\nd 0.4\nNi 1.45\n"
        "newmtl leaf\nKd 0.5 0.8 0.4\nKe 0.1 0 0\nmap_Kd leaf.png\nmap_d leaf_mask.png\n"
        "map_Ns rough.dds\nmap_Ks metal.png\nbump wall.png\n")
    (d / "scene.obj").write_text(
        "mtllib scene.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\n"
        "usemtl wall\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"  # quad -> 2 tris
        "usemtl glass\nf 1/1/1 3/3/1 2/2/1\n"
        "usemtl leaf\nf 1/1 2/2 5/3\nf -1/-1 -4/-2 -5/-3\n")  # no normals, negative indices
    return str(d / "scene.obj")


def test_obj_mtl_matches_reference(tmp_path):
    path = _obj_files(tmp_path)
    got, want = objmtl.load_merged(path), jobjmtl.load_merged(path)
    _same(got, want, "obj")
    soup, table, images = got
    assert soup["indices"].shape == (5, 3) and table["albedo_texture"][0] == 0
    assert table["queue"].tolist() == [0, 2, 1] and table["orm_texture"][2] >= 0
    _same(objmtl.load_mtl(str(tmp_path / "scene.mtl")),
          jobjmtl.load_mtl(str(tmp_path / "scene.mtl")), "mtl")
    _same(objmtl.load_mtl_defaults(), jobjmtl.load_mtl_defaults(), "defaults")
    for rel in ("wall.dds", "ROUGH.dds", "missing.png"):
        assert objmtl._resolve_tex(str(tmp_path), rel) == jobjmtl._resolve_tex(str(tmp_path), rel)


# --- FBX -------------------------------------------------------------------------


@pytest.mark.parametrize("version", [7400, 7500])
def test_fbx_matches_reference(tmp_path, version):
    (tmp_path / "model.fbx").write_bytes(fbx_scene(version))
    tex = tmp_path / "textures"
    tex.mkdir()
    rng = np.random.default_rng(8)
    (tex / "Mat_Stone_Base_Color.png").write_bytes(
        rgba_png(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)))
    (tex / "stone_normal.png").write_bytes(png_bytes(rng.integers(0, 256, (8, 8, 3)), 2, 8))
    (tex / "Mat_Stone_Roughness.png").write_bytes(png_bytes(rng.integers(0, 256, (8, 8)), 0, 8))
    (tex / "Stone_Metallic.png").write_bytes(png_bytes(rng.integers(0, 256, (4, 4)), 0, 8))
    (tex / "cloth.png").write_bytes(png_bytes(rng.integers(0, 256, (4, 4, 3)), 2, 8))
    path = str(tmp_path / "model.fbx")
    got, want = fbx.load_merged(path), jfbx.load_merged(path)
    _same(got, want, "fbx")
    soup, table, images = got
    assert soup["indices"].shape == (5, 3) and len(images) == 4
    assert table["albedo_texture"].tolist() == [0, 3] and table["orm_texture"][0] == 2
    assert sorted(set(soup["material_id"].tolist())) == [0, 1]
    v, nodes = fbx.parse(path)
    assert v == version and [n["name"] for n in nodes] == [
        "FBXHeaderExtension", "Objects", "Connections"]


# --- .mat, registry, MaterialLibrary ---------------------------------------------

FULL_MAT = """\
name: Brick
renderQueue: Masked
blendMode: Alpha
cullMode: None
depthBias: 0.25
enableDepthTest: false
shader: Standard
defines: [ALPHA_TEST, NORMAL_MAP]
uniformsVec4:
  material.albedo: [0.7, 0.3, 0.2, 0.6]
  material.emission: [0.1, 0.0, 0.0, 0.0]
uniformsFloat:
  material.roughness: 0.4
  material.metallic: 0.1
  material.alphaCutoff: 0.3
samplers:
  baseSampler: brick.png
"""


@pytest.mark.parametrize("text", [FULL_MAT, "", FULL_MAT.replace("Masked", "Transparent")],
                         ids=["full", "empty", "transparent"])
def test_material_asset_matches_reference(text):
    got = materials.MaterialAsset.from_yaml(text, "x.mat")
    want = jmat.MaterialAsset.from_yaml(text, "x.mat")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_table_row() == want.to_table_row()


def test_registry_scan_load_hot_reload(tmp_path):
    """test_assets.py's registry test on the port, and PNG and GLB loads
    through the registry equal to the reference registry's."""
    content = tmp_path / "content"
    content.mkdir()
    mat = content / "red.mat"
    mat.write_text("uniformsVec4:\n  material.albedo: [1.0, 0.0, 0.0, 1.0]\n")
    (content / "world.world").write_text("name: W\ngameObjects: []\n")
    (content / "t.png").write_bytes(png_bytes(np.arange(12).reshape(2, 2, 3) * 20, 2, 8))
    (content / "t.png.asset").write_text("import:\n  srgb: false\n  flip_y: true\n")
    shutil.copy(_make_glb(tmp_path), content / "quad.glb")
    reg, jreg = AssetRegistry(str(content)), JAssetRegistry(str(content))
    assert reg.scan_content_folder() == 4
    assert jreg.scan_content_folder() == 4
    import yaml

    assert "fileId" in yaml.safe_load((content / "red.mat.asset").read_text())
    assert reg.infos[str(mat)].file_id == jreg.infos[str(mat)].file_id
    m = reg.load(str(mat))
    assert m.to_table_row()["albedo"] == [1.0, 0.0, 0.0]
    assert reg.load(str(mat)) is m  # cached
    for name in ("t.png", "quad.glb"):
        _same(reg.load(name), jreg.load(name), name)
    events = []
    reg.add_hot_reload_listener(lambda info: events.append(info.path))
    time.sleep(0.01)
    mat.write_text("uniformsVec4:\n  material.albedo: [0.0, 1.0, 0.0, 1.0]\n")
    os.utime(mat, (time.time() + 1, time.time() + 1))
    assert len(reg.check_hot_reload()) == 1 and events == [str(mat)]
    assert reg.load(str(mat)).to_table_row()["albedo"] == [0.0, 1.0, 0.0]


def tables_equal(got, want):
    """A port MaterialTable equal to a reference one, field by field (the
    reference's int32-packed u8 quad rows unpacked). One dtype differs by
    design: the reference keeps a parameter row of Python ints as int32
    (``MaterialAsset.to_table_row``'s default emission [0, 0, 0]); the
    port's ``from_host`` stores its parameter rows as float32."""
    nbytes = sum(4 * n for _, (_, n) in want.quad_offsets)
    for f in materials.TENSOR_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            w = _rows(w, nbytes) if f in ("tex_quad", "tex_quad_mip0") else np.asarray(w)
            if f in ("albedo", "metallic", "roughness", "emissive") and w.dtype == np.int32:
                w = w.astype(np.float32)
            assert g.numpy().dtype == w.dtype, f
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    for f in materials.HOST_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


LIB_MATS = {
    "stone.mat": "uniformsVec4:\n  material.albedo: [0.6, 0.6, 0.55, 1.0]\n"
                 "uniformsFloat:\n  material.roughness: 0.8\n"
                 "samplers:\n  baseSampler: stone.png\n  normalSampler: bumps.png\n",
    "leaf.mat": "renderQueue: Masked\nuniformsVec4:\n  material.albedo: [0.4, 0.8, 0.3, 1.0]\n"
                "samplers:\n  albedoSampler: leaf.png\n",
    "glass.mat": "renderQueue: Transparent\nuniformsVec4:\n"
                 "  material.albedo: [0.5, 0.7, 0.9, 0.4]\n",
}


def write_library(d):
    rng = np.random.default_rng(9)
    (d / "stone.png").write_bytes(rgba_png(rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)))
    (d / "bumps.png").write_bytes(png_bytes(rng.integers(0, 256, (8, 8, 3)), 2, 8, filters=(4,)))
    leaf = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    leaf[::3, :, 3] = 0
    (d / "leaf.png").write_bytes(rgba_png(leaf))
    for name, text in LIB_MATS.items():
        (d / name).write_text(text)
    return [str(d / n) for n in LIB_MATS]


def _edit(path, text):
    with open(path, "w") as f:
        f.write(text)
    t = time.time() + 5
    os.utime(path, (t, t))


def test_material_library_matches_reference(tmp_path):
    paths = write_library(tmp_path)
    reg, jreg = AssetRegistry(str(tmp_path)), JAssetRegistry(str(tmp_path))
    reg.scan_content_folder()
    jreg.scan_content_folder()
    lib = materials.MaterialLibrary(reg, paths, texture_size=16, mips=True, device="cpu")
    jlib = jmat.MaterialLibrary(jreg, paths, texture_size=16, mips=True)
    assert lib.version == jlib.version == 1
    tables_equal(lib.table, jlib.table)
    first = lib.table
    _edit(paths[0], LIB_MATS["stone.mat"].replace("0.6, 0.6, 0.55", "0.1, 0.9, 0.2"))
    assert len(reg.check_hot_reload()) == 1 and len(jreg.check_hot_reload()) == 1
    assert lib.version == jlib.version == 2 and lib.table is not first
    tables_equal(lib.table, jlib.table)
    np.testing.assert_array_equal(lib.table.albedo[0].numpy(),
                                  np.float32([0.1, 0.9, 0.2]))


# --- small renders ----------------------------------------------------------------


def test_glb_renders_in_path_tracer(tmp_path):
    """test_assets.py's GLB through both path tracers at 24x24."""
    from sailor_tpu.core import math3d as jm3
    from sailor_tpu.raytracing import path_tracer as jpt
    from sailor_tpu_torch.raytracing import path_tracer as pt
    from test_torch_path_tracer import jax_uniforms

    path = _make_glb(tmp_path)
    soup, mats = gltf.load_merged(path)
    jsoup, jmats = jgltf.load_merged(path)
    mats.pop("albedo_texture")
    jmats.pop("albedo_texture")
    ref = jpt.scene_from_mesh(jsoup, jmats)
    scene = pt.scene_from_mesh(soup, mats, device="cpu")
    cam = jnp.asarray([2.0, 3.0, 3.0])
    view = jm3.look_at(cam, jnp.asarray([2.0, 0.0, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    proj = jm3.perspective(jnp.pi / 3, 1.0, 0.1, 50.0)
    key = jax.random.PRNGKey(0)
    w = h = 24
    want, want_rays = jpt.render(ref, cam, view, proj, width=w, height=h, spp=2,
                                 max_bounces=2, key=key)
    uniforms = jax_uniforms(key, 2, 2, pt.rays_per_sample(w, h))
    got, rays = pt.render(scene, *(torch.from_numpy(np.array(a)) for a in (cam, view, proj)),
                          width=w, height=h, spp=2, max_bounces=2,
                          uniforms=torch.from_numpy(uniforms))
    want = np.asarray(want)
    assert float(rays) == float(want_rays)
    close = np.abs(got.numpy() - want).max(-1) <= 1e-3 * (1 + np.abs(want).max(-1))
    assert close.mean() >= 0.99, close.mean()
    c = got.numpy()[12, 12]
    assert c[0] > c[2]  # the reddish quad in the centre


CW, CH = 128, 96
CONTENT_CONFIG = {"z_far": 60.0, "shadow_resolution": 128, "env_resolution": 16,
                  "bin_capacity": 256, "bin_rounds": 2, "sky_clouds": False}


def content_arrays(path):
    """tests/test_golden.py's render_content inputs for a GLB: (geometry
    arrays, host table, images), the floor plane and its material row
    appended, through the reference's loader."""
    soup, mats = jgltf.load_merged(path)
    images = jgltf.GLTF.load(path).load_texture_images()
    floor = primitives.merge([(primitives.plane(12.0), np.eye(4))])
    n_mat = len(mats["albedo"])
    geo = {k: np.concatenate([np.asarray(floor[k], np.float32 if k != "indices" else np.int32),
                              np.asarray(soup[k], np.float32 if k != "indices" else np.int32)
                              + (len(floor["position"]) if k == "indices" else 0)])
           for k in ("position", "normal", "uv", "color", "indices")}
    geo["material_id"] = np.concatenate([np.full(len(floor["indices"]), n_mat, np.int32),
                                         np.asarray(soup["material_id"], np.int32)])
    floor_row = {"albedo": [[0.55, 0.55, 0.58]], "metallic": [0.0], "roughness": [0.75],
                 "emissive": [[0, 0, 0]], "albedo_texture": [-1], "normal_texture": [-1],
                 "queue": [0], "alpha_cutoff": [0.5], "opacity": [1.0]}
    table = {k: np.concatenate([np.asarray(v), np.asarray(floor_row[k], np.asarray(v).dtype)])
             for k, v in mats.items() if k in floor_row}
    return geo, table, images


def test_render_content_matches_reference(tmp_path):
    """render_content's path on the hierarchy GLB at 128x96."""
    from sailor_tpu.core import math3d as jm3
    from sailor_tpu.framegraph import FrameGraph as JFrameGraph
    from sailor_tpu.framegraph import FrameGraphAsset as JAsset
    from sailor_tpu.kernels import pbr_pallas as j_pk
    from sailor_tpu.kernels.lights import DIRECTIONAL, Lights
    from sailor_tpu.kernels.sky import SkyParams
    from sailor_tpu.raster.setup import Geometry
    from sailor_tpu.rhi.scene_view import SceneView
    from sailor_tpu.rhi.types import FrameData
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.rhi.scene_view import scene_from_numpy
    from test_torch_scenes import scene_arrays
    from test_torch_world import check_frame

    path = str(tmp_path / "h.glb")
    with open(path, "wb") as f:
        f.write(hierarchy_glb())
    geo, table, images = content_arrays(path)
    # the port's loader gives the same arrays (test_gltf_matches_reference)
    jm = jmat.MaterialTable.from_host(table, images, texture_size=32)
    tm = materials.MaterialTable.from_host(table, images, texture_size=32, device="cpu")
    tables_equal(tm, jm)
    lights = Lights.from_host(types=[DIRECTIONAL], positions=[[0, 0, 0]],
                              directions=[[-0.4, -0.75, -0.35]], intensities=[[3.2, 3.0, 2.7]],
                              attenuations=[[1, 0, 0]], radii=[0.0])
    cam = jnp.asarray([2.6, 2.2, 3.2])
    view = jm3.look_at(cam, jnp.asarray([0.0, 0.9, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    proj = jm3.perspective(jnp.pi / 3, CW / CH, 0.1, 60.0)
    frame = FrameData.create(view, proj, cam, 0.1, 60.0, time=0.0, dt=1 / 60)
    js = SceneView.create(Geometry(**{k: jnp.asarray(v) for k, v in geo.items()}), lights,
                          frame, sky=SkyParams.default(sun_direction=(-0.4, -0.75, -0.35)),
                          materials=jm)
    arrays = scene_arrays(js)
    arrays.update({"materials." + f: getattr(jm, f)
                   for f in materials.TENSOR_FIELDS + materials.HOST_FIELDS})
    ts = scene_from_numpy(arrays, "cpu")
    keys = ("Depth", "TriId", "LightIndices", "Main", "Final")
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        jfg = JFrameGraph(JAsset.load(RENDERER), CW, CH, config=dict(CONTENT_CONFIG))
        state = jfg.initial_state()
        jfg.prepare(js, state)
        jt, _ = jfg.process(js, state)
        ref = {k: np.asarray(jt[k]) for k in keys}
    finally:
        mp.undo()
        jax.clear_caches()
    fg = FrameGraph(FrameGraphAsset.load(RENDERER), CW, CH, dict(CONTENT_CONFIG), device="cpu")
    state = fg.initial_state()
    fg.prepare(ts, state)
    tt, _ = fg.process(ts, state)
    got = {k: tt[k].numpy() for k in keys}
    check_frame(got, ref, main_all=0.99)
    # the textured model is on screen: ids of the GLB's triangles (past the floor's 2)
    assert (got["TriId"] >= 4).mean() > 0.05


def test_engine_material_library_matches_reference(tmp_path):
    """An engine world whose objects use three .mat files (one with an
    albedo and a normal map, one Masked, one Transparent) through both
    EngineLoops at 128x96: a frame, an edit of stone.mat and the hot
    reload, then the next frame, each against the reference."""
    from sailor_tpu.engine.app import EngineLoop as JEngineLoop
    from sailor_tpu.engine.app import Renderer as JRenderer
    from sailor_tpu.engine.world import World as JWorld
    from sailor_tpu.kernels import pbr_pallas as j_pk
    from sailor_tpu.kernels.sky import SkyParams as JSkyParams
    from sailor_tpu_torch.engine import World
    from sailor_tpu_torch.engine.app import EngineLoop, Renderer
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.scenes import flagship_world_doc
    from test_torch_world import SUN, TEST_CONFIG, check_frame

    paths = write_library(tmp_path)
    doc = flagship_world_doc(8, 6, aspect=CW / CH)
    for i, o in enumerate(doc["gameObjects"]):
        for c in o["components"]:
            if c["typename"] == "MeshRendererComponent":
                c["material_id"] = i % 3
    reg, jreg = AssetRegistry(str(tmp_path)), JAssetRegistry(str(tmp_path))
    reg.scan_content_folder()
    jreg.scan_content_folder()
    world, jworld = World.deserialize(doc, device="cpu"), JWorld.deserialize(doc)
    world.materials = materials.MaterialLibrary(reg, paths, texture_size=16, mips=True,
                                                device="cpu")
    jworld.materials = jmat.MaterialLibrary(jreg, paths, texture_size=16, mips=True)
    loop = EngineLoop(world, Renderer(RENDERER, CW, CH, config=dict(TEST_CONFIG), device="cpu"),
                      sky=SkyParams.default(sun_direction=SUN))
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        jloop = JEngineLoop(jworld, JRenderer(RENDERER, CW, CH, config=dict(TEST_CONFIG)),
                            sky=JSkyParams.default(sun_direction=SUN))
        frames = []
        for step in range(2):
            if step == 1:
                _edit(paths[0], LIB_MATS["stone.mat"].replace("0.6, 0.6, 0.55", "0.1, 0.9, 0.2"))
                assert len(reg.check_hot_reload()) == len(jreg.check_hot_reload()) == 1
                assert world.materials.version == jworld.materials.version == 2
                tables_equal(world.materials.table, jworld.materials.table)
            tt = loop.process_cpu_frame(1 / 60)
            jt = jloop.process_cpu_frame(1 / 60)
            got = {k: v.numpy() for k, v in tt.items() if torch.is_tensor(v)}
            ref = {k: np.asarray(jt[k]) for k in got}
            # at 128x96 the 16-px border band is half the frame: Main is held
            # at 99.9% inside it and at 97% over all (measured 97.9%; every
            # miss in the band, where the reference's compiled HBAO clamps
            # its taps otherwise, ROADMAP C 8)
            check_frame(got, ref, main_all=0.97)
            frames.append(got)
    finally:
        mp.undo()
        jax.clear_caches()
    # the edit shows: stone's pixels change, and turn green
    mid = world.meshes.geometry.material_id.numpy()
    src = np.repeat(np.arange(mid.shape[0]), 2)
    tid = frames[1]["TriId"]
    stone = (tid >= 0) & (mid[src[np.maximum(tid, 0)]] == 0)
    assert stone.sum() > 100
    d = frames[1]["Main"] - frames[0]["Main"]
    assert (d[stone][:, 1] > d[stone][:, 0]).mean() > 0.9
