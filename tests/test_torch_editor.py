"""The port's editor protocol and web front end (engine/editor_server.py,
engine/editor_web.py) against the JAX package's, on the CPU.

- tests/test_editor_web.py, tests/test_editor_material_edit.py and
  tests/test_engine_aux.py::test_editor_server_roundtrip on the port, in a
  temporary copy of content/ (the registry writes `.asset` sidecars);
- the same requests to both packages' EditorWebApp over the same world
  and content give equal payloads: the page, /api/world (Editor.world
  names its instance ids), /api/update and /api/input, /api/content (both
  registries read the same sidecars, so the file ids agree) and
  /api/asset for a .mat, the .renderer, a PNG texture (the port's decoder
  against imageio, the thumbnail PNG byte for byte) and a GLB's summary;
  a BMP texture's preview is a 500 naming the missing decoder on the port;
- ``update_asset``'s .mat file byte-equal to the reference's after the
  same patch;
- the material edit: both packages render the reference test's world at
  96x64 with its config, before and after the .mat edit through
  ``EditorServer.update_asset``, each frame held at the engine tests'
  bars (test_torch_world.check_frame's, its coverage floor aside: Depth,
  TriId and LightIndices exact, Main within 1e-4 relative on >= 99.9% of
  the pixels more than 16 px from the border and on >= 97% of all, as
  test_torch_assets.py's material-library frames at 128x96, Final within
  2/255), and the box turns green in the port's next frame;
- the live server: ``make_server`` on port 0 with the render loop running
  (a 96x64 frame graph), GET and POST over a socket, a frame PNG the loop
  rendered after an edit, the loop and server stopped.
"""

import http.client
import json
import os
import shutil
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
import yaml

from sailor_tpu.assets.registry import AssetRegistry as JAssetRegistry
from sailor_tpu.engine.editor_server import EditorServer as JEditorServer
from sailor_tpu.engine.editor_web import EditorWebApp as JEditorWebApp
from sailor_tpu_torch.assets.registry import AssetRegistry
from sailor_tpu_torch.engine import input as ik
from sailor_tpu_torch.engine.components import MeshRendererComponent
from sailor_tpu_torch.engine.editor_server import EditorServer
from sailor_tpu_torch.engine.editor_web import EditorWebApp
from sailor_tpu_torch.utils.png import SIGNATURE, decode_png, encode_png
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDERER = os.path.join(REPO, "content", "DefaultRenderer.renderer")
RED_MAT = """\
name: TestRed
renderQueue: Opaque
shader: Standard
uniformsVec4:
  material.albedo: [0.9, 0.05, 0.05, 1.0]
uniformsFloat:
  material.roughness: 0.6
  material.metallic: 0.0
"""
EDIT_CONFIG = {"bin_capacity": 256, "bin_rounds": 2, "sky_clouds": False,
               "shadow_resolution": 128, "env_resolution": 16}


@pytest.fixture
def content_copy(tmp_path, monkeypatch):
    """A working directory holding a copy of content/, a PNG texture, a GLB
    and a .mat."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from sailor_tpu_torch.scenes import procedural_test_maps

    shutil.copytree(os.path.join(REPO, "content"), tmp_path / "content")
    tex = np.random.default_rng(0).integers(0, 255, (32, 48, 3), dtype=np.uint8)
    (tmp_path / "content" / "Textures").mkdir(parents=True, exist_ok=True)
    (tmp_path / "content" / "Textures" / "_test_tex.png").write_bytes(encode_png(tex))
    (tmp_path / "content" / "balls.glb").write_bytes(
        chip_smoke.balls_glb(procedural_test_maps(0, 16), 6, 12))
    (tmp_path / "content" / "red.mat").write_text(RED_MAT)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _apps():
    """Both packages' EditorWebApp over content/Editor.world, headless."""
    ed = EditorServer()
    ed.initialize("content/Editor.world", device="cpu")
    ed.start()
    jed = JEditorServer()
    jed.initialize("content/Editor.world")
    jed.start()
    return EditorWebApp(ed), ed, JEditorWebApp(jed), jed


# --- tests/test_editor_web.py on the port ---------------------------------------


def test_page_and_world_listing(content_copy):
    app, ed, japp, _ = _apps()
    status, ctype, page = app.handle("GET", "/", b"")
    assert status == 200 and b"Hierarchy" in page
    assert (status, ctype, page) == japp.handle("GET", "/", b"")
    got = app.handle("GET", "/api/world", b"")
    assert got == japp.handle("GET", "/api/world", b"")
    doc = json.loads(got[2])
    assert doc["objects"] and doc["objects"][0]["instance_id"]
    assert "position" in doc["objects"][0]["yaml"]


def test_update_object_roundtrip(content_copy):
    app, ed, japp, jed = _apps()
    obj = json.loads(app.handle("GET", "/api/world", b"")[2])["objects"][0]
    iid = obj["instance_id"]
    patch = b"position: [5.0, 6.0, 7.0]\nname: Moved\n"
    for a in (app, japp):
        status, _, resp = a.handle("POST", f"/api/update?id={iid}", patch)
        assert status == 200 and json.loads(resp)["ok"]
    np.testing.assert_array_equal(ed.world.find_by_instance_id(iid).position, [5.0, 6.0, 7.0])
    assert app.handle("GET", "/api/world", b"") == japp.handle("GET", "/api/world", b"")
    assert app.handle("POST", "/api/update?id=nope", b"name: x\n") == japp.handle(
        "POST", "/api/update?id=nope", b"name: x\n")
    assert not json.loads(app.handle("POST", "/api/update?id=nope", b"name: x\n")[2])["ok"]


def test_messages_and_frame_endpoints(content_copy):
    app, *_ = _apps()
    status, ctype, png = app.handle("GET", "/api/frame.png", b"")
    assert status == 200 and ctype == "image/png" and png[:8] == SIGNATURE
    status, _, msgs = app.handle("GET", "/api/messages", b"")
    assert status == 200 and isinstance(json.loads(msgs), list)
    assert app.handle("GET", "/nothing", b"")[0] == 404


def test_input_endpoint_routes_to_engine(content_copy):
    app, ed, japp, _ = _apps()
    events = json.dumps([{"type": "keydown", "code": ik.KEY_W},
                         {"type": "mousemove", "x": 7, "y": 9},
                         {"type": "mousedown", "button": 1}]).encode()
    got = app.handle("POST", "/api/input", events)
    assert got == japp.handle("POST", "/api/input", events)
    assert got[0] == 200 and json.loads(got[2])["ok"]
    assert ed.input.is_key_down(ik.KEY_W) and ed.input.is_button_down(1)
    assert ed.input.cursor == (7, 9)


def test_content_browser_and_previews(content_copy):
    app, ed, japp, jed = _apps()
    got = app.handle("GET", "/api/content", b"")
    want = japp.handle("GET", "/api/content", b"")
    assert got == want
    paths = {it["path"]: it["kind"] for it in json.loads(got[2])["items"]}
    assert any(p.endswith("DefaultRenderer.renderer") for p in paths)
    kinds = {p.rsplit(".", 1)[1]: k for p, k in paths.items()}
    assert kinds["png"] == "texture" and kinds["glb"] == "model" and kinds["mat"] == "material"
    for ext in ("png", "glb", "mat", "renderer", "world"):
        path = next(p for p in paths if p.endswith("." + ext))
        g = app.handle("GET", f"/api/asset?path={path}", b"")
        assert g == japp.handle("GET", f"/api/asset?path={path}", b""), ext
        assert g[0] == 200, g
    tex = next(p for p in paths if p.endswith("_test_tex.png"))
    thumb = app.handle("GET", f"/api/asset?path={tex}", b"")[2]
    assert decode_png(thumb).shape == (32, 48, 3)
    assert json.loads(app.handle("GET", "/api/asset?path=" + next(
        p for p in paths if p.endswith(".glb")), b"")[2])["materials"] == 9
    assert app.handle("GET", "/api/asset?path=nope.png", b"")[0] == 404


def test_undecoded_texture_preview_is_a_500(content_copy):
    """A valid BMP's preview is a PNG (the port decodes BMP); a malformed
    one stays a 500 that names the decode error."""
    import io

    from PIL import Image

    rgb = np.arange(12 * 20 * 3, dtype=np.uint8).reshape(12, 20, 3)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="BMP")
    (content_copy / "content" / "Textures" / "ok.bmp").write_bytes(buf.getvalue())
    (content_copy / "content" / "Textures" / "t.bmp").write_bytes(b"BM" + bytes(64))
    app, ed, _, _ = _apps()
    reg = AssetRegistry("content")
    reg.scan_content_folder()
    ed.registry = reg
    status, ctype, body = app.handle("GET", "/api/asset?path=content/Textures/ok.bmp", b"")
    assert status == 200 and ctype == "image/png"
    np.testing.assert_array_equal(decode_png(body), rgb)
    status, ctype, body = app.handle("GET", "/api/asset?path=content/Textures/t.bmp", b"")
    assert status == 500 and b"BMP: " in body


def test_jpeg_texture_preview_is_a_png(content_copy):
    """A JPEG's preview is a 200 PNG of the pixels imageio reads (the port
    decodes JPEG since its own decoder)."""
    import io

    import imageio.v2 as imageio
    from PIL import Image

    rgb = np.random.default_rng(1).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", progressive=True)
    (content_copy / "content" / "Textures" / "ok.jpg").write_bytes(buf.getvalue())
    app, ed, _, _ = _apps()
    reg = AssetRegistry("content")
    reg.scan_content_folder()
    ed.registry = reg
    status, ctype, body = app.handle("GET", "/api/asset?path=content/Textures/ok.jpg", b"")
    assert status == 200 and ctype == "image/png"
    np.testing.assert_array_equal(decode_png(body), imageio.imread(buf.getvalue()))


# --- tests/test_engine_aux.py::test_editor_server_roundtrip ------------------------


def test_editor_server_roundtrip(content_copy):
    srv = EditorServer()
    srv.initialize("content/Editor.world", device="cpu")
    srv.start()
    jsrv = JEditorServer()
    jsrv.initialize("content/Editor.world")
    assert yaml.safe_load(srv.serialize_current_world()) == yaml.safe_load(
        jsrv.serialize_current_world())
    srv.set_viewport(640, 480)
    srv.tick(1 / 60)
    assert srv.viewport == (640, 480)
    text = srv.serialize_current_world()
    assert "Camera" in text and "instanceId" in text
    box = srv.world.find("Box")
    assert srv.update_object(box.instance_id,
                             "position: [3.0, 1.0, 2.0]\n"
                             "components:\n"
                             "  - typename: MeshRendererComponent\n"
                             "    material_id: 7\n")
    np.testing.assert_array_equal(box.position, [3.0, 1.0, 2.0])
    assert box.get_component(MeshRendererComponent).material_id == 7
    assert not srv.update_object("nonexistent0000", "position: [0,0,0]")
    assert isinstance(srv.get_messages(), list)
    srv.shutdown()
    assert srv.world is None and not srv.running


# --- tests/test_editor_material_edit.py on the port, against the reference ----------


def _make_world(pkg):
    """test_editor_material_edit.py's world in the package ``pkg``."""
    import importlib

    comp = importlib.import_module(f"{pkg}.engine.components")
    world_mod = importlib.import_module(f"{pkg}.engine.world")
    w = (world_mod.World("MatEdit", device="cpu") if pkg == "sailor_tpu_torch"
         else world_mod.World("MatEdit"))
    cam = w.instantiate("Camera")
    cam.position = [0.0, 1.0, 4.0]
    cam.add_component(comp.CameraComponent(fov_degrees=60.0, aspect=1.5))
    sun = w.instantiate("Sun")
    sun.add_component(comp.LightComponent(light_type=0, direction=[-0.2, -0.9, -0.3],
                                          intensity=[5.0, 5.0, 5.0]))
    box = w.instantiate("Box")
    box.position = [0.0, 1.0, 0.0]
    box.add_component(comp.MeshRendererComponent(mesh_asset="cube", material_id=0))
    return w


def _edit_run(pkg, folder):
    """The material edit in package ``pkg``: frame 1, the edit through
    EditorServer.update_asset, frame 2. Returns (frames, library, .mat text)."""
    import importlib

    mats = importlib.import_module(f"{pkg}.assets.materials")
    reg_mod = importlib.import_module(f"{pkg}.assets.registry")
    app = importlib.import_module(f"{pkg}.engine.app")
    srv_mod = importlib.import_module(f"{pkg}.engine.editor_server")
    sky = importlib.import_module(f"{pkg}.kernels.sky")
    port = pkg == "sailor_tpu_torch"
    dev = {"device": "cpu"} if port else {}
    mat_path = os.path.join(folder, "TestRed.mat")
    with open(mat_path, "w") as f:
        f.write(RED_MAT)
    reg = reg_mod.AssetRegistry(folder)
    reg.scan_content_folder()
    lib = mats.MaterialLibrary(reg, [mat_path], **dev)
    world = _make_world(pkg)
    world.materials = lib
    world.tick(1 / 60)
    loop = app.EngineLoop(world, app.Renderer(RENDERER, 96, 64, config=dict(EDIT_CONFIG), **dev),
                          sky=sky.SkyParams.default())
    frames = [loop.process_cpu_frame(1 / 60)]
    editor = srv_mod.EditorServer()
    editor.world = world
    editor.registry = reg
    assert editor.update_asset(mat_path, "uniformsVec4:\n  material.albedo: [0.05, 0.9, 0.05, 1.0]\n")
    assert lib.version == 2
    frames.append(loop.process_cpu_frame(1 / 60))
    keys = [k for k, v in frames[0].items() if torch.is_tensor(v)] if port else None
    with open(mat_path) as f:
        text = f.read()
    return frames, lib, text, keys


def _check_frame(got, ref):
    """test_torch_world.check_frame's bars (its coverage floor aside: the
    box covers 4% of this frame): Depth, TriId and LightIndices exact,
    Main within 1e-4 relative on >= 99.9% of the pixels more than 16 px
    from the border and >= 97% of all, Final within 2/255."""
    from test_torch_world import BAND, EXACT

    for k in EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rel = (np.abs(got["Main"] - ref["Main"]) / np.maximum(np.abs(ref["Main"]), 1e-3)).max(-1)
    ok = rel <= 1e-4
    assert ok[BAND:-BAND, BAND:-BAND].mean() >= 0.999 and ok.mean() >= 0.97
    assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255


def test_material_edit_roundtrip(tmp_path):
    from sailor_tpu.kernels import pbr_pallas as j_pk

    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got, lib, text, keys = _edit_run("sailor_tpu_torch", str(tmp_path / "port"))
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        ref, _, jtext, _ = _edit_run("sailor_tpu", str(tmp_path / "ref"))
    finally:
        mp.undo()
        jax.clear_caches()
    assert text == jtext  # the edited .mat byte for byte
    a1 = lib.table.albedo[0].numpy()
    assert a1[1] > 0.5 and a1[0] < 0.2
    frames = []
    for g, r in zip(got, ref):
        g = {k: g[k].numpy() for k in keys}
        _check_frame(g, {k: np.asarray(r[k]) for k in keys})
        frames.append(g["Main"])
    f1, f2 = frames
    changed = np.abs(f2 - f1).sum(-1) > 0.05
    box = changed & (f1[..., 0] > f1[..., 1])
    assert box.sum() > 50
    assert (f2[..., 1] > f2[..., 0])[box].mean() > 0.8


def test_web_asset_update_endpoint(tmp_path):
    """POST /api/asset/update on both packages: the same .mat bytes."""
    texts = []
    for pkg, Srv, App, Reg in (("port", EditorServer, EditorWebApp, AssetRegistry),
                               ("ref", JEditorServer, JEditorWebApp, JAssetRegistry)):
        folder = tmp_path / pkg
        folder.mkdir()
        mat_path = folder / "TestRed.mat"
        mat_path.write_text(RED_MAT)
        reg = Reg(str(folder))
        reg.scan_content_folder()
        editor = Srv()
        editor.initialize(**({"device": "cpu"} if pkg == "port" else {}))
        editor.registry = reg
        status, _, payload = App(editor).handle(
            "POST", f"/api/asset/update?path={mat_path}",
            b"uniformsFloat:\n  material.roughness: 0.123\n")
        assert status == 200 and b'"ok": true' in payload
        texts.append(mat_path.read_bytes())
        doc = yaml.safe_load(mat_path.read_text())
        assert doc["uniformsFloat"]["material.roughness"] == 0.123
        assert doc["uniformsVec4"]["material.albedo"][0] == 0.9
    assert texts[0] == texts[1]


# --- the live server -----------------------------------------------------------------


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_live_http_server_with_render_loop(content_copy):
    from sailor_tpu_torch.engine.app import Renderer
    from sailor_tpu_torch.kernels.sky import SkyParams

    ed = EditorServer()
    ed.initialize("content/Editor.world", device="cpu")
    ed.start(Renderer(RENDERER, 96, 64, config=dict(EDIT_CONFIG), device="cpu"),
             sky=SkyParams.default())
    app = EditorWebApp(ed, tick_hz=50.0)
    server = app.make_server("127.0.0.1", 0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    app.start_loop()
    try:
        status, body = _request(port, "GET", "/api/world")
        assert status == 200
        box = next(o for o in json.loads(body)["objects"] if o["name"] == "Box")
        status, body = _request(port, "POST", f"/api/update?id={box['instance_id']}",
                                b"position: [0.5, 1.0, 0.0]\n")
        assert status == 200 and json.loads(body)["ok"]
        start = app.frame_png()[0]
        deadline = time.monotonic() + 120
        while app.frame_png()[0] < start + 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        status, png = _request(port, "GET", "/api/frame.png")
        assert status == 200 and decode_png(png).shape == (64, 96, 3)
        assert app.frame_png()[0] >= start + 2
    finally:
        app.stop_loop()
        server.shutdown()
        server.server_close()
        t.join(30)
    assert not t.is_alive()
    assert not any("tick failed" in m for m in ed.get_messages(1024))
