"""Web editor client (counterpart of sailor_tpu/engine/editor_web.py): the
minimal UI in place of the reference's .NET MAUI editor (Editor/), over
the protocol the MAUI app P/Invokes (Lib/DllMain.cpp):
SerializeCurrentWorld -> hierarchy and inspector, UpdateObject -> live
YAML property patching, GetMessages -> console, an asset browser with
previews and asset edits that hot-reload, and the rendered viewport as a
PNG (the CopyTextureToRam readback).

Run: ``python -m sailor_tpu_torch.engine.editor_web --world
content/Editor.world`` (on the card; ``--cpu`` runs the plain PyTorch
path) and open http://localhost:8787. The engine ticks on a background
thread; the page polls the frame PNG and the console and POSTs YAML
patches.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import yaml

from sailor_tpu_torch.engine.editor_server import EditorServer
from sailor_tpu_torch.utils.log import SAILOR_LOG
from sailor_tpu_torch.utils.png import encode_png, srgb_to_u8

_PAGE = """<!doctype html>
<html><head><title>sailor-tpu editor</title><style>
body{font-family:monospace;background:#1b1d22;color:#cfd2d8;margin:0;display:flex;height:100vh}
#left{width:330px;padding:10px;overflow:auto;border-right:1px solid #333}
#mid{flex:1;padding:10px;display:flex;flex-direction:column}
#viewport{image-rendering:pixelated;border:1px solid #333;max-width:100%}
textarea{width:100%;height:220px;background:#14161a;color:#cfd2d8;border:1px solid #333}
#console{height:140px;overflow:auto;background:#14161a;border:1px solid #333;padding:4px;font-size:11px;white-space:pre}
button{background:#2d6cdf;color:#fff;border:0;padding:6px 12px;margin:4px 0;cursor:pointer}
.obj{cursor:pointer;padding:2px 4px}.obj:hover{background:#2a2d34}.sel{background:#2d6cdf33}
h3{margin:6px 0;color:#8ab4ff}</style></head><body>
<div id=left><h3>Hierarchy</h3><div id=tree></div>
<h3>Content</h3><div id=content></div>
<img id=preview style="max-width:300px;display:none;border:1px solid #333"></div>
<div id=mid>
  <img id=viewport src=/api/frame.png>
  <h3>Inspector <span id=selname></span></h3>
  <textarea id=yaml></textarea>
  <button onclick=apply()>Apply (UpdateObject)</button>
  <h3>Console</h3><div id=console></div>
</div>
<script>
let sel=null, objs=[];
async function refreshWorld(){
  const w = await (await fetch('/api/world')).json();
  objs = w.objects||[];
  const t = document.getElementById('tree'); t.innerHTML='';
  for(const o of objs){
    const d=document.createElement('div');
    d.className='obj'+(sel===o.instance_id?' sel':'');
    d.textContent=o.name+'  ['+o.instance_id+']';
    d.onclick=()=>{sel=o.instance_id;
      document.getElementById('selname').textContent=o.name;
      document.getElementById('yaml').value=o.yaml; refreshWorld();};
    t.appendChild(d);
  }
}
async function apply(){
  if(!sel) return;
  await fetch('/api/update?id='+encodeURIComponent(sel),
    {method:'POST', body:document.getElementById('yaml').value});
  refreshWorld();
}
async function poll(){
  document.getElementById('viewport').src='/api/frame.png?t='+Date.now();
  const m = await (await fetch('/api/messages')).json();
  const c=document.getElementById('console');
  c.textContent=m.join('\\n'); c.scrollTop=c.scrollHeight;
}
let evq=[];
function pushEv(e){evq.push(e); if(evq.length>32) flushEv();}
async function flushEv(){ if(!evq.length) return;
  const b=JSON.stringify(evq); evq=[];
  fetch('/api/input', {method:'POST', body:b}); }
const vp=document.getElementById('viewport');
window.addEventListener('keydown',e=>pushEv({type:'keydown',code:e.keyCode}));
window.addEventListener('keyup',e=>pushEv({type:'keyup',code:e.keyCode}));
vp.addEventListener('mousedown',e=>pushEv({type:'mousedown',button:e.button}));
vp.addEventListener('mouseup',e=>pushEv({type:'mouseup',button:e.button}));
vp.addEventListener('mousemove',e=>pushEv({type:'mousemove',x:e.offsetX,y:e.offsetY}));
vp.addEventListener('contextmenu',e=>e.preventDefault());
async function refreshContent(){
  const c = await (await fetch('/api/content')).json();
  const t = document.getElementById('content'); t.innerHTML='';
  for(const it of c.items||[]){
    const d=document.createElement('div'); d.className='obj';
    d.textContent='['+it.kind[0]+'] '+it.path;
    d.onclick=()=>previewAsset(it); t.appendChild(d);
  }
}
async function previewAsset(it){
  const img=document.getElementById('preview');
  document.getElementById('selname').textContent=it.path;
  if(it.kind==='texture'){
    img.src='/api/asset?path='+encodeURIComponent(it.path)+'&t='+Date.now();
    img.style.display='block'; return;
  }
  img.style.display='none';
  const r = await fetch('/api/asset?path='+encodeURIComponent(it.path));
  const txt = await r.text();
  document.getElementById('yaml').value = txt;
}
setInterval(flushEv, 100);
refreshWorld(); refreshContent();
setInterval(poll, 500); setInterval(refreshWorld, 3000);
</script></body></html>"""


class EditorWebApp:
    """HTTP front end over an EditorServer, with a background render loop.
    ``frames`` counts the frames the loop has encoded into the viewport
    PNG."""

    def __init__(self, editor: EditorServer, tick_hz: float = 10.0):
        self.editor = editor
        self.tick_hz = tick_hz
        self._frame_png: bytes = encode_png(np.zeros((8, 8, 3), np.uint8))
        self.frames = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- engine loop -----------------------------------------------------------

    def _loop(self):
        dt = 1.0 / self.tick_hz
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                targets = self.editor.tick(dt)
                if targets is not None and "Final" in targets:
                    png = encode_png(srgb_to_u8(targets["Final"]))
                    with self._lock:
                        self._frame_png = png
                        self.frames += 1
            except Exception as e:  # the UI keeps serving; the console shows the error
                SAILOR_LOG("EditorWeb: tick failed: %s", e)
            left = dt - (time.perf_counter() - t0)
            if left > 0:
                self._stop.wait(left)

    def start_loop(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop_loop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError("the editor's render loop did not stop within 60 s")
            self._thread = None

    def frame_png(self) -> tuple[int, bytes]:
        """The loop's frame count and the newest viewport PNG."""
        with self._lock:
            return self.frames, self._frame_png

    # -- request handling (framework-free) ---------------------------------------

    def handle(self, method: str, path: str, body: bytes):
        """(status, content type, payload) of one request: a pure function
        of the protocol, which the HTTP layer and the tests both call."""
        url = urlparse(path)
        if method == "GET" and url.path == "/":
            return 200, "text/html", _PAGE.encode()
        if method == "GET" and url.path == "/api/world":
            objs = []
            w = self.editor.world
            if w is not None:
                with self.editor.lock:
                    for go in w.game_objects:
                        doc = {
                            "name": go.name,
                            "position": go.position.tolist(),
                            "rotation": go.rotation.tolist(),
                            "scale": go.scale.tolist(),
                            "components": [c.serialize() for c in go.components],
                        }
                        objs.append({"name": go.name, "instance_id": go.instance_id,
                                     "yaml": yaml.safe_dump(doc, sort_keys=False)})
            return 200, "application/json", json.dumps(
                {"name": w.name if w else "", "objects": objs}).encode()
        if method == "GET" and url.path == "/api/frame.png":
            return 200, "image/png", self.frame_png()[1]
        if method == "GET" and url.path == "/api/messages":
            return 200, "application/json", json.dumps(self.editor.get_messages(64)).encode()
        if method == "POST" and url.path == "/api/input":
            # frontend key and mouse events into the InputState (GlobalInput)
            inp = getattr(self.editor, "input", None)
            if inp is not None:
                for ev in json.loads(body.decode() or "[]"):
                    t = ev.get("type")
                    if t == "keydown":
                        inp.key_down(int(ev.get("code", -1)))
                    elif t == "keyup":
                        inp.key_up(int(ev.get("code", -1)))
                    elif t == "mousedown":
                        inp.button_down(int(ev.get("button", 0)))
                    elif t == "mouseup":
                        inp.button_up(int(ev.get("button", 0)))
                    elif t == "mousemove":
                        inp.move_cursor(ev.get("x", 0), ev.get("y", 0))
            return 200, "application/json", json.dumps({"ok": inp is not None}).encode()
        if method == "POST" and url.path == "/api/update":
            iid = (parse_qs(url.query).get("id") or [""])[0]
            ok = self.editor.update_object(iid, body.decode())
            return 200, "application/json", json.dumps({"ok": ok}).encode()
        if method == "POST" and url.path == "/api/asset/update":
            # the inspector's asset edit: patch a .mat (or any YAML asset)
            # and hot-reload it, so the viewport shows it next frame
            rel = (parse_qs(url.query).get("path") or [""])[0]
            ok = self.editor.update_asset(rel, body.decode(), registry=self._registry())
            return 200, "application/json", json.dumps({"ok": ok}).encode()
        if method == "GET" and url.path == "/api/content":
            # the content browser (Editor/ViewModels AssetsViewModel): the
            # registry's scanned files with their ids and kinds
            reg = self._registry()
            items = [{"path": path, "file_id": info.file_id, "kind": _asset_kind(path)}
                     for path, info in sorted(reg.infos.items())]
            return 200, "application/json", json.dumps(
                {"root": reg.content_root, "items": items}).encode()
        if method == "GET" and url.path == "/api/asset":
            rel = (parse_qs(url.query).get("path") or [""])[0]
            reg = self._registry()
            if rel not in reg.infos:
                return 404, "text/plain", b"unknown asset"
            return self._asset_preview(rel)
        return 404, "text/plain", b"not found"

    def _registry(self):
        """The editor's registry; without one, a scan of ``content/`` under
        the working directory becomes it."""
        reg = getattr(self.editor, "registry", None)
        if reg is None:
            from sailor_tpu_torch.assets.registry import AssetRegistry

            reg = AssetRegistry("content")
            reg.scan_content_folder()
            self.editor.registry = reg
        return reg

    def _asset_preview(self, path):
        """A texture's thumbnail (PNG), a model's summary (JSON) or a text
        asset's first 64 KiB; a failure is a 500 with its message."""
        kind = _asset_kind(path)
        try:
            if kind == "texture":
                from sailor_tpu_torch.assets import textures

                img = np.asarray(textures.imread(path))
                if img.dtype.kind == "f":  # Radiance HDR: linear radiance, clipped to 8 bits
                    img = np.clip(img * 255.0 + 0.5, 0.0, 255.0)
                if img.ndim == 2:
                    img = np.stack([img] * 3, -1)
                img = img[..., :3]
                s = max(1, max(img.shape[:2]) // 256)
                thumb = np.ascontiguousarray(img[::s, ::s]).astype(np.uint8)
                return 200, "image/png", encode_png(thumb)
            if kind == "model":
                from sailor_tpu_torch.assets import gltf

                g = gltf.GLTF.load(path)
                mats = g.materials()
                summary = {
                    "meshes": len(g.doc.get("meshes", [])),
                    "primitives": sum(len(m.get("primitives", []))
                                      for m in g.doc.get("meshes", [])),
                    "materials": len(g.doc.get("materials", [])),
                    "images": len(g.doc.get("images", [])),
                    "material_names": [m.get("name", f"mat{i}")
                                       for i, m in enumerate(g.doc.get("materials", []))],
                    "queues": mats["queue"].tolist(),
                }
                return 200, "application/json", json.dumps(summary).encode()
            # text-like assets: .mat/.renderer/.world/.prefab/...
            with open(path, "rb") as f:
                return 200, "text/plain", f.read(65536)
        except Exception as e:  # the reference returns every preview error as a 500
            return 500, "text/plain", str(e).encode()

    # -- HTTP ----------------------------------------------------------------------

    def make_server(self, host: str = "127.0.0.1", port: int = 8787) -> ThreadingHTTPServer:
        """An HTTP server bound to (host, port) that answers with ``handle``;
        port 0 takes a free port (``server.server_address[1]``). The
        caller runs ``serve_forever`` and ends with ``shutdown`` and
        ``server_close``."""
        app = self

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, method):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                status, ctype, payload = app.handle(method, self.path, body)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._respond("GET")

            def do_POST(self):
                self._respond("POST")

            def log_message(self, *a):  # quiet
                pass

        return ThreadingHTTPServer((host, port), Handler)

    def serve(self, port: int = 8787):
        """Serve on 127.0.0.1:``port`` with the render loop running, until
        interrupted."""
        server = self.make_server("127.0.0.1", port)
        self.start_loop()
        try:
            server.serve_forever()
        finally:
            self.stop_loop()
            server.server_close()


EDITOR_CONFIG = {"bin_capacity": 512, "bin_rounds": 2, "shadow_resolution": 512,
                 "env_resolution": 32}


def main(argv=None):
    import argparse

    from sailor_tpu_torch.engine.app import Renderer
    from sailor_tpu_torch.kernels.sky import SkyParams

    ap = argparse.ArgumentParser()
    ap.add_argument("--world", default="content/Editor.world")
    ap.add_argument("--renderer", default="content/DefaultRenderer.renderer")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--cpu", action="store_true", help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    editor = EditorServer()
    editor.initialize(args.world, device=device)
    renderer = Renderer(args.renderer, args.width, args.height, config=dict(EDITOR_CONFIG),
                        device=device)
    editor.start(renderer, sky=SkyParams.default())
    app = EditorWebApp(editor)
    print(f"sailor-tpu editor: http://localhost:{args.port}")
    app.serve(args.port)


_KIND_EXT = {
    "texture": (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".gif", ".hdr", ".exr"),
    "model": (".gltf", ".glb"),
    "material": (".mat",),
    "framegraph": (".renderer",),
    "world": (".world",),
    "prefab": (".prefab",),
}


def _asset_kind(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    for kind, exts in _KIND_EXT.items():
        if ext in exts:
            return kind
    return "file"


if __name__ == "__main__":
    main()
