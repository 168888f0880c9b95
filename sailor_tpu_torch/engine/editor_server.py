"""Editor protocol (counterpart of sailor_tpu/engine/editor_server.py):
the engine DLL's C API that the reference's MAUI editor P/Invokes
(Lib/DllMain.cpp: Initialize/Start/Stop/Shutdown, SerializeCurrentWorld,
UpdateObject, GetMessages, SetViewport) and the engine-side Editor
submodule (Runtime/Submodules/Editor.cpp).

An out-of-process editor drives the engine through this object
(engine/editor_web.py serves it over HTTP). ``update_object`` patches live
component and transform state from YAML through the components'
reflection, as the editor's property inspector does; ``update_asset``
patches an asset file and hot-reloads it, so the next frame shows the
edit. ``lock`` serialises the frame (``tick``) with the edits, which an
editor's server thread makes while another thread ticks the engine.
"""

from __future__ import annotations

import io
import threading

import numpy as np
import yaml

from sailor_tpu_torch.engine.world import World
from sailor_tpu_torch.utils.log import SAILOR_LOG, get_log_messages


class EditorServer:
    def __init__(self):
        self.world: World | None = None
        self.engine_loop = None
        self.viewport = (1280, 720)
        self.running = False
        self.lock = threading.RLock()

    # -- lifecycle (DllMain Initialize/Start/Stop/Shutdown) -------------------

    def initialize(self, world_path: str | None = None, assets=None, device=None) -> bool:
        """Load ``world_path`` (or an empty world) on ``device``, the card
        unless the caller names another."""
        if world_path:
            self.world = World.load(world_path, assets, device=device)
        else:
            self.world = World("Untitled", device=device)
        SAILOR_LOG("Editor: initialized world '%s'", self.world.name)
        return True

    def start(self, renderer=None, sky=None) -> None:
        """With a renderer, an EngineLoop on it renders each tick; headless,
        the world still gets an InputState that frontends drive."""
        from sailor_tpu_torch.engine.app import EngineLoop
        from sailor_tpu_torch.engine.input import InputState

        if renderer is not None:
            self.engine_loop = EngineLoop(self.world, renderer, sky=sky)
            self.input = self.engine_loop.input
        else:
            self.input = InputState()
            if self.world is not None:
                self.world.input = self.input
        self.running = True

    def stop(self) -> None:
        self.running = False

    def shutdown(self) -> None:
        self.stop()
        self.world = None
        self.engine_loop = None

    # -- frame + viewport ------------------------------------------------------

    def set_viewport(self, width: int, height: int) -> None:
        self.viewport = (int(width), int(height))

    def tick(self, dt: float = 1 / 60):
        """One engine frame (its targets), or a world tick when headless."""
        with self.lock:
            if self.engine_loop is not None and self.running:
                return self.engine_loop.process_cpu_frame(dt)
            if self.world is not None and self.running:
                self.world.tick(dt)
            return None

    # -- world serialization (SerializeCurrentWorld) ----------------------------

    def serialize_current_world(self) -> str:
        buf = io.StringIO()
        with self.lock:
            yaml.safe_dump(self.world.serialize(), buf, sort_keys=False)
        return buf.getvalue()

    # -- live property patching (UpdateObject) -----------------------------------

    def update_object(self, instance_id: str, yaml_patch: str) -> bool:
        """Apply a YAML patch to a live game object by instance id: its
        name, transform fields and components' reflected data
        (Runtime/Submodules/Editor.cpp UpdateObject)."""
        patch = yaml.safe_load(yaml_patch) or {}
        with self.lock:
            go = self.world.find_by_instance_id(instance_id)
            if go is None:
                SAILOR_LOG("Editor: UpdateObject unknown instance %s", instance_id)
                return False
            if "name" in patch:
                go.name = patch["name"]
            for field in ("position", "rotation", "scale"):
                if field in patch:
                    setattr(go, field, np.asarray(patch[field], np.float32))
            for cdata in patch.get("components", []) or []:
                tname = cdata.get("typename")
                for comp in go.components:
                    if type(comp).__name__ == tname:
                        comp.apply(cdata)
                        break
        return True

    # -- live asset patching (editor ViewModels -> hot reload) --------------------

    def update_asset(self, path: str, yaml_patch: str, registry=None) -> bool:
        """Patch an asset file (a .mat's uniforms, say) and hot-reload it: the
        reference's editor ViewModels write the asset YAML and the engine
        re-imports it (OnUpdateAssetInfo, MaterialImporter.cpp:53). The
        patch deep-merges into the document; the registry's listeners (a
        MaterialLibrary) rebuild, so the next frame shows the edit."""
        reg = registry or getattr(self, "registry", None)
        try:
            with open(path) as f:
                doc = yaml.safe_load(f) or {}
        except OSError:
            SAILOR_LOG("Editor: UpdateAsset unknown path %s", path)
            return False

        def merge(dst, src):
            for k, v in src.items():
                if isinstance(v, dict) and isinstance(dst.get(k), dict):
                    merge(dst[k], v)
                else:
                    dst[k] = v

        merge(doc, yaml.safe_load(yaml_patch) or {})
        with self.lock:
            with open(path, "w") as f:
                yaml.safe_dump(doc, f, sort_keys=False)
            if reg is not None:
                # the file's mtime may not move past the load time within
                # the filesystem's granularity: expire the asset outright
                info = reg.infos.get(path)
                if info is not None:
                    info.load_time = 0.0
                reg.check_hot_reload()
        SAILOR_LOG("Editor: UpdateAsset %s", path)
        return True

    # -- message queue (GetMessages) ----------------------------------------------

    def get_messages(self, max_count: int = 64) -> list[str]:
        return [f"[{ts:.3f}] {msg}" for ts, msg in get_log_messages(max_count)]
