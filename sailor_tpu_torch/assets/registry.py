"""Asset registry (counterpart of sailor_tpu/assets/registry.py,
Runtime/AssetRegistry/AssetRegistry.{h,cpp}): folder scan, file ids in
`.asset` YAML sidecars (written beside each file that lacks one),
importer dispatch by extension, a cache with timestamp expiry, hot reload.

It registers the reference's importers for the same extensions, so a scan
counts the same files: `.gltf`/`.glb` (``gltf.load_merged``), `.renderer`,
`.mat` (``MaterialAsset``), `.world`, `.prefab`, the image extensions
(``textures.load`` with the sidecar's import settings) and `.bsc5` (star
catalogue). Of the images PNG, JPEG, GIF, BMP, TGA and Radiance HDR
decode; OpenEXR raises NotImplementedError naming the format
(``textures.UNDECODED``).
"""

from __future__ import annotations

import atexit
import os
import threading
import time
import uuid
from typing import Any, Callable

from sailor_tpu_torch.utils.log import SAILOR_LOG

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".gif", ".hdr", ".exr")


def _yaml_load(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _load_mat(path: str, meta):
    from sailor_tpu_torch.assets.materials import MaterialAsset

    with open(path) as f:
        return MaterialAsset.from_yaml(f.read(), os.path.basename(path))


class AssetInfo:
    """Per-asset metadata (AssetInfo.h): file id, timestamps, import settings."""

    def __init__(self, path: str, file_id: str, meta: dict | None = None):
        self.path = path
        self.file_id = file_id
        self.meta = meta or {}
        self.load_time = 0.0

    @property
    def mtime(self) -> float:
        try:
            return os.path.getmtime(self.path)
        except OSError:
            return 0.0

    def is_expired(self) -> bool:
        return self.mtime > self.load_time


class AssetRegistry:
    """Scan, load, cache and hot reload under one content root."""

    def __init__(self, content_root: str = "content"):
        self.content_root = content_root
        self.infos: dict[str, AssetInfo] = {}       # path -> info
        self.by_id: dict[str, AssetInfo] = {}       # file id -> info
        self.cache: dict[str, Any] = {}             # file id -> loaded asset
        self.importers: dict[str, Callable] = {}    # extension -> loader
        self.listeners: list[Callable] = []         # hot-reload callbacks
        self._register_lock = threading.Lock()      # loads run on worker threads too
        self._register_default_importers()

    def register_importer(self, extension: str, loader: Callable) -> None:
        self.importers[extension.lower()] = loader

    def _register_default_importers(self) -> None:
        from sailor_tpu_torch.assets import gltf, stars, textures
        from sailor_tpu_torch.framegraph.graph import FrameGraphAsset

        for ext in (".gltf", ".glb"):
            self.register_importer(ext, lambda p, meta: gltf.load_merged(p))
        self.register_importer(".renderer", lambda p, meta: FrameGraphAsset.load(p))
        self.register_importer(".mat", _load_mat)
        self.register_importer(".world", lambda p, meta: _yaml_load(p))
        self.register_importer(".prefab", lambda p, meta: _yaml_load(p))
        for ext in IMAGE_EXTENSIONS:
            self.register_importer(ext, lambda p, meta: textures.load(p, **(meta or {})))
        self.register_importer(".bsc5", lambda p, meta: stars.load(p))

    def scan_content_folder(self) -> int:
        """Walk the content root, assign file ids, write missing sidecars."""
        count = 0
        for root, _dirs, files in os.walk(self.content_root):
            for fn in files:
                if fn.endswith(".asset"):
                    continue
                ext = os.path.splitext(fn)[1].lower()
                if ext not in self.importers:
                    continue
                self._register_file(os.path.join(root, fn))
                count += 1
        return count

    def _register_file(self, path: str) -> AssetInfo:
        with self._register_lock:
            return self._register_file_locked(path)

    def _register_file_locked(self, path: str) -> AssetInfo:
        if path in self.infos:
            return self.infos[path]
        sidecar = path + ".asset"
        meta = {}
        if os.path.exists(sidecar):
            meta = _yaml_load(sidecar) or {}
        file_id = meta.get("fileId") or uuid.uuid4().hex
        if "fileId" not in meta:
            meta["fileId"] = file_id
            try:
                import yaml

                with open(sidecar, "w") as f:
                    yaml.safe_dump(meta, f)
            except OSError:
                pass  # read-only content roots are fine
        info = AssetInfo(path, file_id, meta)
        self.infos[path] = info
        self.by_id[file_id] = info
        return info

    def load(self, path_or_id: str) -> Any:
        info = self.by_id.get(path_or_id)
        if info is None:
            path = (path_or_id if os.path.exists(path_or_id)
                    else os.path.join(self.content_root, path_or_id))
            info = self._register_file(path)
        if info.file_id in self.cache and not info.is_expired():
            return self.cache[info.file_id]
        ext = os.path.splitext(info.path)[1].lower()
        loader = self.importers.get(ext)
        if loader is None:
            raise KeyError(f"no importer for '{ext}'")
        asset = loader(info.path, info.meta.get("import", {}))
        info.load_time = time.time()
        self.cache[info.file_id] = asset
        return asset

    def load_mesh(self, name: str, **params):
        """A MeshRendererComponent's mesh: a primitive name or a model file."""
        from sailor_tpu_torch.engine.components import primitive_mesh

        mesh = primitive_mesh(name, params)
        return mesh if mesh is not None else self.load(name)

    def add_hot_reload_listener(self, fn: Callable) -> None:
        self.listeners.append(fn)

    def check_hot_reload(self) -> list[str]:
        """Re-import expired cached assets and notify the listeners;
        returns the reloaded file ids (console `scan`, F5)."""
        reloaded = []
        for info in list(self.infos.values()):
            if info.file_id in self.cache and info.is_expired():
                SAILOR_LOG("Hot reload: %s", info.path)
                self.cache.pop(info.file_id, None)
                self.load(info.path)
                reloaded.append(info.file_id)
                for fn in self.listeners:
                    fn(info)
        return reloaded


_scheduler = None
_scheduler_lock = threading.Lock()


def _get_scheduler():
    """The process's load scheduler (native_bridge.Scheduler), made at the
    first asynchronous load and shut down at interpreter exit."""
    global _scheduler
    with _scheduler_lock:
        if _scheduler is None:
            from sailor_tpu_torch import native_bridge

            _scheduler = native_bridge.Scheduler()
            atexit.register(_scheduler.shutdown)
        return _scheduler


class AsyncLoad:
    """A load submitted to the native scheduler: ``wait(timeout=None)``
    returns the asset (or raises the loader's exception), ``is_done()``
    polls."""

    def __init__(self, scheduler, task: int):
        self._scheduler = scheduler
        self._task = task

    def wait(self, timeout: float | None = None):
        return self._scheduler.wait(self._task, timeout)

    def is_done(self) -> bool:
        return self._scheduler.is_done(self._task)


def load_async(registry: AssetRegistry, path: str) -> AsyncLoad:
    """Submit ``registry.load(path)`` to the native worker pool (the
    reference's asynchronous import tasks). The load runs on the host; a
    loader that touches the card does so on the worker thread's current
    device, device 0. There is no synchronous fallback: a failed build of
    the runtime library raises here."""
    sched = _get_scheduler()
    return AsyncLoad(sched, sched.submit(lambda: registry.load(path)))
