"""World, GameObject and Component (counterpart of sailor_tpu/engine/world.py,
Runtime/Engine/World.{h,cpp} and GameObject.h).

The world owns game objects and the ECS systems, ticks the systems in
order, instantiates documents with two-phase instance-id resolution and
serializes to YAML (the `.world` format, the engine's checkpoint and
resume). A world lives on one device, the card unless the caller names
another; its systems keep what a frame draws there.
"""

from __future__ import annotations

import uuid

import numpy as np
import torch

from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.ecs.ecs import SystemRegistry
from sailor_tpu_torch import ecs  # noqa: F401 (registers the systems)

_COMPONENT_TYPES: dict[str, type] = {}


def register_component(cls):
    """Component factory registration (Reflection::RegisterFactoryMethod)."""
    _COMPONENT_TYPES[cls.__name__] = cls
    return cls


def component_types() -> dict[str, type]:
    return dict(_COMPONENT_TYPES)


class Component:
    """Base component. ``serialized_fields``: the attributes persisted to
    YAML (the reflection-generated ReflectedData analog)."""

    serialized_fields: tuple[str, ...] = ()

    def __init__(self, **kwargs):
        self.game_object: GameObject | None = None
        for k, v in kwargs.items():
            setattr(self, k, v)

    def begin_play(self) -> None:
        pass

    def tick(self, dt: float) -> None:
        pass

    def end_play(self) -> None:
        pass

    def serialize(self) -> dict:
        out = {"typename": type(self).__name__}
        for f in self.serialized_fields:
            v = getattr(self, f)
            if isinstance(v, np.ndarray):
                v = v.tolist()
            out[f] = v
        return out

    def apply(self, data: dict) -> None:
        for f in self.serialized_fields:
            if f in data:
                setattr(self, f, data[f])


class GameObject:
    """Transform handle plus component list (Runtime/Engine/GameObject.h)."""

    def __init__(self, world: "World", name: str = "GameObject",
                 instance_id: str | None = None):
        self.world = world
        self.name = name
        self.instance_id = instance_id or uuid.uuid4().hex[:16]
        self.transform = world.transforms.add()
        self.parent: GameObject | None = None
        self.components: list[Component] = []
        self._began = False

    @property
    def position(self):
        return self.world.transforms.pool.position[self.transform].copy()

    @position.setter
    def position(self, v):
        self.world.transforms.set_position(self.transform, v)

    @property
    def rotation(self):
        return self.world.transforms.pool.rotation[self.transform].copy()

    @rotation.setter
    def rotation(self, v):
        self.world.transforms.set_rotation(self.transform, v)

    @property
    def scale(self):
        return self.world.transforms.pool.scale[self.transform].copy()

    @scale.setter
    def scale(self, v):
        self.world.transforms.set_scale(self.transform, v)

    def set_parent(self, parent: "GameObject | None") -> None:
        self.parent = parent
        self.world.transforms.set_parent(self.transform, parent.transform if parent else -1)

    def add_component(self, comp: Component) -> Component:
        comp.game_object = self
        self.components.append(comp)
        if self._began:
            comp.begin_play()
        return comp

    def get_component(self, cls) -> Component | None:
        for c in self.components:
            if isinstance(c, cls):
                return c
        return None

    def tick(self, dt: float) -> None:
        if not self._began:
            for c in self.components:
                c.begin_play()
            self._began = True
        for c in self.components:
            c.tick(dt)


def _instantiate_entries(world: "World", entries: list, instance_ids: bool, assets=None):
    """Two phases: create every object (instance ids kept, or fresh), then
    resolve parents and add the components (World::Instantiate +
    ResolveExternalDependencies). Returns the new objects in order."""
    gos = []
    for e in entries:
        go = GameObject(world, e.get("name", "GameObject"),
                        instance_id=e.get("instanceId") if instance_ids else None)
        world.game_objects.append(go)
        go.position = e.get("position", [0, 0, 0])
        go.rotation = e.get("rotation", [0, 0, 0, 1])
        go.scale = e.get("scale", [1, 1, 1])
        gos.append(go)
    for e, go in zip(entries, gos):
        p = e.get("parentIndex", -1)
        if p is not None and p >= 0:
            go.set_parent(gos[p])
        for cdata in e.get("components", []) or []:
            tname = cdata.get("typename")
            ctype = _COMPONENT_TYPES.get(tname)
            if ctype is None:
                raise KeyError(f"unknown component type '{tname}'")
            comp = ctype()
            comp.apply(cdata)
            go.add_component(comp)
            if assets is not None and hasattr(comp, "resolve_assets"):
                comp.resolve_assets(assets)
    return gos


class World:
    """Owns game objects and systems; ticks them in order (World::Tick)."""

    def __init__(self, name: str = "World", device=None):
        self.name = name
        self.device = resolve_device(device)
        self.systems = SystemRegistry.create_all(self)
        self._by_name = {s.name: s for s in self.systems}
        self.game_objects: list[GameObject] = []
        self._pending_destroy: list[GameObject] = []
        self.time = 0.0
        # an object whose ``table`` is an assets.materials.MaterialTable
        # (assets.materials.MaterialLibrary): mesh renderers' material_id
        # indexes it, and a hot reload's new table is repacked next frame
        self.materials = None
        self._attrs_key = None
        self._attrs_packed = None
        self._stars_src = None  # the (dirs, colours) arrays last copied, and the copies
        self._stars = None

    def system(self, name: str):
        return self._by_name.get(name)

    @property
    def transforms(self):
        return self._by_name["Transform"]

    @property
    def cameras(self):
        return self._by_name["Camera"]

    @property
    def lighting(self):
        return self._by_name["Lighting"]

    @property
    def meshes(self):
        return self._by_name["StaticMesh"]

    def instantiate(self, name: str = "GameObject") -> GameObject:
        go = GameObject(self, name)
        self.game_objects.append(go)
        return go

    def destroy(self, go: GameObject) -> None:
        self._pending_destroy.append(go)

    def find(self, name: str) -> GameObject | None:
        for go in self.game_objects:
            if go.name == name:
                return go
        return None

    def find_by_instance_id(self, iid: str) -> GameObject | None:
        for go in self.game_objects:
            if go.instance_id == iid:
                return go
        return None

    def tick(self, dt: float) -> None:
        """World::Tick: object ticks, then systems in order, then destroys."""
        self.time += dt
        for go in self.game_objects:
            go.tick(dt)
        for s in self.systems:
            s.tick(dt)
        for s in self.systems:
            s.post_tick()
        for go in self._pending_destroy:
            for c in go.components:
                c.end_play()
            self.world_release(go)
        self._pending_destroy.clear()

    def world_release(self, go: GameObject) -> None:
        if go in self.game_objects:
            self.game_objects.remove(go)
            self.transforms.pool.release(go.transform)

    def scene_view(self, sky=None, stars=None, prev_frame=None):
        """The frame graph's snapshot (Renderer::PushFrame copy stage).
        ``stars``: a (directions, colours) pair of (S, 3) arrays
        (assets/stars.py), copied to the world's device once for each pair
        of arrays, not once a frame."""
        from sailor_tpu_torch.rhi.scene_view import SceneView

        frame = self.cameras.main_frame()
        if frame is None:
            raise RuntimeError("world has no camera")
        geo = self.meshes.geometry
        if geo is None:
            raise RuntimeError("world has no static meshes")
        star_dirs = star_colors = None
        if stars is not None:
            src = self._stars_src
            if src is None or any(a is not b for a, b in zip(stars, src)):
                self._stars = tuple(torch.as_tensor(np.asarray(a, np.float32),
                                                    device=self.device) for a in stars)
                self._stars_src = tuple(stars)
            star_dirs, star_colors = self._stars
        mats = self.materials.table if self.materials is not None else None
        # the per-source-triangle table: repacked only when the soup object
        # (movement, topology) or the material table (a MaterialLibrary's
        # hot reload builds a new one) changes; the key holds the objects,
        # so a freed table's id cannot be taken for its successor's
        key = (geo, mats)
        if self._attrs_key is None or any(a is not b for a, b in zip(self._attrs_key, key)):
            from sailor_tpu_torch.raster.interpolate import pack_source_attributes

            self._attrs_packed = pack_source_attributes(geo, mats)
            self._attrs_key = key
        return SceneView.create(geo, self.lighting.snapshot, frame, sky=sky,
                                prev_frame=prev_frame, materials=mats,
                                attrs_packed=self._attrs_packed,
                                star_dirs=star_dirs, star_colors=star_colors)

    def serialize(self) -> dict:
        index = {go: i for i, go in enumerate(self.game_objects)}
        objs = [{
            "name": go.name,
            "instanceId": go.instance_id,
            "position": go.position.tolist(),
            "rotation": go.rotation.tolist(),
            "scale": go.scale.tolist(),
            "parentIndex": index.get(go.parent, -1),
            "components": [c.serialize() for c in go.components],
        } for go in self.game_objects]
        return {"name": self.name, "gameObjects": objs}

    def save(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.serialize(), f, sort_keys=False)

    @classmethod
    def deserialize(cls, doc: dict, assets=None, device=None) -> "World":
        """A world from a `.world` document (a dict of lists and numbers),
        instance ids kept."""
        world = cls(doc.get("name", "World"), device=device)
        _instantiate_entries(world, doc.get("gameObjects", []) or [], True, assets)
        return world

    @classmethod
    def load(cls, path: str, assets=None, device=None) -> "World":
        import yaml

        with open(path) as f:
            return cls.deserialize(yaml.safe_load(f), assets, device=device)
