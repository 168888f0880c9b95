"""Standard components (counterpart of sailor_tpu/engine/components.py,
Runtime/Components/): Camera, Light, MeshRenderer, the demo TestComponent
(a grid of point lights and an orbiting game object) and the editor's fly
camera."""

from __future__ import annotations

import numpy as np

from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.engine.world import Component, register_component


def primitive_mesh(name: str, params: dict):
    """The primitive that a mesh asset name stands for, or None."""
    if name == "cube":
        return primitives.cube(params.get("size", 1.0))
    if name == "sphere":
        return primitives.uv_sphere(params.get("radius", 0.5))
    if name == "plane":
        return primitives.plane(params.get("size", 1.0))
    return None


@register_component
class CameraComponent(Component):
    """CameraComponent.h: fov, aspect, near and far -> a CameraSystem entry."""

    serialized_fields = ("fov_degrees", "aspect", "z_near", "z_far")

    def __init__(self, fov_degrees: float = 60.0, aspect: float = 16 / 9,
                 z_near: float = 0.1, z_far: float = 100.0, **kw):
        super().__init__(**kw)
        self.fov_degrees = fov_degrees
        self.aspect = aspect
        self.z_near = z_near
        self.z_far = z_far
        self.handle = None

    def begin_play(self):
        w = self.game_object.world
        self.handle = w.cameras.add(
            self.game_object.transform, fov_y=np.deg2rad(self.fov_degrees),
            aspect=self.aspect, z_near=self.z_near, z_far=self.z_far)

    def end_play(self):
        if self.handle is not None:
            self.game_object.world.cameras.pool.release(self.handle)


@register_component
class LightComponent(Component):
    """LightComponent.h: type, intensity, attenuation, cutoff, radius."""

    serialized_fields = ("light_type", "intensity", "attenuation", "direction", "cutoff",
                         "radius", "shadow_type")

    def __init__(self, light_type: int = 1, intensity=(1.0, 1.0, 1.0),
                 attenuation=(1.0, 0.0, 1.0), direction=(0.0, -1.0, 0.0),
                 cutoff=(0.9, 0.7), radius: float = 10.0, shadow_type: int = 0, **kw):
        super().__init__(**kw)
        self.light_type = light_type
        self.intensity = list(intensity)
        self.attenuation = list(attenuation)
        self.direction = list(direction)
        self.cutoff = list(cutoff)
        self.radius = radius
        self.shadow_type = shadow_type
        self.handle = None

    def begin_play(self):
        w = self.game_object.world
        self.handle = w.lighting.add(
            self.game_object.transform, type=self.light_type, intensity=self.intensity,
            attenuation=self.attenuation, direction=self.direction, cutoff=self.cutoff,
            radius=self.radius, shadow_type=self.shadow_type)

    def end_play(self):
        if self.handle is not None:
            self.game_object.world.lighting.pool.release(self.handle)


@register_component
class MeshRendererComponent(Component):
    """MeshRendererComponent.h: a mesh and a material id -> a
    StaticMeshSystem instance. ``mesh`` is a primitives.Mesh, or
    ``mesh_asset`` names a primitive ("cube", "sphere", "plane") or an
    asset-registry model resolved at load time."""

    serialized_fields = ("mesh_asset", "material_id", "mesh_params")

    def __init__(self, mesh=None, mesh_asset: str = "", material_id: int = 0,
                 mesh_params: dict | None = None, **kw):
        super().__init__(**kw)
        self.mesh = mesh
        self.mesh_asset = mesh_asset
        self.material_id = material_id
        self.mesh_params = mesh_params or {}
        self.handle = None

    def resolve_assets(self, assets):
        if self.mesh is None and self.mesh_asset:
            self.mesh = assets.load_mesh(self.mesh_asset, **self.mesh_params)

    def begin_play(self):
        if self.mesh is None:
            self.mesh = primitive_mesh(self.mesh_asset or "cube", self.mesh_params)
            if self.mesh is None:
                raise KeyError(f"cannot resolve mesh asset '{self.mesh_asset}' "
                               "without a registry")
        w = self.game_object.world
        self.handle = w.meshes.add(self.mesh, self.game_object.transform, self.material_id)

    def end_play(self):
        if self.handle is not None:
            self.game_object.world.meshes.remove(self.handle)


@register_component
class TestComponent(Component):
    """The demo scene component (Runtime/Components/TestComponent.cpp): spawns
    a grid of coloured point lights and orbits its game object about the
    y axis (its rotation is left as it is)."""

    __test__ = False  # not a pytest class
    serialized_fields = ("num_lights", "orbit_radius", "orbit_speed")

    def __init__(self, num_lights: int = 16, orbit_radius: float = 10.0,
                 orbit_speed: float = 0.2, **kw):
        super().__init__(**kw)
        self.num_lights = num_lights
        self.orbit_radius = orbit_radius
        self.orbit_speed = orbit_speed
        self._t = 0.0

    def begin_play(self):
        w = self.game_object.world
        rng = np.random.default_rng(1)
        side = max(1, int(np.sqrt(self.num_lights)))
        for i in range(self.num_lights):
            go = w.instantiate(f"light_{i}")
            go.position = [(i % side - side / 2) * 3.0, 0.8, (i // side - side / 2) * 3.0]
            go.add_component(LightComponent(
                light_type=1, intensity=(rng.uniform(0.5, 4, 3)).tolist(), radius=4.0))

    def tick(self, dt: float):
        self._t += dt * self.orbit_speed
        r = self.orbit_radius
        self.game_object.position = [
            r * np.cos(self._t), self.game_object.position[1], r * np.sin(self._t)]


@register_component
class EditorComponent(Component):
    """The editor's camera rig and grid toggle (EditorComponent.cpp)."""

    serialized_fields = ("show_grid", "move_speed")

    def __init__(self, show_grid: bool = True, move_speed: float = 5.0, **kw):
        super().__init__(**kw)
        self.show_grid = show_grid
        self.move_speed = move_speed
        self.yaw = 0.0
        self.pitch = 0.0

    def tick(self, dt: float):
        """The input-driven fly camera (EditorComponent.cpp:23-176: WASD/QE
        move, right-drag look), from ``world.input`` when a frontend (the
        EngineLoop) provides one. Like the reference, it writes the rotation
        from its own yaw and pitch on every tick, so a world's authored
        camera rotation is replaced by quat_from_euler(0, 0, 0) until the
        mouse turns it."""
        inp = getattr(self.game_object.world, "input", None)
        if inp is None:
            return
        from sailor_tpu_torch.core import math3d as m3
        from sailor_tpu_torch.engine import input as ik

        if inp.is_button_down(1):  # right mouse: look
            dx, dy = inp.cursor_delta()
            self.yaw -= dx * 0.005
            self.pitch = float(np.clip(self.pitch - dy * 0.005, -1.4, 1.4))
        rot = m3.quat_from_euler(self.yaw, self.pitch, 0.0)
        self.game_object.rotation = rot.numpy()

        fwd = m3.quat_rotate(rot, [0.0, 0.0, -1.0]).numpy()
        right = m3.quat_rotate(rot, [1.0, 0.0, 0.0]).numpy()
        move = np.zeros(3)
        if inp.is_key_down(ik.KEY_W):
            move += fwd
        if inp.is_key_down(ik.KEY_S):
            move -= fwd
        if inp.is_key_down(ik.KEY_D):
            move += right
        if inp.is_key_down(ik.KEY_A):
            move -= right
        if inp.is_key_down(ik.KEY_E):
            move += [0.0, 1.0, 0.0]
        if inp.is_key_down(ik.KEY_Q):
            move -= [0.0, 1.0, 0.0]
        speed = self.move_speed * (3.0 if inp.is_key_down(ik.KEY_SHIFT) else 1.0)
        if np.any(move != 0.0):
            self.game_object.position = (
                np.asarray(self.game_object.position) + move * (speed * dt)).tolist()
