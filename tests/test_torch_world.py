"""The port's World, components and prefabs against the JAX package's,
on the CPU.

- ``content/Editor.world`` and ``scenes.flagship_world_doc(40, 8)`` load to
  equal ``serialize()`` output in both packages, and a JAX world's
  ``serialize()`` (after ticks that spawned TestComponent's lights)
  carried into the port's ``deserialize`` serializes back to it and ticks
  to bit-equal world matrices;
- save/load and prefab round trips, the hierarchy and the snapshots, as
  the reference's tests/test_world.py and test_engine_aux.py check them;
- ``EngineLoop.run(2)`` over Editor.world at 128x96 through all of
  content/DefaultRenderer.renderer with the reference's test config
  (tests/test_world.py:96-100) in both packages: Depth, TriId and
  LightIndices exact; Main within 1e-4 relative (to max(|ref|, 1e-3)) on
  >= 99.9% of the pixels more than 16 px from the border and on >= 98%
  of all (measured: every inner pixel, 98.95% of all: the reference's
  compiled HBAO at the border, ROADMAP C 8); Final within 2/255 on every
  pixel (measured 8.9e-5).
"""

import os

import numpy as np
import pytest
import torch
import yaml

from sailor_tpu.engine import World as JWorld
from sailor_tpu.engine import prefab as j_prefab
from sailor_tpu.engine.app import EngineLoop as JEngineLoop
from sailor_tpu.engine.app import Renderer as JRenderer
from sailor_tpu.engine.input import InputState as JInputState
from sailor_tpu.kernels.sky import SkyParams as JSkyParams
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.engine import World, prefab
from sailor_tpu_torch.engine.app import EngineLoop, Renderer
from sailor_tpu_torch.engine.components import (CameraComponent, LightComponent,
                                                MeshRendererComponent, TestComponent)
from sailor_tpu_torch.engine.input import InputState
from sailor_tpu_torch.kernels.sky import SkyParams
from sailor_tpu_torch.scenes import flagship_world_doc
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDITOR_WORLD = os.path.join(REPO, "content", "Editor.world")
RENDERER = os.path.join(REPO, "content", "DefaultRenderer.renderer")
# the reference's engine test config (tests/test_world.py:96-100)
TEST_CONFIG = {"shadow_resolution": 128, "env_resolution": 16, "bin_capacity": 256,
               "bin_rounds": 2, "sky_clouds": False}
SUN = (-0.35, -0.7, -0.3)
EXACT = ("Depth", "TriId", "LightIndices")
BAND = 16  # the border band of the reference's compiled HBAO (ROADMAP C 8)


def _docs():
    with open(EDITOR_WORLD) as f:
        return {"editor": yaml.safe_load(f), "flagship": flagship_world_doc(40, 8)}


@pytest.mark.parametrize("name", ["editor", "flagship"])
def test_world_docs_serialize_equal(name):
    doc = _docs()[name]
    got = World.deserialize(doc, device="cpu").serialize()
    ref = JWorld.deserialize(doc).serialize()
    assert got == ref
    assert len(got["gameObjects"]) == len(doc["gameObjects"])


@pytest.mark.parametrize("name", ["editor", "flagship"])
def test_jax_serialize_into_port(name):
    """A JAX world ticked twice (Editor.world's TestComponent has spawned
    its nine lights by then) carried across by its serialize(); the port's
    world serializes back to the same document and, ticked once more
    beside it, gives bit-equal world matrices and light tables."""
    ref = JWorld.deserialize(_docs()[name])
    ref.input = JInputState()
    for _ in range(2):
        ref.tick(1 / 60)
    doc = ref.serialize()
    got = World.deserialize(doc, device="cpu")
    assert got.serialize() == doc
    carried = JWorld.deserialize(doc)
    for w, inp in ((got, InputState()), (carried, JInputState())):
        w.input = inp
        w.tick(1 / 60)
    np.testing.assert_array_equal(got.transforms.world_matrices,
                                  np.asarray(carried.transforms.world_matrices))
    for f in ("position", "direction", "intensity", "radius"):
        np.testing.assert_array_equal(getattr(got.lighting.snapshot, f).numpy(),
                                      np.asarray(getattr(carried.lighting.snapshot, f)))
    assert got.lighting.snapshot.num == int(carried.lighting.snapshot.num)


def test_flagship_world_doc():
    """1,099 game objects at (1000, 96), which grows the transform pool past
    1024; 1,001 lights (the sun first); the camera looks at (0, 0.5, 0)."""
    doc = flagship_world_doc(1000, 96)
    w = World.deserialize(doc, device="cpu")
    assert len(w.game_objects) == 1099 and w.transforms.pool.capacity == 2048
    w.tick(1 / 60)
    assert w.lighting.snapshot.num == 1001 and int(w.lighting.snapshot.type[0]) == 0
    assert w.meshes.geometry.indices.shape[0] == 49730
    cam = w.find("Camera")
    view = w.cameras.main_frame().view
    fwd = -view[2, :3]
    to_target = torch.tensor([0.0, 0.5, 0.0]) - torch.from_numpy(cam.position)
    assert float(fwd @ (to_target / to_target.norm())) > 0.9999


def test_transform_hierarchy():
    w = World(device="cpu")
    parent = w.instantiate("parent")
    child = w.instantiate("child")
    parent.position = [5.0, 0.0, 0.0]
    child.set_parent(parent)
    child.position = [0.0, 2.0, 0.0]
    w.tick(1 / 60)
    np.testing.assert_allclose(w.transforms.world_matrices[child.transform][:3, 3],
                               [5.0, 2.0, 0.0], atol=1e-5)
    parent.rotation = m3.quat_from_axis_angle([0.0, 1.0, 0.0], np.pi / 2).numpy()
    child.position = [1.0, 0.0, 0.0]
    w.tick(1 / 60)
    # +x in the parent's space turned 90 degrees about y is -z
    np.testing.assert_allclose(w.transforms.world_matrices[child.transform][:3, 3],
                               [5.0, 0.0, -1.0], atol=1e-5)


def test_world_tick_builds_snapshots():
    w = World(device="cpu")
    cam = w.instantiate("cam")
    cam.position = [0, 2, 8]
    cam.add_component(CameraComponent())
    sun = w.instantiate("sun")
    sun.add_component(LightComponent(light_type=0, intensity=[2, 2, 2]))
    box = w.instantiate("box")
    box.position = [0, 0.5, 0]
    box.add_component(MeshRendererComponent(mesh_asset="cube"))
    with pytest.raises(RuntimeError, match="camera"):
        w.scene_view()
    w.tick(1 / 60)
    assert w.lighting.snapshot.num == 1
    assert w.meshes.geometry.indices.shape[0] == 12
    view = w.scene_view()
    assert view.frame is not None and tuple(view.star_dirs.shape) == (0, 3)
    # stars go to the world's device once for each pair of arrays
    pair = (np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32))
    first = w.scene_view(stars=pair)
    assert first.star_dirs.shape == (2, 3) and torch.equal(first.star_dirs, torch.ones(2, 3))
    assert w.scene_view(stars=pair).star_dirs is first.star_dirs
    assert w.scene_view(stars=(pair[0].copy(), pair[1])).star_dirs is not first.star_dirs


def test_test_component_spawns_lights_and_destroy():
    w = World(device="cpu")
    demo = w.instantiate("demo")
    demo.add_component(TestComponent(num_lights=5))
    w.tick(1 / 60)
    w.tick(1 / 60)
    assert w.lighting.snapshot.num == 5
    w.destroy(w.find("light_0"))
    w.tick(1 / 60)  # destroys run after the systems, as World::Tick orders them
    assert w.find("light_0") is None and w.lighting.snapshot.num == 5
    w.tick(1 / 60)
    assert w.lighting.snapshot.num == 4


def test_world_save_load_roundtrip(tmp_path):
    w = World("roundtrip", device="cpu")
    cam = w.instantiate("cam")
    cam.position = [1, 2, 3]
    cam.add_component(CameraComponent(fov_degrees=45.0))
    box = w.instantiate("box")
    box.add_component(MeshRendererComponent(mesh_asset="cube", material_id=3))
    box.set_parent(cam)
    path = str(tmp_path / "test.world")
    w.save(path)
    w2 = World.load(path, device="cpu")
    assert w2.name == "roundtrip"
    cam2 = w2.find("cam")
    np.testing.assert_allclose(cam2.position, [1, 2, 3])
    assert cam2.get_component(CameraComponent).fov_degrees == 45.0
    box2 = w2.find("box")
    assert box2.parent is cam2
    assert box2.get_component(MeshRendererComponent).material_id == 3
    assert w2.find_by_instance_id(cam.instance_id) is cam2
    # the reference reads the port's file to the same world
    assert JWorld.load(path).serialize() == w2.serialize()


def test_prefab_roundtrip(tmp_path):
    """As the reference's test_engine_aux.py:118, and the reference reads
    the port's prefab file to the same document."""
    w = World(device="cpu")
    root = w.instantiate("rig")
    root.position = [1, 0, 0]
    child = w.instantiate("lamp")
    child.set_parent(root)
    child.position = [0, 2, 0]
    child.add_component(LightComponent(light_type=1, intensity=[5, 1, 1]))
    path = str(tmp_path / "rig.prefab")
    prefab.save(root, path)
    w2 = World(device="cpu")
    inst = prefab.instantiate(w2, path, position=[10, 0, 0])
    assert inst.name == "rig"
    np.testing.assert_allclose(inst.position, [10, 0, 0])
    lamp = w2.find("lamp")
    assert lamp is not None and lamp.parent is inst
    inst2 = prefab.instantiate(w2, path, position=[-10, 0, 0])
    assert inst2.instance_id != inst.instance_id
    w2.tick(1 / 60)
    assert w2.lighting.snapshot.num == 2
    jw = JWorld()
    j_prefab.instantiate(jw, path, position=[10, 0, 0])
    assert j_prefab.from_game_object(jw.game_objects[0]) == prefab.from_game_object(inst)


def test_world_materials_reach_the_scene_view():
    """A world's material library (an object whose ``table`` is a
    MaterialTable) goes into the snapshot and its 49-column attributes;
    the attributes are packed once while nothing moves."""
    import types

    from sailor_tpu_torch.assets.materials import MaterialTable
    from sailor_tpu_torch.scenes import queue_materials

    doc = _docs()["editor"]
    doc["gameObjects"] = [e for e in doc["gameObjects"] if e["name"] != "Demo"]
    w = World.deserialize(doc, device="cpu")
    table, images = queue_materials(16)
    w.materials = types.SimpleNamespace(
        table=MaterialTable.from_host(table, images, texture_size=16, device="cpu"))
    w.tick(1 / 60)
    first = w.scene_view()
    assert first.materials is w.materials.table and first.attrs_packed.shape[1] == 49
    w.tick(1 / 60)  # nothing moves: no input, no demo component
    assert w.scene_view().attrs_packed is first.attrs_packed


def run_both(doc, width, height, config, frames=2):
    """EngineLoop.run(frames) over the same document in both packages, the
    port on the CPU. Returns (port targets, reference targets)."""
    w = World.deserialize(doc, device="cpu")
    r = Renderer(RENDERER, width, height, config=dict(config), device="cpu")
    got = EngineLoop(w, r, sky=SkyParams.default(sun_direction=SUN)).run(frames)
    jw = JWorld.deserialize(doc)
    jr = JRenderer(RENDERER, width, height, config=dict(config))
    ref = JEngineLoop(jw, jr, sky=JSkyParams.default(sun_direction=SUN)).run(frames)
    assert r.stats["gpu_frames"] == jr.stats["gpu_frames"] == frames
    return ({k: v.numpy() for k, v in got.items() if torch.is_tensor(v)},
            {k: np.asarray(ref[k]) for k in got if torch.is_tensor(got[k])})


def check_frame(got, ref, main_all=0.98):
    """test_torch_frame_full.py's bars: Depth, TriId and LightIndices
    exact; Main within 1e-4 relative on >= 99.9% of the pixels more than
    16 px from the border (and on >= ``main_all`` of all); Final within
    2/255."""
    assert (ref["TriId"] >= 0).mean() > 0.2
    for k in EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rel = (np.abs(got["Main"] - ref["Main"]) / np.maximum(np.abs(ref["Main"]), 1e-3)).max(-1)
    ok = rel <= 1e-4
    assert ok[BAND:-BAND, BAND:-BAND].mean() >= 0.999 and ok.mean() >= main_all
    assert np.abs(got["Final"] - ref["Final"]).max() <= 2 / 255
    assert got["Final"].std() > 0.01


def test_editor_world_engine_loop_matches_jax():
    got, ref = run_both(_docs()["editor"], 128, 96, TEST_CONFIG)
    assert got["Final"].shape == (96, 128, 3)
    check_frame(got, ref)
