"""The port's engine loop, CLI, console and asset registry, on the CPU.

- ``EngineLoop.run(2)`` over ``scenes.flagship_world_doc(40, 8)`` at
  128x96 (the camera orbits, so both frames move a transform) through all
  of content/DefaultRenderer.renderer with the reference's test config, in
  both packages, held at test_torch_world.py's bars (Depth, TriId and
  LightIndices exact; Main within 1e-4 relative on >= 99.9% of the pixels
  more than 16 px from the border and >= 98% of all; Final within 2/255);
- ``python -m sailor_tpu_torch --cpu`` writes a 96x128x3 PNG, run in a
  temporary copy of content/ (the registry writes `.asset` sidecars
  beside files that lack one);
- input drives EditorComponent (as the reference's
  test_engine_aux.py:195); supersample=2 resolves Final as the reference's
  ``reduce_window`` does (bit-equal); a ``torch.AcceleratorError`` rebuilds
  the graph and retries once, and a second one propagates; the console's
  capture, profile, stats.memory, world.save, scan and refresh; the
  registry scans the files the reference's does and loads worlds,
  prefabs and renderer files.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets.registry import AssetRegistry as JAssetRegistry
from sailor_tpu_torch.__main__ import main
from sailor_tpu_torch.assets.registry import AssetRegistry
from sailor_tpu_torch.engine import World
from sailor_tpu_torch.engine import input as ik
from sailor_tpu_torch.engine.app import EngineLoop, Renderer
from sailor_tpu_torch.engine.components import EditorComponent
from sailor_tpu_torch.engine.console import Console
from sailor_tpu_torch.engine.input import InputState
from sailor_tpu_torch.framegraph import FrameGraphAsset
from sailor_tpu_torch.kernels.sky import SkyParams
from sailor_tpu_torch.scenes import flagship_world_doc
from sailor_tpu_torch.utils.capture import FrameCapture
from sailor_tpu_torch.utils.png import decode_png
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)
from test_torch_world import EDITOR_WORLD, RENDERER, TEST_CONFIG, check_frame, run_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(TEST_CONFIG, shadow_resolution=64, env_resolution=8)


def test_flagship_world_engine_loop_matches_jax():
    got, ref = run_both(flagship_world_doc(40, 8, aspect=128 / 96), 128, 96, TEST_CONFIG)
    assert got["Final"].shape == (96, 128, 3)
    check_frame(got, ref)


@pytest.fixture
def content_copy(tmp_path, monkeypatch):
    """A working directory holding a copy of the repository's content/."""
    shutil.copytree(os.path.join(REPO, "content"), tmp_path / "content")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_cli_cpu_writes_png(content_copy, capsys):
    out = str(content_copy / "frame.png")
    rc = main(["--cpu", "--width", "128", "--height", "96", "--frames", "2", "--out", out,
               "--command", "stats.memory", "--command", "scan"])
    assert rc == 0
    with open(out, "rb") as f:
        img = decode_png(f.read())
    assert img.shape == (96, 128, 3) and img.std() > 1
    text = capsys.readouterr().out
    assert "2 frames in" in text and "transform pool: 15/1024" in text
    assert "scanned 2 assets" in text


def test_input_drives_editor_camera():
    w = World(device="cpu")
    go = w.instantiate("editor")
    cam = go.add_component(EditorComponent(move_speed=2.0))
    inp = InputState()
    w.input = inp
    inp.key_down(ik.KEY_W)
    assert inp.is_key_down(ik.KEY_W) and inp.is_key_pressed(ik.KEY_W)
    p0 = np.asarray(go.position)
    w.tick(0.5)
    inp.end_frame()
    assert not inp.is_key_pressed(ik.KEY_W)  # the edge cleared
    p1 = np.asarray(go.position)
    np.testing.assert_allclose(p1 - p0, [0.0, 0.0, -1.0], atol=1e-6)  # 2 m/s down -z
    inp.key_up(ik.KEY_W)
    inp.button_down(1)  # right-drag look turns the yaw
    inp.move_cursor(0, 0)
    inp.end_frame()
    inp.move_cursor(40, 0)
    w.tick(0.1)
    assert abs(cam.yaw + 0.2) < 1e-9
    q = go.rotation
    assert abs(q[1]) > 0.09 and abs(np.linalg.norm(q) - 1) < 1e-6


def test_editor_component_replaces_authored_rotation():
    """As the reference's EditorComponent, once the loop injects input the
    camera's authored rotation becomes quat_from_euler(0, 0, 0) (ROADMAP C)."""
    w = World.load(EDITOR_WORLD, device="cpu")
    cam = w.find("Camera")
    assert cam.rotation[3] < 0.95
    w.input = InputState()
    w.tick(1 / 60)
    np.testing.assert_array_equal(cam.rotation, [0.0, 0.0, 0.0, 1.0])


def _loop(width=128, height=64, **config):
    world = World.load(EDITOR_WORLD, device="cpu")
    r = Renderer(RENDERER, width, height, config=dict(SMALL, **config), device="cpu")
    return EngineLoop(world, r, sky=SkyParams.default()), r


def test_supersampled_renderer_resolves():
    loop, r = _loop(supersample=2)
    targets = loop.process_cpu_frame(1 / 60)
    ss = targets["FinalSS"]
    assert ss.shape == (128, 256, 3) and targets["Final"].shape == (64, 128, 3)
    ref = jax.lax.reduce_window(jnp.asarray(ss.numpy()), 0.0, jax.lax.add, (2, 2, 1),
                                (2, 2, 1), "VALID") * (1.0 / 4)
    np.testing.assert_array_equal(targets["Final"].numpy(), np.asarray(ref))


class _LostGraph:
    def __init__(self, counter, error=torch.AcceleratorError):
        self.counter, self.error = counter, error

    def initial_state(self):
        return {}

    def prepare(self, scene, state):
        pass

    def process(self, scene, state):
        self.counter["n"] += 1
        raise self.error("CUDA error: device lost")


def test_fix_lost_device_retries_once(monkeypatch):
    loop, r = _loop()
    boom = {"n": 0}
    r.frame_graph = _LostGraph(boom)
    targets = loop.process_cpu_frame(1 / 60)  # fails once, rebuilds, retries
    assert boom["n"] == 1 and r.stats["device_losses"] == 1
    assert bool(torch.isfinite(targets["Final"]).all())
    assert r.frame_graph.device.type == "cpu"  # rebuilt on its own device
    # a second failure in the retry propagates
    monkeypatch.setattr(r, "_build", lambda: _LostGraph(boom))
    r.frame_graph = _LostGraph(boom)
    with pytest.raises(torch.AcceleratorError):
        loop.process_cpu_frame(1 / 60)
    assert boom["n"] == 3 and r.stats["device_losses"] == 2
    # other errors are not device losses
    r.frame_graph = _LostGraph(boom, RuntimeError)
    with pytest.raises(RuntimeError):
        loop.process_cpu_frame(1 / 60)
    assert boom["n"] == 4 and r.stats["device_losses"] == 2


def test_console_capture_profile_and_commands(tmp_path):
    loop, r = _loop()
    r.capture = FrameCapture(str(tmp_path / "captures"))
    con = Console(world=loop.world, renderer=r)
    assert con.execute("profile") == "no frame pushed yet"
    assert "armed" in con.execute("capture")
    loop.process_cpu_frame(1 / 60)
    assert not r.capture.armed and r.capture.num_captures == 1
    with open(os.path.join(r.capture.last_path, "manifest.json")) as f:
        man = json.load(f)
    assert man["targets"]["Final"]["file"] == "Final.png"
    assert man["targets"]["TriId"]["file"] == "TriId.npy"
    with open(os.path.join(r.capture.last_path, "Final.png"), "rb") as f:
        assert decode_png(f.read()).shape == (64, 128, 3)
    out = con.execute("profile")
    lines = out.splitlines()
    assert len(lines) == len(r.frame_graph.nodes) + 1 and lines[-1].startswith("TOTAL")
    assert sorted(k[:2] for k in r.stats["node_ms"]) == [
        f"{i:02d}" for i in range(len(r.frame_graph.nodes))]
    assert "cpu: (no device memory stats)" in con.execute("stats.memory")
    path = str(tmp_path / "saved.world")
    assert con.execute(f"world.save {path}") == f"saved {path}"
    assert World.load(path, device="cpu").serialize() == loop.world.serialize()
    assert con.execute("world.save").startswith("usage")
    graph = r.frame_graph
    assert con.execute("refresh") == "frame graph refreshed" and r.frame_graph is not graph
    assert con.execute("scan") == "no asset registry"
    assert con.execute("nope").startswith("unknown command 'nope'")
    assert not any(k.startswith("cache.") for k in con.commands)  # A 10: not ported
    assert {k for k in con.commands if k.endswith(".benchmark")} == {
        f"{n}.benchmark" for n in ("memory", "pool", "scheduler", "bvh", "math")}


def test_registry_scans_and_loads(tmp_path):
    """The port's registry counts the files the reference's counts in a
    copy of content/ with files of every registered kind, loads worlds,
    prefabs and renderer files, writes a sidecar for a file without one,
    and reloads a changed file."""
    for name in ("port", "ref"):
        root = tmp_path / name
        shutil.copytree(os.path.join(REPO, "content"), root)
        for fn in ("a.glb", "b.png", "c.mat", "d.bsc5", "e.prefab", "f.txt", "g.hdr"):
            (root / fn).write_text("gameObjects: []\n")
    reg, jreg = AssetRegistry(str(tmp_path / "port")), JAssetRegistry(str(tmp_path / "ref"))
    assert sorted(reg.importers) == sorted(jreg.importers)
    n = reg.scan_content_folder()
    assert n == jreg.scan_content_folder() == 8
    assert os.path.exists(tmp_path / "port" / "e.prefab.asset")
    doc = reg.load(str(tmp_path / "port" / "Editor.world"))
    assert doc["name"] == "EditorWorld"
    assert isinstance(reg.load("DefaultRenderer.renderer"), FrameGraphAsset)
    info = reg.infos[str(tmp_path / "port" / "e.prefab")]
    assert reg.load(info.file_id) == {"gameObjects": []}
    (tmp_path / "port" / "e.prefab").write_text("gameObjects: [{name: x}]\n")
    os.utime(tmp_path / "port" / "e.prefab", (info.load_time + 5, info.load_time + 5))
    assert reg.check_hot_reload() == [info.file_id]
    assert reg.load(info.file_id) == {"gameObjects": [{"name": "x"}]}
    assert reg.load_mesh("sphere", radius=2.0).positions.shape == (17 * 33, 3)


def test_app_registry_and_log_queue():
    """App's submodule registry, and the log queue that the console and
    the renderer write to."""
    from sailor_tpu_torch.engine.app import App
    from sailor_tpu_torch.utils.log import get_log_messages

    loop, r = _loop()
    try:
        assert App.add_submodule(r) is r and App.get_submodule(Renderer) is r
        App.remove_submodule(Renderer)
        assert App.get_submodule(Renderer) is None
        App.add_submodule(loop)
    finally:
        App.shutdown()
    assert App.get_submodule(EngineLoop) is None
    get_log_messages()
    Console(renderer=r).execute("refresh")
    texts = [t for _, t in get_log_messages()]
    assert texts == ["Renderer: refreshing frame graph",
                     "console: refresh -> frame graph refreshed"]
