"""App, Renderer and EngineLoop (counterpart of sailor_tpu/engine/app.py;
Runtime/Sailor.cpp's submodule registry and main loop,
Runtime/Engine/EngineLoop.cpp and Runtime/RHI/Renderer.cpp).

PyTorch queues a frame's kernels and returns; the Renderer records one
CUDA event after each frame and, before queueing another, waits on the
oldest while ``max_frames_in_flight`` are queued (Renderer.cpp:209-214's
back-pressure). The host reads nothing else back for pacing.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.engine.world import World
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.kernels.postprocess import window_sum
from sailor_tpu_torch.utils.capture import FrameCapture
from sailor_tpu_torch.utils.log import SAILOR_LOG


class App:
    """Static submodule registry (Sailor::App)."""

    _submodules: dict[type, Any] = {}

    @classmethod
    def add_submodule(cls, instance) -> Any:
        cls._submodules[type(instance)] = instance
        return instance

    @classmethod
    def get_submodule(cls, t: type):
        return cls._submodules.get(t)

    @classmethod
    def remove_submodule(cls, t: type) -> None:
        cls._submodules.pop(t, None)

    @classmethod
    def shutdown(cls) -> None:
        cls._submodules.clear()


class Renderer:
    """Frame-graph lifecycle and pacing on one device (the card unless the
    caller names another). ``config["supersample"] = N`` renders the graph
    at N times the size and box-resolves Final (kept as FinalSS) back."""

    def __init__(self, renderer_path: str, width: int, height: int,
                 config: dict | None = None, max_frames_in_flight: int = 2, device=None):
        self.device = resolve_device(device)
        self.asset_path = renderer_path
        self.width = width
        self.height = height
        self.config = config or {}
        self.supersample = int(self.config.get("supersample", 1))
        self.max_frames_in_flight = max_frames_in_flight
        self._in_flight: list = []  # a CUDA event recorded after each queued frame
        self.frame_graph = self._build()
        self.state = self.frame_graph.initial_state()
        self.stats = {"gpu_frames": 0, "last_frame_ms": 0.0}
        self.capture = FrameCapture()  # armed by the console's `capture`
        self._last_scene = None

    def _build(self) -> FrameGraph:
        ss = self.supersample
        return FrameGraph(FrameGraphAsset.load(self.asset_path), self.width * ss,
                          self.height * ss, config=self.config, device=self.device)

    def refresh_frame_graph(self) -> None:
        """F5 hot reload: parse the .renderer again and rebuild the graph."""
        SAILOR_LOG("Renderer: refreshing frame graph")
        self.frame_graph = self._build()

    def fix_lost_device(self) -> None:
        """Device-loss recovery (Renderer::FixLostDevice): drop the frames
        in flight, rebuild the graph on the same device and reseed the
        temporal state; the next frame starts from scratch."""
        SAILOR_LOG("Renderer: device lost, rebuilding frame graph")
        self._in_flight.clear()
        self.frame_graph = self._build()
        self.state = self.frame_graph.initial_state()
        self.stats["device_losses"] = self.stats.get("device_losses", 0) + 1

    def push_frame(self, scene_view):
        """Queue one frame and return its targets. A device error
        (``torch.AcceleratorError``) rebuilds the graph (``fix_lost_device``)
        and retries once, on the same device; a second error propagates."""
        try:
            return self._push_frame(scene_view)
        except torch.AcceleratorError:
            self.fix_lost_device()
            return self._push_frame(scene_view)

    def profile_nodes(self, repeats: int = 2) -> dict:
        """Per-node times of the last pushed scene (``process_debug``, a
        synchronise after each node), the least of ``repeats`` runs; kept
        in ``stats['node_ms']``."""
        if self._last_scene is None:
            return {}
        timings: dict[str, float] = {}
        for _ in range(repeats):
            _, _, t = self.frame_graph.process_debug(self._last_scene, dict(self.state))
            for k, v in t.items():
                timings[k] = min(v, timings.get(k, v))
        self.stats["node_ms"] = timings
        return timings

    def _push_frame(self, scene_view):
        self._last_scene = scene_view
        if len(self._in_flight) >= self.max_frames_in_flight:
            self._in_flight.pop(0).synchronize()
        t0 = time.perf_counter()
        self.frame_graph.prepare(scene_view, self.state)
        targets, self.state = self.frame_graph.process(scene_view, self.state)
        if self.supersample > 1:
            ss = self.supersample
            targets["FinalSS"] = targets["Final"]
            targets["Final"] = window_sum(targets["Final"], ss) * (1.0 / (ss * ss))
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))  # the frame's device
            self._in_flight.append(event)
        self.stats["gpu_frames"] += 1
        self.stats["last_frame_ms"] = (time.perf_counter() - t0) * 1e3
        if self.capture.armed:
            path = self.capture.capture(targets, state=self.state)
            SAILOR_LOG(f"Renderer: frame captured to {path}")
        return targets

    def wait_idle(self) -> None:
        for event in self._in_flight:
            event.synchronize()
        self._in_flight.clear()


class EngineLoop:
    """CPU frame orchestration (Runtime/Engine/EngineLoop.cpp)."""

    CPU_FPS_CAP = 120.0  # the reference sleeps below ~1000/130 ms

    def __init__(self, world: World, renderer: Renderer, sky=None, stars=None, overlay=None):
        """``stars``: a (directions, colours) pair of (S, 3) arrays for the
        Sky node (assets/stars.py); ``overlay``: an
        engine.overlay.OverlayContext, drawn with ``stats_hud`` each frame
        and blended by the RenderOverlay node."""
        from sailor_tpu_torch.engine.input import InputState

        self.world = world
        self.renderer = renderer
        self.sky = sky
        self.stars = stars
        self.overlay = overlay
        self._prev_frame = None
        self.frame_index = 0
        # frontends inject events; components read world.input during tick
        self.input = InputState()
        world.input = self.input

    def process_cpu_frame(self, dt: float):
        """HUD build (ImGui NewFrame) -> world tick -> scene snapshot ->
        renderer push (one frame, EngineLoop::ProcessCpuFrame)."""
        if self.overlay is not None:
            from sailor_tpu_torch.engine.overlay import stats_hud

            stats_hud(self.overlay, self.renderer.stats)
            self.renderer.state["overlay/canvas"] = torch.from_numpy(
                self.overlay.canvas()).to(self.renderer.device)
        self.world.tick(dt)
        scene = self.world.scene_view(sky=self.sky, stars=self.stars,
                                      prev_frame=self._prev_frame)
        self._prev_frame = scene.frame
        targets = self.renderer.push_frame(scene)
        self.input.end_frame()
        self.frame_index += 1
        return targets

    def run(self, num_frames: int, dt: float = 1 / 60, pace: bool = False):
        """Fixed-step loop (the headless main loop); returns the last
        frame's targets after the device is idle."""
        last = None
        for _ in range(num_frames):
            t0 = time.perf_counter()
            last = self.process_cpu_frame(dt)
            if pace:
                elapsed = time.perf_counter() - t0
                budget = 1.0 / self.CPU_FPS_CAP
                if elapsed < budget:
                    time.sleep(budget - elapsed)
        self.renderer.wait_idle()
        return last
