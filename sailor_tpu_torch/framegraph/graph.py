"""Frame-graph core: YAML asset, node registry, eager execution
(counterpart of sailor_tpu/framegraph/graph.py; FrameGraphParser.cpp,
RHIFrameGraph).

The YAML schema is the JAX package's: ``renderTargets``, an ordered
``frame`` node list and named ``float`` values. Nodes self-register by name
with ``@node``. PyTorch runs eagerly, so ``process`` calls the nodes in
order; there is no jit and no executable cache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.rhi.types import RenderTargets, TargetSpec

_NODE_REGISTRY: dict[str, type] = {}

# nodes of the JAX package's registry that this port does not have yet
UNPORTED_NODES = (
    "Clear", "ShadowPrepass", "Sky", "Environment", "PostProcess",
    "RenderTransparent", "Bloom", "Blit", "DepthHighZ", "DebugDraw",
    "RenderOverlay", "CopyTextureToRam", "Particles",
)


def node(name: str):
    """Register a frame-graph node class under its YAML name."""

    def deco(cls):
        cls.node_name = name
        _NODE_REGISTRY[name] = cls
        return cls

    return deco


def node_types() -> dict[str, type]:
    return dict(_NODE_REGISTRY)


class BaseNode:
    """A frame-graph node: a function over the target dict. YAML params
    land in ``self.params``."""

    node_name = "Base"

    def __init__(self, params: dict | None = None):
        self.params = params or {}

    def p(self, key: str, default=None):
        return self.params.get(key, default)

    def prepare(self, ctx: "RenderContext") -> None:
        """Host-side per-frame setup; runs before process()."""

    def process(self, ctx: "RenderContext", targets: dict) -> dict:
        raise NotImplementedError


@dataclasses.dataclass
class RenderContext:
    """Static + per-frame context handed to nodes (single device: row0 = 0,
    full height = local height)."""

    width: int
    height: int
    scene: Any = None
    state: dict | None = None
    values: dict | None = None
    config: dict | None = None
    full_height: int | None = None
    row0: int = 0

    def value(self, key: str, default: float = 0.0) -> float:
        return (self.values or {}).get(key, default)

    @property
    def fh(self) -> int:
        return self.full_height if self.full_height is not None else self.height


@dataclasses.dataclass
class FrameGraphAsset:
    """Parsed `.renderer` file."""

    targets: list[TargetSpec]
    frame: list[dict]
    values: dict[str, float]

    @classmethod
    def from_nodes(cls, names, values: dict | None = None) -> "FrameGraphAsset":
        """An asset with no declared targets running ``names`` in order."""
        return cls(targets=[], frame=[{"name": n} for n in names],
                   values=dict(values or {}))

    @classmethod
    def from_yaml(cls, text: str) -> "FrameGraphAsset":
        import yaml  # PyYAML: needed only to read .renderer files

        doc = yaml.safe_load(text) or {}
        targets = [
            TargetSpec(
                name=t["name"],
                format=t.get("format", "R16G16B16A16_SFLOAT"),
                width=t.get("width", "ViewportWidth"),
                height=t.get("height", "ViewportHeight"),
                mips=t.get("mips", 1),
                clear=tuple(t.get("clear", (0.0, 0.0, 0.0, 0.0))),
            )
            for t in doc.get("renderTargets", []) or []
        ]
        frame = [dict({"name": e} if isinstance(e, str) else e)
                 for e in doc.get("frame", []) or []]
        return cls(targets=targets, frame=frame,
                   values=dict(doc.get("float", {}) or {}))

    @classmethod
    def load(cls, path: str) -> "FrameGraphAsset":
        with open(path) as f:
            return cls.from_yaml(f.read())


def _check_config(config: dict, names: list[str]) -> None:
    """Raise on configuration this port does not implement yet, instead of
    silently rendering something else."""
    unsupported = []
    if "DepthPrepass" in names and config.get("hiz_culling", True):
        unsupported.append("hiz_culling=True (needs the DepthHighZ node)")
    if config.get("raster_mode", "stream") != "stream":
        unsupported.append(f"raster_mode={config['raster_mode']!r}")
    if not config.get("raster_worklist", True):
        unsupported.append("raster_worklist=False")
    if config.get("raster_mxu", False):
        unsupported.append("raster_mxu=True")
    if not config.get("fused_resolve", True):
        unsupported.append("fused_resolve=False")
    if config.get("tonemap", "aces") != "aces":
        unsupported.append(f"tonemap={config['tonemap']!r}")
    if unsupported:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(unsupported))


class FrameGraph:
    """Materialized frame graph on one device (the card unless the caller
    asks for another)."""

    def __init__(self, asset: FrameGraphAsset, width: int, height: int,
                 config: dict | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.asset = asset
        self.width = width
        self.height = height
        self.config = dict(config or {})
        names = [e["name"] for e in asset.frame]
        for name in names:
            if name in UNPORTED_NODES:
                raise NotImplementedError(f"frame-graph node '{name}' is not ported yet")
            if name not in _NODE_REGISTRY:
                raise KeyError(f"unknown frame-graph node '{name}' "
                               f"(registered: {sorted(_NODE_REGISTRY)})")
        _check_config(self.config, names)
        self.targets = RenderTargets(width, height, self.device)
        for spec in asset.targets:
            self.targets.declare(spec)
        self.nodes: list[BaseNode] = [
            _NODE_REGISTRY[e["name"]]({k: v for k, v in e.items() if k != "name"})
            for e in asset.frame
        ]

    def _ctx(self, scene, state) -> RenderContext:
        if scene.materials is not None:
            raise NotImplementedError("materials are not ported yet")
        return RenderContext(width=self.width, height=self.height, scene=scene,
                             state=state, values=self.asset.values,
                             config=self.config)

    def initial_state(self) -> dict:
        return {"avg_luminance": torch.tensor(0.18, dtype=torch.float32,
                                              device=self.device)}

    def prepare(self, scene, state) -> None:
        """Host-side node prep; call once per frame before process."""
        ctx = self._ctx(scene, state)
        for n in self.nodes:
            n.prepare(ctx)

    def _run(self, scene, state, timings: dict | None):
        ctx = self._ctx(scene, state)
        targets = self.targets.allocate()
        targets.update({k: v for k, v in state.items() if k.startswith("rt/")})
        for i, n in enumerate(self.nodes):
            t0 = time.perf_counter()
            targets = n.process(ctx, targets)
            if timings is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings[f"{i:02d}_{n.node_name}"] = (time.perf_counter() - t0) * 1e3
        new_state = dict(state)
        new_state.update(targets.pop("state_out", {}))
        return targets, new_state

    def process(self, scene, state: dict):
        """Run the whole graph. Returns (targets, new_state)."""
        return self._run(scene, state, None)

    def process_sharded(self, *args, **kwargs):
        raise NotImplementedError("multi-device rendering is not ported yet")

    def process_debug(self, scene, state: dict):
        """Run the graph node by node, synchronising the device after each,
        and return (targets, new_state, {node: wall ms})."""
        timings: dict[str, float] = {}
        targets, new_state = self._run(scene, state, timings)
        return targets, new_state, timings
