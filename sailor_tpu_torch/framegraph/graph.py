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

from sailor_tpu_torch import config as cfg
from sailor_tpu_torch.assets.materials import MaterialTable
from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.kernels import sampling
from sailor_tpu_torch.raster import tile_raster
from sailor_tpu_torch.rhi.types import RenderTargets, TargetSpec

_NODE_REGISTRY: dict[str, type] = {}


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
    """Static + per-frame context handed to nodes.

    On one device row0 = 0, the full height is the local height and
    ``comm`` is None. In a row shard (``FrameGraph.process_sharded``)
    ``width``/``height`` are the slice's, ``full_height`` the viewport's,
    ``row0`` the global row of the slice's row 0, and ``comm`` the shard's
    communicator (``parallel.mesh.Comm``) over the ``mesh_axis`` of
    ``mesh_size`` shards: nodes that need global pixel coordinates or data
    of other slices read these."""

    width: int
    height: int
    scene: Any = None
    state: dict | None = None
    values: dict | None = None
    config: dict | None = None
    full_height: int | None = None
    row0: int = 0
    mesh_axis: str | None = None
    mesh_size: int = 1
    comm: Any = None
    _inv_vp: Any = dataclasses.field(default=None, repr=False)  # the frame's, once computed

    def value(self, key: str, default: float = 0.0) -> float:
        return (self.values or {}).get(key, default)

    @property
    def fh(self) -> int:
        return self.full_height if self.full_height is not None else self.height

    @property
    def sharded(self) -> bool:
        return self.mesh_axis is not None

    def upsample(self, src, dst_hw):
        """Integer-factor bilinear upsample (``sampling.upsample_bilinear_pow2``),
        boundary-exact in a row shard."""
        if self.sharded:
            return sampling.upsample_bilinear_pow2_sharded(src, dst_hw, self.comm)
        return sampling.upsample_bilinear_pow2(src, dst_hw)


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


def _check_config(config: dict) -> None:
    """Raise on a tonemap mode that no operator implements (the reference
    raises the same ValueError at the first frame's EyeAdaptation)."""
    from sailor_tpu_torch.kernels.tonemap import MODES

    mode = config.get("tonemap", "aces")
    if mode not in MODES:
        raise ValueError(f"unknown tonemap mode: {mode}")


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
            if name not in _NODE_REGISTRY:
                raise KeyError(f"unknown frame-graph node '{name}' "
                               f"(registered: {sorted(_NODE_REGISTRY)})")
        _check_config(self.config)
        self.targets = RenderTargets(width, height, self.device)
        for spec in asset.targets:
            self.targets.declare(spec)
        self.nodes: list[BaseNode] = [
            _NODE_REGISTRY[e["name"]]({k: v for k, v in e.items() if k != "name"})
            for e in asset.frame
        ]

    @staticmethod
    def _check_scene(scene) -> None:
        """Refuse a frame before any node runs: a materials table of another
        type, or a raster tile height that is not a positive multiple of 8
        (``tile_raster.check_tile_h``)."""
        tile_raster.check_tile_h()
        if scene.materials is not None and not isinstance(scene.materials, MaterialTable):
            raise TypeError("scene.materials must be an assets.materials.MaterialTable, "
                            f"not {type(scene.materials).__name__}")

    def _ctx(self, scene, state) -> RenderContext:
        self._check_scene(scene)
        return RenderContext(width=self.width, height=self.height, scene=scene,
                             state=state, values=self.asset.values,
                             config=self.config)

    def initial_state(self) -> dict:
        """Exposure 0.18; with the CSM cache and a ShadowPrepass node, zero
        maps and moments and a key of -1e30 (the first frame is dirty); with
        the sky cache and a Sky node, a zero (H, W, 3) buffer and an (18,)
        key of -1e30 (never inf: inf - inf is nan, and nan > 0 is false);
        with HiZ culling, a zero pyramid (reverse-Z 0 culls nothing) of the
        shapes DepthHighZ publishes: the culling levels ``mips[2:]`` of its
        ``levels`` (default 8)."""
        f32 = dict(dtype=torch.float32, device=self.device)
        state = {"avg_luminance": torch.tensor(0.18, **f32)}
        names = [n.node_name for n in self.nodes]
        if self.config.get("csm_cache", True) and "ShadowPrepass" in names:
            s = int(self.config.get("shadow_resolution", 1024))
            c = cfg.NUM_CSM_CASCADES
            state["csm/maps"] = torch.zeros(c, s, s, **f32)
            state["csm/evsm"] = torch.zeros(c, s, s, 4, **f32)
            state["csm/key"] = torch.full((c * 16 + 3,), -1e30, **f32)
        if self.config.get("sky_cache", True) and "Sky" in names:
            state["sky/buf"] = torch.zeros(self.height, self.width, 3, **f32)
            state["sky/key"] = torch.full((18,), -1e30, **f32)
        if self.config.get("hiz_culling", True):
            levels = 8
            for n in self.nodes:
                if n.node_name == "DepthHighZ":
                    levels = int(n.p("levels", 8))
            mips = sampling.build_min_pyramid(
                torch.zeros(self.height, self.width, **f32), levels)
            for i, m in enumerate(mips[2:]):
                state[f"hiz/mip{i}"] = m
        return state

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
                label = n.node_name + (f"/{n.p('shader')}" if n.p("shader") else "")
                timings[f"{i:02d}_{label}"] = (time.perf_counter() - t0) * 1e3
        new_state = dict(state)
        new_state.update(targets.pop("state_out", {}))
        return targets, new_state

    def process(self, scene, state: dict):
        """Run the whole graph. Returns (targets, new_state)."""
        return self._run(scene, state, None)

    def process_views(self, scene, states: list, frames: list):
        """Render N cameras of one world, one frame each (RHISceneView's
        per-camera snapshots, SceneView.h:85-115; RHIFrameGraph runs once a
        snapshot, RHIFrameGraph.cpp:95).

        ``frames``: one FrameData a camera; ``states``: one temporal state a
        camera (the CSM cache, HiZ pyramid, exposure and sky cache must not
        bleed between views). The host-side bakes of ``prepare``
        (environment, particles) are kept by the nodes and shared. The main
        camera (``scene.frame``) keeps its previous frame for MotionBlur;
        other views reproject against themselves.

        Returns (list of target dicts, list of new states)."""
        outs, new_states = [], []
        for frame, st in zip(frames, states):
            view_scene = dataclasses.replace(
                scene, frame=frame,
                prev_frame=scene.prev_frame if frame is scene.frame else frame)
            t, s = self.process(view_scene, st)
            outs.append(t)
            new_states.append(s)
        return outs, new_states

    #: state entries that hold the shard's rows; gathered to full height
    ROW_LOCAL_STATE = ("hiz/", "particles/trail", "sky/buf")

    def process_sharded(self, scene, state: dict, mesh, axis: str = "screen",
                        extra_outputs: tuple = ()):
        """Run the whole graph split by pixel rows over ``mesh``
        (``parallel.mesh.make_mesh``): each shard runs every node on its
        slice of ``height // n`` rows, with the slice's targets on its
        device, and the nodes exchange what crosses slices through the
        shard's communicator. Returns ({"Final", "Main", *extra_outputs}
        gathered to full height, new_state) on the first shard's device:
        the row-local state (``ROW_LOCAL_STATE``: the HiZ pyramid, the
        particle trail, the sky buffer) is gathered to full height, the
        rest (the CSM cache, the exposure, ...) is the same on every shard
        and is passed on. Raises ValueError unless the height splits into
        32-row tile rows across the shards; the first error of any shard
        is raised (``Mesh.run``)."""
        n = mesh.size
        if axis != mesh.axis:
            raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
        if self.height % (n * 32) != 0:
            raise ValueError(f"height {self.height} must split into 32-px tile rows "
                             f"across {n} shards")
        h_local = self.height // n
        self._check_scene(scene)

        def shard(comm):
            from sailor_tpu_torch.parallel.mesh import replicate

            dev = comm.device
            local = RenderTargets(self.width, h_local, dev)
            for spec in self.asset.targets:
                local.declare(spec)
            sc, st = replicate(scene, dev), replicate(state, dev)
            ctx = RenderContext(width=self.width, height=h_local, scene=sc, state=st,
                                values=self.asset.values, config=self.config,
                                full_height=self.height, row0=comm.index * h_local,
                                mesh_axis=axis, mesh_size=n, comm=comm)
            targets = local.allocate()
            for nd in self.nodes:
                targets = nd.process(ctx, targets)
            out = {name: comm.gather(targets[name])
                   for name in ("Final", "Main") + tuple(extra_outputs)}
            new_state = dict(state)
            for k, v in targets.get("state_out", {}).items():
                if k.startswith(self.ROW_LOCAL_STATE):
                    new_state[k] = comm.gather(v)
                else:
                    new_state[k] = v
            return out, new_state

        return mesh.run(shard)[0]

    def process_debug(self, scene, state: dict):
        """Run the graph node by node, synchronising the device after each,
        and return (targets, new_state, {node: wall ms})."""
        timings: dict[str, float] = {}
        targets, new_state = self._run(scene, state, timings)
        return targets, new_state, timings
