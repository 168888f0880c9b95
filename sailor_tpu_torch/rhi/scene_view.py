"""SceneView: the render-thread snapshot of the world (counterpart of
sailor_tpu/rhi/scene_view.py, Runtime/RHI/SceneView.h).

It holds geometry, lights, frame matrices and the packed per-source-triangle
attribute table — the state a frame renders from, made once per scene.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sailor_tpu_torch.kernels.lights import Lights
from sailor_tpu_torch.raster.setup import Geometry
from sailor_tpu_torch.rhi.types import FrameData


@dataclasses.dataclass
class SceneView:
    """Everything the frame graph needs to render one camera's view."""

    geometry: Geometry
    lights: Lights
    frame: FrameData
    sky: Any = None          # the Sky node is not ported yet
    materials: Any = None    # MaterialTable: not ported yet (raises in the graph)
    attrs_packed: torch.Tensor | None = None  # (T, 37) pack_source_attributes

    @classmethod
    def create(cls, geometry, lights, frame, sky=None, materials=None,
               pack_attrs: bool = True, attrs_packed=None):
        if materials is not None:
            raise NotImplementedError("materials are not ported yet")
        if pack_attrs and attrs_packed is None and geometry is not None:
            from sailor_tpu_torch.raster.interpolate import pack_source_attributes

            attrs_packed = pack_source_attributes(geometry)
        return cls(geometry=geometry, lights=lights, frame=frame, sky=sky,
                   materials=materials, attrs_packed=attrs_packed)


GEOMETRY_KEYS = ("position", "normal", "uv", "color", "indices", "material_id")
LIGHT_KEYS = ("type", "shadow_type", "position", "direction", "intensity",
              "attenuation", "cutoff", "radius", "num")
FRAME_KEYS = ("view", "projection", "inv_projection", "camera_position",
              "camera_z_near_far", "current_time", "delta_time")


def scene_from_numpy(arrays: dict[str, np.ndarray], device) -> SceneView:
    """Build a SceneView from numpy arrays, e.g. those of another
    implementation's scene, so both render from identical inputs.

    Keys: ``geometry.<f>`` for f in GEOMETRY_KEYS, ``lights.<f>`` for f in
    LIGHT_KEYS, ``frame.<f>`` for f in FRAME_KEYS and, optionally,
    ``attrs_packed`` (T, 37); without it the table is packed here."""
    def t(key):
        return torch.from_numpy(np.array(arrays[key])).to(device)

    geo = Geometry(**{f: t(f"geometry.{f}") for f in GEOMETRY_KEYS})
    lights = Lights(**{f: t(f"lights.{f}") for f in LIGHT_KEYS if f != "num"},
                    num=int(arrays["lights.num"]))
    frame = FrameData(**{f: t(f"frame.{f}") for f in FRAME_KEYS})
    packed = t("attrs_packed") if "attrs_packed" in arrays else None
    return SceneView.create(geo, lights, frame, attrs_packed=packed)
