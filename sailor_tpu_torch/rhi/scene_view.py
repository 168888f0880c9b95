"""SceneView: the render-thread snapshot of the world (counterpart of
sailor_tpu/rhi/scene_view.py, Runtime/RHI/SceneView.h).

It holds geometry, lights, frame matrices, the material table (if any),
the packed per-source-triangle attribute table, 49 columns wide with
materials, and the star field — the state a frame renders from, made once
per scene.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sailor_tpu_torch.kernels.lights import Lights
from sailor_tpu_torch.kernels.sky import SkyParams
from sailor_tpu_torch.raster.setup import Geometry
from sailor_tpu_torch.rhi.types import FrameData


@dataclasses.dataclass
class SceneView:
    """Everything the frame graph needs to render one camera's view."""

    geometry: Geometry
    lights: Lights
    frame: FrameData
    sky: SkyParams | None = None  # sun and sky (ShadowPrepass, Sky, Environment, ...)
    materials: Any = None    # assets.materials.MaterialTable, or None (vertex colours)
    attrs_packed: torch.Tensor | None = None  # (T, 37 | 49) pack_source_attributes
    prev_frame: FrameData | None = None  # last frame's camera (MotionBlur); frame if None
    # the Sky node's stars (assets/stars.py): (S, 3) unit directions and
    # linear RGB; (0, 3) on the scene's device when there are none
    star_dirs: torch.Tensor | None = None
    star_colors: torch.Tensor | None = None

    def __post_init__(self):
        if self.prev_frame is None:
            self.prev_frame = self.frame
        dev = self.frame.view.device
        for name in ("star_dirs", "star_colors"):
            v = getattr(self, name)
            setattr(self, name, torch.zeros((0, 3), device=dev) if v is None
                    else torch.as_tensor(v, dtype=torch.float32, device=dev))

    @classmethod
    def create(cls, geometry, lights, frame, sky=None, materials=None,
               pack_attrs: bool = True, attrs_packed=None, prev_frame=None,
               star_dirs=None, star_colors=None):
        if pack_attrs and attrs_packed is None and geometry is not None:
            from sailor_tpu_torch.raster.interpolate import pack_source_attributes

            attrs_packed = pack_source_attributes(geometry, materials)
        return cls(geometry=geometry, lights=lights, frame=frame,
                   sky=sky if sky is not None else SkyParams.default(),
                   materials=materials, attrs_packed=attrs_packed,
                   prev_frame=prev_frame if prev_frame is not None else frame,
                   star_dirs=star_dirs, star_colors=star_colors)


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
    ``prev_frame.<f>`` for f in FRAME_KEYS (else the previous frame is the
    frame), ``attrs_packed`` (T, 37 | 49), without which the table is
    packed here, ``sky.<f>`` for any field of ``SkyParams``, taken as given
    (the sun direction already normalised) into the default sky, and
    ``materials.<f>`` for the fields of a ``MaterialTable`` (its tensors
    as arrays, its host bools and tuples as they are; see
    ``MaterialTable.from_arrays``), without which the scene has none, and
    ``star_dirs``/``star_colors`` (S, 3), without which it has no stars."""
    def t(key):
        return torch.from_numpy(np.array(arrays[key])).to(device)

    geo = Geometry(**{f: t(f"geometry.{f}") for f in GEOMETRY_KEYS})
    lights = Lights(**{f: t(f"lights.{f}") for f in LIGHT_KEYS if f != "num"},
                    num=int(arrays["lights.num"]))
    frame = FrameData(**{f: t(f"frame.{f}") for f in FRAME_KEYS})
    prev = None
    if f"prev_frame.{FRAME_KEYS[0]}" in arrays:
        prev = FrameData(**{f: t(f"prev_frame.{f}") for f in FRAME_KEYS})
    packed = t("attrs_packed") if "attrs_packed" in arrays else None
    sky = dataclasses.replace(SkyParams.default(), **{
        f.name: np.array(arrays[f"sky.{f.name}"], np.float32)
        for f in dataclasses.fields(SkyParams) if f"sky.{f.name}" in arrays})
    materials = None
    if any(k.startswith("materials.") for k in arrays):
        from sailor_tpu_torch.assets.materials import MaterialTable

        materials = MaterialTable.from_arrays(arrays, "materials.", device)
    stars = {k: t(k) for k in ("star_dirs", "star_colors") if k in arrays}
    return SceneView.create(geo, lights, frame, sky=sky, materials=materials,
                            attrs_packed=packed, prev_frame=prev, **stars)
