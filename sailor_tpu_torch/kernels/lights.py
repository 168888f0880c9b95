"""Light table as struct-of-arrays (counterpart of sailor_tpu/kernels/lights.py,
Lighting.glsl LightData)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Light types (parity with LightData.type encoding used by Standard.shader)
DIRECTIONAL = 0
POINT = 1
SPOT = 2


@dataclasses.dataclass
class Lights:
    """Padded SoA light table. ``num`` is the live count (<= capacity)."""

    type: torch.Tensor          # (L,) int32
    shadow_type: torch.Tensor   # (L,) int32
    position: torch.Tensor      # (L, 3) world position
    direction: torch.Tensor     # (L, 3) normalized
    intensity: torch.Tensor     # (L, 3) radiance
    attenuation: torch.Tensor   # (L, 3) constant/linear/quadratic
    cutoff: torch.Tensor        # (L, 2) cos inner/outer (spot)
    radius: torch.Tensor        # (L,) bounds radius
    num: int                    # live count

    @property
    def capacity(self) -> int:
        return self.type.shape[0]

    @property
    def valid_mask(self):
        return torch.arange(self.capacity, device=self.type.device) < self.num

    @classmethod
    def from_host(cls, types, positions, directions, intensities,
                  attenuations=None, cutoffs=None, radii=None,
                  shadow_types=None, capacity: int | None = None,
                  device=None) -> "Lights":
        n = len(types)
        capacity = capacity or max(1, n)
        defaults = {
            "type": np.zeros(capacity, np.int32),
            "shadow_type": np.zeros(capacity, np.int32),
            "position": np.zeros((capacity, 3), np.float32),
            "direction": np.tile(
                np.asarray([[0.0, -1.0, 0.0]], np.float32), (capacity, 1)),
            "intensity": np.zeros((capacity, 3), np.float32),
            "attenuation": np.tile(
                np.asarray([[1.0, 0.0, 0.0]], np.float32), (capacity, 1)),
            "cutoff": np.zeros((capacity, 2), np.float32),
            "radius": np.zeros(capacity, np.float32),
        }

        def put(field, values, default=None):
            arr = defaults[field]
            if values is not None:
                arr[:n] = np.asarray(values)
            elif default is not None:
                arr[:n] = default
            return torch.from_numpy(arr).to(device)

        return cls(
            type=put("type", np.asarray(types, np.int32)),
            shadow_type=put("shadow_type", shadow_types),
            position=put("position", positions),
            direction=put("direction", directions),
            intensity=put("intensity", intensities),
            attenuation=put("attenuation", attenuations),
            cutoff=put("cutoff", cutoffs),
            radius=put("radius", radii, default=100.0),
            num=n,
        )
