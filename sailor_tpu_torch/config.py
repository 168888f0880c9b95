"""Engine constants and device selection for the PyTorch port.

The constants are copies of ``sailor_tpu/config.py`` (Constants.glsl parity);
the port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

#: Forward+ light-culling tile edge, in pixels (Constants.glsl LIGHTS_CULLING_TILE_SIZE).
LIGHTS_CULLING_TILE_SIZE = 16
#: Max candidate lights per tile before impact sort (LIGHTS_CANDIDATES_PER_TILE).
LIGHTS_CANDIDATES_PER_TILE = 196
#: Max lights shaded per tile (LIGHTS_PER_TILE).
LIGHTS_PER_TILE = 128
#: Max lights per world (Runtime/ECS/LightingECS.h:53).
MAX_LIGHTS = 65535
#: Number of cascaded-shadow-map cascades (NUM_CSM_CASCADES).
NUM_CSM_CASCADES = 4
#: Cascade split fractions of zFar (Constants.glsl ShadowCascadeLevels).
SHADOW_CASCADE_LEVELS = (0.05, 0.1, 0.333333, 0.5)
#: CSM shadow-map resolution (Runtime/ECS/LightingECS.h cascade targets 4096^2).
CSM_RESOLUTION = 4096
#: EVSM exponents (Lighting.glsl EVSM_C1/C2).
EVSM_C1 = 40.0
EVSM_C2 = 40.0
#: GPU-culling workgroup (Constants.glsl GPU_CULLING_GROUP_SIZE).
GPU_CULLING_GROUP_SIZE = 256
#: Luminance weights used across histogram/tonemap passes (RTR vol4 pg. 278).
RGB_TO_LUM = (0.2125, 0.7154, 0.0721)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Asking for the card where there is none raises; nothing falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sailor_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static per-pipeline configuration: the frame size, the light
    capacity and the raster's binning capacities. Kept for parity with
    the reference's public names (its jit statics); the port's pipeline
    does not read it: a frame graph takes its size and options itself."""

    width: int = 1920
    height: int = 1080
    max_lights: int = 1024
    msaa: int = 1
    raster_tile: int = 32          # raster tile edge in pixels
    max_tris_per_tile: int = 512   # per-tile bin capacity
    reverse_z: bool = True

    @property
    def num_tiles_x(self) -> int:
        return -(-self.width // LIGHTS_CULLING_TILE_SIZE)

    @property
    def num_tiles_y(self) -> int:
        return -(-self.height // LIGHTS_CULLING_TILE_SIZE)
