"""Engine constants and device selection for the PyTorch port.

The constants are copies of ``sailor_tpu/config.py`` (Constants.glsl parity);
the port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import torch

#: Forward+ light-culling tile edge, in pixels (Constants.glsl LIGHTS_CULLING_TILE_SIZE).
LIGHTS_CULLING_TILE_SIZE = 16
#: Max lights shaded per tile (LIGHTS_PER_TILE).
LIGHTS_PER_TILE = 128
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
