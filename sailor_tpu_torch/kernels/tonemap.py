"""Tone mapping (counterpart of sailor_tpu/kernels/tonemap.py,
Tonemapping.shader); this slice needs the ACES fit."""

from __future__ import annotations

import torch

# sRGB => XYZ => D65_2_D60 => AP1 => RRT_SAT
_ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
# ODT_SAT => XYZ => D60_2_D65 => sRGB
_ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def _mat3(m, c):
    mt = torch.tensor(m, dtype=torch.float32, device=c.device)
    return c @ mt.T


def aces(color):
    """ACES RRT+ODT fit (Stephen Hill); input linear HDR RGB, output [0,1]."""
    c = _mat3(_ACES_INPUT, color)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    c = _mat3(_ACES_OUTPUT, a / b)
    return torch.clamp(c, 0.0, 1.0)


def tonemap(color, avg_luminance, *, mode: str = "aces"):
    """Exposure by the adapted average luminance, then the operator."""
    if mode != "aces":
        raise NotImplementedError(f"tonemap mode {mode!r} is not ported yet")
    key = 9.6 * avg_luminance + 1e-4
    return aces(color / key)
