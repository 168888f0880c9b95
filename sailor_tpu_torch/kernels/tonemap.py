"""Tone mapping (counterpart of sailor_tpu/kernels/tonemap.py,
Tonemapping.shader): the ACES fit, Uncharted 2's filmic curve, Reinhard
and none, on RGB or on the Y of Yxy alone."""

from __future__ import annotations

import torch

from sailor_tpu_torch.core import math3d as m3

MODES = ("aces", "uncharted2", "reinhard", "none")

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


def aces(color):
    """ACES RRT+ODT fit (Stephen Hill); input linear HDR RGB, output [0,1]."""
    c = m3.mat3_rows(_ACES_INPUT, color)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    c = m3.mat3_rows(_ACES_OUTPUT, a / b)
    return torch.clamp(c, 0.0, 1.0)


def _uncharted2_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def uncharted2(color, white_point, exposure):
    curr = _uncharted2_partial(color * exposure)
    white = torch.tensor(white_point, dtype=torch.float32, device=color.device)
    return curr * (1.0 / _uncharted2_partial(white))


def reinhard(color):
    return color / (1.0 + color)


def tonemap(color, avg_luminance, *, mode: str = "aces", luminance_only: bool = False,
            white_point=(4.0, 4.0, 4.0), exposure: float = 1.0):
    """Exposure by the adapted average luminance, then the operator
    ``mode`` (one of MODES); with ``luminance_only`` the operator maps the
    exposed Y of Yxy and the chromaticity is kept."""
    if mode not in MODES:
        raise ValueError(f"unknown tonemap mode: {mode}")
    key = 9.6 * avg_luminance + 1e-4
    if luminance_only:
        yxy = m3.rgb_to_yxy(color)
        c = (yxy[..., 0] / key)[..., None].expand(yxy.shape)
    else:
        c = color / key
    if mode == "aces":
        c = aces(c)
    elif mode == "uncharted2":
        c = uncharted2(c, white_point, exposure)
    elif mode == "reinhard":
        c = reinhard(c)
    if luminance_only:
        return m3.yxy_to_rgb(torch.stack([c[..., 0], yxy[..., 1], yxy[..., 2]], dim=-1))
    return c
