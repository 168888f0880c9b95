"""Plain exposure and tonemapping (ComputeHistogram, ComputeAverageLuminance
and Tonemapping shaders): a 256-bin log-luminance histogram of the
quarter-resolution average, the adapted average luminance, the ACES fit,
sRGB encoding and the blue-noise dither of +-0.5/255."""

from __future__ import annotations

import torch

from benchmark.reference import bluenoise

LUM = (0.2125, 0.7154, 0.0721)
ACES_IN = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566),
           (0.02840, 0.13383, 0.83777))
ACES_OUT = ((1.60475, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605),
            (-0.00327, -0.07276, 1.07602))


def average_luminance(hdr, prev, dt: float, tau: float, min_log=-10.0, log_range=12.0):
    h, w = hdr.shape[:2]
    q = 4
    he, we = (h // q) * q, (w // q) * q
    hq = hdr[:he, :we].reshape(he // q, q, we // q, q, 3).sum(dim=(1, 3)) * (1.0 / (q * q))
    lum = (hq[..., 0] * LUM[0] + hq[..., 1] * LUM[1] + hq[..., 2] * LUM[2]).reshape(-1)
    ll = torch.clamp((torch.log2(torch.clamp(lum, min=1e-12)) - min_log) / log_range, 0.0, 1.0)
    bins = torch.where(lum < 0.005, torch.zeros_like(lum, dtype=torch.int64),
                       (ll * 254.0 + 1.0).to(torch.int64))
    hist = torch.bincount(bins, minlength=256).to(hdr.dtype)
    weights = torch.arange(256, dtype=hdr.dtype, device=hdr.device)
    n = float((w // q) * (h // q))
    wavg = (hist * weights).sum() / torch.clamp(n - hist[0], min=1.0) - 1.0
    avg = torch.exp2((wavg / 254.0) * log_range + min_log)
    return prev + (avg - prev) * (1.0 - torch.exp(torch.tensor(-dt * tau, dtype=hdr.dtype)))


def _rows(m, v):
    return v @ torch.tensor(m, dtype=v.dtype, device=v.device).T


def final(hdr, avg):
    """Final from HDR Main and the adapted average luminance."""
    c = hdr / (9.6 * avg + 1e-4)
    c = _rows(ACES_IN, c)
    c = _rows(ACES_OUT, (c * (c + 0.0245786) - 0.000090537)
              / (c * (0.983729 * c + 0.4329510) + 0.238081))
    c = torch.clamp(torch.clamp(c, 0.0, 1.0), 0.0, 1.0)
    srgb = torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)
    h, w = hdr.shape[:2]
    bn = torch.from_numpy(bluenoise.mask(64)).to(hdr.device, hdr.dtype)
    tiled = bn.tile(-(-h // 64) + 1, -(-w // 64))[:h, :w]
    return torch.clamp(srgb + (tiled[..., None] - 0.5) * (1.0 / 255.0), 0.0, 1.0)
