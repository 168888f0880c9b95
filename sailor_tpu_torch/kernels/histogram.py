"""Luminance histogram + eye adaptation (counterpart of
sailor_tpu/kernels/histogram.py: ComputeHistogram.shader and
ComputeAverageLuminance.shader, Bruneton-style exposure)."""

from __future__ import annotations

import torch

from sailor_tpu_torch import config

NUM_BINS = 256
_EPS = 0.005  # ComputeHistogram.shader EPSILON


def _luminance(rgb):
    return (rgb[..., 0] * config.RGB_TO_LUM[0] + rgb[..., 1] * config.RGB_TO_LUM[1]
            + rgb[..., 2] * config.RGB_TO_LUM[2])


def luminance_histogram(hdr, min_log_lum: float = -10.0, log_lum_range: float = 12.0):
    """256-bin log-luminance histogram of an (H, W, 3) HDR image as float32
    counts. Bin 0 = pixels with luminance < EPS."""
    lum = _luminance(hdr).reshape(-1)
    log_lum = torch.clamp(
        (torch.log2(torch.clamp(lum, min=1e-12)) - min_log_lum) / log_lum_range, 0.0, 1.0)
    bins = torch.where(lum < _EPS, torch.zeros_like(lum, dtype=torch.int64),
                       (log_lum * 254.0 + 1.0).to(torch.int64))
    return torch.bincount(bins, minlength=NUM_BINS).to(torch.float32)


def adapt_average_luminance(hist, prev_avg_lum, num_pixels: float, dt, *,
                            min_log_lum: float = -10.0, log_lum_range: float = 12.0,
                            tau: float = 1.1):
    """Weighted-average luminance with temporal adaptation; timeCoeff =
    1 - exp(-dt * tau). Returns the new adapted average (0-d tensor)."""
    weights = torch.arange(NUM_BINS, dtype=torch.float32, device=hist.device)
    weighted_sum = torch.sum(hist * weights)
    black = hist[0]
    weighted_log_avg = weighted_sum / torch.clamp(num_pixels - black, min=1.0) - 1.0
    avg_lum = torch.exp2((weighted_log_avg / 254.0) * log_lum_range + min_log_lum)
    time_coeff = 1.0 - torch.exp(-dt * tau)
    return prev_avg_lum + (avg_lum - prev_avg_lum) * time_coeff
