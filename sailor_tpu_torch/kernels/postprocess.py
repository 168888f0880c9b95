"""Screen-space post passes (counterpart of sailor_tpu/kernels/postprocess.py);
this slice needs only LinearizeDepth.shader."""

from __future__ import annotations

import torch


def linearize_depth(depth_rev, z_near, z_far):
    """Reverse-Z ndc depth -> positive view-space distance; background (0)
    maps to z_far."""
    lin = z_near * z_far / (depth_rev * (z_far - z_near) + z_near)
    return torch.where(depth_rev > 0.0, lin, torch.broadcast_to(z_far, lin.shape))
