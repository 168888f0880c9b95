"""The Forward+ shade's least work on a frame (B3), from the frame's
tile light lists: the G-buffer read and the radiance written once (60
bytes a pixel), each light row read once (68 bytes), the tile counts (4
bytes a tile), and 108 float operations a (pixel, listed light) pair."""

from __future__ import annotations

from benchmark.bounds import peaks


def frame_s(light_idx, n_lights: int) -> float:
    ty, tx, _ = light_idx.shape
    pairs = int((light_idx >= 0).sum()) * 256
    npix = ty * tx * 256
    return peaks.least_s(npix * 60 + n_lights * 68 + ty * tx * 4, pairs * 108)
