"""Immediate-mode debug drawing (counterpart of
sailor_tpu/rhi/debug_context.py, Runtime/RHI/DebugContext): lines,
boxes, spheres, frustums and origins with lifetimes, batched into one draw.

Lines accumulate on the host with their lifetimes; ``rasterize_over``
projects fixed sample points along every segment in one batch and writes
them into the image. Where several samples land on one pixel the last
sample in the batch decides it, as the reference's scatter does on a CPU,
and a sample outside the view writes its pixel's own colour back.
"""

from __future__ import annotations

import numpy as np
import torch

from sailor_tpu_torch.core import math3d as m3

_SAMPLES_PER_LINE = 64


class DebugContext:
    def __init__(self):
        self._lines: list[tuple] = []  # (a, b, color, ttl)
        self._uploaded = None  # (the lines' host arrays, their (L, 9) device copy)

    # -- emit API (DebugContext.h) ---------------------------------------------

    def draw_line(self, a, b, color=(0.0, 1.0, 0.0), duration: float = 0.0):
        # copies: a line's device rows are kept while its arrays are the same
        self._lines.append((np.array(a, np.float32), np.array(b, np.float32),
                            np.array(color, np.float32), duration))

    def draw_aabb(self, bmin, bmax, color=(1.0, 1.0, 0.0), duration=0.0):
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        c = [bmin, bmax]
        corners = np.asarray(
            [[c[x][0], c[y][1], c[z][2]] for x in (0, 1) for y in (0, 1) for z in (0, 1)])
        edges = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7), (5, 1), (5, 4),
                 (5, 7), (6, 2), (6, 4), (6, 7)]
        for i, j in edges:
            self.draw_line(corners[i], corners[j], color, duration)

    def draw_sphere(self, center, radius, color=(0.0, 0.7, 1.0), duration=0.0,
                    segments: int = 16):
        center = np.asarray(center, np.float32)
        t = np.linspace(0, 2 * np.pi, segments + 1)
        for axis in range(3):
            pts = np.zeros((len(t), 3), np.float32)
            pts[:, (axis + 1) % 3] = np.cos(t) * radius
            pts[:, (axis + 2) % 3] = np.sin(t) * radius
            pts += center
            for k in range(segments):
                self.draw_line(pts[k], pts[k + 1], color, duration)

    def draw_frustum(self, inv_view_proj, color=(1.0, 0.2, 0.2), duration=0.0):
        ndc = np.asarray(
            [[x, y, z, 1.0] for z in (1.0, 1e-3) for y in (-1, 1) for x in (-1, 1)],
            np.float32)
        m = inv_view_proj.cpu().numpy() if torch.is_tensor(inv_view_proj) else inv_view_proj
        p = ndc @ np.asarray(m, np.float32).T
        p = p[:, :3] / p[:, 3:4]
        edges = [(0, 1), (0, 2), (3, 1), (3, 2), (4, 5), (4, 6), (7, 5), (7, 6),
                 (0, 4), (1, 5), (2, 6), (3, 7)]
        for i, j in edges:
            self.draw_line(p[i], p[j], color, duration)

    def draw_origin(self, origin=(0, 0, 0), size: float = 1.0, duration=0.0):
        o = np.asarray(origin, np.float32)
        self.draw_line(o, o + [size, 0, 0], (1, 0, 0), duration)
        self.draw_line(o, o + [0, size, 0], (0, 1, 0), duration)
        self.draw_line(o, o + [0, 0, size], (0, 0, 1), duration)

    # -- frame lifecycle ---------------------------------------------------------

    @property
    def has_lines(self) -> bool:
        return bool(self._lines)

    def tick(self, dt: float):
        """Expire lines (DebugContext::Tick): a line is kept while its
        lifetime before this tick was positive, and counts down by dt
        (the reference's two filters, the second dropping a line only once
        its lifetime is below -1e9)."""
        self._lines = [(a, b, c, ttl - dt) for (a, b, c, ttl) in self._lines if ttl - dt > -dt]
        self._lines = [e for e in self._lines if e[3] >= 0.0 or e[3] > -1e9]

    def clear(self):
        self._lines.clear()

    # -- render --------------------------------------------------------------------

    def rasterize_over(self, image, view_projection):
        """All debug lines over the (H, W, 3) image, as point splats: 64
        samples a line, projected by ``view_projection`` (4, 4); a sample
        is drawn where it lies in front of the camera, inside the frame and
        at a depth in (0, 1]."""
        if not self._lines:
            return image
        h, w = image.shape[:2]
        dev = image.device
        rows = self._rows(dev)
        a, b, col = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        t = _line_params(dev)[None, :, None]
        pts = a[:, None, :] * (1 - t) + b[:, None, :] * t           # (L, S, 3)
        clip = m3.transform_point_h(view_projection.to(dev), pts)
        wclip = clip[..., 3]
        ndc = clip[..., :3] / torch.clamp(wclip.abs()[..., None], min=1e-6)
        xs = _to_int32((ndc[..., 0] * 0.5 + 0.5) * w)
        ys = _to_int32((0.5 - ndc[..., 1] * 0.5) * h)
        ok = ((wclip > 1e-6) & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
              & (ndc[..., 2] > 0.0) & (ndc[..., 2] <= 1.0)).reshape(-1)
        pix = (ys.clamp(0, h - 1).long() * w + xs.clamp(0, w - 1).long()).reshape(-1)
        # the last sample that lands on a pixel decides it: its colour, or
        # the pixel's own where that sample is not drawn (no host read)
        sample = torch.arange(pix.numel(), device=dev)
        last = torch.full((h * w,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, pix, sample, "amax")
        win = last.clamp(min=0)
        draw = (last >= 0) & ok[win]
        colors = col[win // _SAMPLES_PER_LINE].to(image.dtype)
        out = torch.where(draw[:, None], colors, image.reshape(h * w, -1))
        return out.reshape(image.shape)

    def _rows(self, device):
        """The lines as one (L, 9) tensor (a, b, colour) on ``device``,
        copied again only when the set of lines changed."""
        src = [e[:3] for e in self._lines]
        held = self._uploaded
        if (held is None or held[1].device != torch.device(device) or len(held[0]) != len(src)
                or any(x is not y for p, q in zip(src, held[0]) for x, y in zip(p, q))):
            rows = np.concatenate([np.stack([e[k] for e in src]) for k in range(3)], axis=1)
            self._uploaded = (src, torch.from_numpy(rows).to(device))
        return self._uploaded[1]


def _line_params(device):
    """The 64 sample parameters in [0, 1], rounded as the reference's
    float32 ``linspace`` (i * float32(1/63), then 1)."""
    i = torch.arange(_SAMPLES_PER_LINE, dtype=torch.float32, device=device)
    step = float(np.float32(1.0 / (_SAMPLES_PER_LINE - 1)))
    return torch.where(i < _SAMPLES_PER_LINE - 1, i * step, 1.0)


def _to_int32(x):
    """float32 -> int32 toward zero, saturating at the int32 range and NaN
    to 0, as the reference's conversion does (a plain cast is undefined
    out of range)."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31)
    return x.to(torch.int64).clamp(max=2 ** 31 - 1).to(torch.int32)
