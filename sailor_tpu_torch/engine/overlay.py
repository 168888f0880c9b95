"""Immediate-mode overlay UI, the ImGui analog (counterpart of
sailor_tpu/engine/overlay.py; Runtime/Engine/ImGuiApi.cpp,
RenderImGuiNode.cpp, ImGuiUI.shader).

The host draws the HUD into a small RGBA canvas each frame; the canvas
goes into the frame's state as "overlay/canvas" and the RenderOverlay node
blends it over Final on the device.

    ov = OverlayContext(384, 192)
    ov.new_frame()
    ov.text(4, 4, f"{fps:.1f} FPS")
    ov.rect(0, 0, 120, 40, fill=(0, 0, 0, 120))
    state["overlay/canvas"] = torch.from_numpy(ov.canvas()).to(device)

The reference draws with Pillow (ImageDraw on an RGBA image,
``ImageFont.load_default()``); the port draws the same pixels with numpy:
rectangles and one-pixel lines replace pixels, text blends its ink by the
glyphs' coverage, whose masks, offsets and advances come from
``font_atlas.npz`` (Aileron Regular at size 10, the font Pillow embeds;
made by tests/torch_font_atlas.py).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_WHITE = (255, 255, 255, 255)
_ATLAS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "font_atlas.npz")
_LINE_SPACING = 4  # Pillow's multiline spacing


@functools.cache
def _font():
    """code point -> (coverage mask (h, w) uint8, (dx, dy) from the pen,
    advance), and the line height."""
    with np.load(_ATLAS) as a:
        glyphs = {}
        for i, code in enumerate(a["codes"]):
            h, w = a["sizes"][i]
            mask = a["pixels"][a["starts"][i]:a["starts"][i + 1]].reshape(h, w)
            glyphs[chr(code)] = (mask, tuple(int(v) for v in a["offsets"][i]),
                                 int(a["advances"][i]))
        return glyphs, int(a["line_height"])


def _div255(a):
    """a / 255 rounded, for 0 <= a <= 255 * 255 (Pillow's DIV255)."""
    t = a + 128
    return ((t >> 8) + t) >> 8


def _ink(color) -> np.ndarray:
    c = tuple(int(v) for v in color)
    return np.asarray(c + (255,) * (4 - len(c)), np.int32)


class OverlayContext:
    """The host's HUD canvas (ImGuiApi analog): (height, width) RGBA8,
    straight alpha."""

    def __init__(self, width: int = 384, height: int = 192, scale: int = 1):
        self.width = width
        self.height = height
        self.scale = scale
        self._img = np.zeros((height, width, 4), np.uint8)

    # -- immediate-mode draw calls ---------------------------------------------

    def new_frame(self) -> None:
        """ImGui::NewFrame analog: clear the canvas."""
        self._img = np.zeros((self.height, self.width, 4), np.uint8)

    def text(self, x: int, y: int, s: str, color=_WHITE) -> None:
        """Text with its top-left at the ascender (Pillow's "la" anchor) at
        whole pixels (x, y); lines split at newlines, each the font's line
        height + 4 below the last. Characters outside printable ASCII raise
        ValueError."""
        glyphs, line_height = _font()
        for i, line in enumerate(s.split("\n")):
            missing = sorted(set(line) - set(glyphs))
            if missing:
                raise ValueError(f"the HUD font has no glyph for {missing!r}")
            self._text_line(int(x), int(y) + i * (line_height + _LINE_SPACING), line,
                            _ink(color), glyphs)

    def _text_line(self, x, y, s, ink, glyphs):
        # the string's coverage: each glyph at its pen position, overlaps
        # composited as Pillow's font_render does (src over dst, DIV255)
        placed, pen = [], 0
        for ch in s:
            mask, (dx, dy), adv = glyphs[ch]
            if mask.size:
                placed.append((x + pen + dx, y + dy, mask))
            pen += adv
        if not placed:
            return
        x0 = min(p[0] for p in placed)
        y0 = min(p[1] for p in placed)
        x1 = max(p[0] + p[2].shape[1] for p in placed)
        y1 = max(p[1] + p[2].shape[0] for p in placed)
        cov = np.zeros((y1 - y0, x1 - x0), np.int32)
        for gx, gy, mask in placed:
            m = mask.astype(np.int32)
            reg = cov[gy - y0:gy - y0 + m.shape[0], gx - x0:gx - x0 + m.shape[1]]
            reg[...] = m + _div255(reg * (255 - m))
        # clip to the canvas, then blend the ink by the coverage (Pillow's
        # fill_mask_L on RGBA: a colour channel over a transparent pixel
        # takes the ink whole, alpha blends by the coverage)
        cx0, cy0 = max(x0, 0), max(y0, 0)
        cx1, cy1 = min(x1, self.width), min(y1, self.height)
        if cx0 >= cx1 or cy0 >= cy1:
            return
        m = cov[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0][..., None]
        out = self._img[cy0:cy1, cx0:cx1].astype(np.int32)
        cm = np.where((out[..., 3:4] == 0) & (np.arange(4) != 3), 255, m)
        blended = _div255(out * (255 - cm) + ink * cm)
        self._img[cy0:cy1, cx0:cx1] = np.where(m > 0, blended, out).astype(np.uint8)

    def rect(self, x: int, y: int, w: int, h: int, fill=(0, 0, 0, 128), outline=None) -> None:
        """Pixels [x, x + w) x [y, y + h) set to ``fill``, then a one-pixel
        ``outline`` on the box's edge, as Pillow draws them; w or h below 1
        raises ValueError, as Pillow's rectangle does."""
        x1, y1 = x + w - 1, y + h - 1
        if x1 < x:
            raise ValueError("x1 must be greater than or equal to x0")
        if y1 < y:
            raise ValueError("y1 must be greater than or equal to y0")
        fill_ink = _ink(fill) if fill is not None else None
        if fill_ink is not None:
            self._fill(x, y, x1, y1, fill_ink)
        if outline:
            ink = _ink(outline)
            if fill_ink is None or not np.array_equal(ink, fill_ink):
                # Pillow's one-pixel outline: the top and bottom rows, then
                # each side from the row below the top toward the bottom
                # row, that row excluded (a box one row high thus gets a
                # side pixel in the row below it)
                self._fill(x, y, x1, y, ink)
                self._fill(x, y1, x1, y1, ink)
                step = 1 if y1 >= y + 1 else -1
                rows = range(y + 1, y1, step)
                for col in (x1, x):
                    for row in rows:
                        self._fill(col, row, col, row, ink)

    def _fill(self, x0, y0, x1, y1, ink):
        """Pixels [x0, x1] x [y0, y1], clipped to the canvas, set to ink."""
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, self.width - 1), min(y1, self.height - 1)
        if x0 <= x1 and y0 <= y1:
            self._img[y0:y1 + 1, x0:x1 + 1] = ink.astype(np.uint8)

    def line(self, x0: int, y0: int, x1: int, y1: int, color=_WHITE, width: int = 1) -> None:
        """A one-pixel line from (x0, y0) to (x1, y1), both ends drawn, on
        Pillow's Bresenham steps; wider lines raise NotImplementedError."""
        if width != 1:
            raise NotImplementedError("overlay lines wider than one pixel are not ported")
        ink = _ink(color).astype(np.uint8)
        for px, py in _bresenham(int(x0), int(y0), int(x1), int(y1)):
            if 0 <= px < self.width and 0 <= py < self.height:
                self._img[py, px] = ink

    def progress_bar(self, x: int, y: int, w: int, h: int, frac: float,
                     color=(90, 200, 90, 220)) -> None:
        self.rect(x, y, w, h, fill=(0, 0, 0, 140), outline=(255, 255, 255, 90))
        self.rect(x + 1, y + 1, max(0, int((w - 2) * min(max(frac, 0.0), 1.0))), h - 2,
                  fill=color)

    # -- output ------------------------------------------------------------------

    def canvas(self) -> np.ndarray:
        """(H, W, 4) float32 straight-alpha canvas for the overlay node,
        each pixel repeated ``scale`` times in both directions."""
        arr = self._img.astype(np.float32) / np.float32(255.0)
        if self.scale > 1:
            arr = np.repeat(np.repeat(arr, self.scale, 0), self.scale, 1)
        return arr


def _bresenham(x0, y0, x1, y1):
    """The pixels of a one-pixel line, both ends included."""
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    xs, ys = (1 if x1 >= x0 else -1), (1 if y1 >= y0 else -1)
    pts = []
    if dx >= dy:
        e = 2 * dy - dx
        for _ in range(dx + 1):
            pts.append((x0, y0))
            if e >= 0 and dy:
                y0 += ys
                e -= 2 * dx
            e += 2 * dy
            x0 += xs
    else:
        e = 2 * dx - dy
        for _ in range(dy + 1):
            pts.append((x0, y0))
            if e >= 0 and dx:
                x0 += xs
                e -= 2 * dy
            e += 2 * dx
            y0 += ys
    return pts


def stats_hud(ov: OverlayContext, stats: dict, console_lines=()) -> None:
    """The frame-stats HUD (the reference's window-title FPS/VRAM readout,
    Sailor.cpp:328-347, and the editor console's tail)."""
    ov.new_frame()
    fps = 1000.0 / stats["last_frame_ms"] if stats.get("last_frame_ms") else 0.0
    lines = [
        f"{fps:6.1f} FPS  {stats.get('last_frame_ms', 0.0):6.2f} ms",
        f"frames {stats.get('gpu_frames', 0)}",
    ]
    if "triangles" in stats:
        lines.append(f"tris {stats['triangles']}")
    # per-node device times once a `profile` pass has run, heaviest first
    node_ms = stats.get("node_ms")
    if node_ms:
        for name, ms in sorted(node_ms.items(), key=lambda kv: -kv[1])[:8]:
            lines.append(f"{name[:18]:<18}{ms:6.2f}ms")
    pad, lh = 4, 12
    h = pad * 2 + lh * (len(lines) + len(tuple(console_lines)))
    ov.rect(0, 0, 190, h, fill=(0, 0, 0, 130))
    y = pad
    for ln in lines:
        ov.text(pad, y, ln)
        y += lh
    for ln in console_lines:
        ov.text(pad, y, str(ln)[:30], color=(180, 220, 180, 255))
        y += lh
