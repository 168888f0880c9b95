"""Radiance HDR (RGBE) decoder: ``.hdr`` files to linear float32 RGB.

``decode_hdr`` reads files that start ``#?RADIANCE`` or ``#?RGBE`` with
``FORMAT=32-bit_rle_rgbe`` (or no FORMAT line), the resolution line
``-Y H +X W`` (rows top to bottom, columns left to right; the other
orientations raise), and flat or new run-length scanlines (a scanline of
8 to 32767 pixels that starts 2, 2 and its width; its four channels are
each runs of one byte, count > 128, or literal bytes). A scanline that
does not start so is flat, and so is every one after it, as in the
Radiance reader. A pixel (r, g, b, e) is (r, g, b) * 2^(e - 136), or 0
where e is 0: the array OpenCV's ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
gives, reversed to RGB, (H, W, 3) float32. A truncated or malformed file
raises ValueError naming Radiance HDR.
"""

from __future__ import annotations

import re

import numpy as np

SIGNATURES = (b"#?RADIANCE", b"#?RGBE")


def _fail(msg: str):
    return ValueError(f"Radiance HDR: {msg}")


def _header(data: bytes):
    """(width, height, offset of the pixels)."""
    if not data.startswith(SIGNATURES):
        raise _fail("not a Radiance file")
    pos = 0
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise _fail("truncated header")
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise _fail(f"unsupported {line.decode(errors='replace')}")
    end = data.find(b"\n", pos)
    if end < 0:
        raise _fail("truncated resolution line")
    m = re.fullmatch(rb"-Y (\d+) \+X (\d+)", data[pos:end].strip())
    if m is None:
        raise _fail(f"unsupported resolution line {data[pos:end][:40]!r} (only -Y H +X W)")
    h, w = int(m.group(1)), int(m.group(2))
    if w <= 0 or h <= 0:
        raise _fail(f"bad size {w}x{h}")
    return w, h, end + 1


def _scanline_rle(data: bytes, pos: int, w: int) -> tuple[np.ndarray, int]:
    """One new-RLE scanline after its 4-byte start: (W, 4) bytes, next pos."""
    line = np.zeros((4, w), np.uint8)
    for c in range(4):
        x = 0
        while x < w:
            if pos >= len(data):
                raise _fail("truncated scanline")
            count = data[pos]
            pos += 1
            if count > 128:
                count -= 128
                if count > w - x or pos >= len(data):
                    raise _fail("bad scanline run")
                line[c, x:x + count] = data[pos]
                pos += 1
            else:
                if count == 0 or count > w - x or pos + count > len(data):
                    raise _fail("bad scanline run")
                line[c, x:x + count] = np.frombuffer(data, np.uint8, count, pos)
                pos += count
            x += count
    return line.T, pos


def decode_hdr(data: bytes) -> np.ndarray:
    """A Radiance HDR file's bytes -> (H, W, 3) float32 linear RGB."""
    w, h, pos = _header(data)
    rgbe = np.zeros((h, w, 4), np.uint8)
    y = 0
    if 8 <= w <= 0x7FFF:
        while y < h:
            start = data[pos:pos + 4]
            if len(start) < 4:
                raise _fail("truncated scanline")
            if start[0] != 2 or start[1] != 2 or start[2] & 0x80:
                break  # not run-length encoded: the rest is flat
            if (start[2] << 8 | start[3]) != w:
                raise _fail("scanline width mismatch")
            rgbe[y], pos = _scanline_rle(data, pos + 4, w)
            y += 1
    if y < h:
        n = (h - y) * w * 4
        flat = data[pos:pos + n]
        if len(flat) < n:
            raise _fail("truncated pixel data")
        rgbe[y:] = np.frombuffer(flat, np.uint8).reshape(h - y, w, 4)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]
