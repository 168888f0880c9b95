"""Dependency-free PNG encoder for RGB8 images (counterpart of
sailor_tpu/utils/png.py). The CLI's ``--out`` and the frame capture write
with it, so the port needs no image library."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(img_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    h, w = img_u8.shape[:2]
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by ``encode_png`` (8-bit RGB, filter 0 on every
    row) -> (H, W, 3) uint8; anything else raises ValueError."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"unsupported PNG header {hdr}")
    w, h = hdr[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("filtered PNG rows are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy()
