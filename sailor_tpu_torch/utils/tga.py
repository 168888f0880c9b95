"""Truevision TGA decoder (the counterpart of ``imageio.v2.imread`` for
``.tga`` files in sailor_tpu/assets; imageio reads them through Pillow).
TGA has no signature: callers dispatch by extension.

``decode_tga`` reads image types 1 (colour-mapped), 2 (true colour) and 3
(grey), and their run-length forms 9, 10 and 11; pixel depths 8, 16, 24
and 32 (and 1-bit grey), colour maps of 16, 24 and 32 bits with a first
entry index, an image ID, and every origin (bits 4 and 5 of the image
descriptor: right-to-left columns, top-to-bottom rows). It returns what
imageio returns for the same file:

- grey: (H, W) uint8 (bool at 1 bit); 16-bit grey is grey + alpha,
  (H, W, 2) uint8;
- colour-mapped: (H, W, 3) uint8 through a 24-bit map, (H, W, 4) through a
  16- or 32-bit map (a colour-mapped type without a map is grey);
- true colour: (H, W, 3) uint8 at 24 bits, (H, W, 4) at 16 and 32 bits.

Alpha follows the pixel data, as Pillow reads it: a 32-bit pixel's fourth
byte, and a 16-bit pixel's top bit (255 where it is clear, 0 where set;
5-bit samples become c * 255 // 31). The descriptor's alpha-bit count
(bits 0-3) is read but, as in Pillow, does not drop the channel. A
truncated or malformed file raises ValueError naming TGA.
"""

from __future__ import annotations

import numpy as np


def _fail(msg: str):
    return ValueError(f"TGA: {msg}")


def _rle(data: bytes, pos: int, npix: int, bpp: int) -> bytes:
    """Expand ``npix`` pixels of ``bpp`` bytes from run-length packets
    (runs may cross rows)."""
    out = bytearray()
    want = npix * bpp
    while len(out) < want:
        if pos >= len(data):
            raise _fail("truncated run-length data")
        head = data[pos]
        pos += 1
        count = (head & 0x7F) + 1
        if head & 0x80:
            px = data[pos:pos + bpp]
            pos += bpp
            out += px * count
        else:
            px = data[pos:pos + bpp * count]
            pos += bpp * count
            out += px
        if len(px) < bpp:
            raise _fail("truncated run-length data")
    return bytes(out[:want])


def _bgra15(px: np.ndarray) -> np.ndarray:
    """(..., 2) little-endian A1R5G5B5 bytes -> (..., 4) RGBA uint8."""
    v = px[..., 0].astype(np.uint32) | (px[..., 1].astype(np.uint32) << 8)
    r = ((v >> 10) & 31) * 255 // 31
    g = ((v >> 5) & 31) * 255 // 31
    b = (v & 31) * 255 // 31
    a = np.where(v & 0x8000, 0, 255)
    return np.stack([r, g, b, a], -1).astype(np.uint8)


def decode_tga(data: bytes) -> np.ndarray:
    """A TGA file's bytes -> the array ``imageio.v2.imread`` gives."""
    if len(data) < 18:
        raise _fail("truncated header")
    id_len, cmap_type, kind = data[0], data[1], data[2]
    cmap_start = int.from_bytes(data[3:5], "little")
    cmap_len = int.from_bytes(data[5:7], "little")
    cmap_depth = data[7]
    w = int.from_bytes(data[12:14], "little")
    h = int.from_bytes(data[14:16], "little")
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise _fail("not a TGA file")
    base = kind & 7
    if kind not in (1, 2, 3, 9, 10, 11):
        raise _fail(f"unsupported image type {kind}")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        nb = {16: 2, 24: 3, 32: 4}.get(cmap_depth)
        if nb is None:
            raise _fail(f"unsupported colour map depth {cmap_depth}")
        raw = data[pos:pos + nb * cmap_len]
        if len(raw) < nb * cmap_len:
            raise _fail("truncated colour map")
        pos += nb * cmap_len
        ent = np.frombuffer(raw, np.uint8).reshape(cmap_len, nb)
        if nb == 2:
            ent = _bgra15(ent)
        else:
            ent = ent[:, [2, 1, 0, 3][:nb]]
        palette = np.zeros((max(256, cmap_start + cmap_len), ent.shape[1]), np.uint8)
        if nb == 2:  # entries before the first are 16-bit zeros: opaque black
            palette[:cmap_start] = _bgra15(np.zeros((1, 2), np.uint8))
        palette[cmap_start:cmap_start + cmap_len] = ent
    supported = {(1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32)}
    if (base, depth) not in supported:
        raise _fail(f"unsupported type {kind} at {depth} bits")

    if depth == 1:
        if kind & 8:
            raise _fail("run-length 1-bit grey")
        stride = (w + 7) // 8
        raw = data[pos:pos + stride * h]
        if len(raw) < stride * h:
            raise _fail("truncated pixel data")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride), axis=1)
        img = bits[:, :w].astype(bool)
    else:
        bpp = depth // 8
        if kind & 8:
            raw = _rle(data, pos, w * h, bpp)
        else:
            raw = data[pos:pos + w * h * bpp]
            if len(raw) < w * h * bpp:
                raise _fail("truncated pixel data")
        px = np.frombuffer(raw, np.uint8).reshape(h, w, bpp)
        if base == 1:
            idx = px[..., 0]
            img = idx if palette is None else palette[idx]
        elif base == 3:
            img = px[..., 0] if depth == 8 else px.copy()  # grey, or grey + alpha
        elif depth == 16:
            img = _bgra15(px)
        else:
            img = px[..., [2, 1, 0, 3][:bpp]]
    if not flags & 0x20:  # rows stored bottom-up
        img = img[::-1]
    if flags & 0x10:  # columns stored right-to-left
        img = img[:, ::-1]
    return np.ascontiguousarray(img)
